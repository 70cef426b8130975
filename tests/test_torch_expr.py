"""The port's expression evaluator against the JAX package's: the Q1/Q6/
Q14 predicates, scaled-decimal arithmetic, CASE, LIKE and the other
ported node kinds, compared on data and validity over every lane (dead
lanes poisoned), exactly."""

import numpy as np
import pytest

import oceanbase_tpu.datatypes as jdt
import oceanbase_tpu.expr.compile as jcomp
import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu_torch.datatypes as tdt
import oceanbase_tpu_torch.expr.compile as tcomp
import oceanbase_tpu_torch.expr.ir as tir
from oceanbase_tpu.analysis.poison import poison_pad_lanes
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge


def jax_parts(rel):
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _exprs(ir, dt):
    """name -> expression, built on either package's IR."""
    def dec(s):
        return ir.lit(s, dt.SqlType.decimal())

    def date(s):
        return ir.lit(s, dt.SqlType.date())

    c = ir.col
    disc_price = c("price") * (dec("1.00") - c("disc"))
    return {
        "q6_pred": (c("ship") >= date("1994-01-01"))
        .and_(c("ship") < date("1995-01-01"))
        .and_(c("disc").between(dec("0.05"), dec("0.07")))
        .and_(c("qty") < dec("24.00")),
        "q1_pred": c("ship") <= date("1998-09-02"),
        "q14_pred": (c("ship") >= date("1995-09-01"))
        .and_(c("ship") < date("1995-10-01")),
        "disc_price": disc_price,
        "charge": disc_price * (dec("1.00") + c("tax")),
        "q6_product": c("price") * c("disc"),
        "promo_case": ir.Case(
            whens=[(c("ptype").like("PROMO%"), disc_price)],
            else_=ir.lit("0.0000", dt.SqlType.decimal(15, 4))),
        "like": c("ptype").like("%BRUSH_D%"),
        "not_like": ir.Like(c("ptype"), "PROMO%", negated=True),
        "str_eq": c("ptype").eq(ir.lit("ECONOMY")),
        "str_lt": c("ptype") < ir.lit("P"),
        "str_ge_absent": c("ptype") >= ir.lit("Q"),
        "str_col_eq": c("ptype").eq(c("ptype2")),
        "str_col_ne": c("ptype").ne(c("ptype2")),
        "or_not": ir.Not(c("n").is_null()).or_(c("qty") > dec("45")),
        "nullable_arith": c("n") + ir.lit(3),
        "nullable_cmp": c("n") > ir.lit(0),
        "div_double": c("price") / c("n"),
        "mod": c("n") % ir.lit(7),
        "sub_int": c("n") - c("k"),
        "in_list": c("k").isin([1, 3, 5, 8]),
        "in_str": c("ptype").isin(["ECONOMY", "nope", "STANDARD PLATED"]),
        "date_plus": c("ship") + ir.lit(30),
        "case_multi": ir.Case(
            whens=[(c("k") < ir.lit(3), c("n")),
                   (c("k") < ir.lit(6), ir.lit(100))],
            else_=None),
        "cast_dec": ir.Cast(c("n"), dt.SqlType.decimal(15, 2)),
        "cast_round": ir.Cast(c("price"), dt.SqlType.decimal(15, 0)),
        "cast_int": ir.Cast(c("price"), dt.SqlType.int_()),
        "cast_double": ir.Cast(c("tax"), dt.SqlType.double()),
        "float_mix": ir.lit(100.0) * c("price") / c("tax"),
    }


NAMES = sorted(_exprs(tir, tdt))


def _relations(n=500, seed=21):
    rng = np.random.default_rng(seed)
    words = np.array(["PROMO BRUSHED TIN", "STANDARD PLATED", "ECONOMY",
                      "PROMO ANODIZED", "LARGE BRUSHED NICKEL", "MEDIUM"],
                     dtype=object)
    arrays = {
        "ship": rng.integers(8000, 10600, n).astype(np.int32),
        "disc": rng.integers(0, 11, n),
        "qty": rng.integers(1, 51, n) * 100,
        "price": rng.integers(-50_000, 10_000_000, n),
        "tax": rng.integers(0, 9, n),
        "ptype": words[rng.integers(0, len(words), n)],
        # another dictionary, partly overlapping ptype's
        "ptype2": np.array(["ECONOMY", "MEDIUM", "ZZZ", "PROMO ANODIZED"],
                           dtype=object)[rng.integers(0, 4, n)],
        "n": rng.integers(-20, 20, n),
        "k": rng.integers(0, 10, n),
    }
    types = {c: jdt.SqlType.decimal(15, 2)
             for c in ("disc", "qty", "price", "tax")}
    types["ship"] = jdt.SqlType.date()
    valids = {"n": rng.random(n) < 0.8}
    jrel = jcol.from_numpy(arrays, types=types, valids=valids)
    jrel = poison_pad_lanes(jrel.pad_to(jcol.bucket_capacity(n + 1)))
    parts, mask = jax_parts(jrel)
    return jrel, bridge.relation_from_parts(parts, mask, device="cpu")


@pytest.fixture(scope="module")
def rels():
    return _relations()


def _assert_same_column(tc, jc):
    assert tc.dtype.kind.value == jc.dtype.kind.value
    assert (tc.dtype.precision, tc.dtype.scale) == \
        (jc.dtype.precision, jc.dtype.scale)
    jd = np.asarray(jc.data)
    td = tc.data.numpy()
    assert td.dtype == jd.dtype
    np.testing.assert_array_equal(td, jd)
    assert (tc.valid is None) == (jc.valid is None)
    if jc.valid is not None:
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    if jc.sdict is not None:
        np.testing.assert_array_equal(tc.sdict.values, jc.sdict.values)


@pytest.mark.parametrize("name", NAMES)
def test_eval_expr_matches(rels, name):
    jrel, trel = rels
    je = _exprs(jir, jdt)[name]
    te = _exprs(tir, tdt)[name]
    _assert_same_column(tcomp.eval_expr(te, trel),
                        jcomp.eval_expr(je, jrel))


@pytest.mark.parametrize("name", ["q6_pred", "q1_pred", "q14_pred", "like",
                                  "nullable_cmp", "or_not"])
def test_eval_predicate_matches(rels, name):
    jrel, trel = rels
    got = tcomp.eval_predicate(_exprs(tir, tdt)[name], trel).numpy()
    want = np.asarray(jcomp.eval_predicate(_exprs(jir, jdt)[name], jrel))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text,dtype", [
    ("0.06", "decimal"), ("-12.500", "decimal"), ("24", "decimal"),
    ("1995-09-01", "date"), (7, None), (2.5, None), ("abc", None),
    (True, None), (None, None),
])
def test_literal_value_matches(text, dtype):
    def make(ir, dt):
        t = None if dtype is None else getattr(dt.SqlType, dtype)()
        return ir.lit(text, t)

    tv, tt = tcomp.literal_value(make(tir, tdt))
    jv, jt = jcomp.literal_value(make(jir, jdt))
    assert tv == jv
    assert (tt.kind.value, tt.precision, tt.scale) == \
        (jt.kind.value, jt.precision, jt.scale)


@pytest.mark.parametrize("pattern", ["PROMO%", "%", "_", "a.b%", "%[x]_"])
def test_like_to_regex_matches(pattern):
    assert tcomp.like_to_regex(pattern) == jcomp.like_to_regex(pattern)


def test_functions_not_ported_yet_raise(rels):
    # scalar functions are ported (tests/test_torch_functions.py); the
    # VECTOR distance functions are the ones still queued
    _jrel, trel = rels
    for name in ("l2_distance", "inner_product", "negative_inner_product",
                 "cosine_distance"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcomp.eval_expr(tir.FuncCall(name, [tir.col("n"),
                                                tir.lit("[1]")]), trel)
    with pytest.raises(NotImplementedError, match="function no_such_fn"):
        tcomp.eval_expr(tir.FuncCall("no_such_fn", [tir.col("n")]), trel)
