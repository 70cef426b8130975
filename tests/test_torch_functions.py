"""The port's scalar functions against the JAX package's ``eval_expr``:
the cases of ``tests/test_functions.py`` and ``tests/test_expr.py`` (math,
string, NULL, date and date-name functions, CONCAT_WS, UDFs) on one
relation with NULLs, dates on both sides of 1970 and across leap years,
and poisoned dead lanes.  Integer, decimal, date, string-code and
validity lanes must match exactly; float64 lanes at rtol 1e-12 (libm and
XLA may round a transcendental differently in the last place)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceanbase_tpu.datatypes as jdt
import oceanbase_tpu.expr.compile as jcomp
import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu_torch.datatypes as tdt
import oceanbase_tpu_torch.expr.compile as tcomp
import oceanbase_tpu_torch.expr.ir as tir
from oceanbase_tpu.analysis.poison import poison_pad_lanes
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge

FLOAT_RTOL = 1e-12


def jax_parts(rel):
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _relation(n=300, seed=7):
    rng = np.random.default_rng(seed)
    words = np.array(["hello", "  World ", "abc", "", "x", "a b c d",
                      "lollipop", "PROMO brushed", "13-456-789"],
                     dtype=object)
    lo, hi = jdt.date_to_days("1895-01-01"), jdt.date_to_days("2105-12-31")
    edges = [jdt.date_to_days(s) for s in (
        "1900-02-28", "1900-03-01", "1969-12-31", "1970-01-01",
        "2000-02-29", "2000-03-01", "2024-02-29", "2100-02-28",
        "1996-12-31", "1994-03-15")]
    days = rng.integers(lo, hi, n)
    days[:len(edges)] = edges
    arrays = {
        "a": rng.integers(-50, 50, n),
        "k": rng.integers(0, 12, n),
        "f": rng.normal(scale=20.0, size=n),
        "pos": rng.random(n) * 50 + 0.5,
        "dec": rng.integers(-100_000, 100_000, n),
        "w": words[rng.integers(0, len(words), n)],
        "w2": np.array(["x", "-", "yz"], dtype=object)[
            rng.integers(0, 3, n)],
        "d": days.astype(np.int32),
    }
    types = {"dec": jdt.SqlType.decimal(15, 2), "d": jdt.SqlType.date()}
    valids = {"a": rng.random(n) < 0.85, "dec": rng.random(n) < 0.9,
              "w2": rng.random(n) < 0.8, "d": rng.random(n) < 0.9}
    jrel = jcol.from_numpy(arrays, types=types, valids=valids)
    jrel = jrel.pad_to(jcol.bucket_capacity(n + 1))
    mask = np.asarray(jrel.mask) & (rng.random(jrel.capacity) < 0.9)
    jrel = poison_pad_lanes(jrel.with_mask(jnp.asarray(mask)))
    parts, m = jax_parts(jrel)
    return jrel, bridge.relation_from_parts(parts, m, device="cpu")


@pytest.fixture(scope="module")
def rel():
    return _relation()


def _cases(ir, dt):
    """name -> expression, built on either package's IR."""
    c, lit, f = ir.col, ir.lit, ir.FuncCall

    def dec(s):
        return lit(s, dt.SqlType.decimal())

    return {
        "abs_int": f("abs", [c("a")]),
        "abs_dec": f("abs", [c("dec")]),
        "sign_int": f("sign", [c("a") - lit(1)]),
        "sign_float": f("sign", [c("f")]),
        "ceil_dec": f("ceil", [c("dec")]),
        "floor_dec": f("floor", [c("dec")]),
        "ceiling_float": f("ceiling", [c("f")]),
        "floor_float": f("floor", [c("f")]),
        "floor_int": f("floor", [c("a")]),
        "round_dec_1": f("round", [c("dec"), lit(1)]),
        "round_dec_0": f("round", [c("dec")]),
        "round_dec_4": f("round", [c("dec"), lit(4)]),
        "truncate_dec_1": f("truncate", [c("dec"), lit(1)]),
        "truncate_dec_0": f("truncate", [c("dec"), lit(0)]),
        "round_float_2": f("round", [c("f"), lit(2)]),
        "truncate_float_1": f("truncate", [c("f"), lit(1)]),
        "round_int": f("round", [c("a"), lit(2)]),
        "sqrt": f("sqrt", [c("pos")]),
        "sqrt_negative": f("sqrt", [c("f")]),
        "exp": f("exp", [c("dec") / lit(100)]),
        "ln": f("ln", [f("abs", [c("a")]) + lit(1)]),
        "ln_zero": f("ln", [c("a")]),
        "log2": f("log2", [c("pos")]),
        "log10": f("log10", [c("dec")]),
        "sin": f("sin", [c("f")]),
        "cos": f("cos", [c("dec")]),
        "tan": f("tan", [c("f")]),
        "power": f("power", [c("pos"), lit(1.5)]),
        "pow_int": f("pow", [lit(2), c("k")]),
        "mod": f("mod", [c("a"), lit(7)]),
        "mod_by_zero": f("mod", [c("a"), c("k") - c("k")]),
        "greatest": f("greatest", [c("a"), lit(2)]),
        "least": f("least", [c("a"), c("k"), lit(5)]),
        "greatest_dec": f("greatest", [c("dec"), c("a")]),
        "ifnull": f("ifnull", [c("a"), lit(-1)]),
        "coalesce": f("coalesce", [c("a"), c("k"), lit(0)]),
        "coalesce_str": f("coalesce", [c("w2"), c("w")]),
        "nullif": f("nullif", [c("a"), lit(1)]),
        "length": f("length", [c("w")]),
        "char_length": f("char_length", [c("w2")]),
        "trim": f("trim", [c("w")]),
        "ltrim": f("ltrim", [c("w")]),
        "rtrim": f("rtrim", [c("w")]),
        "reverse": f("reverse", [c("w")]),
        "replace": f("replace", [c("w"), lit("l"), lit("L")]),
        "left": f("left", [c("w"), lit(2)]),
        "right": f("right", [c("w"), lit(2)]),
        "right_zero": f("right", [c("w"), lit(0)]),
        "concat_lit": f("concat", [f("trim", [c("w")]), lit("!")]),
        "concat_cols": f("concat", [c("w"), c("w2"), c("w")]),
        "substring_2": f("substring", [c("w"), lit(3)]),
        "substring_3": f("substring", [c("w"), lit(1), lit(2)]),
        "substr": f("substr", [c("w2"), lit(2), lit(5)]),
        "upper": f("upper", [f("trim", [c("w")])]),
        "lower": f("lower", [c("w")]),
        "ucase": f("ucase", [c("w2")]),
        "lcase": f("lcase", [c("w")]),
        "if_str": f("if", [c("k").eq(lit(1)), f("upper", [c("w")]),
                           c("w")]),
        "if_num": f("if", [c("a") > lit(0), c("a"), c("dec")]),
        "isnull": f("isnull", [c("a")]),
        "isnull_notnull": f("isnull", [c("k")]),
        "atan": f("atan", [c("f")]),
        "asin": f("asin", [c("f") / lit(100.0)]),
        "acos": f("acos", [c("f") / lit(100.0)]),
        "sinh": f("sinh", [c("f") / lit(10.0)]),
        "cosh": f("cosh", [c("f") / lit(10.0)]),
        "tanh": f("tanh", [c("f")]),
        "cot": f("cot", [c("pos")]),
        "degrees": f("degrees", [f("pi", [])]),
        "radians": f("radians", [c("dec")]),
        "atan2": f("atan2", [c("f"), c("pos")]),
        "pi": f("pi", []),
        "log_1": f("log", [c("pos")]),
        "log_2": f("log", [lit(2), c("pos")]),
        "repeat": f("repeat", [c("w"), lit(2)]),
        "repeat_neg": f("repeat", [c("w2"), lit(-1)]),
        "lpad": f("lpad", [c("w"), lit(5), lit("*")]),
        "rpad": f("rpad", [c("w"), lit(7)]),
        "instr": f("instr", [c("w"), lit("l")]),
        "locate": f("locate", [lit("o"), c("w")]),
        "position": f("position", [lit("b"), c("w")]),
        "ascii": f("ascii", [c("w")]),
        "substring_index_pos": f("substring_index", [c("w"), lit(" "),
                                                     lit(1)]),
        "substring_index_neg": f("substring_index", [c("w"), lit("-"),
                                                     lit(-2)]),
        "concat_ws": f("concat_ws", [lit("-"), c("w2"), c("w"), c("w2")]),
        "md5": f("md5", [c("w")]),
        "sha1": f("sha1", [c("w2")]),
        "hex": f("hex", [c("w")]),
        "dayname": f("dayname", [c("d")]),
        "monthname": f("monthname", [c("d")]),
        "last_day": f("last_day", [c("d")]),
        "extract_year": f("extract_year", [c("d")]),
        "year": f("year", [c("d")]),
        "extract_month": f("extract_month", [c("d")]),
        "month": f("month", [c("d")]),
        "extract_day": f("extract_day", [c("d")]),
        "day": f("day", [c("d")]),
        "quarter": f("quarter", [c("d")]),
        "dayofyear": f("dayofyear", [c("d")]),
        "dayofweek": f("dayofweek", [c("d")]),
        "weekday": f("weekday", [c("d")]),
        "add_months": f("add_months", [c("d"), lit(12)]),
        "add_months_col": f("add_months", [c("d"), c("a")]),
        "datediff": f("datediff", [c("d"),
                                   lit("1994-01-01", dt.SqlType.date())]),
        "match_against": f("match_against", [c("w"),
                                             lit("hello brushed")]),
        "match_against_empty": f("match_against", [c("w"), lit("")]),
        "extract_in_arith": f("extract_year", [c("d")]) * lit(100)
        + f("extract_month", [c("d")]),
        "dec_round_then_cmp": f("round", [c("dec"), lit(0)]) > dec("10"),
    }


NAMES = sorted(_cases(tir, tdt))

# float -> int64 casts of NaN are implementation-defined: XLA saturates to
# 0 while a torch cast on the CPU gives INT64_MIN.  Only the poisoned dead
# lanes hold NaN, so these cases are held on the live lanes.
_LIVE_ONLY = {"sign_float", "ceiling_float", "floor_float"}


def _assert_same_column(tc, jc, live=None):
    assert tc.dtype.kind.value == jc.dtype.kind.value
    assert (tc.dtype.precision, tc.dtype.scale) == \
        (jc.dtype.precision, jc.dtype.scale)
    jd = np.asarray(jc.data)
    td = tc.data.numpy()
    assert td.dtype == jd.dtype
    assert td.shape == jd.shape
    sel = slice(None) if live is None else live
    if jd.dtype.kind == "f":
        np.testing.assert_allclose(td[sel], jd[sel], rtol=FLOAT_RTOL)
    else:
        np.testing.assert_array_equal(td[sel], jd[sel])
    assert (tc.valid is None) == (jc.valid is None)
    if jc.valid is not None:
        np.testing.assert_array_equal(tc.valid.numpy()[sel],
                                      np.asarray(jc.valid)[sel])
    assert (tc.sdict is None) == (jc.sdict is None)
    if jc.sdict is not None:
        assert list(tc.sdict.values) == list(jc.sdict.values)


@pytest.mark.parametrize("name", NAMES)
def test_eval_func_matches(rel, name):
    jrel, trel = rel
    live = np.asarray(jrel.mask) if name in _LIVE_ONLY else None
    _assert_same_column(tcomp.eval_expr(_cases(tir, tdt)[name], trel),
                        jcomp.eval_expr(_cases(jir, jdt)[name], jrel),
                        live)


def test_udf_registry_matches(rel):
    jrel, trel = rel
    jcomp.register_udf("twice_plus", lambda x, y: x * 2 + y)
    tcomp.register_udf("twice_plus", lambda x, y: x * 2 + y)
    jcomp.register_udf("halve", lambda x: x / 2.0, jdt.SqlType.double())
    tcomp.register_udf("halve", lambda x: x / 2.0, tdt.SqlType.double())
    try:
        for args in (("twice_plus", ["a", "k"]), ("halve", ["f"]),
                     ("TWICE_PLUS", ["k", "a"])):
            fname, cols = args
            _assert_same_column(
                tcomp.eval_expr(tir.FuncCall(fname, [tir.col(x)
                                                     for x in cols]), trel),
                jcomp.eval_expr(jir.FuncCall(fname, [jir.col(x)
                                                     for x in cols]), jrel))
    finally:
        for name in ("twice_plus", "halve"):
            jcomp.unregister_udf(name)
            tcomp.unregister_udf(name)
    with pytest.raises(NotImplementedError, match="twice_plus"):
        tcomp.eval_expr(tir.FuncCall("twice_plus", [tir.col("a"),
                                                    tir.col("k")]), trel)


@pytest.mark.parametrize("seed", [0, 1])
def test_civil_date_helpers_match(seed):
    rng = np.random.default_rng(seed)
    z = np.concatenate([
        rng.integers(-1_000_000, 3_000_000, 2000),
        np.array([-719469, -719468, -146097, -1, 0, 59, 60, 365, 10957,
                  11016, 2932896])])
    jy, jm, jd = jcomp.civil_from_days(jnp.asarray(z))
    ty, tm, td = tcomp.civil_from_days(torch.from_numpy(z))
    for a, b in ((ty, jy), (tm, jm), (td, jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tcomp.days_from_civil(ty, tm, td)
    np.testing.assert_array_equal(back.numpy(), z)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomp.days_from_civil(jy, jm, jd)))
    np.testing.assert_array_equal(
        tcomp._days_in_month(ty, tm).numpy(),
        np.asarray(jcomp._days_in_month(jy, jm)))


def test_vector_functions_wait():
    """The VECTOR distance functions against the JAX package's on a [n, d] column with NULL lanes, over a
    literal and over a second column: float64 at 1e-6 relative (float32
    sums underneath, summed in another order), with a 1e-6 absolute
    floor where an inner product cancels; validity exactly."""
    rng = np.random.default_rng(17)
    n, d = 64, 12
    arrays = {"a": rng.normal(size=(n, d)).astype(np.float32),
              "b": rng.normal(size=(n, d)).astype(np.float32)}
    valids = {"a": rng.random(n) > 0.2, "b": rng.random(n) > 0.2}
    jrel = jcol.from_numpy(arrays, valids=valids)
    trel = bridge.relation_from_parts(jax_parts(jrel)[0], device="cpu")
    lit = "[" + ", ".join(f"{x:.4f}" for x in rng.normal(size=d)) + "]"
    for name in ("l2_distance", "cosine_distance", "inner_product",
                 "negative_inner_product"):
        for args in (("a", lit), (lit, "a"), ("a", "b")):
            def ir_args(mod):
                return [mod.col(x) if not x.startswith("[") else mod.lit(x)
                        for x in args]

            j = jcomp.eval_expr(jir.FuncCall(name, ir_args(jir)), jrel)
            t = tcomp.eval_expr(tir.FuncCall(name, ir_args(tir)), trel)
            assert t.dtype.kind == tdt.TypeKind.DOUBLE
            assert t.data.dtype == torch.float64
            np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(
                t.valid.numpy(), np.asarray(j.valid))
