"""The port's operators against the JAX package's on identical inputs
(dead lanes poisoned): group-by on both paths, scalar aggregates, sorts,
exact-key joins of every kind with capacity padding and overflow, and
the torch counterparts of lexsort / repeat."""

import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceanbase_tpu.datatypes as jdt
import oceanbase_tpu.exec.ops as jops
import oceanbase_tpu.exec.plan as jplan
import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu_torch.datatypes as tdt
import oceanbase_tpu_torch.exec.ops as tops
import oceanbase_tpu_torch.exec.plan as tplan
import oceanbase_tpu_torch.expr.ir as tir
from oceanbase_tpu.analysis.poison import poison_pad_lanes, results_identical
from oceanbase_tpu.exec.diag import CapacityOverflow as JOverflow
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge
from oceanbase_tpu_torch.exec.diag import CapacityOverflow as TOverflow
from oceanbase_tpu_torch.expr.compile import eval_expr
from oceanbase_tpu_torch.vector import column as tcol

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)

JAX = (jir, jdt, jops, jplan)
TORCH = (tir, tdt, tops, tplan)


def jax_parts(rel):
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _load(arrays, types, valids, seed, pad=True):
    """(JAX relation, port relation) on the same lanes: padded to the
    next bucket with poisoned dead lanes and a few masked-out live ones."""
    n = len(next(iter(arrays.values())))
    jrel = jcol.from_numpy(arrays, types=types, valids=valids)
    if pad:
        jrel = jrel.pad_to(jcol.bucket_capacity(n + 1))
        rng = np.random.default_rng(seed)
        mask = np.asarray(jrel.mask) & (rng.random(jrel.capacity) < 0.9)
        jrel = poison_pad_lanes(jrel.with_mask(jnp.asarray(mask)))
    parts, mask = jax_parts(jrel)
    return jrel, bridge.relation_from_parts(parts, mask, device="cpu")


def _facts(n=400, seed=1):
    rng = np.random.default_rng(seed)
    flags = np.array(["A", "N", "R"], dtype=object)
    arrays = {
        "g": flags[rng.integers(0, 3, n)],
        "h": np.array(["F", "O"], dtype=object)[rng.integers(0, 2, n)],
        "k": rng.integers(0, 12, n),
        "v": rng.integers(-10_000, 10_000, n),
        "x": rng.normal(size=n),
        "b": rng.random(n) < 0.3,
        "dt": rng.integers(9000, 9100, n).astype(np.int32),
    }
    types = {"v": jdt.SqlType.decimal(15, 2), "dt": jdt.SqlType.date()}
    valids = {"k": rng.random(n) < 0.85, "v": rng.random(n) < 0.9,
              "g": rng.random(n) < 0.95}
    return _load(arrays, types, valids, seed)


@pytest.fixture(scope="module")
def facts():
    return _facts()


def _assert_same(trel, jrel, float_rtol=1e-12):
    np.testing.assert_array_equal(trel.mask_or_true().numpy(),
                                  np.asarray(jrel.mask_or_true()))
    t, j = tcol.to_numpy(trel), jcol.to_numpy(jrel)
    assert sorted(t) == sorted(j)
    for k in j:
        x, y = np.asarray(t[k]), np.asarray(j[k])
        assert x.shape == y.shape, k
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=float_rtol, err_msg=k)
        elif y.dtype == object:
            assert list(map(repr, x)) == list(map(repr, y)), k
        else:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def _aggs(ir, ops, with_float=True):
    c = ir.col
    out = [ops.AggSpec("cnt", "count_star"),
           ops.AggSpec("cnt_k", "count", c("k")),
           ops.AggSpec("sum_v", "sum", c("v")),
           ops.AggSpec("avg_v", "avg", c("v")),
           ops.AggSpec("min_v", "min", c("v")),
           ops.AggSpec("max_k", "max", c("k")),
           ops.AggSpec("sum_b", "sum", c("b")),
           ops.AggSpec("min_dt", "min", c("dt")),
           ops.AggSpec("max_g", "max", c("g"))]
    if with_float:
        out += [ops.AggSpec("max_x", "max", c("x")),
                ops.AggSpec("avg_k", "avg", c("k"))]
    return out


GROUPINGS = {
    "lowcard_two_strings": (lambda ir: {"g": ir.col("g"), "h": ir.col("h")},
                            None),
    "lowcard_bool": (lambda ir: {"b": ir.col("b")}, 8),
    "sort_int_nullable": (lambda ir: {"k": ir.col("k")}, None),
    "sort_int_and_string": (lambda ir: {"k": ir.col("k"), "h": ir.col("h")},
                            64),
    "sort_expr_key": (lambda ir: {"kk": ir.col("k") % ir.lit(5)}, None),
    "lowcard_capped_to_sort": (lambda ir: {"g": ir.col("g"),
                                           "h": ir.col("h")}, 4),
}


@pytest.mark.parametrize("name", sorted(GROUPINGS))
def test_hash_groupby_matches(facts, name):
    jrel, trel = facts
    keys, cap = GROUPINGS[name]
    jout = jops.hash_groupby(jrel, keys(jir), _aggs(jir, jops),
                             out_capacity=cap)
    tout = tops.hash_groupby(trel, keys(tir), _aggs(tir, tops),
                             out_capacity=cap)
    assert tout.capacity == jout.capacity
    _assert_same(tout, jout)


def test_hash_groupby_sorted_sums_exact(facts):
    # the float sums may reassociate; integer and decimal sums may not
    jrel, trel = facts
    keys = GROUPINGS["sort_int_nullable"][0]
    jout = jops.hash_groupby(jrel, keys(jir), _aggs(jir, jops, False))
    tout = tops.hash_groupby(trel, keys(tir), _aggs(tir, tops, False))
    ok, why = results_identical(tcol.to_numpy(tout), jcol.to_numpy(jout))
    assert ok, why


@pytest.mark.parametrize("live", ["some", "none"])
def test_scalar_agg_matches(facts, live):
    jrel, trel = facts
    if live == "none":
        jrel = jrel.with_mask(jnp.zeros(jrel.capacity, dtype=bool))
        trel = trel.with_mask(torch.zeros(trel.capacity, dtype=torch.bool))
    aggs = _aggs(jir, jops) + [jops.AggSpec("nd", "count_distinct",
                                            jir.col("k"))]
    taggs = _aggs(tir, tops) + [tops.AggSpec("nd", "count_distinct",
                                             tir.col("k"))]
    # COUNT(DISTINCT k) over a nullable k with dead lanes: SQLite's
    # count (ROADMAP Queue 3 #5), every other aggregate the reference's
    tout = tops.scalar_agg(trel, taggs)
    _assert_same_except(tout, jops.scalar_agg(jrel, aggs), ["nd"])
    assert tcol.to_numpy(tout)["nd"].tolist() == \
        [_distinct_oracle(trel, {}, tir.col("k"))[()]]


SORTS = {
    "one_key": (lambda ir: [ir.col("k")], None),
    "desc_nullable": (lambda ir: [ir.col("k"), ir.col("v")], [False, True]),
    "string_then_float": (lambda ir: [ir.col("g"), ir.col("x")],
                          [True, False]),
    "bool_date": (lambda ir: [ir.col("b"), ir.col("dt")], [False, True]),
}


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_rows_matches(facts, name):
    jrel, trel = facts
    keys, asc = SORTS[name]
    _assert_same(tops.sort_rows(trel, keys(tir), asc),
                 jops.sort_rows(jrel, keys(jir), asc))


@pytest.mark.parametrize("k,offset", [(5, 0), (10, 7), (1000, 3)])
def test_limit_matches(facts, k, offset):
    jrel, trel = facts
    _assert_same(tops.limit(trel, k, offset), jops.limit(jrel, k, offset))


@pytest.mark.parametrize("cap", [None, 50, 512])
def test_compact_matches(facts, cap):
    jrel, trel = facts
    _assert_same(tops.compact(trel, cap), jops.compact(jrel, cap))


def _join_sides(seed=9):
    rng = np.random.default_rng(seed)
    nl, nr = 150, 60
    left = {"lk": rng.integers(0, 40, nl), "lv": rng.integers(0, 100, nl),
            "ls": np.array(["x", "y", "z"], dtype=object)[
                rng.integers(0, 3, nl)]}
    right = {"rk": rng.integers(0, 40, nr), "rv": rng.integers(0, 1000, nr),
             "rs": np.array(["y", "z", "w"], dtype=object)[
                 rng.integers(0, 3, nr)]}
    lvalid = {"lk": rng.random(nl) < 0.9}
    rvalid = {"rk": rng.random(nr) < 0.9, "rv": rng.random(nr) < 0.8}
    jl, tl = _load(left, None, lvalid, seed)
    jr, tr = _load(right, None, rvalid, seed + 1)
    return jl, tl, jr, tr


@pytest.fixture(scope="module")
def sides():
    return _join_sides()


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
@pytest.mark.parametrize("keys", ["int", "string"])
def test_join_matches(sides, how, keys):
    jl, tl, jr, tr = sides
    k = ("lk", "rk") if keys == "int" else ("ls", "rs")
    cap = 2048  # above every total: padding lanes stay dead
    jout = jops.join(jl, jr, [jir.col(k[0])], [jir.col(k[1])], how=how,
                     out_capacity=cap)
    tout = tops.join(tl, tr, [tir.col(k[0])], [tir.col(k[1])], how=how,
                     out_capacity=cap)
    assert tout.capacity == jout.capacity
    _assert_same(tout, jout)


def test_cross_join_matches(sides):
    jl, tl, jr, tr = sides
    _assert_same(tops.join(tl, tr, [], [], out_capacity=20_000),
                 jops.join(jl, jr, [], [], out_capacity=20_000))


def test_join_multi_key_waits(sides):
    # the hashed multi-key path no longer waits: it matches the reference
    jl, tl, jr, tr = sides
    _assert_same(tops.join(tl, tr, [tir.col("lk"), tir.col("ls")],
                           [tir.col("rk"), tir.col("rs")]),
                 jops.join(jl, jr, [jir.col("lk"), jir.col("ls")],
                           [jir.col("rk"), jir.col("rs")]))


def _overflow_plans(m, lk, rk):
    ir, _dt, ops, plan = m
    scan_l = plan.TableScan("l")
    scan_r = plan.TableScan("r")
    return {
        "join": plan.HashJoin(scan_l, scan_r, [ir.col(lk)], [ir.col(rk)],
                              out_capacity=32),
        "left_join": plan.HashJoin(scan_l, scan_r, [ir.col(lk)],
                                   [ir.col(rk)], how="left",
                                   out_capacity=100),
        "groupby": plan.GroupBy(scan_l, {"lv": ir.col("lv")},
                                [ops.AggSpec("c", "count_star")],
                                out_capacity=10),
        "compact": plan.ScalarAgg(
            plan.Compact(scan_l, capacity=20, strict=True),
            [ops.AggSpec("c", "count_star")]),
        "fits": plan.HashJoin(scan_l, scan_r, [ir.col(lk)], [ir.col(rk)],
                              out_capacity=4096),
    }


@pytest.mark.parametrize("name", ["join", "left_join", "groupby", "compact",
                                  "fits"])
def test_capacity_overflow_matches(sides, name):
    jl, tl, jr, tr = sides
    jp = _overflow_plans(JAX, "lk", "rk")[name]
    tp = _overflow_plans(TORCH, "lk", "rk")[name]
    if name == "fits":
        _assert_same(tplan.execute_plan(tp, {"l": tl, "r": tr}),
                     jplan.execute_plan(jp, {"l": jl, "r": jr}))
        return
    with pytest.raises(JOverflow) as jerr:
        jplan.execute_plan(jp, {"l": jl, "r": jr})
    with pytest.raises(TOverflow) as terr:
        tplan.execute_plan(tp, {"l": tl, "r": tr})
    assert terr.value.drops == jerr.value.drops
    assert terr.value.drops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lexsort_matches_jnp(seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 4, 300), rng.integers(-3, 3, 300),
            (rng.random(300) < 0.5).astype(np.int8)]
    want = np.asarray(jnp.lexsort(tuple(jnp.asarray(k) for k in keys)))
    got = tops.lexsort([torch.from_numpy(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("counts,cap", [
    ([1, 0, 2, 0], 6), ([1, 0, 2, 0], 2), ([0, 0, 3], 5), ([2, 2], 4),
    ([5], 3), ([0, 0, 0], 4), ([1, 2, 3, 4], 20),
])
def test_repeat_index_matches_jnp(counts, cap):
    c = np.asarray(counts, dtype=np.int64)
    want = np.asarray(jnp.repeat(jnp.arange(len(c)), jnp.asarray(c),
                                 total_repeat_length=cap))
    got = tops._repeat_index(torch.from_numpy(c), cap).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["min", "max"])
def test_segment_minmax_empty_segments_match(fn):
    data = np.array([5, -3, 7, 2], dtype=np.int64)
    seg = np.array([0, 0, 2, 2])
    jfn = {"min": __import__("jax").ops.segment_min,
           "max": __import__("jax").ops.segment_max}[fn]
    want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(seg),
                          num_segments=4))
    got = tops._segment_minmax(fn, torch.from_numpy(data),
                               torch.from_numpy(seg), 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_ops_not_ported_yet_raise(facts):
    # every plan node lowers now (Union, IndexProbe and Window are held
    # against the reference in tests/test_torch_{dml,index_probe,
    # window}.py); a node the executor does not know still raises, and
    # an IndexProbe whose sidecar was never prepared fails loudly
    _jrel, trel = facts
    scan = tplan.TableScan("t")

    class Unknown(tplan.PlanNode):
        pass

    with pytest.raises(NotImplementedError, match="Unknown"):
        tplan.execute_plan(Unknown(), {"t": trel})
    with pytest.raises(KeyError, match="__probe__t__ix"):
        tplan.execute_plan(tplan.IndexProbe(scan, "t", "ix", tir.col("k")),
                           {"t": trel})
    out = tplan.execute_plan(tplan.Union([scan, scan]), {"t": trel})
    assert out.capacity == 2 * trel.capacity


# ---------------------------------------------------------------------------
# the hashed multi-key join (_mix64), top_n, COUNT(DISTINCT), residual
# semi/anti joins
# ---------------------------------------------------------------------------

_EDGE_INT64 = np.array([0, 1, -1, 2**63 - 1, -2**63, -2**63 + 1, 2**62,
                        -2**62, 0x5AD5AD5AD5AD5AD, 2**31, -2**31],
                       dtype=np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix64_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([_EDGE_INT64,
                        rng.integers(-2**63, 2**63 - 1, 4000,
                                     dtype=np.int64, endpoint=True)])
    want = np.asarray(jops._mix64(jnp.asarray(x).astype(jnp.uint64)))
    got = tops._mix64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)


def _typed_cols(rng, n):
    """(arrays, types, valids) with int, float (NaN, -0.0), date, decimal,
    bool and string keys."""
    f = rng.normal(size=n)
    f[::13] = np.nan
    f[::17] = -0.0
    f[::19] = 0.0
    arrays = {"i": np.concatenate([_EDGE_INT64,
                                   rng.integers(-5, 5, n - 11)]),
              "f": f, "dt": rng.integers(-3, 3, n).astype(np.int32),
              "dc": rng.integers(-3, 3, n), "b": rng.random(n) < 0.5,
              "s": np.array(["p", "q", "r"], dtype=object)[
                  rng.integers(0, 3, n)]}
    types = {"dt": jdt.SqlType.date(), "dc": jdt.SqlType.decimal(15, 2)}
    return arrays, types


def test_combined_key_bit_identical():
    rng = np.random.default_rng(3)
    arrays, types = _typed_cols(rng, 300)
    valids = {"i": rng.random(300) < 0.9}
    jrel, trel = _load(arrays, types, valids, 3)
    for names in (["i", "f"], ["f"], ["dt", "dc", "b", "s"], ["s", "i"]):
        jk, jex = jops._combined_key([jrel.columns[c] for c in names])
        tk, tex = tops._combined_key([trel.columns[c] for c in names])
        assert tex == jex
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def _multi_sides(seed=11):
    rng = np.random.default_rng(seed)
    nl, nr = 160, 70
    left = {"la": rng.integers(0, 6, nl), "lb": rng.integers(0, 4, nl),
            "lf": rng.integers(0, 3, nl) / 2.0,
            "ls": np.array(["x", "y", "z"], dtype=object)[
                rng.integers(0, 3, nl)],
            "lv": rng.integers(0, 100, nl)}
    right = {"ra": rng.integers(0, 6, nr), "rb": rng.integers(0, 4, nr),
             "rf": rng.integers(0, 3, nr) / 2.0,
             "rs": np.array(["y", "z", "w"], dtype=object)[
                 rng.integers(0, 3, nr)],
             "rv": rng.integers(0, 1000, nr)}
    lvalid = {"la": rng.random(nl) < 0.9, "lf": rng.random(nl) < 0.9}
    rvalid = {"rb": rng.random(nr) < 0.9, "rv": rng.random(nr) < 0.8}
    jl, tl = _load(left, None, lvalid, seed)
    jr, tr = _load(right, None, rvalid, seed + 1)
    return jl, tl, jr, tr


@pytest.fixture(scope="module")
def multi_sides():
    return _multi_sides()


MULTI_KEYS = {
    "int_int": (["la", "lb"], ["ra", "rb"]),
    "int_string": (["la", "ls"], ["ra", "rs"]),
    "float": (["lf"], ["rf"]),
}


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
@pytest.mark.parametrize("keys", sorted(MULTI_KEYS))
def test_join_multi_key_matches(multi_sides, how, keys):
    jl, tl, jr, tr = multi_sides
    lk, rk = MULTI_KEYS[keys]
    cap = 4096
    jout = jops.join(jl, jr, [jir.col(c) for c in lk],
                     [jir.col(c) for c in rk], how=how, out_capacity=cap)
    tout = tops.join(tl, tr, [tir.col(c) for c in lk],
                     [tir.col(c) for c in rk], how=how, out_capacity=cap)
    assert tout.capacity == jout.capacity
    _assert_same(tout, jout)


def _live_rows(rel, to_numpy):
    """The live rows as a sorted list of tuples, NULL for invalid lanes
    (whose payload is unspecified)."""
    res = to_numpy(rel)
    names = sorted(k for k in res if not k.startswith("__"))
    cols = []
    for k in names:
        data = np.asarray(res[k]).tolist()
        valid = res.get("__valid__" + k)
        valid = [True] * len(data) if valid is None else list(valid)
        cols.append([repr(x) if v else "NULL" for x, v in zip(data, valid)])
    return sorted(zip(*cols))


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
def test_join_forced_hash_collisions(multi_sides, monkeypatch, how):
    """Both packages' mixes cut to 2 bits: nearly every candidate pair is
    a collision the exact-key re-check must throw out.  The port matches
    the reference lane for lane, and both return the rows of the join
    with a collision-free hash."""
    jl, tl, jr, tr = multi_sides
    lk, rk = MULTI_KEYS["int_int"]
    args_j = (jl, jr, [jir.col(c) for c in lk], [jir.col(c) for c in rk])
    args_t = (tl, tr, [tir.col(c) for c in lk], [tir.col(c) for c in rk])
    clean = tops.join(*args_t, how=how, out_capacity=8192)
    jmix, tmix = jops._mix64, tops._mix64
    monkeypatch.setattr(jops, "_mix64",
                        lambda x: jmix(x) & jnp.asarray(3, jnp.uint64))
    monkeypatch.setattr(tops, "_mix64", lambda x: tmix(x) & 3)
    jout = jops.join(*args_j, how=how, out_capacity=8192)
    tout = tops.join(*args_t, how=how, out_capacity=8192)
    _assert_same(tout, jout)
    assert _live_rows(tout, tcol.to_numpy) == \
        _live_rows(clean, tcol.to_numpy)


def test_join_multi_key_overflow_drops_match(multi_sides):
    jl, tl, jr, tr = multi_sides
    lk, rk = MULTI_KEYS["int_string"]
    jp = jplan.HashJoin(jplan.TableScan("l"), jplan.TableScan("r"),
                        [jir.col(c) for c in lk], [jir.col(c) for c in rk],
                        how="left", out_capacity=64)
    tp = tplan.HashJoin(tplan.TableScan("l"), tplan.TableScan("r"),
                        [tir.col(c) for c in lk], [tir.col(c) for c in rk],
                        how="left", out_capacity=64)
    with pytest.raises(JOverflow) as jerr:
        jplan.execute_plan(jp, {"l": jl, "r": jr})
    with pytest.raises(TOverflow) as terr:
        tplan.execute_plan(tp, {"l": tl, "r": tr})
    assert terr.value.drops == jerr.value.drops
    assert terr.value.drops


TOPN = {
    "int_asc": ("k", True, 10), "int_desc": ("k", False, 10),
    "string_asc": ("g", True, 7), "string_desc": ("g", False, 7),
    "decimal_desc": ("v", False, 25), "float_asc": ("x", True, 5),
    "float_desc": ("x", False, 5), "date_asc": ("dt", True, 3),
    "bool_desc": ("b", False, 4), "k_above_n": ("k", True, 5000),
}


@pytest.mark.parametrize("name", sorted(TOPN))
def test_top_n_matches(facts, name):
    jrel, trel = facts
    key, asc, k = TOPN[name]
    jout = jops.top_n(jrel, jir.col(key), asc, k)
    tout = tops.top_n(trel, tir.col(key), asc, k)
    assert tout.capacity == jout.capacity
    _assert_same(tout, jout)


def test_top_n_lowers_from_limit_over_sort(facts):
    jrel, trel = facts
    jp = jplan.Limit(jplan.Sort(jplan.TableScan("t"), [jir.col("v")],
                                [False]), 9)
    tp = tplan.Limit(tplan.Sort(tplan.TableScan("t"), [tir.col("v")],
                                [False]), 9)
    _assert_same(tplan.execute_plan(tp, {"t": trel}),
                 jplan.execute_plan(jp, {"t": jrel}))


DISTINCT_GROUPS = {
    "int_key": lambda ir: {"k": ir.col("k")},
    "string_key": lambda ir: {"g": ir.col("g")},
    "two_keys": lambda ir: {"g": ir.col("g"), "h": ir.col("h")},
    "expr_key": lambda ir: {"kk": ir.col("k") % ir.lit(3)},
}


@pytest.mark.parametrize("name", sorted(DISTINCT_GROUPS))
def test_count_distinct_matches(facts, name):
    jrel, trel = facts

    def aggs(ir, ops):
        c = ir.col
        return [ops.AggSpec("nd_v", "count_distinct", c("v")),
                ops.AggSpec("nd_dt", "count_distinct", c("dt")),
                ops.AggSpec("nd_g", "count_distinct", c("g")),
                ops.AggSpec("nd_b", "count_distinct", c("b")),
                ops.AggSpec("cnt", "count_star"),
                ops.AggSpec("sum_v", "sum", c("v"))]

    keys = DISTINCT_GROUPS[name]
    jout = jops.hash_groupby(jrel, keys(jir), aggs(jir, jops))
    tout = tops.hash_groupby(trel, keys(tir), aggs(tir, tops))
    assert tout.capacity == jout.capacity
    # v and g hold NULLs with real payloads: their COUNT(DISTINCT) is
    # SQLite's (ROADMAP Queue 3 #5), everything else the reference's
    nulls = ["nd_v", "nd_g"]
    _assert_same_except(tout, jout, nulls)
    out = tcol.to_numpy(tout)
    gk = list(keys(tir))
    for nd, arg in (("nd_v", "v"), ("nd_g", "g")):
        want = _distinct_oracle(trel, keys(tir), tir.col(arg))
        got = {tuple(None if out.get("__valid__" + k) is not None
                     and not out["__valid__" + k][i] else out[k][i]
                     for k in gk): out[nd][i]
               for i in range(len(out[nd]))}
        assert got == want, nd
    # without groups the dead lanes hide values the same way (the
    # reference sorts them among the live ones): all four are SQLite's
    distinct = ["nd_v", "nd_dt", "nd_g", "nd_b"]
    _assert_same_except(tops.scalar_agg(trel, aggs(tir, tops)),
                        jops.scalar_agg(jrel, aggs(jir, jops)), distinct)
    scalar = tcol.to_numpy(tops.scalar_agg(trel, aggs(tir, tops)))
    for nd in distinct:
        assert scalar[nd].tolist() == \
            [_distinct_oracle(trel, {}, tir.col(nd[3:]))[()]], nd


def test_count_distinct_null_behind_a_value():
    """ROADMAP Queue 3 #5: a NULL lane whose payload equals a value and
    sorts first hides that value in the reference; the port counts
    SQLite's 2 distinct values."""
    arrays = {"g": np.array([1, 1, 1]), "x": np.array([5, 5, 7])}
    valids = {"x": np.array([False, True, True])}
    jrel, trel = _load(arrays, {}, valids, 0, pad=False)
    jn = jcol.to_numpy(jops.hash_groupby(
        jrel, {"g": jir.col("g")},
        [jops.AggSpec("n", "count_distinct", jir.col("x"))]))
    tn = tcol.to_numpy(tops.hash_groupby(
        trel, {"g": tir.col("g")},
        [tops.AggSpec("n", "count_distinct", tir.col("x"))]))
    conn = sqlite3.connect(":memory:")
    conn.execute("create table t (g int, x int)")
    conn.executemany("insert into t values (?, ?)",
                     [(1, None), (1, 5), (1, 7)])
    want = conn.execute(
        "select count(distinct x) from t group by g").fetchall()
    assert want == [(2,)]
    assert tn["n"].tolist() == [2] and jn["n"].tolist() == [1]
    js = jcol.to_numpy(jops.scalar_agg(
        jrel, [jops.AggSpec("n", "count_distinct", jir.col("x"))]))
    ts = tcol.to_numpy(tops.scalar_agg(
        trel, [tops.AggSpec("n", "count_distinct", tir.col("x"))]))
    assert ts["n"].tolist() == [2] and js["n"].tolist() == [1]


def _assert_same_except(trel, jrel, skip):
    """``_assert_same`` over every output column but ``skip``."""
    keep = [c for c in jrel.columns if c not in skip]
    _assert_same(tcol.Relation({c: trel.columns[c] for c in keep},
                               trel.mask),
                 jcol.Relation({c: jrel.columns[c] for c in keep},
                               jrel.mask))


def _distinct_oracle(trel, group_by: dict, arg) -> dict:
    """{group key tuple (None for NULL): number of distinct non-NULL
    ``arg`` values} over the live lanes: what SQLite counts."""
    live = trel.mask_or_true().numpy()
    a = eval_expr(arg, trel)
    av = a.valid_or_true().numpy()
    ad = a.data.numpy()
    keys = [eval_expr(e, trel) for e in group_by.values()]
    kd = [(k.data.numpy() if k.sdict is None
           else k.sdict.values[np.clip(k.data.numpy(), 0, k.sdict.size - 1)],
           k.valid_or_true().numpy()) for k in keys]
    out: dict = {}
    for i in np.nonzero(live)[0]:
        g = tuple((d[i].item() if hasattr(d[i], "item") else d[i])
                  if v[i] else None for d, v in kd)
        vals = out.setdefault(g, set())
        if av[i]:
            vals.add(ad[i].item())
    return {g: len(v) for g, v in out.items()} if group_by or out \
        else {(): 0}


def _residual(ir, kind):
    c = ir.col
    return {"lt": [c("lv") < c("rv")],
            "two": [c("lv") * ir.lit(10) > c("rv"), c("ls").ne(c("rs"))],
            "none": []}[kind]


@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("kind", ["lt", "two", "none"])
def test_semi_join_residual_matches(multi_sides, anti, kind):
    jl, tl, jr, tr = multi_sides
    jout = jops.semi_join_residual(
        jl, jr, [jir.col("la")], [jir.col("ra")], _residual(jir, kind),
        anti=anti, out_capacity=4096)
    tout = tops.semi_join_residual(
        tl, tr, [tir.col("la")], [tir.col("ra")], _residual(tir, kind),
        anti=anti, out_capacity=4096)
    _assert_same(tout, jout)


@pytest.mark.parametrize("anti", [False, True])
def test_semi_join_residual_plan_and_overflow(multi_sides, anti):
    jl, tl, jr, tr = multi_sides

    def plan(m, cap):
        ir, _dt, _ops, pl = m
        return pl.SemiJoinResidual(
            pl.TableScan("l"), pl.TableScan("r"),
            [ir.col("la"), ir.col("lb")], [ir.col("ra"), ir.col("rb")],
            _residual(ir, "lt"), anti=anti, out_capacity=cap)

    jt, tt = {"l": jl, "r": jr}, {"l": tl, "r": tr}
    _assert_same(tplan.execute_plan(plan(TORCH, 4096), tt),
                 jplan.execute_plan(plan(JAX, 4096), jt))
    with pytest.raises(JOverflow) as jerr:
        jplan.execute_plan(plan(JAX, 16), jt)
    with pytest.raises(TOverflow) as terr:
        tplan.execute_plan(plan(TORCH, 16), tt)
    assert terr.value.drops == jerr.value.drops
    assert terr.value.drops
