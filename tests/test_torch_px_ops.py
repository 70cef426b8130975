"""The port's distributed operators and PX planner levers against the JAX
package's on the same inputs (the cases of ``tests/test_px.py`` and
``tests/test_px_levers.py``): the distributed group-by and HASH-HASH
join, the hybrid hot-key join with tied key counts, the runtime bloom
filter, partition-wise affinity and its guards, the distributed sort
(NaN, NULLs, DESC with LIMIT) and the skew overflow retry.

Shard programs are compared lane by lane where the reference runs them
inside ``shard_map`` (8 host devices, ``tests/conftest.py``); whole plans
through ``execute_plan_distributed`` are compared row by row in result
order.  Ints, decimals, masks and validity exactly, float64 within 1e-9
relative."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import oceanbase_tpu.datatypes as jdt
import oceanbase_tpu.exec.ops as jops
import oceanbase_tpu.exec.plan as jplan
import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu.px.bloom as jbloom
import oceanbase_tpu.px.dist_ops as jdist
import oceanbase_tpu.px.exchange as jx
import oceanbase_tpu.px.planner as jpx
import oceanbase_tpu_torch.datatypes as tdt
import oceanbase_tpu_torch.exec.ops as tops
import oceanbase_tpu_torch.exec.plan as tplan
import oceanbase_tpu_torch.expr.ir as tir
import oceanbase_tpu_torch.px.bloom as tbloom
import oceanbase_tpu_torch.px.dist_ops as tdist
import oceanbase_tpu_torch.px.exchange as tx
import oceanbase_tpu_torch.px.planner as tpx
from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.server.database import Database as TDatabase
from oceanbase_tpu_torch.vector import column as tcol

torch.set_num_threads(2)

JAX = (jir, jdt, jops, jplan, jpx)
TORCH = (tir, tdt, tops, tplan, tpx)


@pytest.fixture(autouse=True)
def _mesh8():
    tx.set_mesh_size(8)
    yield
    tx.set_mesh_size(None)


def jax_parts(rel):
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _pair(arrays, types=None, valids=None):
    """(JAX relation, port relation on the CPU) on the same lanes."""
    jrel = jcol.from_numpy(arrays, types=types, valids=valids)
    parts, mask = jax_parts(jrel)
    return jrel, bridge.relation_from_parts(parts, mask, device="cpu")


def _tables(arrays_by_name, types=None, valids=None):
    j, t = {}, {}
    for name, arrays in arrays_by_name.items():
        tv = {k: v for k, v in (types or {}).items() if k in arrays}
        vv = {k: v for k, v in (valids or {}).items() if k in arrays}
        j[name], t[name] = _pair(arrays, tv or None, vv or None)
    return j, t


def assert_lanes_equal(jrel, trel):
    assert sorted(jrel.columns) == sorted(trel.columns)
    for name, jc in jrel.columns.items():
        tc = trel.columns[name]
        jd, td = np.asarray(jc.data), tc.data.numpy()
        assert jd.shape == td.shape, name
        assert np.array_equal(jd, td, equal_nan=jd.dtype.kind == "f"), name
        assert (jc.valid is None) == (tc.valid is None), name
        if jc.valid is not None:
            assert np.array_equal(np.asarray(jc.valid), tc.valid.numpy()), \
                name
    assert np.array_equal(np.asarray(jrel.mask_or_true()),
                          trel.mask_or_true().numpy())


def assert_rows_equal(jres: dict, tres: dict, float_rtol=1e-9):
    """Two to_numpy results, row by row in order."""
    assert sorted(jres) == sorted(tres)
    for k in jres:
        a, b = np.asarray(jres[k]), np.asarray(tres[k])
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=float_rtol, equal_nan=True,
                                       err_msg=k)
        else:
            assert a.tolist() == b.tolist(), k


def _row_set(res: dict) -> list:
    """A to_numpy result as sorted rows, NULL payloads as None."""
    cols = sorted(c for c in res if not c.startswith("__valid__"))
    lanes = []
    for c in cols:
        vals = res[c].tolist()
        valid = res.get("__valid__" + c)
        if valid is not None:
            vals = [v if ok else None for v, ok in zip(vals, valid)]
        lanes.append(vals)
    return sorted(zip(*lanes), key=repr)


def _both(fn):
    """Run ``fn(ir, dt, ops, plan, px)`` for each package -> (jax, port)."""
    return fn(*JAX), fn(*TORCH)


def _jrun(fn, args, out_specs, ndev=8):
    mesh = jx.default_mesh(ndev)
    run = jax.jit(jx.shard_map_compat(
        fn, mesh=mesh, in_specs=tuple(P("px") for _ in args),
        out_specs=out_specs))
    return run(*args)


# ---------------------------------------------------------------------------
# tests/test_px.py
# ---------------------------------------------------------------------------


def test_dist_groupby_matches_reference():
    rng = np.random.default_rng(42)
    n = 4096
    g = rng.integers(0, 37, n)
    v = rng.integers(-100, 100, n)
    jrel, trel = _pair({"g": g, "v": v})

    def run(ir, _dt, ops, _plan, _px):
        return [ops.AggSpec("s", "sum", ir.col("v")),
                ops.AggSpec("c", "count_star"),
                ops.AggSpec("mx", "max", ir.col("v")),
                ops.AggSpec("av", "avg", ir.col("v"))]

    jaggs, taggs = _both(run)
    jout = jdist.dist_groupby(jrel, {"g": jir.col("g")}, jaggs,
                              jx.default_mesh(8), local_cap=64, out_cap=64)
    tout = tdist.dist_groupby(trel, {"g": tir.col("g")}, taggs,
                              tx.default_mesh(8, "cpu"), local_cap=64,
                              out_cap=64)
    assert_lanes_equal(jout, tout)
    res = tcol.to_numpy(tout)
    order = np.argsort(res["g"])
    keys = np.unique(g)
    assert res["g"][order].tolist() == keys.tolist()
    assert res["s"][order].tolist() == [v[g == k].sum() for k in keys]
    # an undersized exchange budget raises
    with pytest.raises(CapacityOverflow, match="rows dropped"):
        tdist.dist_groupby(trel, {"g": tir.col("g")}, taggs,
                           tx.default_mesh(8, "cpu"), local_cap=4,
                           out_cap=4)


@pytest.mark.parametrize("cap", [512, 8])
def test_dist_join_shard_matches_reference(cap):
    rng = np.random.default_rng(42)
    nl, nr = 2048, 256
    fk = rng.integers(0, nr, nl)
    jl, tl = _pair({"fk": fk, "lv": np.arange(nl)})
    jr, tr = _pair({"pk": np.arange(nr), "rv": rng.integers(0, 1000, nr)})
    mesh = jx.default_mesh(8)
    tmesh = tx.default_mesh(8, "cpu")

    def fn(left, right):
        out, ovf = jdist.dist_join_shard(
            left, right, [jir.col("fk")], [jir.col("pk")], ndev=8,
            cap_per_dest=cap, out_capacity=nl, how="inner")
        return out, jax.lax.psum(ovf, "px")

    jout, jovf = _jrun(fn, (jx.shard_relation(jl, mesh),
                            jx.shard_relation(jr, mesh)), (P("px"), P()))
    tout, tovf = tdist.dist_join_shard(
        tx.shard_relation(tl, tmesh), tx.shard_relation(tr, tmesh),
        [tir.col("fk")], [tir.col("pk")], tmesh, cap_per_dest=cap,
        out_capacity=nl, how="inner")
    assert int(tx.datahub_psum(tovf)) == int(jovf)
    assert_lanes_equal(jx.unshard_relation(jout), tx.unshard_relation(tout))
    if cap == 512:
        assert int(jovf) == 0
        res = tcol.to_numpy(tx.unshard_relation(tout))
        assert len(res["fk"]) == nl
        assert res["fk"].tolist() == res["pk"].tolist()


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_hybrid_hot_key_join_with_tied_counts(how):
    """Six probe keys share the top count and three build keys tie too:
    which of them are hot (top 8 of each side) follows ``lax.top_k``'s
    lower-index-first order, lane for lane."""
    rng = np.random.default_rng(7)
    hot = np.repeat(np.array([11, 3, 29, 5, 17, 23]), 150)
    cold = rng.integers(100, 400, 1200)
    lk = np.concatenate([hot, cold])
    rng.shuffle(lk)
    rk = np.concatenate([np.repeat([3, 29, 101], 40),
                         np.arange(0, 400, 3)])
    rng.shuffle(rk)
    jl, tl = _pair({"lk": lk, "lv": np.arange(len(lk))})
    jr, tr = _pair({"rk": rk, "rv": np.arange(len(rk)) * 7})
    mesh = jx.default_mesh(8)
    tmesh = tx.default_mesh(8, "cpu")

    def fn(left, right):
        out, ovf = jdist.dist_join_shard_hybrid(
            left, right, [jir.col("lk")], [jir.col("rk")], ndev=8,
            cap_per_dest=1024, out_capacity=1 << 13, how=how, n_hot=4)
        return out, jax.lax.psum(ovf, "px")

    jsl, jsr = jx.shard_relation(jl, mesh), jx.shard_relation(jr, mesh)
    jout, jovf = _jrun(fn, (jsl, jsr), (P("px"), P()))
    tsl, tsr = tx.shard_relation(tl, tmesh), tx.shard_relation(tr, tmesh)
    tout, tovf = tdist.dist_join_shard_hybrid(
        tsl, tsr, [tir.col("lk")], [tir.col("rk")], tmesh,
        cap_per_dest=1024, out_capacity=1 << 13, how=how, n_hot=4)
    assert int(tx.datahub_psum(tovf)) == int(jovf) == 0
    assert_lanes_equal(jx.unshard_relation(jout), tx.unshard_relation(tout))

    # the hot sets themselves
    def jhot(rel):
        v, _k, _m = jdist._global_hot_keys(rel, [jir.col("lk")], 4, "px")
        return v[None]

    jv = np.asarray(_jrun(jhot, (jsl,), P("px")))
    tv, _ks, _ms = tdist._global_hot_keys(tsl, [tir.col("lk")], 4, tmesh)
    assert [t.tolist() for t in tv] == jv.tolist()
    # four of the six tied keys: which four is the tie order above
    assert len(set(tv[0].tolist()) & {11, 3, 29, 5, 17, 23}) == 4


# ---------------------------------------------------------------------------
# tests/test_px_levers.py
# ---------------------------------------------------------------------------


def _fact_dim(n_fact=20_000, n_dim=2_000, seed=3):
    rng = np.random.default_rng(seed)
    fact = {"f_key": rng.integers(0, n_dim * 4, n_fact).astype(np.int64),
            "f_val": rng.integers(0, 100, n_fact).astype(np.int64)}
    dim = {"d_key": np.arange(n_dim, dtype=np.int64),
           "d_tag": rng.integers(0, 10, n_dim).astype(np.int64)}
    return fact, dim


def _join_plan(ir, plan, how="inner", project=False):
    scan_f = plan.TableScan("fact", rename={"f_key": "fk", "f_val": "fv"})
    scan_d = plan.TableScan("dim", rename={"d_key": "dk", "d_tag": "dt"})
    if project:
        # a Project breaks the scan-chain shape -> no affinity elision
        scan_d = plan.Project(scan_d, {"dk": ir.col("dk"),
                                       "dt": ir.col("dt")})
    return plan.HashJoin(scan_f, scan_d, [ir.col("fk")], [ir.col("dk")],
                         how=how, out_capacity=1 << 16)


def _run_both(plans, jtables, ttables, dop=8):
    jplan_, tplan_ = plans
    jres = jcol.to_numpy(jpx.execute_plan_distributed(jplan_, jtables,
                                                      dop=dop))
    tres = tcol.to_numpy(tpx.execute_plan_distributed(tplan_, ttables,
                                                      dop=dop, device="cpu"))
    return jres, tres


def test_affinity_chosen_and_join_correct():
    fact, dim = _fact_dim()
    jt, tt = _tables({"fact": fact, "dim": dim})
    plans = _both(lambda ir, _dt, _ops, plan, _px: _join_plan(ir, plan))
    jaff, _ = jpx.choose_affinity(plans[0], jt)
    taff, telide = tpx.choose_affinity(plans[1], tt)
    assert taff == jaff == {"fact": ["f_key"], "dim": ["d_key"]}
    assert len(telide) == 1
    jres, tres = _run_both(plans, jt, tt)
    assert_rows_equal(jres, tres)
    want = tcol.to_numpy(tplan.execute_plan(plans[1], tt))
    assert _row_set(tres) == _row_set(want)


def test_affinity_skipped_for_string_keys_self_join_and_decimal_scales():
    fact, dim = _fact_dim(2_000, 500)
    sfact = dict(fact, f_name=np.array(
        [f"s{i % 7}" for i in range(2_000)], dtype=object))
    sdim = dict(dim, d_name=np.array(
        [f"s{i % 7}" for i in range(500)], dtype=object))
    jt, tt = _tables({"fact": sfact, "dim": sdim})

    def strings(ir, _dt, _ops, plan, _px):
        scan_f = plan.TableScan("fact", rename={"f_name": "fn",
                                                "f_val": "fv"})
        scan_d = plan.TableScan("dim", rename={"d_name": "dn",
                                               "d_tag": "dt"})
        return plan.HashJoin(scan_f, scan_d, [ir.col("fn")], [ir.col("dn")],
                             how="inner", out_capacity=1 << 16)

    def self_join(ir, _dt, _ops, plan, _px):
        scan_a = plan.TableScan("dim", rename={"d_key": "ak", "d_tag": "at"})
        scan_b = plan.TableScan("dim", rename={"d_key": "bk", "d_tag": "bt"})
        return plan.HashJoin(scan_a, scan_b, [ir.col("ak")], [ir.col("bk")],
                             how="inner", out_capacity=1 << 14)

    for build in (strings, self_join):
        jp, tp = _both(build)
        assert tpx.choose_affinity(tp, tt) == (
            {}, frozenset()) and jpx.choose_affinity(jp, jt)[0] == {}
        jres, tres = _run_both((jp, tp), jt, tt)
        assert_rows_equal(jres, tres)
    # mixed DECIMAL scales: raw-value hashing cannot reconcile them
    f2 = {"f_key": np.array([500, 1500]), "f_val": np.array([1, 2])}
    d2 = {"d_key": np.array([50, 150]), "d_tag": np.array([7, 8])}
    jf, tf = _pair(f2, types={"f_key": jdt.SqlType.decimal(10, 2)})
    jd, td = _pair(d2, types={"d_key": jdt.SqlType.decimal(10, 1)})
    jp, tp = _both(lambda ir, _dt, _ops, plan, _px: _join_plan(ir, plan))
    assert tpx.choose_affinity(tp, {"fact": tf, "dim": td}) == \
        ({}, frozenset())
    assert jpx.choose_affinity(jp, {"fact": jf, "dim": jd})[0] == {}


def test_hash_partitionable_guard():
    cases = [
        ({"a": np.array(["x", "y"], dtype=object)},
         {"b": np.array(["x", "z"], dtype=object)}, None, False),
        ({"a": np.array([1, 2])}, {"b": np.array([1, 3])}, None, True),
        ({"a": np.array([10])}, {"b": np.array([100])},
         (jdt.SqlType.decimal(10, 1), jdt.SqlType.decimal(10, 2)), False),
    ]
    for la, ra, dts, want in cases:
        jl, tl = _pair(la, types={"a": dts[0]} if dts else None)
        jr, tr = _pair(ra, types={"b": dts[1]} if dts else None)
        assert jpx._keys_hash_partitionable(
            jl, jr, [jir.col("a")], [jir.col("b")]) is want
        assert tpx._keys_hash_partitionable(
            tl, tr, [tir.col("a")], [tir.col("b")]) is want


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_bloom_hash_join_parity(how, monkeypatch):
    """The HASH-HASH + bloom path (build side above the broadcast
    threshold) against the JAX package's and the serial join."""
    fact, dim = _fact_dim(6_000, 3_000, seed=11)
    jt, tt = _tables({"fact": fact, "dim": dim})
    plans = _both(lambda ir, _dt, _ops, plan, _px: _join_plan(
        ir, plan, how=how, project=True))
    monkeypatch.setattr(jpx, "BROADCAST_THRESHOLD_BYTES", 1)
    monkeypatch.setattr(tpx, "BROADCAST_THRESHOLD_BYTES", 1)
    jres, tres = _run_both(plans, jt, tt)
    assert_rows_equal(jres, tres)
    want = tcol.to_numpy(tplan.execute_plan(plans[1], tt))
    assert _row_set(tres) == _row_set(want)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_bloom_filter_bitmap_and_probe_mask(how):
    rng = np.random.default_rng(5)
    nb, npr = 800, 3000
    bk = rng.integers(0, 5000, nb)
    bvalid = rng.random(nb) < 0.9
    pk = rng.integers(0, 5000, npr)
    pvalid = rng.random(npr) < 0.9
    jb, tb = _pair({"bk": bk}, valids={"bk": bvalid})
    jp, tp = _pair({"pk": pk}, valids={"pk": pvalid})
    mesh, tmesh = jx.default_mesh(8), tx.default_mesh(8, "cpu")

    def fn(build, probe):
        bm = jbloom.build_bloom(build, [jir.col("bk")])
        out = jbloom.apply_bloom(probe, [jir.col("pk")], bm)
        return bm[None], out

    jbm, jout = _jrun(fn, (jx.shard_relation(jb, mesh),
                           jx.shard_relation(jp, mesh)),
                      (P("px"), P("px")))
    tsb = tx.shard_relation(tb, tmesh)
    tsp = tx.shard_relation(tp, tmesh)
    tbm = tbloom.build_bloom(tsb, [tir.col("bk")], tmesh)
    tout = [tbloom.apply_bloom(r, [tir.col("pk")], b)
            for r, b in zip(tsp, tbm)]
    assert np.array_equal(np.asarray(jbm), np.stack([b.numpy()
                                                     for b in tbm]))
    assert_lanes_equal(jx.unshard_relation(jout), tx.unshard_relation(tout))
    # no false negative: every live probe row whose key is in the build
    # side survives; NULL probe keys survive (the outer join needs them)
    m = tx.unshard_relation(tout).mask.numpy()[:npr]
    live_keys = set(bk[bvalid].tolist())
    for i in range(npr):
        if not pvalid[i] or pk[i] in live_keys:
            assert m[i], i
    assert m.sum() < npr  # and it filters


def test_distributed_sort_global_order():
    rng = np.random.default_rng(5)
    n = 50_000
    arrays = {"a": rng.integers(-1000, 1000, n), "b": rng.integers(0, 5, n)}
    jt, tt = _tables({"t": arrays})
    plans = _both(lambda ir, _dt, _ops, plan, _px: plan.Sort(
        plan.TableScan("t", rename={"a": "a", "b": "b"}),
        [ir.col("a"), ir.col("b")], [True, False]))
    jres, tres = _run_both(plans, jt, tt)
    assert_rows_equal(jres, tres)
    rows = list(zip(tres["a"].tolist(), tres["b"].tolist()))
    assert rows == sorted(rows, key=lambda r: (r[0], -r[1]))
    assert len(rows) == n


def test_distributed_sort_desc_with_nulls_and_limit():
    n = 9_000
    vals = np.arange(n, dtype=np.int64) % 97
    valid = (np.arange(n) % 11) != 0
    jt, tt = _tables({"t": {"v": vals}}, valids={"v": valid})
    plans = _both(lambda ir, _dt, _ops, plan, _px: plan.Limit(plan.Sort(
        plan.TableScan("t", rename={"v": "v"}), [ir.col("v")], [False]),
        50))
    jres, tres = _run_both(plans, jt, tt)
    assert_rows_equal(jres, tres)
    want = tcol.to_numpy(tops.limit(tops.sort_rows(
        tt["t"].select(["v"]), [tir.col("v")], [False]), 50))
    assert tres["v"].tolist() == want["v"].tolist()


@pytest.mark.parametrize("asc", [True, False])
def test_distributed_sort_float_nan_and_nulls(asc):
    rng = np.random.default_rng(9)
    n = 8_192
    vals = rng.normal(size=n)
    vals[::97] = np.nan
    valid = rng.random(n) < 0.95
    jt, tt = _tables({"t": {"x": vals, "i": np.arange(n)}},
                     valids={"x": valid})
    plans = _both(lambda ir, _dt, _ops, plan, _px: plan.Sort(
        plan.TableScan("t", rename={"x": "x", "i": "i"}),
        [ir.col("x"), ir.col("i")], [asc, True]))
    jres, tres = _run_both(plans, jt, tt)
    assert_rows_equal(jres, tres, float_rtol=0)
    want = tcol.to_numpy(tops.sort_rows(tt["t"], [tir.col("x"),
                                                  tir.col("i")],
                                        [asc, True]))
    assert tres["i"].tolist() == want["i"].tolist()


def test_distributed_sort_skew_overflow_retries(tmp_path, monkeypatch):
    """All-equal sort keys through ``SET px_dop = 8`` (tests/test_px_levers
    .py's case): both packages run it through PX with the same re-plans
    and answer.  The binder puts a Project under the Sort, so the sort
    runs on the gathered rows and the range exchange is not reached from
    SQL in either package (``test_range_sort_skew_overflow_ladder`` holds
    that exchange's overflow and retry)."""
    calls = []
    jrun = jpx.execute_plan_distributed

    def counted(*a, **k):
        calls.append(k.get("budget_factor"))
        return jrun(*a, **k)

    monkeypatch.setattr(jpx, "execute_plan_distributed", counted)
    n = 4_000
    got = []
    for db in (JDatabase(str(tmp_path / "j")),
               TDatabase(str(tmp_path / "t"), device="cpu")):
        s = db.session()
        s.execute("set px_dop = 8")
        s.execute("create table t (k int primary key, v int)")
        db.engine.bulk_load("t", {"k": np.arange(n, dtype=np.int64),
                                  "v": np.zeros(n, dtype=np.int64)},
                            version=db.tenant().tx.gts.current())
        db.tenant().catalog.invalidate("t")
        rows = s.execute("select k from t order by v, k limit 5").rows()
        got.append((rows, s._last_px))
        if isinstance(db, TDatabase):
            tretries = s.last_retries
        db.close()
    (jrows, jlast), (trows, tlast) = got
    assert [r[0] for r in trows] == [r[0] for r in jrows] == [0, 1, 2, 3, 4]
    assert tlast and jlast
    assert tretries == len(calls) - 1


def test_range_sort_skew_overflow_ladder():
    """All-equal first keys send every row to ONE shard: at 16,000 rows
    each sender's 2,048 rows overflow the range exchange's 1,024-row
    budget in both packages; a 4x budget factor (the session ladder's
    step) clears it, and the answer is the global order."""
    n = 16_000
    rng = np.random.default_rng(1)
    arrays = {"v": np.zeros(n, dtype=np.int64),
              "k": rng.permutation(n).astype(np.int64)}
    jt, tt = _tables({"t": arrays})
    jp, tp = _both(lambda ir, _dt, _ops, plan, _px: plan.Sort(
        plan.TableScan("t", rename={"v": "v", "k": "k"}),
        [ir.col("v"), ir.col("k")], [True, True]))
    for run, p, t in ((jpx.execute_plan_distributed, jp, jt),
                      (lambda *a, **k: tpx.execute_plan_distributed(
                          *a, device="cpu", **k), tp, tt)):
        with pytest.raises(Exception, match="PX exchange overflow"):
            run(p, t, dop=8, budget_factor=1)
    jres = jcol.to_numpy(jpx.execute_plan_distributed(jp, jt, dop=8,
                                                      budget_factor=4))
    tres = tcol.to_numpy(tpx.execute_plan_distributed(
        tp, tt, dop=8, budget_factor=4, device="cpu"))
    assert_rows_equal(jres, tres)
    assert tres["k"].tolist() == list(range(n))


def test_no_mesh_runs_on_cuda(monkeypatch):
    """Without a mesh or a device the entry point targets ``cuda`` and
    raises on a box with no card; the session's refusals alone fall
    back to serial."""
    fact, dim = _fact_dim(200, 50)
    _jt, tt = _tables({"fact": fact, "dim": dim})
    tp = _join_plan(tir, tplan)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpx.execute_plan_distributed(tp, tt)
    with pytest.raises(tpx.NotDistributable):
        tpx.execute_plan_distributed(
            tplan.IndexProbe(tplan.TableScan("fact"), "dim", "ix",
                             tir.col("f_key")), tt, device="cpu")


def _refused_plans(ir, _dt, ops, plan, _px):
    """Plans the lowering refuses by their shape alone, by case name."""
    fact = plan.TableScan("fact", rename={"f_key": "fk", "f_val": "fv"})
    dim = plan.TableScan("dim", rename={"d_key": "dk", "d_tag": "dt"})
    total = plan.ScalarAgg(fact, [ops.AggSpec("s", "sum", ir.col("fv"))])
    rank = ir.WindowCall("rank", order_by=[(ir.col("fk"), True)])
    return {
        "window_no_partition": plan.Window(fact, [("r", rank)]),
        "replicated_root": plan.Filter(
            total, ir.Cmp(">", ir.col("s"), ir.lit(0))),
        "groupby_over_replicated": plan.GroupBy(
            total, {"s": ir.col("s")}, [ops.AggSpec("c", "count_star")]),
        "left_join_replicated_probe": plan.HashJoin(
            total, dim, [ir.col("s")], [ir.col("dk")], how="left"),
        "union_over_replicated": plan.Union([
            plan.Project(total, {"x": ir.col("s")}),
            plan.Project(fact, {"x": ir.col("fv")})]),
        "count_distinct_root": plan.ScalarAgg(
            fact, [ops.AggSpec("n", "count_distinct", ir.col("fv"))]),
    }


@pytest.mark.parametrize("case", ["window_no_partition", "replicated_root",
                                  "groupby_over_replicated",
                                  "left_join_replicated_probe",
                                  "union_over_replicated",
                                  "count_distinct_root"])
def test_shape_refusals_before_any_sharding(monkeypatch, case):
    """A plan the lowering refuses by its shape is refused by both
    packages with the same exception and message; the port refuses it
    before it shards a table or runs an exchange."""
    fact, dim = _fact_dim(400, 50)
    jt, tt = _tables({"fact": fact, "dim": dim})
    jplans, tplans = _both(_refused_plans)
    with pytest.raises((jpx.NotDistributable, NotImplementedError)) as jexc:
        jpx.execute_plan_distributed(jplans[case], jt, dop=8)

    def no_sharding(*_a, **_k):
        raise AssertionError("a refused plan was sharded")

    for name in ("shard_relation", "shard_relation_by_hash",
                 "all_to_all_repartition", "broadcast_gather"):
        monkeypatch.setattr(tpx, name, no_sharding)
    with pytest.raises((tpx.NotDistributable, NotImplementedError)) as texc:
        tpx.execute_plan_distributed(tplans[case], tt, dop=8, device="cpu")
    assert type(texc.value).__name__ == type(jexc.value).__name__
    assert str(texc.value) == str(jexc.value)
