"""The port's index probe against the JAX package's: the sorted sidecar
``prepare_index_probes`` builds (bit-identical, over a relation with
poisoned dead lanes and NULL keys), the ``index_probe`` operator and its
overflow lane, and the index-probe SQL shapes of ``tests/test_cbo.py``
through both packages' ``Session``: the probe is chosen and correct,
DROP INDEX returns to a hash plan with the same answer, DML between
executions is seen, and a scalar subquery folded at bind time reads its
sidecar.  Both optimizers price with the uncalibrated cost units."""

import numpy as np
import pytest
import torch

import oceanbase_tpu.exec.plan as jplan
import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu.server.calibrate as jcalibrate
import oceanbase_tpu_torch.exec.plan as tplan
import oceanbase_tpu_torch.expr.ir as tir
from oceanbase_tpu.bench.oracle import load_sqlite, rows_match, run_oracle
from oceanbase_tpu.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
from oceanbase_tpu.bench.tpch_queries import QUERIES
from oceanbase_tpu.exec.diag import CapacityOverflow as JOverflow
from oceanbase_tpu.sql import Session as JSession
from oceanbase_tpu.sql.parser import parse_sql as jparse
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch.bench.surface_queries import IP1
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen_tpch
from oceanbase_tpu_torch.exec.diag import CapacityOverflow as TOverflow
from oceanbase_tpu_torch.sql import Session as TSession
from oceanbase_tpu_torch.sql.parser import parse_sql as tparse
from oceanbase_tpu_torch.vector import column as tcol
from test_torch_ops import _load

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _uncalibrated(monkeypatch):
    # process-wide cost units another test in this worker may have
    # calibrated would give the JAX optimizer other plans
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)


def _walk(plan):
    stack = [plan]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(n.children())


def _probes(plan, mod):
    return sum(isinstance(n, mod.IndexProbe) for n in _walk(plan))


@pytest.fixture(scope="module")
def probe_env():
    """Base table b (k with duplicates and NULLs, indexed) and probe
    relation p (keys with NULLs and misses) in both packages."""
    rng = np.random.default_rng(21)
    nb, np_ = 700, 90
    b = {"id": np.arange(nb), "k": rng.integers(0, 120, nb),
         "v": rng.integers(-500, 500, nb)}
    bvalid = {"k": rng.random(nb) < 0.9}
    p = {"pk": rng.integers(-5, 130, np_), "tag": rng.integers(0, 9, np_)}
    pvalid = {"pk": rng.random(np_) < 0.85}
    # padded, dead lanes poisoned, a tenth of the live lanes masked out
    jb, tb = _load(b, None, bvalid, 1)
    jp, tp = _load(p, None, pvalid, 2)
    js, ts = JSession(), TSession(device="cpu")
    for s in (js, ts):
        s.catalog.load_numpy("b", b, valids=bvalid)
        s.catalog.load_numpy("p", p, valids=pvalid)
        s.execute("create index ix_b_k on b (k)")
    return js, ts, {"b": jb, "p": jp}, {"b": tb, "p": tp}


def _probe_plan(mod, ir, cap):
    return mod.IndexProbe(mod.TableScan("p"), table="b", index="ix_b_k",
                          key=ir.col("pk"), out_capacity=cap)


def test_sidecar_bit_identical(probe_env):
    js, ts, jt, tt = probe_env
    jtables, ttables = dict(jt), dict(tt)
    jplan.prepare_index_probes(js.catalog, _probe_plan(jplan, jir, None),
                               jtables)
    tplan.prepare_index_probes(ts.catalog, _probe_plan(tplan, tir, None),
                               ttables)
    name = tplan.IndexProbe.sidecar_name("b", "ix_b_k")
    js_, ts_ = jtables[name], ttables[name]
    assert ts_.capacity == js_.capacity and ts_.mask is None
    for col in ("__key__", "__pos__"):
        got = ts_.columns[col].data.numpy()
        want = np.asarray(js_.columns[col].data)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert ts_.columns["__key__"].data.device == tt["b"].device


def test_sidecar_cached_per_relation(probe_env):
    _js, ts, _jt, tt = probe_env
    plan = _probe_plan(tplan, tir, None)
    name = tplan.IndexProbe.sidecar_name("b", "ix_b_k")
    t1, t2 = dict(tt), dict(tt)
    tplan.prepare_index_probes(ts.catalog, plan, t1)
    tplan.prepare_index_probes(ts.catalog, plan, t2)
    assert t1[name] is t2[name]
    t3 = dict(tt, b=tt["b"].with_mask(tt["b"].mask_or_true()))
    tplan.prepare_index_probes(ts.catalog, plan, t3)
    assert t3[name] is not t1[name]   # a new relation rebuilds


@pytest.mark.parametrize("cap", [None, 4096, 512])
def test_index_probe_matches(probe_env, cap):
    """The probe's output relation equals the reference's lane for lane
    (poisoned dead lanes, NULL and missing keys, a capacity above and at
    the match count)."""
    js, ts, jt, tt = probe_env
    jtables, ttables = dict(jt), dict(tt)
    jp, tp = _probe_plan(jplan, jir, cap), _probe_plan(tplan, tir, cap)
    jplan.prepare_index_probes(js.catalog, jp, jtables)
    tplan.prepare_index_probes(ts.catalog, tp, ttables)
    jout = jplan.execute_plan(jp, jtables)
    tout = tplan.execute_plan(tp, ttables)
    np.testing.assert_array_equal(tout.mask_or_true().numpy(),
                                  np.asarray(jout.mask_or_true()))
    t, j = tcol.to_numpy(tout), jcol.to_numpy(jout)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                      err_msg=k)


def test_index_probe_overflow_matches(probe_env):
    js, ts, jt, tt = probe_env
    jtables, ttables = dict(jt), dict(tt)
    jp, tp = _probe_plan(jplan, jir, 64), _probe_plan(tplan, tir, 64)
    jplan.prepare_index_probes(js.catalog, jp, jtables)
    tplan.prepare_index_probes(ts.catalog, tp, ttables)
    with pytest.raises(JOverflow) as je:
        jplan.execute_plan(jp, jtables)
    with pytest.raises(TOverflow) as te:
        tplan.execute_plan(tp, ttables)
    assert te.value.drops == [tuple(d) for d in je.value.drops]
    assert te.value.drops[0][0] == "index_probe_overflow"


# ---------------------------------------------------------------------------
# SQL shapes of tests/test_cbo.py, both sessions
# ---------------------------------------------------------------------------


def _mk_indexed(seed=3, n_big=4000, n_small=60):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 500, n_big).astype(np.int64)
    v = rng.integers(0, 1000, n_big).astype(np.int64)
    tag = rng.integers(0, 100, 500).astype(np.int64)
    sessions = (JSession(), TSession(device="cpu"))
    for s in sessions:
        s.catalog.load_numpy("big", {
            "id": np.arange(n_big, dtype=np.int64), "k": k, "v": v})
        s.catalog.load_numpy("small", {
            "sk": np.arange(500, dtype=np.int64), "tag": tag})
        s.execute("analyze table big")
        s.execute("analyze table small")
        s.execute("create index idx_big_k on big (k)")
    keep = set(np.nonzero(tag < 10)[0].tolist())
    want = int(sum(int(vv) for kk, vv in zip(k, v) if int(kk) in keep))
    return sessions, want


Q = ("select sum(big.v) as sv from big, small "
     "where big.k = small.sk and small.tag < 10")


def _explain(s, q):
    return "\n".join(str(r) for r in s.execute("explain " + q).rows())


def test_index_probe_chosen_and_correct():
    (js, ts), want = _mk_indexed()
    for s in (js, ts):
        assert "IndexProbe" in _explain(s, Q)
        assert s.execute(Q).rows() == [(want,)]
    assert _probes(ts.last_plan, tplan) == 1
    for s in (js, ts):
        s.execute("drop index idx_big_k on big")
        assert "IndexProbe" not in _explain(s, Q)
        assert s.execute(Q).rows() == [(want,)]
    assert ts.catalog.sidecar("big", "idx_big_k",
                              ts.catalog.table_data("big")) is None


def test_index_probe_plans_match():
    (js, ts), _want = _mk_indexed()
    jp, _o, jest = js._plan_select(jparse(Q), None)
    tp, _o, test = ts._plan_select(tparse(Q), None)
    assert tplan.logical_hash(tp) == jplan.logical_hash(jp)
    assert test == jest


def test_index_probe_poisoned_tables():
    """Dead lanes of the base and probe tables, poisoned, leave the
    answer alone: the port's result on poisoned copies equals the
    reference's on the same copies."""
    (js, ts), _want = _mk_indexed()
    jt, tt = {}, {}
    for name in ("big", "small"):
        rel = js.catalog.table_data(name)
        arrays = {c: np.asarray(rel.columns[c].data) for c in rel.columns}
        jt[name], tt[name] = _load(arrays, None, None, 7)
    outs = []
    for s, mod, parse, tables in ((js, jplan, jparse, jt),
                                  (ts, tplan, tparse, tt)):
        plan, _o, _e = s._plan_select(parse(Q), None)
        assert _probes(plan, mod) == 1
        mod.prepare_index_probes(s.catalog, plan, tables)
        outs.append(mod.execute_plan(plan, tables))
    # output columns carry each binder's process-wide column ids, so
    # they are matched by position
    exp = list(jcol.to_numpy(outs[0]).values())
    got = list(tcol.to_numpy(outs[1]).values())
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_index_probe_survives_dml_between_executions():
    """The sidecar cache keys on the relation's identity: rows inserted,
    updated or deleted after an execution are seen by the next one."""
    results = []
    for s in (JSession(), TSession(device="cpu")):
        s.catalog.load_numpy("t", {
            "a": np.arange(100, dtype=np.int64),
            "k": (np.arange(100, dtype=np.int64) % 10)})
        s.catalog.load_numpy("d", {"dk": np.arange(10, dtype=np.int64)})
        s.execute("analyze table t")
        s.execute("analyze table d")
        s.execute("create index idx_t_k on t (k)")
        q = "select count(*) from t, d where t.k = d.dk and d.dk < 3"
        out = [s.execute(q).rows()]
        s.execute("insert into t values (1000, 1), (1001, 2), (1002, 7)")
        out.append(s.execute(q).rows())
        s.execute("update t set k = 0 where a < 5")
        out.append(s.execute(q).rows())
        s.execute("delete from t where k = 2")
        out.append(s.execute(q).rows())
        results.append(out)
        if isinstance(s, TSession):
            assert _probes(s.last_plan, tplan) == 1
    assert results[1] == results[0]
    assert results[1] == [[(30,)], [(32,)], [(34,)], [(24,)]]


def test_catalog_only_create_and_drop_index():
    s = TSession(device="cpu")
    s.catalog.load_numpy("t", {"a": np.arange(10, dtype=np.int64),
                               "k": np.arange(10, dtype=np.int64)})
    s.execute("create index ix on t (k)")
    td = s.catalog.table_def("t")
    assert any(i.name == "ix" for i in td.indexes)
    with pytest.raises(ValueError, match="exists"):
        s.execute("create index ix on t (k)")  # duplicate name
    s.execute("create index if not exists ix on t (k)")
    with pytest.raises(KeyError):
        s.execute("create index ix2 on t (missing)")  # unknown column
    assert s.execute("show index from t").rows() == [("ix", "k", 0,
                                                      "normal")]
    s.execute("drop index ix on t")
    assert not any(i.name == "ix"
                   for i in s.catalog.table_def("t").indexes)
    with pytest.raises(KeyError):
        s.execute("drop index ix on t")
    s.execute("drop index if exists ix on t")  # idempotent
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        s.execute("create vector index vx on t (k)")


def test_sidecar_cache_lifecycle():
    """The catalog frees a table's cached sidecars when the table is
    dropped or its relation replaced, and DESCRIBE of a view over an
    index probe leaves the cached sidecar alone."""
    (js, ts), want = _mk_indexed()
    cat = ts.catalog

    def cached():
        return cat.sidecar("big", "idx_big_k", cat.table_data("big"))

    assert ts.execute(Q).rows() == [(want,)]
    side = cached()
    assert side is not None
    for s in (js, ts):
        s.execute(f"create view vq as {Q}")
    assert ts.execute("describe vq").rows() == js.execute(
        "describe vq").rows()
    assert cached() is side
    assert ts.execute(Q).rows() == [(want,)]
    assert cached() is side   # no rebuild after DESCRIBE
    for s in (js, ts):
        s.execute("insert into big values (99999, 0, 1)")
    assert cached() is None   # freed with the relation it was built from
    assert ts.execute(Q).rows() == js.execute(Q).rows()
    rel = cat.table_data("big")
    assert cached() is not None
    ts.execute("drop table big")
    assert cat.sidecar("big", "idx_big_k", rel) is None


def test_scalar_subquery_fold_reads_sidecar():
    """A HAVING scalar subquery is executed while binding; its plan holds
    an IndexProbe, so the fold must build the sidecar first."""
    (js, ts), want = _mk_indexed()
    tp, _o, _e = ts._plan_select(tparse(Q), None)
    assert _probes(tp, tplan) == 1
    sql = ("select tag, count(*) as n from small group by tag "
           f"having count(*) * 1000 < ({Q}) order by tag")
    ts.catalog.drop_sidecars("big")
    got = ts.execute(sql).rows()
    # the outer query reads only small: the sidecar was built by the fold
    assert ts.catalog.sidecar("big", "idx_big_k",
                              ts.catalog.table_data("big")) is not None
    assert got == js.execute(sql).rows()
    assert got and want > 0


# ---------------------------------------------------------------------------
# TPC-H SF0.01 with the SF1 parity run's indexes (scripts/sf_parity.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_indexed():
    tables, jtypes = gen_tpch(sf=0.01)
    _t, ttypes = tgen_tpch(sf=0.01)
    js, ts = JSession(), TSession(device="cpu")
    for s, types in ((js, jtypes), (ts, ttypes)):
        for name, arrays in tables.items():
            s.catalog.load_numpy(
                name, arrays, primary_key=TPCH_PRIMARY_KEYS[name],
                types={k: v for k, v in types.items() if k in arrays})
        for name in tables:
            s.execute(f"analyze table {name}")
        for name, arrays in tables.items():
            for c in arrays:
                if c.endswith("key"):
                    s.execute(f"create index idx_{name}_{c} on {name} ({c})")
    return js, ts, load_sqlite(tables, jtypes)


@pytest.mark.parametrize("name", ["ip1", "q5", "q8"])
def test_tpch_indexed_matches(tpch_indexed, name, monkeypatch):
    js, ts, conn = tpch_indexed
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)
    sql = IP1 if name == "ip1" else QUERIES[int(name[1:])]
    jp, _o, _e = js._plan_select(jparse(sql), None)
    tp, _o, _e = ts._plan_select(tparse(sql), None)
    assert _probes(tp, tplan) == _probes(jp, jplan) >= 1
    got = ts.execute(sql).rows()
    ok, why = rows_match(got, js.execute(sql).rows(), ordered=True,
                         rtol=1e-12)
    assert ok, why
    ok, why = rows_match(got, run_oracle(conn, sql),
                         ordered="order by" in sql)
    assert ok, why
