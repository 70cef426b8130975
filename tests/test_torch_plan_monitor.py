"""The port's plan monitor, cardinality feedback and plan-quality
ledger against the JAX package's, on the CPU.

- the reference's ``tests/test_plan_monitor.py`` case on both packages;
- TPC-H Q1/Q3/Q14 at SF0.01 through both ``Database``s (calibration
  off, as the reference boots in every port test): equal ``op_stats``
  (op, rows, est, q_error), equal ``logical_hash`` and equal feedback
  rows after a repeat;
- the hand-built Q6/Q1/Q14 plans over poisoned pad lanes: the monitor
  rows equal the reference's, and monitoring changes no result bit;
- one host read per execution: with the monitor, trace, metrics and the
  time split all on, an ``execute_plan`` of Q1/Q6/Q14 reads the device
  as often as with all of them off, and at most once (counting
  ``Tensor.item``/``__int__``/``__bool__``/``tolist``/``cpu``/``numpy``);
- the single-node cases of the reference's ``tests/test_planqual.py``
  and ``tests/test_explain_infoschema.py``; its MCV case is left out
  (MCV selectivity belongs to the optimizer, held by
  ``test_torch_sql_frontend.py``);
- its DTL case (slow, as the reference marks it) on a 3-node cluster of
  each package's node processes: the ``DtlPartial:<op>`` monitor rows
  of a pushed-down aggregate and gv$px_exchange's per-slice rows."""

import itertools
import json

import numpy as np
import pytest
import torch

from oceanbase_tpu.analysis.poison import poison_tables, results_identical
from oceanbase_tpu.bench import queries as jq
from oceanbase_tpu.bench.tpch import gen_tpch as jgen
from oceanbase_tpu.exec.plan import execute_plan as jexec
from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu.sql import binder as jbinder
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch.bench import queries as tq
from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen
from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
from oceanbase_tpu_torch.exec import plan as tplan
from oceanbase_tpu_torch.server import metrics as tm
from oceanbase_tpu_torch.server import trace as ttrace
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.sql import binder as tbinder
from oceanbase_tpu_torch.sql.optimizer import overflow_jump_factor
from oceanbase_tpu_torch.vector import column as tcol
from test_torch_sql_frontend import align_colids
from test_torch_tpch_slice import LINEITEM_COLS, PART_COLS, _to_port

torch.set_num_threads(2)

SF = 0.01


def _boot(root, cls, knobs, **kw):
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(
        json.dumps({"enable_calibration": False, **knobs}))
    return cls(str(root), **kw)


def _pair(tmp_path, **knobs):
    return (_boot(tmp_path / "jax", JDatabase, knobs),
            _boot(tmp_path / "port", Database, knobs, device="cpu"))


def _ledger(rec):
    return [(r["op"], r["pos"], r["est"], r["rows"], r["q_error"])
            for r in rec.op_stats]


def _feedback(db):
    return sorted((r["logical_hash"], r["pos"], r["op"], r["est"],
                   r["rows"], r["q_error"]) for r in db.plan_feedback.rows())


# ---------------------------------------------------------------------------
# the reference's test_plan_monitor case, on both packages
# ---------------------------------------------------------------------------


def test_plan_monitor_rows(tmp_path):
    out = []
    for db in _pair(tmp_path):
        s = db.session()
        s.execute("create table t (k int primary key, v int)")
        s.execute("insert into t values (1, 1), (2, 2), (3, 3)")
        align_colids()
        s.execute("select sum(v) from t where k >= 2")
        rec = db.plan_monitor.recent(5)[-1]
        ops = {r["op"]: r["rows"] for r in rec.op_stats}
        assert ops == {"TableScan": 3, "Filter": 2, "ScalarAgg": 1}
        assert all("est" in r and "q_error" in r for r in rec.op_stats)
        assert rec.logical_hash and rec.path == "serial"
        r = s.execute("select operator, output_rows from gv$plan_monitor"
                      " where operator = 'Filter'")
        assert ("Filter", 2) in r.rows()
        s.execute("alter system set enable_sql_plan_monitor = false")
        n_before = len(db.plan_monitor.recent(1000))
        s.execute("select count(*) from t")
        assert len(db.plan_monitor.recent(1000)) == n_before
        out.append((_ledger(rec), rec.logical_hash, rec.retries))
        db.close()
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# TPC-H Q1/Q3/Q14 through both Databases
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_pair(tmp_path_factory):
    # without the session plan cache: the reference caches the plan its
    # retry ladder scaled, the port's cache keeps the plan as bound
    # (test_torch_plan_cache.py), so a repeat would start from another
    # plan in each; re-binding isolates the monitor and the feedback
    root = tmp_path_factory.mktemp("tpch")
    j, t = _pair(root, enable_plan_cache=False)
    for db, gen in ((j, jgen), (t, tgen)):
        tables, types = gen(sf=SF)
        for name, arrays in tables.items():
            db.catalog.load_numpy(
                name, arrays, primary_key=TPCH_PRIMARY_KEYS[name],
                types={k: v for k, v in types.items() if k in arrays})
    yield j, t
    j.close()
    t.close()


@pytest.mark.parametrize("qnum", [1, 3, 14])
def test_tpch_ledger_and_feedback_equal_the_reference(tpch_pair, qnum):
    j, t = tpch_pair
    sql = QUERIES[qnum]
    recs = []
    for db in (j, t):
        s = db.session()
        align_colids()
        first = s.execute(sql).rows()
        rec1 = db.plan_monitor.recent(1)[-1]
        align_colids()
        again = s.execute(sql).rows()  # a repeat consults the feedback
        rec2 = db.plan_monitor.recent(1)[-1]
        assert again == first
        recs.append((_ledger(rec1), _ledger(rec2), rec1.logical_hash,
                     rec2.logical_hash, rec1.retries, rec2.retries))
    assert recs[1] == recs[0]
    assert _feedback(t) == _feedback(j)


# ---------------------------------------------------------------------------
# hand-built plans over poisoned lanes, monitor on
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_tables():
    tables, types = jgen(sf=SF)
    jtables = {}
    for name, cols in (("lineitem", LINEITEM_COLS), ("part", PART_COLS)):
        arrays = {c: tables[name][c] for c in cols}
        rel = jcol.from_numpy(
            arrays, types={k: v for k, v in types.items() if k in arrays})
        jtables[name] = rel.pad_to(jcol.bucket_capacity(rel.capacity + 1))
    poisoned = poison_tables(jtables)
    return (len(tables["lineitem"]["l_orderkey"]), poisoned,
            _to_port(poisoned), _to_port(jtables))


def _plan(mod, qname, n):
    return {"q6": mod.q6_plan, "q1": mod.q1_plan,
            "q14": lambda: mod.q14_plan(n)}[qname]()


@pytest.mark.parametrize("qname", ["q6", "q1", "q14"])
def test_monitor_rows_equal_the_reference_over_poison(slice_tables, qname):
    n, jpois, tpois, tclean = slice_tables
    jmon, tmon = [], []
    jres = jcol.to_numpy(jexec(_plan(jq, qname, n), jpois,
                               monitor_out=jmon))
    tplan.reset_exec_times()
    tres = tcol.to_numpy(tplan.execute_plan(_plan(tq, qname, n), tpois,
                                            monitor_out=tmon))
    tplan.resolve_pending()
    keys = ("op", "pos", "est", "rows", "q_error")
    assert [tuple(r[k] for k in keys) for r in tmon] == \
        [tuple(r[k] for k in keys) for r in jmon]
    # monitoring changes no bit of the result, poisoned or clean
    plain = tcol.to_numpy(tplan.execute_plan(_plan(tq, qname, n), tclean))
    ok, why = results_identical(tres, plain)
    assert ok, why
    assert sorted(tres) == sorted(jres)


# ---------------------------------------------------------------------------
# one host read per execution, with the whole plane on
# ---------------------------------------------------------------------------

_READS = ("item", "__int__", "__bool__", "tolist", "cpu", "numpy")


def _count_reads(monkeypatch, fn):
    n = [0]
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            n[0] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    try:
        fn()
    finally:
        monkeypatch.undo()
    return n[0]


@pytest.mark.parametrize("qname", ["q1", "q6", "q14"])
def test_one_host_read_with_the_plane_on(slice_tables, qname, monkeypatch):
    n, _jp, _tp, tclean = slice_tables
    plan = _plan(tq, qname, n)
    tplan.execute_plan(plan, tclean)  # first execution at the signature

    def plane_off():
        tplan.set_time_split(False)
        tm.set_enabled(False)
        tplan.execute_plan(plan, tclean)

    mon: list = []
    ctx = ttrace.TraceCtx("read-count")

    def plane_on():
        tplan.set_time_split(True)
        tm.set_enabled(True)
        with ttrace.activate(ctx):
            with ttrace.span("statement"):
                tplan.execute_plan(plan, tclean, monitor_out=mon)

    try:
        tplan.reset_exec_times()
        off = _count_reads(monkeypatch, plane_off)
        tplan.reset_exec_times()
        on = _count_reads(monkeypatch, plane_on)
    finally:
        tplan.set_time_split(True)
        tm.set_enabled(True)
    assert on == off <= 1, (on, off)
    # the join's overflow lane is the one read; the monitor counts ride
    # in it, or arrive through resolve_pending after the caller's read
    assert (on == 1) == (qname == "q14")
    tplan.resolve_pending()
    assert [r["op"] for r in mon] == \
        [type(x).__name__ for x in tplan.monitored_postorder(plan)]
    names = [s.name for s in ctx.snapshot()]
    assert "plan.execute" in names and \
        sum(nm.startswith("op.") for nm in names) == len(mon)


def test_analytic_cost_pinned_by_hand():
    """flops/bytes of one small plan, counted by hand: a Filter over a
    4-row int64 scan without mask reads 32 data bytes and writes a
    4-lane bool mask; the ScalarAgg over it reads 32 + 4 bytes and
    writes one int64 sum (8) plus its one-lane mask (1)."""
    from oceanbase_tpu_torch.exec.ops import AggSpec
    from oceanbase_tpu_torch.expr import ir

    rel = tcol.from_numpy({"a": np.arange(4, dtype=np.int64)},
                          device="cpu")
    plan = tplan.ScalarAgg(
        tplan.Filter(tplan.TableScan("t"),
                     ir.Cmp(">", ir.col("a"), ir.lit(1))),
        [AggSpec("s", "sum", ir.col("a"))])
    tplan.execute_plan(plan, {"t": rel})
    st = tplan._plan_stats(plan)
    out = tplan.execute_plan(plan, {"t": rel})
    agg_out = sum(t.numel() * t.element_size()
                  for t in tplan._tensors(out))
    assert st.flops == 4 + 4
    assert st.bytes_accessed == (32 + 4) + (32 + 4 + agg_out)
    assert st.xla_traces == 1 and st.executions == 2
    assert st.hit_count == 1


def test_capacity_signature_counts_first_executions():
    """xla_trace_count stays flat while a table grows inside one bucket
    and steps when it crosses into the next."""
    from oceanbase_tpu_torch.exec.ops import AggSpec

    plan = tplan.ScalarAgg(tplan.TableScan("t"),
                           [AggSpec("c", "count_star", None)])

    def rel(live, cap):
        r = tcol.from_numpy({"a": np.arange(live, dtype=np.int64)},
                            device="cpu")
        return r.pad_to(cap)

    for live in (10, 40, 64):
        tplan.execute_plan(plan, {"t": rel(live, 64)})
    st = tplan._plan_stats(plan)
    assert (st.executions, st.xla_traces) == (3, 1)
    tplan.execute_plan(plan, {"t": rel(65, 128)})
    assert (st.executions, st.xla_traces) == (4, 2)


# ---------------------------------------------------------------------------
# the reference's single-node plan-quality cases
# ---------------------------------------------------------------------------


@pytest.fixture()
def db(tmp_path):
    d = Database(str(tmp_path / "db"), device="cpu")
    yield d
    d.close()


def _seed_join_tables(s, n=100):
    s.execute("create table a (id int primary key, k int)")
    s.execute("create table b (id int primary key, k int)")
    s.execute("insert into a values "
              + ",".join(f"({i},1)" for i in range(n)))
    s.execute("insert into b values "
              + ",".join(f"({i},1)" for i in range(n)))


def _retries():
    return int(tm.sysstat_dict().get("plan.capacity_retries", 0))


def test_qerror_ledger_serial(db):
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (1,1),(2,2),(3,3),(4,4)")
    s.execute("select sum(v) from t where k >= 2")
    rec = db.plan_monitor.recent(1)[-1]
    by_op = {r["op"]: r for r in rec.op_stats}
    assert (by_op["TableScan"]["est"], by_op["TableScan"]["rows"],
            by_op["TableScan"]["q_error"]) == (4, 4, 1.0)
    assert all(r["est"] is not None and r["q_error"] >= 1.0
               for r in rec.op_stats)
    r = s.execute(
        "select operator, est_rows, output_rows, q_error,"
        " capacity_retries, spill_bytes, path from gv$sql_plan_monitor"
        " where operator = 'TableScan' order by ts desc limit 1")
    assert r.rows() == [("TableScan", 4, 4, 1.0, 0, 0, "serial")]


def test_qerror_ledger_spill_path(db):
    s = db.session()
    s.execute("create table big (k int primary key, v int)")
    s.execute("insert into big values "
              + ",".join(f"({i},{i % 7})" for i in range(600)))
    s.execute("alter system set sql_work_area_rows = 100")
    assert len(s.execute("select k, v from big order by v, k limit 5"
                         ).rows()) == 5
    rec = db.plan_monitor.recent(1)[-1]
    assert rec.path == "spill" and rec.spill_bytes > 0
    assert rec.op_stats[-1]["q_error"] >= 1.0
    path, sbytes, q = s.execute(
        "select path, spill_bytes, q_error from gv$sql_plan_monitor"
        " where path = 'spill' order by ts desc limit 1").rows()[0]
    assert path == "spill" and sbytes > 0 and q >= 1.0
    (kind, runs, nbytes), = s.execute(
        "select operation, spill_runs, spill_bytes from v$sql_workarea"
    ).rows()
    assert kind and runs >= 1 and nbytes == sbytes
    assert db.wait_events.stats()["spill io"]["count"] == 1


def test_feedback_avoids_second_overflow(db):
    s = db.session()
    _seed_join_tables(s)
    q = "select count(*) from a, b where a.k = b.k"
    r0 = _retries()
    assert s.execute(q).rows() == [(10000,)]
    assert _retries() - r0 == 1
    s2 = db.session()
    r1 = _retries()
    assert s2.execute(q).rows() == [(10000,)]
    assert _retries() - r1 == 0
    fb = s2.execute(
        "select operator, observed_rows from gv$plan_feedback"
        " where kind = 'card' and operator = 'HashJoin'"
        " order by observed_rows desc limit 1")
    assert fb.rows()[0] == ("HashJoin", 10000)


def test_feedback_off_rides_blind_ladder(db):
    s = db.session()
    s.execute("alter system set enable_plan_feedback = false")
    _seed_join_tables(s)
    r0 = _retries()
    assert s.execute(
        "select count(*) from a, b where a.k = b.k").rows() == [(10000,)]
    assert _retries() - r0 >= 2


def test_overflow_jump_factor_unit():
    assert overflow_jump_factor([]) == 4
    assert overflow_jump_factor([("join_overflow", None, 10)]) == 4
    assert overflow_jump_factor([("join_overflow", 256, 9744)]) == 64
    assert overflow_jump_factor(
        [("a", 256, 100), ("b", 256, 9744)]) == 64


def test_watchdog_flags_slowed_plan(db):
    ph = db.plan_history
    thr = float(db.config["plan_regress_threshold"])
    for _ in range(ph.WARMUP):
        assert ph.record("lh1", 0.001, thr) is False
    transitions = [ph.record("lh1", 0.05, thr) for _ in range(4)]
    assert transitions.count(True) == 1
    for _ in range(20):
        ph.record("lh1", 0.001, thr)
    r = db.session().execute(
        "select logical_hash, regressed, regress_count from"
        " gv$plan_history where logical_hash = 'lh1'")
    assert r.rows() == [("lh1", False, 1)]


def test_watchdog_records_real_executions(db):
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (1,1),(2,2)")
    # the first execution at a capacity signature is excluded from the
    # latency baseline, as the reference excludes its compile
    for _ in range(4):
        s.execute("select sum(v) from t")
    assert any(r["executions"] == 3 for r in db.plan_history.rows())


def test_explain_analyze_forces_collection_when_knob_off(db):
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (1,1),(2,2),(3,3)")
    s.execute("alter system set enable_sql_plan_monitor = false")
    n0 = len(db.plan_monitor.recent(1000))
    s.execute("select count(*) from t")
    assert len(db.plan_monitor.recent(1000)) == n0
    r = s.execute("explain analyze select sum(v) from t where k >= 2")
    assert "[est=" in r.plan_text and "act=" in r.plan_text
    assert "roofline: [" in r.plan_text
    recent = db.plan_monitor.recent(1000)
    assert len(recent) == n0 + 1
    assert any(x["op"] == "Filter" and x["rows"] == 2
               for x in recent[-1].op_stats)


def test_explain_analyze_flags_worst_misestimate(db):
    s = db.session()
    _seed_join_tables(s, n=30)
    r = s.execute(
        "explain analyze select count(*) from a, b where a.k = b.k")
    assert "worst misestimate: HashJoin" in r.plan_text


def test_explain_analyze_text_equals_the_reference(tmp_path):
    """The annotated plan lines (operators with est/act/q) match; the
    roofline line's numbers are each package's own."""
    texts = []
    start = 10 ** 6
    for db in _pair(tmp_path):
        s = db.session()
        s.execute("create table t (k int primary key, v int)")
        s.execute("insert into t values " +
                  ", ".join(f"({i}, {i % 5})" for i in range(50)))
        # both binders number this statement's column ids from one value
        jbinder._uid, tbinder._uid = (itertools.count(start),
                                      itertools.count(start))
        r = s.execute("explain analyze select v, count(*) from t"
                      " where k > 10 group by v")
        texts.append([ln for ln in r.plan_text.splitlines()
                      if not ln.startswith("roofline:")])
        db.close()
    assert texts[1] == texts[0]


def test_information_schema_and_row_counts(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (1, 10), (2, 20), (3, 30)")
    r = s.execute("explain analyze select * from t where v > 15")
    text = "\n".join(x[0] for x in r.rows())
    assert "act=2" in text and "act=3" in text
    rows = s.execute("select table_name, table_rows from"
                     " information_schema.tables").rows()
    assert ("t", 3) in rows
    cols = s.execute("select column_name, ordinal_position, column_key"
                     " from information_schema.columns"
                     " where table_name = 't'").rows()
    assert cols == [("k", 1, "PRI"), ("v", 2, "")]
    db.close()


def _scn_dtl_monitor(c):
    """``tests/test_planqual.py::test_dtl_qerror_and_slice_attribution``
    (:342-389) on a running cluster -> its record."""
    from oceanbase_tpu_torch.bench.cluster import rows

    c.execute(1, "create table q (k int primary key, v int)")
    v = np.random.default_rng(7).integers(0, 100, 3000)
    for s0 in range(0, 3000, 750):
        c.execute(1, "insert into q values " + ", ".join(
            f"({i}, {v[i]})" for i in range(s0, s0 + 750)))
    c.wait_count("q", 3000, nodes=(2,), deadline_s=60)
    c.execute(1, "alter system set dtl_min_rows = 1")
    got = rows(c.execute(1, "select sum(v), count(*) from q where v < 50"))
    sel = v < 50
    ledger = rows(c.execute(
        1, "select operator, est_rows, output_rows, q_error from"
           " gv$sql_plan_monitor where path = 'dtl'"
           " and operator like 'DtlPartial:%'"))
    scan = [x for x in ledger if x[0] == "DtlPartial:TableScan"]
    (parts, mx, mean, skew), = rows(c.execute(
        1, "select parts, max_slice_rows, mean_slice_rows, slice_skew"
           " from gv$px_exchange where mode = 'pushdown'"
           " order by ts desc limit 1"))
    return {"answer": got == [(int(v[sel].sum()), int(sel.sum()))],
            "operators": sorted({x[0] for x in ledger}),
            "scan": scan[-1][1:3] if scan else None,
            "q_error_ge_1": all(x[3] >= 1.0 for x in ledger if x[1] != -1),
            "parts": parts, "slices": mx >= 1 and mean > 0,
            "balanced": 0.0 < skew < 1.5}


@pytest.mark.slow
def test_dtl_qerror_and_slice_attribution(tmp_path):
    from oceanbase_tpu_torch.bench.cluster import NodeCluster
    from torch_pair import NODE_PACKAGES

    out = {}
    for tag, module in NODE_PACKAGES:
        c = NodeCluster(str(tmp_path / tag), n=3, device="cpu",
                        module=module)
        try:
            out[tag] = _scn_dtl_monitor(c)
        finally:
            c.close()
    assert out["ref"]["operators"], "remote per-op ledger rows missing"
    assert out["ref"]["scan"] == (3000, 3000)
    assert out["ref"]["answer"] and out["ref"]["q_error_ge_1"]
    assert out["ref"]["parts"] == 3 and out["ref"]["slices"]
    assert out["ref"]["balanced"]
    assert out["port"] == out["ref"]

