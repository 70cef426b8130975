"""The port's metrics plane (``server/metrics.py`` and its surfaces)
against the JAX package's, on the CPU.

The same declarations and observations, drawn from one seeded numpy
stream, give equal ``snapshot()``s, equal ``hist_stats`` p50/p95/p99,
byte-equal Prometheus text and equal scrape bodies; thread shards merge
and the shards of dead threads retire.  Through a ``Database``: the
cases of the reference's ``tests/test_metrics.py`` that apply to one
node (the plan-cache columns, the counters that flow, gv$memory's pad
waste, gv$sysstat / gv$sysstat_histogram / SHOW METRICS, the
``enable_metrics`` knob), and a scripted run whose statement, plan and
plan-cache counters equal the reference's."""

import json
import threading

import numpy as np
import pytest
import torch

from oceanbase_tpu.server import metrics as jm
from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu_torch.server import metrics as tm
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.server.monitor import WaitEvents

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_registries():
    for m in (jm, tm):
        m.reset()
        m.set_enabled(True)
    yield
    for m in (jm, tm):
        m.reset()
        m.set_enabled(True)


def _stream(seed=7, n=4000):
    """A seeded stream of metric operations: (kind, name, value, labels)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.integers(0, 3)
        lbl = {"verb": ["a", "b", "c"][int(rng.integers(0, 3))]}
        if r == 0:
            ops.append(("inc", "parity.c", int(rng.integers(1, 9)), lbl))
        elif r == 1:
            ops.append(("observe", "parity.h",
                        float(rng.lognormal(-6.0, 2.0)), lbl))
        else:
            ops.append(("gauge", "parity.g", float(rng.normal()), lbl))
    return ops


def _apply(m, ops):
    m.declare("parity.c", "counter", "d")
    m.declare("parity.h", "histogram", "d", unit="s")
    m.declare("parity.g", "gauge", "d")
    for kind, name, v, lbl in ops:
        if kind == "inc":
            m.inc(name, v, **lbl)
        elif kind == "observe":
            m.observe(name, v, **lbl)
        else:
            m.set_gauge(name, v, **lbl)


def _hist_dict(snap):
    return {k: (h.count, h.sum, h.min, h.max, dict(h.buckets))
            for k, h in snap["hists"].items()}


def test_seeded_stream_snapshot_and_prom_text_equal():
    ops = _stream()
    _apply(jm, ops)
    _apply(tm, ops)
    js, ts = jm.snapshot(), tm.snapshot()
    assert ts["counters"] == js["counters"]
    assert ts["gauges"] == js["gauges"]
    assert _hist_dict(ts) == _hist_dict(js)
    for k, h in js["hists"].items():
        assert tm.hist_stats(ts["hists"][k]) == jm.hist_stats(h)
    assert tm.prom_text() == jm.prom_text()
    assert tm.wire_snapshot() == jm.wire_snapshot()
    assert tm.sysstat_dict() == jm.sysstat_dict()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_hist_stats_quantiles_equal(seed):
    vals = np.random.default_rng(seed).lognormal(-5.0, 1.5, 5000)
    jh, th = jm.Histogram(), tm.Histogram()
    for v in vals:
        jh.observe(float(v))
        th.observe(float(v))
    st, sj = tm.hist_stats(th), jm.hist_stats(jh)
    for q in ("p50", "p95", "p99", "count", "sum", "min", "max"):
        assert st[q] == sj[q], q
    # the estimate stays within one bucket of numpy's percentile
    tol = tm.HIST_GROWTH - 1.0 + 0.05
    for q, key in ((50.0, "p50"), (95.0, "p95"), (99.0, "p99")):
        want = float(np.percentile(vals, q))
        assert abs(st[key] - want) <= tol * want


def test_merge_wire_and_flat_equal():
    ops = _stream(seed=11, n=600)
    _apply(jm, ops[:300])
    _apply(tm, ops[:300])
    ja, ta = jm.wire_snapshot(), tm.wire_snapshot()
    jm.reset()
    tm.reset()
    _apply(jm, ops[300:])
    _apply(tm, ops[300:])
    jb, tb = jm.wire_snapshot(), tm.wire_snapshot()
    jmerged, tmerged = jm.merge_wire(ja, jb), tm.merge_wire(ta, tb)
    assert tmerged == jmerged
    assert tm.wire_to_flat(tmerged) == jm.wire_to_flat(jmerged)
    assert tm.prom_text(tmerged) == jm.prom_text(jmerged)
    # merge is associative with the empty body (a fresh node's scrape)
    assert tm.wire_to_flat(tm.merge_wire(tmerged, {})) == \
        tm.wire_to_flat(tmerged)


def test_thread_shards_merge_and_dead_threads_retire():
    tm.declare("test.thr", "counter", "t")
    tm.declare("test.thr_s", "histogram", "t")
    n_threads, per = 8, 2000

    def worker(i):
        for k in range(per):
            tm.inc("test.thr", worker=i % 2)
            if k % 100 == 0:
                tm.observe("test.thr_s", 0.001 * (i + 1))

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert tm.counter_value("test.thr") == n_threads * per
    assert tm.counter_value("test.thr", worker=0) == (n_threads // 2) * per
    snap = tm.snapshot()
    assert snap["hists"][("test.thr_s", ())].count == n_threads * per // 100
    # the dead threads' shards folded into the retired pool: none of
    # them is still registered
    with tm._lock:
        alive = [ref() for ref, _s in tm._shards]
    assert all(t is not None and t.is_alive() for t in alive)
    assert tm._retired.counters[("test.thr", (("worker", 0),))] == \
        (n_threads // 2) * per


def test_registry_semantics():
    with pytest.raises(KeyError):
        tm.inc("test.never_declared_xyz")
    tm.declare("test.h1", "histogram", "t")
    with pytest.raises(TypeError):
        tm.inc("test.h1")
    tm.declare("test.c1", "counter", "t")
    tm.declare("test.c1", "counter", "t")
    with pytest.raises(ValueError):
        tm.declare("test.c1", "gauge", "t")
    tm.set_enabled(False)
    tm.inc("test.c1", 100)
    tm.set_enabled(True)
    assert tm.counter_value("test.c1") == 0


def test_prom_text_one_inf_line_per_series():
    for m in (jm, tm):
        m.declare("test.ps", "histogram", "t")
        m.observe("test.ps", 0.003)
        m.observe("test.ps", 1e12)  # the overflow bucket
    text = tm.prom_text()
    assert text == jm.prom_text()
    assert text.count('ob_test_ps_bucket{le="+Inf"}') == 1
    assert 'ob_test_ps_bucket{le="+Inf"} 2' in text


def test_wait_events_match_the_reference():
    from oceanbase_tpu.server.monitor import WaitEvents as JWaitEvents

    vals = np.random.default_rng(5).exponential(0.01, 200)
    jw, tw = JWaitEvents(), WaitEvents()
    for i, v in enumerate(vals):
        ev = ("spill io", "latch")[i % 2]
        jw.add(ev, float(v))
        tw.add(ev, float(v))
    assert tw.snapshot() == jw.snapshot()
    assert tw.stats() == jw.stats()


# ---------------------------------------------------------------------------
# through a Database
# ---------------------------------------------------------------------------


@pytest.fixture
def db(tmp_path):
    d = Database(str(tmp_path / "db"), device="cpu")
    yield d
    d.close()


def test_plan_cache_columns_after_one_execution(db):
    s = db.session()
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values " +
              ", ".join(f"({i}, {i * 3})" for i in range(200)))
    s.execute("select sum(b) from t where a < 100")
    rows = s.execute(
        "select executions, xla_trace_count, flops, bytes_accessed,"
        " peak_memory, last_compile_s from gv$plan_cache"
        " where executions > 0 order by executions desc").rows()
    attributed = [r for r in rows if r[2] > 0 and r[3] > 0]
    assert attributed, rows
    ex, traces, _f, _b, peak, compile_s = attributed[0]
    # eager torch: no compile, no allocator peak on the CPU
    assert ex >= 1 and traces >= 1 and compile_s == 0.0 and peak == 0


def test_plan_metrics_counters_flow(db):
    s = db.session()
    s.execute("create table t (a int primary key)")
    s.execute("insert into t values (1), (2), (3)")
    s.execute("select count(*) from t")
    assert tm.counter_value("plan.compiles") >= 1
    assert tm.counter_value("plan.executions") >= 1
    assert tm.counter_value("plan.flops_executed") > 0
    assert tm.counter_value("sql.statements", tenant="sys") >= 3
    assert tm.counter_value("palf.appends") >= 1
    assert tm.counter_value("admission.admitted", tenant="sys") >= 2


def test_pad_waste_ratio_reacts_to_bucket_growth(db):
    s = db.session()
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values " +
              ", ".join(f"({i}, {i})" for i in range(100)))
    live, cap, waste, buf_b, live_b = s.execute(
        "select live_rows, buffer_capacity, pad_waste_ratio,"
        " buffer_bytes, live_bytes from gv$memory"
        " where table_name = 't'").rows()[0]
    assert (live, cap) == (100, 128)
    assert waste == pytest.approx(1.0 - 100 / 128)
    assert buf_b > live_b > 0
    s.execute("alter system set shape_bucket_growth = 4.0")
    cap2, waste2 = s.execute("select buffer_capacity, pad_waste_ratio"
                             " from gv$memory where table_name = 't'"
                             ).rows()[0]
    assert cap2 == 256 and waste2 == pytest.approx(1.0 - 100 / 256)


def test_sysstat_sql_face_and_show_metrics(db):
    s = db.session()
    s.execute("create table t (a int primary key)")
    s.execute("insert into t values (1)")
    s.execute("select * from t")
    rows = s.execute("select stat_name, value from gv$sysstat"
                     " where name = 'sql.statements'").rows()
    assert rows and all(v >= 1 for _n, v in rows)
    _n, cnt, p50, p95, p99, mx = s.execute(
        "select stat_name, count, p50_s, p95_s, p99_s, max_s from"
        " gv$sysstat_histogram where name = 'sql.statement_s'").rows()[0]
    assert cnt >= 3 and 0 < p50 <= p95 <= p99 <= mx
    text = "\n".join(r[0] for r in s.execute("show metrics").rows())
    assert "# TYPE ob_sql_statements counter" in text
    assert "ob_sql_statement_s_bucket" in text


def test_enable_metrics_knob(db):
    s = db.session()
    s.execute("create table t (a int primary key)")
    s.execute("alter system set enable_metrics = false")
    base = tm.counter_value("sql.statements")
    s.execute("insert into t values (1)")
    assert tm.counter_value("sql.statements") == base
    s.execute("alter system set enable_metrics = true")
    s.execute("insert into t values (2)")
    assert tm.counter_value("sql.statements") == base + 2


_SCRIPT = [
    "create table t (k int primary key, v int, g varchar(4))",
    "insert into t values (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'a')",
    "select g, sum(v) from t group by g order by g",
    "select g, sum(v) from t group by g order by g",
    "update t set v = v + 1 where k = 2", "begin",
    "insert into t values (4, 40, 'c')", "commit",
    "select count(*) from t where v > 15", "delete from t where k = 1",
    "select * from t order by k",
]

#: counters of a scripted run that mean the same in both packages and
#: do not depend on timing (the palf series do: an election fires when
#: a leader lease expires mid-statement, at other statements in each)
_SCRIPTED = ("sql.statements", "sql.rows_returned", "plan_cache.hits",
             "plan_cache.misses", "plan.compiles", "plan.executions",
             "admission.admitted")


def test_scripted_run_counters_equal_the_reference(tmp_path):
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    for root in (jroot, troot):
        root.mkdir()
        (root / "config.json").write_text(
            json.dumps({"enable_calibration": False}))
    j = JDatabase(str(jroot))
    t = Database(str(troot), device="cpu")
    jm.reset()
    tm.reset()
    for d in (j, t):
        s = d.session()
        for sql in _SCRIPT:
            s.execute(sql)
    jflat, tflat = jm.sysstat_dict(), tm.sysstat_dict()
    want = {k: v for k, v in jflat.items() if k.split("{")[0] in _SCRIPTED}
    got = {k: v for k, v in tflat.items() if k.split("{")[0] in _SCRIPTED}
    assert got == want and want
    # the timing-dependent series run in both, with the same shape
    for name in ("palf.appends", "palf.entries_appended", "palf.fsyncs"):
        assert tflat[name] > 0 and jflat[name] > 0
    assert tflat.get("palf.elections", 0) == \
        tflat.get("palf.elections_won", 0)
    # and the SQL face shows the same rows for those counters
    s = t.session()
    rows = dict(s.execute("select stat_name, value from gv$sysstat").rows())
    for k, v in got.items():
        assert rows[k] >= v
    j.close()
    t.close()
