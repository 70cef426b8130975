"""The port's full-link tracing (``server/trace.py``) against the JAX
package's, on the CPU.

The same statement script through both packages' ``Database`` gives
trace trees with equal span names and parentage (the reference's
``xla.compile`` span has no counterpart: eager torch compiles nothing),
and equal retention under the sample rate, the slow threshold and a
failing statement.  The single-node cases of the reference's
``tests/test_trace.py`` follow; its 3-node DTL case runs in
``test_torch_cluster.py::test_remote_trace_spans_under_the_statement``
and ``test_torch_plane_cluster.py`` (attribution), and its
poisoned-lane case in ``test_torch_plan_monitor.py`` with the whole
plane on."""

import json

import pytest
import torch

from oceanbase_tpu.server import trace as jtrace
from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu_torch.server import trace as ttrace
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.server.monitor import AuditRecord, SqlAudit
from test_torch_sql_frontend import align_colids

torch.set_num_threads(2)

Q_AGG = ("select v, sum(k) as s from t where k < 90 "
         "group by v order by v")
_ROWS = ", ".join(f"({i}, {i % 7})" for i in range(100))

_SCRIPT = [
    "create table t (k int primary key, v int)",
    f"insert into t values {_ROWS}",
    Q_AGG, Q_AGG, "select count(*) from t",
    "update t set v = v + 1 where k = 2", "delete from t where k = 3",
    "begin", "insert into t values (200, 1)", "commit",
    "select * from t where k in (select k from t where v = 1) order by k",
    "explain analyze select sum(v) from t", "select nosuch from t",
    "show trace",
]


def _pair(tmp_path):
    dbs = []
    for name, cls, kw in (("jax", JDatabase, {}),
                          ("port", Database, {"device": "cpu"})):
        root = tmp_path / name
        root.mkdir()
        (root / "config.json").write_text(
            json.dumps({"enable_calibration": False}))
        dbs.append(cls(str(root), **kw))
    return dbs


def _tree(db, sess, sql):
    """(span name, parent span name) edges of the statement's kept
    trace, without the reference's compile span; None when dropped."""
    err = ""
    try:
        sess.execute(sql)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        err = type(e).__name__
    tid = sess._last_trace_id
    if not tid:
        return None, err
    spans = db.trace_registry.trace(tid)
    by_id = {s.span_id: s for s in spans}
    return sorted((s.name, by_id[s.parent_id].name
                   if s.parent_id in by_id else "")
                  for s in spans if s.name != "xla.compile"), err


def test_span_trees_equal_the_reference(tmp_path):
    j, t = _pair(tmp_path)
    js, ts = j.session(), t.session()
    for sql in _SCRIPT:
        align_colids()
        want, got = _tree(j, js, sql), _tree(t, ts, sql)
        assert got == want, sql
    assert t.trace_registry.traces_kept == j.trace_registry.traces_kept
    j.close()
    t.close()


@pytest.mark.parametrize("knobs,sql,kept", [
    ({"trace_sample_rate": 0.0, "trace_slow_threshold_s": 100.0},
     "select count(*) from t", False),
    ({"trace_sample_rate": 0.0, "trace_slow_threshold_s": 0.0},
     "select count(*) from t", True),
    ({"trace_sample_rate": 0.0, "trace_slow_threshold_s": 100.0},
     "select nosuch from t", True),
    ({"trace_sample_rate": 1.0, "trace_slow_threshold_s": 100.0},
     "select count(*) from t", True),
    ({"enable_query_trace": False}, "select count(*) from t", False),
])
def test_retention_equals_the_reference(tmp_path, knobs, sql, kept):
    j, t = _pair(tmp_path)
    out = []
    for d in (j, t):
        s = d.session()
        s.execute("create table t (k int primary key, v int)")
        for k, v in knobs.items():
            s.execute(f"alter system set {k} = {v}")
        before = (d.trace_registry.traces_kept,
                  d.trace_registry.traces_dropped)
        tree = _tree(d, s, sql)
        after = (d.trace_registry.traces_kept,
                 d.trace_registry.traces_dropped)
        audit = [r for r in d.audit.recent(None) if r.sql == sql][-1]
        out.append((tree, after[0] - before[0], after[1] - before[1],
                    bool(audit.trace_id), bool(audit.error)))
        d.close()
    assert out[1] == out[0]
    assert out[1][3] is kept


# ---------------------------------------------------------------------------
# the reference's single-node cases
# ---------------------------------------------------------------------------


@pytest.fixture()
def db(tmp_path):
    d = Database(str(tmp_path / "db"), device="cpu")
    s = d.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute(f"insert into t values {_ROWS}")
    yield d, s
    d.close()


def _trace_rows(sess, trace_id):
    r = sess.execute(
        "select trace_id, span_id, parent_span_id, node, span_name,"
        " elapsed_s, tags from gv$trace")
    return [row for row in r.rows() if row[0] == trace_id]


def _audit_trace_id(sess, sql_prefix):
    r = sess.execute("select sql, trace_id from gv$sql_audit")
    hits = [t for q, t in r.rows() if q.startswith(sql_prefix)]
    assert hits, f"no audit row for {sql_prefix!r}"
    return hits[-1]


def test_serial_span_tree_shape(db):
    _d, s = db
    s.execute(Q_AGG)
    tid = _audit_trace_id(s, "select v, sum(k)")
    spans = _trace_rows(s, tid)
    names = [r[4] for r in spans]
    assert {"statement", "compile", "execute", "plan.execute"} <= set(names)
    ids = {r[1] for r in spans}
    roots = [r for r in spans if r[2] == 0]
    assert len(roots) == 1 and roots[0][4] == "statement"
    for row in spans:
        assert row[2] == 0 or row[2] in ids, f"orphan span {row}"
    root_id = roots[0][1]
    by_name = {r[4]: r for r in spans}
    assert by_name["compile"][2] == root_id
    assert by_name["execute"][2] == root_id
    assert by_name["plan.execute"][2] == by_name["execute"][1]
    ops = [r for r in spans if r[4].startswith("op.")]
    assert ops and all(r[2] == by_name["plan.execute"][1] for r in ops)
    # the first execution at a capacity signature is tagged
    tags = json.loads(by_name["plan.execute"][6])
    assert tags["compiled"] == 1 and tags["device_s"] == 0.0


def test_show_trace_renders_last_statement(db):
    _d, s = db
    s.execute(Q_AGG)
    rows = s.execute("show trace").rows()
    assert rows and rows[0][0] == "statement"
    assert any(op.startswith("  ") for op, *_ in rows[1:])
    assert any(op.strip() == "plan.execute" for op, *_ in rows)
    assert any(op.strip().startswith("op.") for op, *_ in rows)
    again = s.execute("show trace")
    assert [x[0] for x in again.rows()] == [x[0] for x in rows]


def test_audit_join(db):
    _d, s = db
    s.execute(Q_AGG)
    r = s.execute(
        "select a.sql, t.span_name from gv$sql_audit a, gv$trace t"
        " where a.trace_id = t.trace_id and t.parent_span_id = 0")
    assert [q for q, n in r.rows() if q.startswith("select v, sum")]


def test_show_trace_empty_when_sampled_away(db):
    _d, s = db
    s.execute(Q_AGG)
    assert s.execute("show trace").rowcount > 0
    s.execute("alter system set trace_sample_rate = 0.0")
    s.execute("alter system set trace_slow_threshold_s = 100.0")
    s.execute("select k from t where k = 2")
    assert s.execute("show trace").rowcount == 0


def test_ash_samples_carry_trace_id(db):
    d, s = db
    s._ash_state.update(active=True, sql="select 1", state="executing",
                        trace_id="cafebabe")
    d.ash.sample_once()
    s._ash_state.update(active=False, trace_id="")
    r = s.execute("select session_id, trace_id from"
                  " gv$active_session_history")
    assert (s.session_id, "cafebabe") in r.rows()
    assert s.execute("select count(*) from v$session_history").rows() == \
        [(1,)]


def test_ash_state_tracks_statement_trace(db):
    _d, s = db
    seen = {}
    orig = s._materialize_virtuals

    def spy(stmt):
        seen["trace_id"] = s._ash_state.get("trace_id")
        return orig(stmt)

    s._materialize_virtuals = spy
    s.execute("select count(*) from t")
    assert seen["trace_id"]
    assert s._ash_state["trace_id"] == ""


def test_ash_sampler_thread_starts_only_when_asked(tmp_path):
    d = Database(str(tmp_path / "a"), device="cpu")
    assert d.ash._thread is None
    d.close()
    d = Database(str(tmp_path / "b"), device="cpu", start_ash=True)
    assert d.ash._thread is not None
    d.close()
    assert d.ash._thread is None


def test_system_event_view(db):
    d, s = db
    d.wait_events.add("unit test wait", 0.25)
    rows = {e: (w, t) for e, w, t in s.execute(
        "select event, total_waits, time_waited_s from gv$system_event"
    ).rows()}
    assert rows["unit test wait"][0] == 1
    assert rows["unit test wait"][1] == pytest.approx(0.25)


def test_ring_recent_slices_tail():
    a = SqlAudit(capacity=100)
    for i in range(150):
        a.record(AuditRecord(sql=f"q{i}", session_id=i, tenant="sys",
                             start_ts=0.0, elapsed_s=0.0, rows=0))
    assert [r.sql for r in a.recent(10)] == \
        [f"q{i}" for i in range(140, 150)]
    assert len(a.recent(1000)) == 100


def test_manual_spans_and_absorb_match_the_reference():
    """begin/end spans, explicit-parent spans and the wire round trip
    that ``absorb`` merges, in both packages."""
    out = []
    for m in (jtrace, ttrace):
        ctx = m.TraceCtx("t1", node=0)
        with m.activate(ctx):
            with m.span("outer", a=1) as sp:
                m.add_span("point", 0.5, b=2)
                sp.tags["c"] = 3
        open_sp = m.begin_span(ctx, "manual", parent=0, d=4)
        m.end_span(ctx, open_sp)
        wire = [s.to_wire() for s in ctx.snapshot()]
        other = m.TraceCtx("t1", node=1)
        m.absorb(other, wire + [{"bad": 1}])
        spans = other.snapshot()
        by_id = {s.span_id: s for s in spans}
        out.append(sorted(
            (s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else "", tuple(sorted(s.tags.items()))) for s in spans))
    assert out[1] == out[0]
    # the port's explicit-parent helper lands under the given span
    ctx = ttrace.TraceCtx("t2")
    ttrace.add_spans_to(ctx, 7, [("op.X", 0.0, {"rows": 1})])
    assert [(s.name, s.parent_id) for s in ctx.snapshot()] == [("op.X", 7)]
