"""The port's gv$/v$ views (``server/virtual_tables.py``) against the JAX
package's, on the CPU.

Both packages' ``Database`` (calibration off) run one statement script;
then every view the port serves has the reference's column names and
dtypes, and the deterministic views hold equal values: ``v$parameters``
(for the knobs the port declares), ``v$tables``,
``information_schema.tables``/``columns``, ``v$tenants``, ``v$palf``,
the plan-monitor rows and the statement/plan counters of
``gv$sysstat``.  PALF re-elects when a leader's 400 ms lease lapses
between appends, which each package's statement timings decide; the
script runs with both packages' leases held valid, so the log's terms
and LSNs are a function of the script alone.  The views over modules
that are not ported raise ``NotImplementedError`` naming their ROADMAP
item.  The single-node case of the reference's
``tests/test_view_wiring.py`` (a view over a virtual table refreshes
per statement) closes the file."""

import json

import numpy as np
import pytest
import torch

from oceanbase_tpu.palf import election as jelection
from oceanbase_tpu.server import metrics as jm
from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu_torch.palf import election as telection
from oceanbase_tpu_torch.server import metrics as tm
from oceanbase_tpu_torch.server.database import Database
from test_torch_sql_frontend import align_colids

torch.set_num_threads(2)

_SCRIPT = [
    "create table t (k int primary key, v int, g varchar(4))",
    "insert into t values (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'a')",
    "create table u (id int primary key, name varchar(8))",
    "insert into u values (1, 'x'), (2, 'y')",
    "select g, sum(v) from t group by g order by g",
    "select t.k, u.name from t join u on t.k = u.id order by t.k",
    "update t set v = v + 1 where k = 2",
    "alter system minor freeze",
    "delete from t where k = 1",
    "select count(*) from t where v > 15",
    "explain analyze select sum(v) from t",
]

#: the durability plane's views, refused before that plane was ported,
#: each with the module that serves it now
_UNPORTED = {
    "gv$scrub": "storage/scrub.py",
    "v$errsim": "server/errsim.py",
    "gv$workload_snapshot": "server/workload.py",
    "gv$workload_report": "server/workload.py",
}


_SNAPSHOT = ("gv$sysstat", "gv$tenant_resource", "gv$plan_monitor",
             "gv$plan_feedback", "gv$sql_audit", "v$tables",
             "information_schema.tables", "information_schema.columns",
             "v$tenants", "v$palf", "gv$memory", "v$dbms_jobs")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("vt")
    mp = pytest.MonkeyPatch()
    for mod in (jelection, telection):
        mp.setattr(mod.ElectionProposer, "lease_valid", lambda self: True)
    dbs = []
    for name, cls, kw in (("jax", JDatabase, {}),
                          ("port", Database, {"device": "cpu"})):
        d = root / name
        d.mkdir()
        (d / "config.json").write_text(
            json.dumps({"enable_calibration": False}))
        dbs.append(cls(str(d), **kw))
    j, t = dbs
    jm.reset()
    tm.reset()
    js, ts = j.session(), t.session()
    for sql in _SCRIPT:
        align_colids()
        js.execute(sql)
        align_colids()
        ts.execute(sql)
    # the views as the script left them, read before any later
    # statement of this module runs on one package only
    stats = [{n: d.virtual_tables.provide(n) for n in _SNAPSHOT}
             for d in (j, t)]
    yield j, t, stats
    j.close()
    t.close()
    mp.undo()


def test_the_port_serves_the_reference_names(pair):
    j, t, _stats = pair
    assert set(t.virtual_tables.names()) == set(j.virtual_tables.names())


def _schema(arrays):
    return [(k, np.asarray(v).dtype.kind) for k, v in arrays.items()]


_NAMES = sorted([
    "gv$sql_audit", "gv$plan_monitor", "gv$sql_plan_monitor",
    "gv$plan_feedback", "gv$plan_history", "gv$plan_choice",
    "gv$plan_cache", "gv$cost_units", "gv$time_calibration",
    "gv$device_profile", "gv$trace", "gv$active_session_history",
    "gv$system_event", "v$wait_events", "gv$sysstat",
    "gv$sysstat_histogram", "gv$time_model", "v$session_history",
    "v$sql_workarea", "v$parameters", "v$tenants", "v$tables", "v$palf",
    "v$kvcache", "gv$memory", "gv$recovery", "gv$tenant_resource",
    "gv$backend", "v$dbms_jobs", "information_schema.tables",
    "information_schema.columns", "gv$px_exchange",
    "gv$cluster_health", "gv$disk"])


@pytest.mark.parametrize("name", _NAMES)
def test_view_schema_equals_the_reference(pair, name):
    j, t, _stats = pair
    want = j.virtual_tables.provide(name)
    got = t.virtual_tables.provide(name)
    assert list(got) == list(want)
    n_want = len(next(iter(want.values()))) if want else 0
    n_got = len(next(iter(got.values()))) if got else 0
    if n_want and n_got:
        # an empty list gives numpy's default dtype: compare kinds only
        # where both views have rows
        assert _schema(got) == _schema(want)
    # the SQL face answers with the same columns
    r = t.session().execute(f"select * from {name}")
    assert r.names == list(want)


@pytest.mark.parametrize("name", ["gv$px_exchange", "gv$cluster_health",
                                  "gv$disk"])
def test_single_node_subsystem_views_are_empty(pair, name):
    """No DTL exchange or failure detector on one node: the port's
    views are empty, as the reference's are without those subsystems.
    Both single-node databases boot a disk manager per tenant, so
    gv$disk has the same rows in both (the used bytes and utilization
    are each package's own files and are left out)."""
    j, t, _stats = pair
    arrays = t.virtual_tables.provide(name)
    want = j.virtual_tables.provide(name)
    if name == "gv$disk":
        cols = [c for c in want if c not in ("used_bytes", "utilization")]
        assert _rows(arrays, cols) == _rows(want, cols)
        assert len(arrays["tenant"]) == 3   # log, data, spill of sys
        return
    assert all(len(v) == 0 for v in arrays.values())
    assert all(len(v) == 0 for v in want.values())


def _rows(arrays, cols=None):
    cols = list(arrays) if cols is None else cols
    n = len(arrays[cols[0]]) if cols else 0
    return [tuple(np.asarray(arrays[c])[i].item()
                  if hasattr(np.asarray(arrays[c])[i], "item")
                  else arrays[c][i] for c in cols) for i in range(n)]


@pytest.mark.parametrize("name,cols", [
    ("v$tables", None),
    ("information_schema.tables", None),
    ("information_schema.columns", None),
    ("v$tenants", None),
    ("v$palf", None),
    ("gv$memory", None),
    ("gv$tenant_resource", ["tenant", "slots_total", "queue_limit",
                            "weight", "admitted", "queued", "rejected",
                            "kills", "timeouts", "large_slots"]),
    ("v$dbms_jobs", ["job_name", "interval_s", "runs", "failures"]),
    ("gv$plan_monitor", ["logical_hash", "op_pos", "operator", "est_rows",
                         "output_rows", "q_error", "capacity_retries",
                         "spill_bytes", "path"]),
    ("gv$plan_feedback", ["kind", "logical_hash", "op_pos", "operator",
                          "est_rows", "observed_rows", "q_error"]),
    ("gv$sql_audit", ["sql", "session_id", "tenant", "rows_returned",
                      "error"]),
])
def test_deterministic_view_values_equal_the_reference(pair, name, cols):
    _j, _t, stats = pair
    want = _rows(stats[0][name], cols)
    got = _rows(stats[1][name], cols)
    assert got == want and want


def test_parameters_equal_the_reference(pair):
    j, t, _stats = pair
    cols = ["name", "value", "default_value", "type"]
    want = {r[0]: r for r in _rows(j.virtual_tables.provide(
        "v$parameters"), cols)}
    got = _rows(t.virtual_tables.provide("v$parameters"), cols)
    assert got and all(r == want[r[0]] for r in got)


def test_sysstat_counters_equal_the_reference(pair):
    _j, _t, stats = pair
    names = ("sql.statements", "sql.rows_returned", "plan.compiles",
             "plan.executions", "plan_cache.hits", "plan_cache.misses",
             "admission.admitted", "palf.appends",
             "palf.entries_appended", "palf.entries_applied")

    def flat(a):
        return {s: v for s, n, v in zip(a["stat_name"], a["name"],
                                        a["value"]) if n in names}

    want, got = flat(stats[0]["gv$sysstat"]), flat(stats[1]["gv$sysstat"])
    assert got == want and want


@pytest.mark.parametrize("name,item", sorted(_UNPORTED.items()))
def test_unported_views_name_their_item(pair, name, item):
    """The views the durability plane's sub-item ported are served now,
    with the reference's columns through the provider and through SQL
    (their rows are held against the reference's in
    tests/test_torch_{scrub,errsim,workload}.py)."""
    j, t, _stats = pair
    want = j.virtual_tables.provide(name)
    got = t.virtual_tables.provide(name)
    assert list(got) == list(want), item
    r = t.session().execute(f"select * from {name}")
    assert r.names == list(want), item


def test_show_tables_lists_the_views(pair):
    _j, t, _stats = pair
    names = {r[0] for r in t.session().execute("show tables").rows()}
    assert {"t", "u"} <= names
    assert set(t.virtual_tables.names()) <= names


def test_view_over_virtual_table_refreshes(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    s.execute("create table t (a int primary key)")
    s.execute("create view recent_sql as select sql from gv$sql_audit")
    n1 = s.execute("select count(*) from recent_sql").rows()[0][0]
    s.execute("insert into t values (1)")
    n2 = s.execute("select count(*) from recent_sql").rows()[0][0]
    assert n2 > n1
    # DESCRIBE reads the view's columns through the refreshed table
    assert [r[0] for r in s.execute("describe gv$trace").rows()][:2] == \
        ["trace_id", "span_id"]
    db.close()
