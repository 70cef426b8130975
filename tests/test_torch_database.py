"""The port's ``Database`` against the JAX package's, statement by
statement, on the CPU: the cases of ``tests/test_database.py`` (SQL
through the engine, explicit transactions, a write conflict between two
sessions, crash recovery from the WAL, keyless DML, freeze/flush/compact
visibility), the in-scope cases of ``tests/test_truncate_replace.py`` and
``tests/test_secondary_index.py``, one DML and transaction script whose
decoded WAL payloads (tx ids, commit versions, redo values) and engine
``meta`` are held equal between the two packages and whose reads are
held against SQLite, the primary-key access path of a point UPDATE, and
what stays refused (unported statements and knobs, no CUDA)."""

import json
import sqlite3
import threading
import time

import numpy as np
import pytest
import torch

from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu_torch.bench.oracle import rows_match, run_oracle_stmt
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.sql import Session as TSession
from oceanbase_tpu_torch.tx.errors import DuplicateKey, WriteConflict
from test_torch_sql_frontend import align_colids


def _jdb(root):
    """The reference database, booted with calibration off so both
    packages plan with the default cost units."""
    root.mkdir(parents=True, exist_ok=True)
    cfg = root / "config.json"
    if not cfg.exists():
        cfg.write_text(json.dumps({"enable_calibration": False}))
    return JDatabase(str(root))


def _outcome(s, sql):
    try:
        r = s.execute(sql)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__)
    return ("ok", r.rowcount, r.rows())


class Pair:
    """A JAX and a port database under ``tmp_path``, opened (and
    reopened) together, with ``n`` sessions each."""

    def __init__(self, tmp_path, n=1):
        self.tmp, self.n = tmp_path, n
        self.open()

    def open(self):
        self.j = _jdb(self.tmp / "jax")
        self.t = Database(str(self.tmp / "port"), device="cpu")
        self.js = [self.j.session() for _ in range(self.n)]
        self.ts = [self.t.session() for _ in range(self.n)]

    def close(self):
        self.j.close()
        self.t.close()

    def run(self, sql, i=0, rtol=1e-9):
        align_colids()
        want, got = _outcome(self.js[i], sql), _outcome(self.ts[i], sql)
        assert got[0] == want[0], (sql, got, want)
        if got[0] == "error":
            assert got == want, sql
            return got
        assert got[1] == want[1], (sql, got, want)
        ok, why = rows_match(got[2], want[2],
                             ordered="order by" in sql.lower(), rtol=rtol)
        assert ok, (sql, why)
        return got

    def rows(self, sql, i=0):
        out = self.run(sql, i)
        assert out[0] == "ok", (sql, out)
        return out[2]


# ---------------------------------------------------------------------------
# the cases of tests/test_database.py
# ---------------------------------------------------------------------------


def test_sql_through_storage_engine(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int, name varchar(10))")
    p.run("insert into t values (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'c')")
    assert p.rows("select sum(v) from t") == [(60,)]
    p.run("update t set v = v * 10 where k >= 2")
    p.run("delete from t where k = 1")
    assert p.rows("select k, v from t order by k") == [(2, 200), (3, 300)]
    p.close()


def test_explicit_transactions(tmp_path):
    p = Pair(tmp_path, n=2)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 100)")
    p.run("begin")
    p.run("update t set v = 999 where k = 1")
    assert p.rows("select v from t") == [(999,)]     # own write
    assert p.rows("select v from t", 1) == [(100,)]  # other session
    p.run("rollback")
    assert p.rows("select v from t") == [(100,)]
    p.run("begin")
    p.run("update t set v = 555 where k = 1")
    p.run("commit")
    assert p.rows("select v from t", 1) == [(555,)]
    p.close()


def test_write_conflict_between_sessions(tmp_path):
    p = Pair(tmp_path, n=2)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 1)")
    p.run("begin")
    p.run("update t set v = 2 where k = 1")
    assert p.run("update t set v = 3 where k = 1", 1) == \
        ("error", "WriteConflict")
    with pytest.raises(WriteConflict):
        p.ts[1].execute("update t set v = 3 where k = 1")
    p.js[1].execute("select 1")  # keep the two sides' statement counts
    p.run("commit")
    p.run("update t set v = 3 where k = 1", 1)
    assert p.rows("select v from t") == [(3,)]
    p.close()


def test_crash_recovery_from_wal(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 10), (2, 20)")
    p.run("update t set v = 99 where k = 2")
    p.close()  # no checkpoint: the WAL is the only persistence
    p.open()
    assert p.rows("select k, v from t order by k") == [(1, 10), (2, 99)]
    assert p.t.tenant().replayed_entries > 0
    p.t.checkpoint()
    p.j.checkpoint()
    p.run("insert into t values (3, 30)")
    p.close()  # mixed segment + WAL recovery
    p.open()
    assert p.rows("select k, v from t order by k") == \
        [(1, 10), (2, 99), (3, 30)]
    p.close()


def test_keyless_table_dml(tmp_path):
    p = Pair(tmp_path)
    p.run("create table h (a int, b int)")
    p.run("insert into h values (1, 1), (1, 2), (2, 3)")
    p.run("delete from h where b = 2")
    assert p.rows("select a, b from h order by b") == [(1, 1), (2, 3)]
    p.run("update h set b = b + 10 where a = 1")
    assert p.rows("select a, b from h order by b") == [(2, 3), (1, 11)]
    p.close()


def test_freeze_flush_compact_visibility(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 1), (2, 2)")
    for db in (p.t, p.j):
        db.checkpoint()  # flush to L0
    p.run("update t set v = 20 where k = 2")
    for db in (p.t, p.j):
        db.engine.freeze_and_flush("t", snapshot=db.tx.gts.current())
        db.engine.minor_compact("t")
        db.engine.major_compact("t")
    assert p.rows("select k, v from t order by k") == [(1, 1), (2, 20)]
    p.run("alter system major freeze")
    assert p.rows("select k, v from t order by k") == [(1, 1), (2, 20)]
    assert [s.level for s in p.t.engine.tables["t"].tablet.segments] == \
        [s.level for s in p.j.engine.tables["t"].tablet.segments]
    p.close()


# ---------------------------------------------------------------------------
# the in-scope cases of test_truncate_replace.py and test_secondary_index.py
# ---------------------------------------------------------------------------


def test_truncate_and_recovery(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 1), (2, 2)")
    for db in (p.t, p.j):
        db.checkpoint()
    p.run("insert into t values (3, 3)")
    p.run("truncate table t")
    assert p.rows("select count(*) from t") == [(0,)]
    p.run("insert into t values (9, 9)")
    assert p.rows("select k from t") == [(9,)]
    p.close()  # WAL replay must respect the truncate barrier
    p.open()
    assert p.rows("select k from t") == [(9,)]
    p.close()


def test_truncate_with_open_tx_crash_safe(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("begin")
    p.run("insert into t values (5, 5)")
    p.run("truncate table t")  # implicit commit, then truncate
    assert p.rows("select count(*) from t") == [(0,)]
    p.close()
    p.open()
    assert p.rows("select count(*) from t") == [(0,)]
    p.close()


def test_truncate_refuses_a_table_another_tx_wrote(tmp_path):
    """TRUNCATE of a table another live transaction wrote does not run
    beside it: it waits on the table's exclusive lock (the writer holds
    an intent lock) and truncates after the writer commits, so the
    committed row is truncated too, as in the reference."""
    db = Database(str(tmp_path / "db"), device="cpu")
    s1, s2 = db.session(), db.session()
    s1.execute("create table t (k int primary key, v int)")
    s1.execute("begin")
    s1.execute("insert into t values (1, 1)")
    done = {}

    def truncate():
        s2.execute("truncate table t")
        done["at"] = time.monotonic()

    th = threading.Thread(target=truncate, daemon=True)
    th.start()
    time.sleep(0.3)
    assert "at" not in done  # waiting on the writer's lock
    committed = time.monotonic()
    s1.execute("commit")
    th.join(timeout=20)
    assert done["at"] >= committed
    assert s1.execute("select count(*) from t").rows() == [(0,)]
    db.close()


def test_create_table_as_select(tmp_path):
    p = Pair(tmp_path)
    p.run("create table src (k int primary key, v decimal(10,2), "
          "name varchar(20))")
    p.run("insert into src values (1, 1.50, 'a'), (2, 2.25, 'b'), "
          "(3, 3.00, null)")
    assert p.run("create table dst as select k, v * 2 as v2, name "
                 "from src where k >= 2")[1] == 2
    assert p.rows("select k, v2, name from dst order by k") == \
        [(2, 4.5, "b"), (3, 6.0, None)]
    p.run("create table agg as select name, count(*) as n from src "
          "group by name")
    assert p.rows("select sum(n) from agg") == [(3,)]
    p.close()


def _index_entries(db, store):
    arrays, _ = db.engine.tables[store].tablet.snapshot_arrays(
        db.tx.gts.current())
    cols = db.engine.tables[store].tablet.key_cols
    return sorted(zip(*(arrays[c].tolist() for c in cols)))


def test_create_index_backfill_and_lookup(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int, w int)")
    for i in range(50):
        p.run(f"insert into t values ({i}, {i % 7}, {i * 10})")
    p.run("create index iv on t (v)")
    assert p.t.engine.tables["__idx__t__iv"].tablet.key_cols == ["v", "k"]
    assert [r[0] for r in p.rows("select k from t where v = 3 order by k")] \
        == [3, 10, 17, 24, 31, 38, 45]
    assert _index_entries(p.t, "__idx__t__iv") == \
        _index_entries(p.j, "__idx__t__iv")
    p.close()


def test_index_maintained_by_dml_and_restart(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("create index iv on t (v)")
    p.run("insert into t values (1, 10), (2, 20), (3, 10)")
    p.run("update t set v = 99 where k = 2")
    p.run("delete from t where k = 3")
    assert _index_entries(p.t, "__idx__t__iv") == [(10, 1), (99, 2)]
    for db in (p.t, p.j):
        db.checkpoint()
    p.run("insert into t values (4, 99)")  # WAL-only at the crash
    p.close()
    p.open()
    assert [ix.name for ix in p.t.engine.tables["t"].tdef.indexes] == ["iv"]
    p.run("insert into t values (5, 20)")
    assert _index_entries(p.t, "__idx__t__iv") == \
        _index_entries(p.j, "__idx__t__iv") == \
        [(10, 1), (20, 5), (99, 2), (99, 4)]
    p.close()


def test_unique_indexes(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, email varchar(64))")
    p.run("insert into t values (1, 'a@x'), (2, 'b@x')")
    p.run("create unique index ue on t (email)")
    assert p.run("insert into t values (3, 'a@x')") == \
        ("error", "DuplicateKey")
    p.run("insert into t values (4, null)")  # NULLs never conflict
    p.run("insert into t values (5, null)")
    assert p.run("update t set email = 'b@x' where k = 1") == \
        ("error", "DuplicateKey")
    assert p.rows("select count(*) from t") == [(4,)]
    p.run("create table u (k int primary key, v int)")
    p.run("insert into u values (1, 5), (2, 5)")
    assert p.run("create unique index uv on u (v)") == \
        ("error", "DuplicateKey")
    assert p.t.engine.tables["u"].tdef.indexes == []
    p.run("create table w (k int primary key, v int, e varchar(10), "
          "index iv (v), unique key ue (e))")
    assert sorted(ix.name for ix in p.t.engine.tables["w"].tdef.indexes) \
        == ["iv", "ue"]
    text = p.ts[0].execute("show create table w").rows()[0][1]
    assert "KEY iv (v)" in text and "UNIQUE KEY ue (e)" in text
    assert "w" in [r[0] for r in p.ts[0].execute("show tables").rows()]
    assert not any(r[0].startswith("__idx__")
                   for r in p.ts[0].execute("show tables").rows())
    assert p.run("insert into w values (1, 1, 'x'), (2, 2, 'x')") == \
        ("error", "DuplicateKey")
    p.close()


def test_drop_and_truncate_indexes(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("create unique index uv on t (v)")
    p.run("insert into t values (1, 10)")
    p.run("truncate table t")
    p.run("insert into t values (2, 10)")  # the old entry is gone
    assert _index_entries(p.t, "__idx__t__uv") == [(10, 2)]
    p.run("drop index uv on t")
    assert "__idx__t__uv" not in p.t.engine.tables
    p.run("drop index if exists uv on t")
    assert p.run("drop index uv on t") == ("error", "KeyError")
    p.close()


def test_bulk_load_maintains_and_checks_indexes(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("create index iv on t (v)")
    db.engine.bulk_load("t", {"k": np.arange(100, dtype=np.int64),
                              "v": np.arange(100, dtype=np.int64) % 5},
                        version=db.tx.gts.current())
    db.catalog.invalidate("t")
    assert s.execute("select count(*) from t where v = 2").rows() == [(20,)]
    assert db.engine.tables["__idx__t__iv"].tablet.row_count_estimate() == 100
    s.execute("create table u (k int primary key, v int)")
    s.execute("create unique index uv on u (v)")
    s.execute("insert into u values (1, 5)")
    with pytest.raises(DuplicateKey):
        db.engine.bulk_load("u", {"k": np.array([2]), "v": np.array([5])},
                            version=db.tx.gts.current())
    db.engine.bulk_load("u", {"k": np.array([1]), "v": np.array([5])},
                        version=db.tx.gts.current())
    db.close()


def test_create_index_waits_for_inflight_tx(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s1, s2 = db.session(), db.session()
    s1.execute("create table t (k int primary key, v int)")
    s1.execute("begin")
    s1.execute("insert into t values (1, 10)")
    done = {}

    def build():
        s2.execute("create index iv on t (v)")
        done["t1"] = time.time()

    th = threading.Thread(target=build)
    th.start()
    time.sleep(0.3)
    assert "t1" not in done  # still draining
    s1.execute("commit")
    th.join(timeout=10)
    assert "t1" in done
    assert s1.execute("select k from t where v = 10").rows() == [(1,)]
    assert _index_entries(db, "__idx__t__iv") == [(10, 1)]
    db.close()


# ---------------------------------------------------------------------------
# one script: WAL payloads, commit versions and engine meta equal across
# the packages, reads equal to SQLite
# ---------------------------------------------------------------------------

SCRIPT = [
    (0, "create table acct (id int primary key, owner varchar(12), "
        "bal decimal(12,2), opened date)"),
    (0, "create table hist (id int, acct int, amt decimal(12,2))"),
    (0, "insert into acct values (1, 'ann', 100.50, '2020-01-02'), "
        "(2, 'bob', 20.00, '2021-03-04'), (3, 'cy', 0.75, '2019-12-31'), "
        "(4, null, 5.25, null)"),
    (0, "begin"),
    (0, "update acct set bal = bal - 10.25 where id = 1"),
    (0, "insert into hist values (1, 1, -10.25)"),
    (0, "update acct set bal = bal + 10.25 where id = 2"),
    (0, "insert into hist values (2, 2, 10.25)"),
    (0, "select id, bal from acct order by id"),
    (0, "commit"),
    (1, "begin"),
    (1, "update acct set owner = 'zed' where id = 3"),
    (1, "delete from acct where id = 4"),
    (1, "select count(*) from acct"),
    (1, "rollback"),
    (0, "update acct set owner = 'dee', bal = bal * 2 where bal < 10"),
    (0, "delete from hist where amt < 0"),
    (0, "insert into acct select id + 10, owner, bal, opened from acct "
        "where id <= 2"),
    (0, "create view rich as select id, bal from acct where bal > 50"),
    (0, "select id, owner, bal, opened from acct order by id"),
    (0, "select owner, count(*), sum(bal) from acct group by owner"),
    (0, "select a.owner, h.amt from acct a join hist h on a.id = h.acct"),
    (0, "select id from rich order by id"),
]


def _wal(db):
    ldr = db.wal.replicas[db.wal.leader_id]
    return [json.loads(e.payload) for e in ldr.entries[:ldr.committed_lsn]]


def test_script_wal_meta_and_sqlite(tmp_path):
    p = Pair(tmp_path, n=2)
    conn = sqlite3.connect(":memory:", isolation_level=None)
    for i, sql in SCRIPT:
        got = p.run(sql, i)
        assert got[0] == "ok", (sql, got)
        if sql.startswith("create view") or sql.startswith("create table"):
            conn.execute(sql.replace("date)", "text)"))
            continue
        want, _n = run_oracle_stmt(conn, sql)
        if sql.startswith("select"):
            ok, why = rows_match(got[2], want,
                                 ordered="order by" in sql, rtol=1e-9)
            assert ok, (sql, why)
    wal = _wal(p.t)
    assert wal == _wal(p.j)
    commits = [r["version"] for r in wal if r["op"] == "commit"]
    assert commits == sorted(commits) and len(commits) == 5
    # the rolled-back transaction never reached the WAL
    assert not any(r["op"] == "redo" and r["values"].get("owner") == "zed"
                   for r in wal)
    for db in (p.t, p.j):
        db.checkpoint()
    assert p.t.engine.meta == p.j.engine.meta
    p.close()
    p.open()  # recovery from segments + checkpoint reads the same
    p.run("select id, owner, bal, opened from acct order by id")
    p.run("select id from rich order by id")
    p.close()


# ---------------------------------------------------------------------------
# the access path, the device, and what stays refused
# ---------------------------------------------------------------------------


def test_point_update_takes_the_primary_key_path(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    n = 200_000
    db.catalog.load_numpy("big", {"k": np.arange(n), "v": np.arange(n) % 97},
                          primary_key=["k"])
    full = db.catalog.table_data("big")
    assert full.device.type == "cpu"
    assert s.execute("update big set v = -1 where k = 123456").rowcount == 1
    choice = s.last_access_paths["big"]
    assert choice.kind == "primary" and choice.est_rows <= 4
    # the relation it evaluated is the key's candidate row at the floor
    # bucket (decoded from one zone-map-pruned chunk), not the table
    assert s.last_dml_capacity == 64 < full.capacity
    assert s.execute("select v from big where k = 123456").rows() == [(-1,)]
    assert s.last_access_paths["big"].kind == "primary"
    assert s.execute("select count(*) from big where v = -1").rows() == \
        [(1,)]
    db.close()


@pytest.mark.parametrize("sql,item", [
    ("create vector index iv on t (v)", "items 4 and 8"),
    ("create fulltext index ft on t (g)", "items 4 and 8"),
    ("create vector index if not exists iv on t (k)", "items 4 and 8"),
])
def test_unported_statements_raise_with_a_database(tmp_path, sql, item):
    """The vector and fulltext index DDL of ROADMAP Queue 1 ``item``
    against the reference's: the same outcome (a
    VECTOR or string column takes its index, an INT column is refused
    with ValueError), the same SHOW INDEX, and nothing half-created; the
    index is replayed from the slog by a reopen."""
    outs = []
    for db in (_jdb(tmp_path / "jax"),
               Database(str(tmp_path / "port"), device="cpu")):
        s = db.session()
        s.execute("create table t (k int primary key, v vector(4), "
                  "g varchar(8))")
        out = [_outcome(s, sql), s.execute("show index from t").rows(),
               s.catalog.tables(), s.catalog.table_def("t").indexes]
        root = db.root
        db.close()
        again = (Database(root, device="cpu") if isinstance(db, Database)
                 else JDatabase(root))
        out.append(again.session().execute("show index from t").rows())
        again.close()
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[1][2] == ["t"] and outs[1][3] == []
    assert outs[1][4] == outs[1][1]
    if "(k)" in sql:
        assert outs[1][0] == ("error", "ValueError")
    else:
        assert outs[1][0] == ("ok", 0, []) and len(outs[1][1]) == 2


def test_unported_knobs_are_refused(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    for sql in ("alter system set tenant_memory_limit = 1",
                "alter system set px_default_dop = 2",
                "alter system set enable_fault_injection = true",
                "set global fault_seed = 1",
                "alter system set enable_dtl_pushdown = false",
                "alter system set health_ping_interval_s = 1"):
        with pytest.raises(KeyError, match="unknown parameter"):
            s.execute(sql)
    s.execute("alter system set sql_work_area_rows = 4096")
    s.execute("set global minor_compact_trigger = 2")
    s.execute("alter system set enable_workload_repo = false")
    s.execute("set global enable_scrub = true")
    names = {r[0] for r in s.execute("show parameters").rows()}
    assert names == {"sql_work_area_rows", "enable_sql_spill",
                     "enable_shape_buckets", "shape_bucket_growth",
                     "shape_bucket_floor", "memstore_limit_rows",
                     "minor_compact_trigger", "kv_cache_limit_bytes",
                     "pdml_min_rows", "pdml_dop", "tenant_cpu_quota",
                     "lock_wait_timeout_s", "enable_plan_cache",
                     "plan_cache_mem_limit", "query_timeout_s",
                     "enable_admission", "admission_slots",
                     "admission_tenant_slots", "admission_queue_limit",
                     "admission_queue_timeout_s",
                     "admission_tenant_weight",
                     "large_query_threshold_s", "admission_large_slots",
                     "enable_dbms_jobs", "stats_gather_interval_s",
                     "auto_compact_interval_s",
                     # the measurement plane's knobs
                     "enable_sql_plan_monitor",
                     "plan_monitor_sample_every", "enable_plan_feedback",
                     "plan_regress_threshold", "plan_feedback_entries",
                     "plan_history_entries", "enable_profiling",
                     "enable_calibration", "enable_metrics",
                     "enable_query_trace", "trace_sample_rate",
                     "trace_slow_threshold_s", "trace_ring_spans",
                     "enable_ash", "ash_sample_interval_ms",
                     "sql_audit_queue_size",
                     # the durability plane's knobs
                     "enable_rate_limit", "memstore_limit_bytes",
                     "writing_throttle_trigger_pct",
                     "writing_throttle_max_sleep_s",
                     "log_disk_limit_bytes", "data_disk_limit_bytes",
                     "spill_disk_limit_bytes",
                     "log_disk_utilization_threshold", "enable_scrub",
                     "scrub_interval_s", "enable_disk_faults",
                     "enable_workload_repo", "workload_snapshot_interval_s",
                     "workload_retention_keep",
                     "workload_retention_max_age_s"}
    # each new knob has the reference's default
    from oceanbase_tpu.server.config import Config as JConfig

    for name in ("enable_rate_limit", "memstore_limit_bytes",
                 "writing_throttle_trigger_pct",
                 "writing_throttle_max_sleep_s", "log_disk_limit_bytes",
                 "data_disk_limit_bytes", "spill_disk_limit_bytes",
                 "log_disk_utilization_threshold", "enable_scrub",
                 "scrub_interval_s", "enable_disk_faults",
                 "enable_workload_repo", "workload_snapshot_interval_s",
                 "workload_retention_keep",
                 "workload_retention_max_age_s"):
        assert JConfig()[name] == db.config[name], name
    db.close()
    db2 = Database(str(tmp_path / "db"), device="cpu")  # persisted
    assert db2.config["sql_work_area_rows"] == 4096
    db2.close()
    (tmp_path / "db" / "config.json").write_text(
        json.dumps({"px_default_dop": 2}))
    with pytest.raises(KeyError, match="unknown parameter"):
        Database(str(tmp_path / "db"), device="cpu")


def test_database_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Database(str(tmp_path / "db"))
    db = Database(str(tmp_path / "db2"), device="cpu")
    s = db.session()
    assert s.device.type == "cpu" and s.db is db
    s.execute("create table t (k int primary key)")
    assert db.catalog.table_data("t").device.type == "cpu"
    db.close()


def test_catalog_only_session_refuses_what_needs_a_database():
    s = TSession(device="cpu")
    for sql in ("create table t (a int, index ia (a))",
                "create table c as select 1 as a", "truncate table x",
                "alter system set sql_work_area_rows = 1"):
        with pytest.raises(NotImplementedError, match="needs a Database"):
            s.execute(sql)
    assert not s.catalog.has_table("t")
    s.execute("create table t (a int)")  # now works
