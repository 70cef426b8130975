"""The statement surface of the port's ``Database`` for changing data,
against the JAX package's on the CPU: REPLACE INTO, TRUNCATE with the
AUTO_INCREMENT reset (``test_truncate_replace.py``), AUTO_INCREMENT
(``test_using_autoinc.py``, ``test_partition_review_fixes.py``),
sequences, table locks and the KV front end (``test_satellites.py``),
SAVEPOINT (``test_savepoints.py``), XA (``test_xa.py``), ALTER TABLE
(``test_alter_table.py``) and parallel DML (``test_pdml.py``), then one
script mixing them whose decoded WAL payloads and engine meta equal the
reference's and whose reads equal SQLite's."""

import json
import sqlite3
import sys
import threading
import time

import pytest

from oceanbase_tpu.tx.errors import DuplicateKey as JDuplicateKey
from oceanbase_tpu.tx.tablelock import DeadlockDetected as JDeadlock
from oceanbase_tpu.tx.tablelock import LockTable as JLockTable
from oceanbase_tpu_torch.bench.oracle import rows_match
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.tx.errors import WriteConflict
from oceanbase_tpu_torch.tx.tablelock import DeadlockDetected, LockTable
from test_torch_database import Pair, _wal


def _payloads(db) -> list:
    """The decoded WAL records but the leader's no-op entries, which an
    election appends whenever a slow step lets the lease lapse."""
    return [r for r in _wal(db) if r["op"] != "noop"]


# ---------------------------------------------------------------------------
# REPLACE, TRUNCATE, AUTO_INCREMENT, sequences
# ---------------------------------------------------------------------------


def test_replace_into(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 10)")
    assert p.run("insert into t values (1, 20)") == ("error", "DuplicateKey")
    p.run("replace into t values (1, 20), (2, 22)")
    assert p.rows("select k, v from t order by k") == [(1, 20), (2, 22)]
    for db in (p.t, p.j):
        db.checkpoint()
    p.run("replace into t values (1, 30)")  # over a flushed row
    assert p.rows("select v from t where k = 1") == [(30,)]
    # within one statement the last row wins; own-tx writes count
    p.run("replace into t values (5, 1), (5, 2)")
    p.run("begin")
    p.run("insert into t values (7, 70)")
    p.run("replace into t values (7, 71)")
    p.run("commit")
    assert p.rows("select k, v from t order by k") == \
        [(1, 30), (2, 22), (5, 2), (7, 71)]
    assert _payloads(p.t) == _payloads(p.j)  # the same insert/update kinds
    p.close()


def test_truncate_resets_auto_increment(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (id int primary key auto_increment, v int)")
    p.run("insert into t (v) values (1), (2), (3)")
    p.run("truncate table t")
    p.run("insert into t (v) values (9)")
    assert p.rows("select id, v from t") == [(1, 9)]
    p.close()


def test_auto_increment(tmp_path):
    """Omitted ids count up, an explicit id advances the counter, and
    the counter survives a checkpointed restart."""
    p = Pair(tmp_path)
    p.run("create table t (id int primary key auto_increment, "
          "name varchar(10))")
    p.run("insert into t (name) values ('a'), ('b')")
    p.run("insert into t values (100, 'x')")
    p.run("insert into t (name) values ('c')")
    assert p.rows("select id, name from t order by id") == \
        [(1, "a"), (2, "b"), (100, "x"), (101, "c")]
    for db in (p.t, p.j):
        db.checkpoint()
    p.close()
    p.open()
    p.run("insert into t (name) values ('d')")
    p.run("select id, name from t order by id")
    assert p.t.engine.meta["sequences"] == p.j.engine.meta["sequences"]
    p.close()


def test_auto_increment_survives_a_crash(tmp_path):
    """ROADMAP Queue 3 #15: without a checkpoint the reference forgets
    the counter of a table created since the last one, and the next
    omitted-id INSERT collides with a WAL-replayed row; the port slogs
    the high-water mark and hands out a fresh id (MySQL may skip ids
    after a crash; it never repeats one)."""
    p = Pair(tmp_path)
    p.run("create table t (id int primary key auto_increment, v int)")
    p.run("insert into t (v) values (1), (2)")
    p.close()  # no checkpoint
    p.open()
    assert p.js[0].execute("select count(*) from t").rows() == [(2,)]
    with pytest.raises(JDuplicateKey):
        p.js[0].execute("insert into t (v) values (3)")
    p.ts[0].execute("insert into t (v) values (3)")
    ids = [r[0] for r in p.ts[0].execute("select id from t order by id"
                                         ).rows()]
    assert ids[:2] == [1, 2] and len(set(ids)) == 3 and ids[2] > 2
    p.close()


def test_sequences(tmp_path):
    p = Pair(tmp_path)
    p.run("create sequence sq start 100 increment 2 cache 10")
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (nextval('sq'), 1), (nextval('sq'), 2)")
    assert p.rows("select k from t order by k") == [(100,), (102,)]
    assert p.rows("select nextval('sq') as v") == [(104,)]
    p.run("explain select nextval('sq') as v")  # peeks, never advances
    assert p.rows("select nextval('sq') as v") == [(106,)]
    for db in (p.t, p.j):
        db.checkpoint()
    p.close()
    p.open()
    # resumed past the persisted high-water mark (the cached range)
    assert p.rows("select nextval('sq') as v") == [(120,)]
    p.run("drop sequence sq")
    assert p.run("select nextval('sq') as v")[0] == "error"
    p.close()


def test_kv_api(tmp_path):
    p = Pair(tmp_path)
    p.run("create table kvt (k int primary key, v varchar(20), n int)")
    for db in (p.t, p.j):
        kv = db.tenant().kv("kvt")
        kv.put({"k": 1, "v": "one", "n": 10})
        kv.put({"k": 2, "v": "two", "n": 20})
        kv.put({"k": 1, "v": "uno", "n": 11})
        db.checkpoint()
        assert kv.get(2)["n"] == 20 and kv.delete(2) and not kv.delete(2)
        assert kv.scan() == [{"k": 1, "v": "uno", "n": 11}]
    assert p.t.tenant().kv("kvt").live_keys([1, 2, 3]) == {(1,)}
    assert p.rows("select v from kvt") == [("uno",)]
    assert _payloads(p.t) == _payloads(p.j)
    p.close()


# ---------------------------------------------------------------------------
# table locks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_table_locks_and_deadlock(pkg):
    lock_table, deadlock = ((LockTable, DeadlockDetected) if pkg == "torch"
                            else (JLockTable, JDeadlock))
    lt = lock_table()
    lt.acquire("a", "X", tx_id=1)
    lt.acquire("b", "X", tx_id=2)
    results = {}

    def t2():
        try:
            lt.acquire("a", "X", tx_id=2, timeout=5)
            results["t2"] = "ok"
        except Exception as e:  # noqa: BLE001
            results["t2"] = type(e).__name__

    th = threading.Thread(target=t2, daemon=True)
    th.start()
    time.sleep(0.1)
    with pytest.raises(deadlock):
        lt.acquire("b", "X", tx_id=1)
    lt.release_all(1)  # the victim releases; t2 proceeds
    th.join(timeout=5)
    assert results["t2"] == "ok"
    lt2 = lock_table()
    lt2.acquire("t", "S", 10)
    lt2.acquire("t", "S", 11)  # shared locks coexist
    with pytest.raises(Exception, match="lock wait timeout"):
        lt2.acquire("t", "X", 12, timeout=0.2)


def test_lock_tables_sql(tmp_path):
    """LOCK TABLES t WRITE makes a second session's LOCK TABLES and DML
    wait (at most ``lock_wait_timeout_s``), then proceed after UNLOCK
    TABLES."""
    db = Database(str(tmp_path / "db"), device="cpu")
    s1, s2 = db.session(), db.session()
    s1.execute("set global lock_wait_timeout_s = 0.3")
    s1.execute("create table t (k int primary key)")
    s1.execute("lock tables t write")
    t0 = time.monotonic()
    with pytest.raises((WriteConflict, DeadlockDetected)):
        s2.execute("lock tables t write")
    s2.execute("rollback")  # ends the implicit transaction it began
    with pytest.raises(WriteConflict, match="lock wait timeout"):
        s2.execute("insert into t values (1)")
    assert time.monotonic() - t0 < 5
    done = {}

    def write():
        s2.execute("insert into t values (2)")
        done["at"] = time.monotonic()

    db.config.set("lock_wait_timeout_s", 10)
    th = threading.Thread(target=write, daemon=True)
    th.start()
    time.sleep(0.3)
    assert "at" not in done
    released = time.monotonic()
    s1.execute("unlock tables")
    th.join(timeout=10)
    assert done["at"] >= released
    assert s1.execute("select k from t").rows() == [(2,)]
    s2.execute("lock tables t read")
    s2.execute("unlock tables")
    db.close()


def test_lock_tables_dml_waits_in_both(tmp_path):
    """The implicit IX lock of DML honours another session's LOCK TABLES
    WRITE in both packages: the write times out, the lock's holder
    writes, and after COMMIT the other session writes."""
    p = Pair(tmp_path, n=2)
    p.run("set global lock_wait_timeout_s = 0.2")
    p.run("create table t (k int primary key, v int)")
    p.run("lock tables t write")
    assert p.run("insert into t values (1, 1)", 1) == \
        ("error", "WriteConflict")
    p.run("insert into t values (2, 2)")
    p.run("commit")
    p.run("insert into t values (1, 1)", 1)
    assert p.rows("select k, v from t order by k") == [(1, 1), (2, 2)]
    p.close()


# ---------------------------------------------------------------------------
# SAVEPOINT and XA
# ---------------------------------------------------------------------------


def test_savepoint_rollback_to(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("begin")
    p.run("insert into t values (1, 10)")
    p.run("savepoint sp1")
    p.run("insert into t values (2, 20)")
    p.run("update t set v = 99 where k = 1")
    assert p.rows("select sum(v) from t") == [(119,)]
    p.run("rollback to savepoint sp1")
    assert p.rows("select k, v from t order by k") == [(1, 10)]
    p.run("insert into t values (3, 30)")
    p.run("commit")
    assert p.rows("select k, v from t order by k") == [(1, 10), (3, 30)]
    assert _payloads(p.t) == _payloads(p.j)
    p.close()


def test_savepoint_release_and_nesting(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("begin")
    p.run("insert into t values (1, 1)")
    p.run("savepoint a")
    p.run("insert into t values (2, 2)")
    p.run("savepoint b")
    p.run("insert into t values (3, 3)")
    p.run("rollback to a")
    assert p.run("rollback to b") == ("error", "KeyError")  # destroyed
    p.run("commit")
    assert p.rows("select count(*) from t") == [(1,)]
    p.run("begin")
    p.run("savepoint x")
    p.run("release savepoint x")
    assert p.run("rollback to x") == ("error", "KeyError")
    p.run("rollback")
    assert p.run("savepoint y") == ("error", "RuntimeError")  # no tx
    p.close()


def test_savepoint_with_secondary_index(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("create unique index iv on t (v)")
    p.run("begin")
    p.run("insert into t values (1, 100)")
    p.run("savepoint sp")
    p.run("insert into t values (2, 200)")
    p.run("rollback to sp")
    p.run("insert into t values (3, 200)")  # the value is free again
    p.run("commit")
    assert p.rows("select k from t where v = 200") == [(3,)]
    p.close()


def test_xa_prepare_commit_across_sessions(tmp_path):
    p = Pair(tmp_path, n=2)
    p.run("create table t (k int primary key, v int)")
    p.run("xa start 'x1'")
    p.run("insert into t values (1, 10)")
    p.run("xa end 'x1'")
    p.run("xa prepare 'x1'")
    assert p.rows("select count(*) from t", 1) == [(0,)]
    assert p.rows("xa recover", 1) == [("x1",)]
    p.run("xa commit 'x1'", 1)  # another session drives the commit
    assert p.rows("select k, v from t", 1) == [(1, 10)]
    assert p.rows("xa recover", 1) == []
    assert _payloads(p.t) == _payloads(p.j)
    p.close()


def test_xa_rollback_errors_and_guards(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    for sql in ("xa start 'r1'", "insert into t values (1, 1)",
                "xa end 'r1'", "xa prepare 'r1'", "xa rollback 'r1'",
                "xa start 'r1'", "insert into t values (2, 2)",
                "xa end 'r1'", "xa commit 'r1'"):
        p.run(sql)
    assert p.rows("select k from t") == [(2,)]
    assert p.run("xa commit 'nope'") == ("error", "KeyError")
    p.run("xa start 'a'")
    assert p.run("xa start 'b'") == ("error", "RuntimeError")
    p.run("insert into t values (3, 3)")
    assert p.run("commit") == ("error", "RuntimeError")  # XA branch
    p.run("xa end 'a'")
    p.run("xa prepare 'a'")
    p.run("insert into t values (99, 99)")  # the session is not wedged
    p.run("xa commit 'a'")
    p.run("xa start 'g2'")
    p.run("insert into t values (4, 4)")
    p.run("xa end 'g2'")
    p.run("xa commit 'g2' one phase")
    assert p.rows("select k from t order by k") == \
        [(2,), (3,), (4,), (99,)]
    p.close()


def test_xa_prepared_branch_survives_restart(tmp_path):
    """Durable XA: a branch prepared before a crash is listed by XA
    RECOVER after the restart and commits from there."""
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("xa start 'd1'")
    p.run("insert into t values (7, 70)")
    p.run("xa end 'd1'")
    p.run("xa prepare 'd1'")
    p.close()
    p.open()
    assert p.rows("xa recover") == [("d1",)]
    assert p.rows("select count(*) from t") == [(0,)]
    p.run("xa commit 'd1'")
    assert p.rows("select k, v from t") == [(7, 70)]
    p.close()


# ---------------------------------------------------------------------------
# ALTER TABLE
# ---------------------------------------------------------------------------


def test_add_column_over_existing_segments(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 10), (2, 20)")
    for db in (p.t, p.j):
        db.checkpoint()  # the old rows live in a segment without it
    p.run("alter table t add column note varchar(20)")
    p.run("insert into t values (3, 30, 'hello')")
    assert p.rows("select k, v, note from t order by k") == \
        [(1, 10, None), (2, 20, None), (3, 30, "hello")]
    p.run("update t set note = 'old' where k = 1")
    assert p.rows("select note from t where k = 1") == [("old",)]
    # the spill route serves NULLs for the segments that predate it
    p.t.config.set("sql_work_area_rows", 1)
    assert p.ts[0].execute("select note, count(*) from t group by note "
                           "order by note").rows() == \
        [(None, 1), ("hello", 1), ("old", 1)]
    assert p.ts[0].last_spill is not None
    p.t.config.set("sql_work_area_rows", 1 << 22)
    for db in (p.t, p.j):
        db.checkpoint()
    p.close()
    p.open()
    assert p.rows("select k, note from t order by k") == \
        [(1, "old"), (2, None), (3, "hello")]
    p.close()


def test_drop_column(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, a int, b int)")
    p.run("insert into t values (1, 10, 100)")
    for db in (p.t, p.j):
        db.checkpoint()
    p.rows("select * from t")  # a cached relation with the old schema
    p.run("alter table t drop column b")
    assert p.ts[0].execute("select * from t").names == ["k", "a"]
    assert p.run("select b from t")[0] == "error"
    assert p.run("alter table t drop column k") == ("error", "ValueError")
    p.run("alter table t add column b int")  # old values stay gone
    assert p.rows("select b from t") == [(None,)]
    p.close()
    p.open()  # the slog replays both records
    assert p.rows("select * from t") == [(1, 10, None)]
    p.close()


# ---------------------------------------------------------------------------
# parallel DML
# ---------------------------------------------------------------------------

N = 2400


def _pdml_pair(tmp_path):
    p = Pair(tmp_path)
    p.run("alter system set pdml_min_rows = 500")
    p.run("alter system set pdml_dop = 4")
    p.run("create table src (k int primary key, v int, g int)")
    p.run("insert into src values " + ", ".join(
        f"({i}, {i * 3 % 97}, {i % 7})" for i in range(N)))
    return p


def test_pdml_insert_select_update_delete(tmp_path):
    """INSERT ... SELECT into a partitioned table with a secondary index,
    a bulk UPDATE and DELETE, fanned out over the tenant's workers: the
    rows, the index and a WAL-replayed restart equal the reference's."""
    p = _pdml_pair(tmp_path)
    p.run("create table dst (k int primary key, v int, g int) "
          "partition by range (k) (partition p0 values less than (800), "
          "partition p1 values less than (1600), "
          "partition p2 values less than maxvalue)")
    p.run("create index iv on dst (v)")
    assert p.run("insert into dst select k, v, g from src")[1] == N
    p.run("select count(*) from dst where v = 3")
    assert p.run("update dst set v = v + 1000 where g < 5")[1] == \
        sum(1 for i in range(N) if i % 7 < 5)
    assert p.run("delete from dst where g = 6")[1] == N // 7
    want = p.rows("select count(*), sum(v) from dst")
    p.run("select count(*) from dst where v = 1003")
    tw = sorted(json.dumps(r, sort_keys=True) for r in _payloads(p.t))
    jw = sorted(json.dumps(r, sort_keys=True) for r in _payloads(p.j))
    assert tw == jw  # the same records, in the workers' own orders
    p.close()
    p.open()
    assert p.rows("select count(*), sum(v) from dst") == want
    p.close()


def test_pdml_atomicity_on_failure(tmp_path):
    p = _pdml_pair(tmp_path)
    p.run("create table dst (k int primary key, v int, g int)")
    p.run("insert into dst values (2399, -1, 0)")
    assert p.run("insert into dst select k, v, g from src") == \
        ("error", "DuplicateKey")
    assert p.rows("select count(*), sum(v) from dst") == [(1, -1)]
    p.close()


def test_pdml_workers_lose_no_write(tmp_path):
    """More PDML workers than cores writing one transaction, with a
    short thread switch interval: every row, its redo record and its
    participant key arrive exactly once."""
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    s.execute("alter system set tenant_cpu_quota = 16")
    s.execute("alter system set pdml_dop = 16")
    s.execute("alter system set pdml_min_rows = 100")
    db.close()
    db = Database(str(tmp_path / "db"), device="cpu")  # a 16-worker pool
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    n = 3000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        s.execute("begin")
        s.execute("insert into t values " +
                  ", ".join(f"({i}, {i % 13})" for i in range(n)))
        assert len(s._tx.participants["t"].keys) == n
        assert len(s._tx.pending_redo) == n
        s.execute("commit")
    finally:
        sys.setswitchinterval(old)
    assert s.execute("select count(*), sum(v) from t").rows() == \
        [(n, sum(i % 13 for i in range(n)))]
    db.close()


# ---------------------------------------------------------------------------
# one script: WAL payloads and engine meta equal, reads equal SQLite
# ---------------------------------------------------------------------------

# (session, statement, SQLite's statement: "" to skip, None for the same)
SCRIPT = [
    (0, "set global pdml_dop = 1", ""),
    (0, "create table acct (id int primary key, owner varchar(12), "
        "bal decimal(12,2)) partition by range (id) ("
        "partition p0 values less than (100), "
        "partition p1 values less than maxvalue)",
     "create table acct (id int primary key, owner text, bal real)"),
    (0, "create table ev (id int primary key auto_increment, "
        "acct int, amt decimal(12,2))",
     "create table ev (id integer primary key, acct int, amt real)"),
    (0, "create sequence seq start 500", ""),
    (0, "load data infile '{csv}' into table acct fields terminated by '|'",
     ""),
    (0, "replace into acct values (2, 'bo', 25.00), (300, 'zz', 3.00)",
     "replace into acct values (2, 'bo', 25.00), (300, 'zz', 3.00)"),
    (0, "insert into ev (acct, amt) values (1, 10.00), (2, -5.50)", None),
    (0, "insert into ev values (nextval('seq'), 3, 1.25)",
     "insert into ev values (500, 3, 1.25)"),
    (0, "begin", None),
    (0, "update acct set bal = bal - 10.00 where id = 1", None),
    (0, "savepoint s1", None),
    (0, "update acct set id = 150 where id = 3", None),
    (0, "insert into ev (acct, amt) values (150, 0.75)", None),
    (0, "rollback to savepoint s1", "rollback to s1"),
    (0, "update acct set id = 120 where id = 3", None),
    (0, "commit", None),
    (1, "xa start 'b1'", "begin"),
    # AUTO_INCREMENT does not give back the rolled-back id 501 (MySQL);
    # SQLite's INTEGER PRIMARY KEY would
    (1, "insert into ev (acct, amt) values (120, 9.00)",
     "insert into ev values (502, 120, 9.00)"),
    (1, "xa end 'b1'", ""),
    (1, "xa prepare 'b1'", ""),
    (0, "xa recover", ""),
    (0, "xa commit 'b1'", "commit"),
    (0, "alter table acct add column tag varchar(8)",
     "alter table acct add column tag text"),
    (0, "lock tables acct write", ""),
    (0, "update acct set tag = 'vip' where bal > 20", None),
    (0, "unlock tables", ""),
    (0, "select id, owner, bal, tag from acct order by id", None),
    (0, "select id, acct, amt from ev order by id", None),
    (0, "select a.owner, sum(e.amt) from acct a join ev e on a.id = e.acct "
        "group by a.owner", None),
    (0, "truncate table ev", "delete from ev"),
    (0, "insert into ev (acct, amt) values (1, 1.00)", None),
    (0, "select id, acct, amt from ev", None),
]


def test_mixed_script_wal_meta_and_sqlite(tmp_path):
    csv = tmp_path / "acct.tbl"
    csv.write_text("1|ann|100.50\n2|bob|20.00\n3|cy|0.75\n4|\\N|5.25\n")
    p = Pair(tmp_path, n=2)
    lite = sqlite3.connect(":memory:", isolation_level=None)
    for i, sql, lsql in SCRIPT:
        sql = sql.format(csv=csv)
        got = p.run(sql, i)
        assert got[0] == "ok", (sql, got)
        if sql.startswith("load data"):
            lite.executemany("insert into acct values (?, ?, ?)",
                             [(1, "ann", 100.5), (2, "bob", 20.0),
                              (3, "cy", 0.75), (4, None, 5.25)])
        if lsql == "":
            continue
        rows = lite.execute(lsql or sql).fetchall()
        if sql.startswith("select"):
            ok, why = rows_match(got[2], rows, ordered="order by" in sql,
                                 rtol=1e-9)
            assert ok, (sql, why)
    wal = _payloads(p.t)
    assert wal == _payloads(p.j)
    kinds = {r["op"] for r in wal}
    assert {"redo", "commit", "truncate"} <= kinds
    for db in (p.t, p.j):
        db.checkpoint()
    assert p.t.engine.meta == p.j.engine.meta
    p.close()
    p.open()
    for i, sql, _l in SCRIPT[-6:]:
        if sql.startswith("select"):
            p.run(sql, i)
    hwm = p.t.engine.meta["sequences"]["seq"]["hwm"]
    assert p.rows("select nextval('seq') as v") == [(hwm,)]
    p.close()
