"""Two write-boundary faults of the JAX package's ``Database`` the port
repairs, each held beside the reference's wrong answer and SQLite's:

- ROADMAP Queue 3 #13: primary-key uniqueness was checked against the
  active memtable only, so after a flush (or a bulk load) an INSERT of an
  existing key, or an UPDATE moving a key onto one, committed and
  overwrote the row.  The port checks the statement's keys against the
  memtables and the segments (``storage/lookup.py::live_keys``).
- ROADMAP Queue 3 #12: a string written to a DATETIME column committed,
  and every later read and checkpoint of the table failed.  The port
  stores int64 microseconds and refuses what does not parse.

Plus the batched existence test against ``point_lookup``, key by key."""

import sqlite3

import numpy as np
import pytest

from oceanbase_tpu_torch.storage.lookup import live_keys, point_lookup
from oceanbase_tpu_torch.tx.errors import DuplicateKey
from test_torch_database import Pair


def _sqlite(stmts):
    conn = sqlite3.connect(":memory:", isolation_level=None)
    for sql in stmts:
        conn.execute(sql)
    return conn


def _outcome(s, sql):
    try:
        return ("ok", s.execute(sql).rows())
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__)


PARTITIONED = (" partition by range (ok) (partition p0 values less than "
               "(200), partition p1 values less than maxvalue)")


@pytest.mark.parametrize("layout", ["plain", "partitioned", "loaded"])
def test_duplicate_key_after_flush(tmp_path, layout):
    """#13: after the rows reach a segment (a checkpoint, or LOAD DATA's
    baseline), the reference commits a duplicate INSERT and a key-moving
    UPDATE; the port refuses both, as SQLite does."""
    p = Pair(tmp_path)
    ddl = "create table o (ok int, tp int, primary key (ok))"
    ddl += PARTITIONED if layout == "partitioned" else ""
    p.run(ddl)
    if layout == "loaded":
        path = tmp_path / "o.tbl"
        path.write_text("150|1\n250|2\n")
        p.run(f"load data infile '{path}' into table o "
              f"fields terminated by '|'")
    else:
        p.run("insert into o values (150, 1), (250, 2)")
        for db in (p.t, p.j):
            db.checkpoint()
    lite = _sqlite(["create table o (ok int primary key, tp int)",
                    "insert into o values (150, 1), (250, 2)"])
    with pytest.raises(sqlite3.IntegrityError):
        lite.execute("insert into o values (250, 99)")
    with pytest.raises(sqlite3.IntegrityError):
        lite.execute("update o set ok = 250 where ok = 150")
    want = lite.execute("select * from o order by ok").fetchall()

    js, ts = p.js[0], p.ts[0]
    assert _outcome(ts, "insert into o values (250, 99)") == \
        ("error", "DuplicateKey")
    assert _outcome(ts, "update o set ok = 250 where ok = 150") == \
        ("error", "DuplicateKey")
    assert ts.execute("select * from o order by ok").rows() == want == \
        [(150, 1), (250, 2)]
    # the reference moves 150 onto 250 (one row left), then, flushed
    # again, overwrites row 250
    assert _outcome(js, "update o set ok = 250 where ok = 150")[0] == "ok"
    assert js.execute("select * from o order by ok").rows() == [(250, 1)]
    p.j.checkpoint()
    assert _outcome(js, "insert into o values (250, 99)")[0] == "ok"
    assert js.execute("select * from o order by ok").rows() == [(250, 99)]
    # a new key still inserts, a key freed by DELETE can be reused, and
    # keys that shift within one UPDATE follow the memtable's row order
    ts.execute("insert into o values (300, 3)")
    ts.execute("delete from o where ok = 150")
    ts.execute("insert into o values (150, 7)")
    assert ts.execute("update o set ok = ok + 1 where ok >= 300"
                      ).rowcount == 1
    assert ts.execute("select * from o order by ok").rows() == \
        [(150, 7), (250, 2), (301, 3)]
    p.close()


def test_duplicate_key_inside_a_transaction(tmp_path):
    """#13 at a transaction's snapshot: its own delete frees the key, a
    rolled-back statement leaves the transaction usable."""
    p = Pair(tmp_path)
    p.run("create table o (ok int primary key, tp int)")
    p.run("insert into o values (1, 1), (2, 2)")
    for db in (p.t, p.j):
        db.checkpoint()
    ts = p.ts[0]
    ts.execute("begin")
    with pytest.raises(DuplicateKey):
        ts.execute("insert into o values (3, 3), (1, 9)")
    ts.execute("delete from o where ok = 1")
    ts.execute("insert into o values (1, 10)")
    ts.execute("commit")
    assert ts.execute("select * from o order by ok").rows() == \
        [(1, 10), (2, 2)]
    p.close()


def test_live_keys_matches_point_lookup(tmp_path):
    """The batched test answers ``point_lookup(k) is not None`` for every
    key: multi-version histories over memtables, frozen memtables, L0
    segments and a bulk-loaded baseline, with deletes, in a plain and a
    partitioned table."""
    from oceanbase_tpu_torch.server.database import Database

    rng = np.random.default_rng(7)
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    for name, part in (("t", ""), ("pt", " partition by range (k) ("
                       "partition p0 values less than (40), partition "
                       "p1 values less than maxvalue)")):
        s.execute(f"create table {name} (k int, g varchar(4), v int, "
                  f"primary key (k, g)){part}")
        db.engine.bulk_load(name, {
            "k": np.arange(0, 60, 2), "g": np.array(["a", "b"] * 15,
                                                    dtype=object),
            "v": np.zeros(30, dtype=np.int64)},
            version=db.tx.gts.get_ts())
        db.catalog.invalidate(name)
        for step in range(4):
            ks = rng.choice(80, size=12, replace=False)
            for k in ks:
                g = "ab"[int(k) % 2]
                if rng.random() < 0.3:
                    s.execute(f"delete from {name} where k = {k}")
                else:
                    s.execute(f"replace into {name} values ({k}, '{g}', "
                              f"{step})")
            if step % 2 == 0:
                db.checkpoint()
        tablet = db.engine.tables[name].tablet
        snap = db.tx.gts.current()
        keys = [(int(k), g) for k in range(-2, 84) for g in ("a", "b")]
        got = live_keys(tablet, keys, snap)
        want = {k for k in keys if point_lookup(tablet, k, snap)
                is not None}
        assert got == want and len(want) > 20
    db.close()


def test_datetime_string_commits_and_reads(tmp_path):
    """#12: the reference stores the DATETIME string, then the table's
    reads and every checkpoint raise; the port stores microseconds, and
    its reads, a range filter and the checkpoint agree with SQLite."""
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, ts datetime, d date)")
    ins = ["insert into t values (1, '1994-01-05 12:00:00', "
           "date '1994-01-05')",
           "insert into t values (2, date '1994-01-06', '1994-01-06')"]
    for sql in ins:
        p.run(sql)  # both commit
    with pytest.raises(ValueError):
        p.js[0].execute("select k, ts, d from t")
    with pytest.raises(ValueError):
        p.j.checkpoint()
    lite = _sqlite(["create table t (k int primary key, ts text, d text)",
                    "insert into t values (1, '1994-01-05 12:00:00', "
                    "'1994-01-05')",
                    "insert into t values (2, '1994-01-06', "
                    "'1994-01-06')"])
    want = lite.execute("select k, ts, d from t order by k").fetchall()
    got = p.ts[0].execute("select k, ts, d from t order by k").rows()
    assert [(k, str(np.datetime64(us, "us")), d) for k, us, d in got] == \
        [(k, str(np.datetime64(ts.replace(" ", "T"), "us")), d)
         for k, ts, d in want]
    q = "select count(*) from t where ts >= '1994-01-05 18:00:00'"
    assert p.ts[0].execute(q).rows() == lite.execute(q).fetchall() == [(1,)]
    # what does not parse is refused before the write
    with pytest.raises(ValueError, match="DATETIME"):
        p.ts[0].execute("insert into t values (3, 'not a time', null)")
    p.t.checkpoint()
    assert p.ts[0].execute("select count(*) from t").rows() == [(2,)]
    p.j.close()
    p.t.close()
