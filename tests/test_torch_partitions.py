"""RANGE-partitioned tables on the port's ``Database`` against the JAX
package's, on the CPU: the cases of ``tests/test_partitioned_tables.py``
and ``tests/test_partition_review_fixes.py`` (routing, scans, flush and
compaction per partition, recovery, the KV front end and streaming over
partitions, the partition-moving UPDATE, the partition spec checks),
the partition column in the primary key (``test_advice_r2_fixes.py``),
SHOW CREATE TABLE, and string dictionaries that differ per partition
under Q1- and Q3-shaped GROUP BYs, in memory and through the spill
route's chained providers."""

import sqlite3

import numpy as np
import pytest

from oceanbase_tpu.tx.errors import DuplicateKey as JDuplicateKey
from oceanbase_tpu_torch.exec.granule import execute_streamed
from oceanbase_tpu_torch.exec.ops import AggSpec
from oceanbase_tpu_torch.exec.plan import ScalarAgg, TableScan
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.sql.session import Session
from oceanbase_tpu_torch.storage.partition import PartitionedTablet
from oceanbase_tpu_torch.vector import to_numpy
from test_torch_database import Pair

P3 = ("create table t (k int primary key, v int) partition by range (k) ("
      "partition p0 values less than (100), "
      "partition p1 values less than (200), "
      "partition p2 values less than maxvalue)")


def _parts(db, table):
    return db.engine.tables[table].tablet.partitions


def test_partition_routing_and_scan(tmp_path):
    p = Pair(tmp_path)
    p.run(P3)
    assert isinstance(p.t.engine.tables["t"].tablet, PartitionedTablet)
    p.run("insert into t values (50, 1), (150, 2), (250, 3), (99, 4)")
    assert [len(x.active) for x in _parts(p.t, "t")] == \
        [len(x.active) for x in _parts(p.j, "t")] == [2, 1, 1]
    assert p.rows("select k, v from t order by k") == \
        [(50, 1), (99, 4), (150, 2), (250, 3)]
    p.run("update t set v = 20 where k = 150")
    p.run("delete from t where k = 50")
    assert p.rows("select k, v from t order by k") == \
        [(99, 4), (150, 20), (250, 3)]
    p.run("show create table t")
    p.close()


def test_partitioned_flush_compact_recovery(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int) partition by range "
          "(k) (partition p0 values less than (10), "
          "partition p1 values less than maxvalue)")
    p.run("insert into t values " +
          ", ".join(f"({i}, {i})" for i in range(20)))
    for db in (p.t, p.j):
        db.checkpoint()
    assert all(x.segments for x in _parts(p.t, "t"))
    p.run("insert into t values (100, 100)")
    for db in (p.t, p.j):
        db.checkpoint()
        db.engine.major_compact("t")
    assert p.rows("select count(*), sum(v) from t") == [(21, 290)]
    p.close()
    p.open()
    assert [len(x.segments) for x in _parts(p.t, "t")] == \
        [len(x.segments) for x in _parts(p.j, "t")]
    assert p.rows("select count(*), sum(v) from t") == [(21, 290)]
    p.close()


def test_kv_and_streaming_over_partitions(tmp_path):
    p = Pair(tmp_path)
    p.run(P3)
    p.run("insert into t values (50, 1), (150, 2), (250, 3)")
    kv, jkv = p.t.tenant().kv("t"), p.j.tenant().kv("t")
    for k in (150, 250, 999):
        assert kv.get(k) == jkv.get(k)
    assert kv.get(150) == {"k": 150, "v": 2}
    for db in (p.t, p.j):
        db.checkpoint()
    p.run("insert into t values (160, 4)")  # memtable of partition 1
    plan = ScalarAgg(TableScan("t", rename={"k": "k", "v": "v"}),
                     [AggSpec("s", "sum", ir.col("v")),
                      AggSpec("c", "count_star")])
    tablet = p.t.engine.tables["t"].tablet
    out = to_numpy(execute_streamed(
        plan, Session._spill_provider(tablet, p.t.tx.gts.current()),
        chunk_rows=2, device="cpu"))
    assert out["c"][0] == 4 and out["s"][0] == 10
    p.close()


def test_partitioned_bulk_load(tmp_path):
    p = Pair(tmp_path)
    p.run(P3)
    for db in (p.t, p.j):
        db.engine.bulk_load("t", {"k": np.arange(0, 300, 10),
                                  "v": np.arange(30)})
        db.catalog.invalidate("t")
    assert [sum(s.n_rows for s in x.segments) for x in _parts(p.t, "t")] \
        == [10, 10, 10]
    assert p.rows("select count(*), sum(v) from t") == [(30, 435)]
    p.close()


def test_partition_moving_update(tmp_path):
    """The move is a delete in the old partition plus an insert in the
    new one; every read shows the row once, before and after a flush,
    and ``data_version`` (the sum over partitions) moves with it."""
    p = Pair(tmp_path)
    p.run("create table t (k int, v int, primary key (k, v)) "
          "partition by range (v) (partition p0 values less than (100), "
          "partition p1 values less than maxvalue)")
    p.run("insert into t values (1, 50), (2, 60)")
    tab = p.t.engine.tables["t"].tablet
    before = tab.data_version
    p.run("update t set v = 150 where k = 1")
    assert tab.data_version > before
    assert p.rows("select k, v from t order by k") == [(1, 150), (2, 60)]
    assert len(_parts(p.t, "t")[1].active) >= 1
    for db in (p.t, p.j):
        db.checkpoint()
    p.t.config.set("sql_work_area_rows", 1)  # the spill route
    assert p.ts[0].execute("select v, count(*) from t group by v "
                           "order by v").rows() == [(60, 1), (150, 1)]
    assert p.ts[0].last_spill is not None
    p.close()


def test_partial_minor_compact_keeps_other_partitions(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int) partition by range "
          "(k) (partition p0 values less than (100), "
          "partition p1 values less than maxvalue)")
    p.run("insert into t values (1, 1), (200, 2)")
    for db in (p.t, p.j):
        db.checkpoint()
    p.run("insert into t values (2, 3)")
    for db in (p.t, p.j):
        db.checkpoint()
        db.engine.minor_compact("t")  # only partition 0 has two L0s
    p.close()  # no manifest checkpoint: the slog replays the compaction
    p.open()
    assert p.rows("select k from t order by k") == [(1,), (2,), (200,)]
    p.close()


@pytest.mark.parametrize("sql", [
    "create table b1 (k int) partition by range (k) (partition p0 values "
    "less than maxvalue, partition p1 values less than (10))",
    "create table b2 (k int) partition by range (k) (partition p0 values "
    "less than (20), partition p1 values less than (10))",
    "create table p (k int primary key, v int) partition by range (v) ("
    "partition p0 values less than (100), partition p1 values less than "
    "maxvalue)",
])
def test_partition_spec_validation(tmp_path, sql):
    """Bounds out of order and a partition column outside the primary
    key are refused by both packages; nothing is created."""
    p = Pair(tmp_path)
    assert p.run(sql)[0] == "error"
    assert p.t.catalog.tables() == []
    p.close()


def test_keyless_partitioned_table(tmp_path):
    """ROADMAP Queue 3 #14: a keyless partitioned table numbers its
    hidden rowids per partition in the reference, so moving a row into
    a partition that holds the same rowid raises DuplicateKey; the port
    numbers them across partitions and moves it, as SQLite updates."""
    p = Pair(tmp_path)
    p.run("create table q (a int, b int) partition by range (b) ("
          "partition p0 values less than (100), "
          "partition p1 values less than maxvalue)")
    p.run("insert into q values (1, 10), (1, 200)")
    sql = "update q set b = 300 where b = 10"  # moves across partitions
    with pytest.raises(JDuplicateKey):
        p.js[0].execute(sql)
    assert p.ts[0].execute(sql).rowcount == 1
    lite = sqlite3.connect(":memory:")
    lite.execute("create table q (a int, b int)")
    lite.execute("insert into q values (1, 10), (1, 200)")
    lite.execute(sql)
    want = lite.execute("select a, b from q order by b").fetchall()
    assert p.ts[0].execute("select a, b from q order by b").rows() == \
        want == [(1, 200), (1, 300)]
    p.t.checkpoint()
    p.t.close()
    p.j.close()
    p.open()  # the rowids stay distinct across a restart
    p.ts[0].execute("insert into q values (2, 20), (2, 250)")
    assert p.ts[0].execute("update q set b = b + 1").rowcount == 4
    assert p.ts[0].execute("select count(*) from q").rows() == [(4,)]
    p.close()


def test_show_create_table(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (id int primary key auto_increment, "
          "v decimal(10,2) not null, name varchar(20)) "
          "partition by range (id) (partition p0 values less than (100), "
          "partition p1 values less than maxvalue)")
    text = p.rows("show create table t")[0][1]
    assert "AUTO_INCREMENT" in text and "PRIMARY KEY (id)" in text
    assert "PARTITION BY RANGE (id)" in text and "MAXVALUE" in text
    p.close()


def test_string_dictionaries_differ_per_partition(tmp_path):
    """Each partition's segments encode their own dictionaries (flag and
    mode sets differ per partition): Q1- and Q3-shaped GROUP BYs equal
    the reference's in memory, and the spill route, whose dictionary
    pre-pass runs over the chained partitions, gives the same rows."""
    rng = np.random.default_rng(5)
    n = 900
    k = np.arange(n)
    flags = np.where(k < 300, np.array(["A", "N"], dtype=object)[k % 2],
                     np.where(k < 600, np.array(["R", "N"], dtype=object)
                              [k % 2], np.array(["Z", "A"], dtype=object)
                              [k % 2]))
    modes = np.array(["AIR", "MAIL", "SHIP", "RAIL", "TRUCK"],
                     dtype=object)[(k // 300 + k % 3) % 5]
    p = Pair(tmp_path)
    p.run("create table li (ok int, ln int, flag varchar(1), "
          "mode varchar(8), qty int, d date, "
          "primary key (ok, ln)) partition by range (ok) ("
          "partition p0 values less than (300), "
          "partition p1 values less than (600), "
          "partition p2 values less than maxvalue)")
    p.run("create table od (ok int primary key, prio varchar(12), "
          "d date)")
    cols = {"ok": k, "ln": k % 4, "flag": flags, "mode": modes,
            "qty": rng.integers(100, 5000, n),
            "d": 8000 + rng.integers(0, 400, n).astype(np.int32)}
    od = {"ok": k, "prio": np.array(["1-URGENT", "2-HIGH", "5-LOW"],
                                    dtype=object)[k % 3],
          "d": 8000 + (k % 50).astype(np.int32)}
    for db in (p.t, p.j):
        db.engine.bulk_load("li", cols, version=db.tx.gts.get_ts())
        db.engine.bulk_load("od", od, version=db.tx.gts.get_ts())
        db.catalog.invalidate("li")
        db.catalog.invalidate("od")
    p.run("insert into li values (950, 1, 'Q', 'FOB', 1, '1992-01-01')")
    q1 = ("select flag, mode, count(*), sum(qty), avg(qty) from li "
          "where d <= date '1993-01-01' group by flag, mode "
          "order by flag, mode")
    q3 = ("select li.ok, prio, sum(qty) as rev from li join od on "
          "li.ok = od.ok where mode <> 'RAIL' and od.d < date '1991-12-20' "
          "group by li.ok, prio order by rev desc, li.ok limit 10")
    want = [p.rows(q) for q in (q1, q3)]
    # the spill route (the reference's is held to it in
    # test_torch_sql_spill_db.py): the same rows as in memory
    p.t.config.set("sql_work_area_rows", 64)
    for q, w in zip((q1, q3), want):
        assert p.ts[0].execute(q).rows() == w
        assert p.ts[0].last_spill is not None
    p.close()
