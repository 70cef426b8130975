"""The port's catalog-only statement surface against the JAX package's
``Session``: the cases of ``tests/test_sql_basic.py`` and
``tests/test_view_wiring.py`` run as identical statement scripts on both
sessions, with equal rows, rowcounts and errors; ``concat`` across
different dictionaries against the JAX operator; the reference's UPDATE
dictionary fault, which the port does not copy; the D1 DML script and
the window/union reads of ``bench/surface_queries.py`` against SQLite at
a small scale; and the statements that still need a storage plane."""

import sqlite3

import numpy as np
import pytest
import torch

import oceanbase_tpu.exec.ops as jops
import oceanbase_tpu.server.calibrate as jcalibrate
import oceanbase_tpu_torch.exec.ops as tops
from oceanbase_tpu.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
from oceanbase_tpu.sql import Session as JSession
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch.bench import surface_queries as sq
from oceanbase_tpu_torch.bench.oracle import (
    load_sqlite,
    rows_match,
    run_oracle_stmt,
)
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen_tpch
from oceanbase_tpu_torch.sql import Session as TSession
from oceanbase_tpu_torch.vector import column as tcol
from test_torch_ops import _load
from test_torch_sql_frontend import align_colids

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)


def _outcome(s, sql, params=None):
    try:
        r = s.execute(sql, params=params)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__)
    return ("ok", r.rowcount, list(r.names), r.rows())


def run_both(script, params=None):
    """Each statement on a fresh JAX and a fresh port session: equal
    outcomes (rows, rowcount and column names, or the error's type)."""
    js, ts = JSession(), TSession(device="cpu")
    for sql in script:
        align_colids()
        want, got = _outcome(js, sql, params), _outcome(ts, sql, params)
        assert got[0] == want[0], (sql, got, want)
        if got[0] == "error":
            assert got == want, sql
            continue
        assert got[1:3] == want[1:3], (sql, got, want)
        ok, why = rows_match(got[3], want[3],
                             ordered="order by" in sql.lower(), rtol=1e-12)
        assert ok, (sql, why)
    return js, ts


SCRIPTS = {
    "create_insert_select": [
        "create table t (a int primary key, b varchar(20), "
        "c decimal(10,2), d date)",
        "insert into t values (1, 'x', 1.50, '2020-01-05'), "
        "(2, 'y', 2.25, '2021-06-01'), (3, null, 0.75, '2020-01-05')",
        "select a, b, c from t where c > 1.00 order by a",
        "select count(*), sum(c) from t",
        "select b, count(*) as n from t group by b order by n desc, b",
        "select a from t where b is null",
        "select a, d from t where d = date '2020-01-05' order by a",
    ],
    "update_delete": [
        "create table u (k int, v int)",
        "insert into u values (1, 10), (2, 20), (3, 30)",
        "update u set v = v + 5 where k >= 2",
        "select sum(v) from u",
        "delete from u where k = 1",
        "select count(*) from u",
        "update u set v = null where k = 3",
        "select k, v from u order by k",
        "delete from u",
        "select count(*), sum(v) from u",
    ],
    "joins": [
        "create table dept (id int primary key, dname varchar(10))",
        "create table emp (eid int, did int, sal int)",
        "insert into dept values (1, 'eng'), (2, 'ops')",
        "insert into emp values (1, 1, 100), (2, 1, 200), (3, 2, 50), "
        "(4, 9, 10)",
        "select dname, sum(sal) as total from emp, dept where did = id "
        "group by dname order by total desc",
        "select eid, dname from emp left join dept on did = id order by eid",
    ],
    "subqueries": [
        "create table t1 (a int, b int)",
        "insert into t1 values (1, 10), (2, 20), (3, 30)",
        "create table t2 (x int)",
        "insert into t2 values (2), (3), (5)",
        "select a from t1 where a in (select x from t2) order by a",
        "select a from t1 where not exists "
        "(select * from t2 where x = a) order by a",
        "select a from t1 where b > (select avg(b) from t1) order by a",
        "insert into t2 select a + 10 from t1 where a > 1",
        "select x from t2 order by x",
    ],
    "setops": [
        "create table s1 (v int)",
        "insert into s1 values (1), (2), (2), (3)",
        "create table s2 (v int)",
        "insert into s2 values (2), (4)",
        "select v from s1 union select v from s2 order by v",
        "select v from s1 union all select v from s2 order by v",
        "select v from s1 intersect select v from s2",
        "select v from s1 except select v from s2 order by v",
    ],
    "explain_show_describe": [
        "create table e (a int not null, b varchar(5), primary key (a))",
        "show tables",
        "describe e",
        "show create table e",
        "show index from e",
        "create index ib on e (b)",
        "show index from e",
        "show create table e",
        "drop index ib on e",
        "show variables",
        "set max_capacity_retry = 5",
        "show variables",
        "set global max_capacity_retry = 5",
        "begin",
        "insert into e values (1, 'x')",
        "commit",
        "rollback",
        "select * from e",
        "drop table e",
        "drop table if exists e",
        "drop table e",
        "show tables",
    ],
    "distinct_and_case": [
        "create table dc (g varchar(2), v int)",
        "insert into dc values ('a', 1), ('a', 2), ('b', 3)",
        "select distinct g from dc order by g",
        "select g, sum(case when v > 1 then v else 0 end) as s "
        "from dc group by g order by g",
    ],
    # tests/test_view_wiring.py:20-67
    "views": [
        "create table t (k int primary key, v int)",
        "insert into t values (1, 10), (2, 20), (3, 30)",
        "create view big (kk, vv) as select k, v from t where v >= 20",
        "select kk, vv from big order by kk",
        "show tables",
        "describe big",
        "show create table big",
        "create view big as select k from t",
        "create or replace view big as select k from t where k = 1",
        "select * from big",
        "drop view big",
        "show tables",
        "drop view big",
        "drop view if exists big",
        "select * from big",
        "create view v1 as select k from t",
        "create table v1 (x int)",
        "create view t as select 1",
        "with r (x) as (select x from r) select * from r",
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax_session(name):
    run_both(SCRIPTS[name])


def test_params_match():
    run_both(["create table p (a int, b int)",
              "insert into p values (1, 2), (3, 4)",
              "select b from p where a = ?",
              "insert into p values (?, 9)"], params=[3])


def test_explain_plan_text():
    _js, ts = run_both(["create table e (a int, b varchar(5))"])
    r = ts.execute("explain select a from e where b = 'x'")
    assert "TableScan" in r.plan_text and "Filter" in r.plan_text
    assert r.rows() == [(line,) for line in r.plan_text.splitlines()]


def test_update_sets_a_value_missing_from_the_dictionary():
    """The reference's catalog-only UPDATE keeps the column's old
    dictionary and writes codes from the literal's own one-entry
    dictionary, so 'zz' reads back as 'a' there (ROADMAP Queue 3).  The
    port merges the two dictionaries and stores 'zz'."""
    ts = TSession(device="cpu")
    for sql in ("create table u (k int, s varchar(3))",
                "insert into u values (1, 'a'), (2, 'b'), (3, 'c')"):
        ts.execute(sql)
    assert ts.execute("update u set s = 'zz' where k = 2").rowcount == 1
    assert ts.execute("select k, s from u order by k").rows() == \
        [(1, "a"), (2, "zz"), (3, "c")]
    ts.execute("update u set s = null where k = 1")
    ts.execute("update u set s = concat(s, '!') where k = 3")
    assert ts.execute("select k, s from u order by k").rows() == \
        [(1, None), (2, "zz"), (3, "c!")]
    # a string column holding NULLs takes further INSERTs (the
    # reference's append raises comparing None with str)
    ts.execute("insert into u values (4, 'd')")
    assert ts.execute("select count(*), count(s) from u").rows() == [(4, 3)]


def test_insert_select_keeps_nulls():
    """INSERT ... SELECT carries the source's NULLs (the reference's
    append turns a NULL number into its payload; ROADMAP Queue 3), as
    SQLite does."""
    script = ["create table a (x int, s varchar(3))",
              "insert into a values (1, 'p'), (null, 'q'), (3, null)",
              "create table b (x int, s varchar(3))",
              "insert into b select x, s from a",
              "select count(x), count(s), count(*), sum(x) from b"]
    ts, conn = TSession(device="cpu"), sqlite3.connect(":memory:")
    for sql in script:
        res, (rows, count) = ts.execute(sql), run_oracle_stmt(conn, sql)
        if sql.startswith("select"):
            assert res.rows() == rows == [(2, 2, 3, 4)]
        elif sql.startswith("insert"):
            assert res.rowcount == count


def _strings_rel(values, valid, seed):
    """(JAX, port) relations of one string column: padded, dead lanes
    poisoned, some live lanes masked out."""
    return _load({"s": np.array(values, dtype=object),
                  "i": np.arange(len(values))}, None, {"s": valid}, seed)


@pytest.mark.parametrize("same_dict", [False, True])
def test_concat_matches(same_dict):
    rng = np.random.default_rng(3)
    a = rng.choice(["red", "green", "blue"], 70).tolist()
    b = rng.choice(["pink", "blue", "aqua", "red"], 40).tolist()
    ja, ta = _strings_rel(a, rng.random(70) < 0.9, 1)
    jb, tb = _strings_rel(a if same_dict else b, None, 2)
    if same_dict:  # one dictionary object shared by both inputs
        jb.columns["s"] = jcol.Column(jb.columns["s"].data, None,
                                      ja.columns["s"].dtype,
                                      ja.columns["s"].sdict)
        tb.columns["s"] = tcol.Column(tb.columns["s"].data, None,
                                      ta.columns["s"].dtype,
                                      ta.columns["s"].sdict)
    jout, tout = jops.concat([ja, jb, ja]), tops.concat([ta, tb, ta])
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    for name in ("s", "i"):
        tc, jc = tout.columns[name], jout.columns[name]
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        np.testing.assert_array_equal(tc.valid_or_true().numpy(),
                                      np.asarray(jc.valid_or_true()))
        if jc.sdict is not None:
            assert list(tc.sdict.values) == list(jc.sdict.values)
    assert (tout.columns["s"].sdict is ta.columns["s"].sdict) == same_dict
    t, j = tcol.to_numpy(tout), jcol.to_numpy(jout)
    assert list(map(repr, t["s"])) == list(map(repr, j["s"]))


_NEEDS_A_DATABASE = {
    "truncate table t", "alter system set enable_plan_cache = 1",
    "create table c2 as select 1 as a",
    "create table c3 (a int, index ia (a))",
    "load data infile '/x.csv' into table t",
    "alter table t add column z int", "xa start 'x'", "savepoint s1",
    "create sequence sq", "lock tables t write",
    "replace into t values (1)", "kill 3", "create tenant tt",
    "create user u identified by 'p'"}


@pytest.mark.parametrize("sql", [
    "truncate table t", "load data infile '/x.csv' into table t",
    "alter table t add column z int", "kill 3", "xa start 'x'",
    "savepoint s1", "create sequence sq", "create tenant tt",
    "create user u identified by 'p'", "lock tables t write",
    "alter system set enable_plan_cache = 1",
    "create external table e (a int) location '/x.csv'",
    "create table c2 as select 1 as a",
    "create table c3 (a int, index ia (a))", "replace into t values (1)",
])
def test_storage_plane_statements_raise(sql):
    """A catalog-only session refuses what the port's ``Database`` runs
    (naming it) and what still waits for the storage plane's second
    half (naming ROADMAP Queue 1 item 5b and its sub-item)."""
    ts = TSession(device="cpu")
    ts.execute("create table t (a int)")
    match = ("needs a Database" if sql in _NEEDS_A_DATABASE
             else "ROADMAP Queue 1 item 5b")
    with pytest.raises(NotImplementedError, match=match):
        ts.execute(sql)
    assert ts.catalog.tables() == ["t"]  # nothing half-created


def test_catalog_only_session_procedures_and_processlist():
    """As in the reference, a catalog-only session keeps procedures of
    its own and lists no sessions."""
    ts = TSession(device="cpu")
    ts.execute("create table t (a int)")
    ts.execute("insert into t values (4), (5)")
    with pytest.raises(KeyError, match="unknown procedure p"):
        ts.execute("call p()")
    ts.execute("create procedure p() begin select sum(a) from t; end")
    assert ts.execute("call p()").rows() == [(9,)]
    r = ts.execute("show processlist")
    assert r.names == ["id", "state", "info"] and r.rows() == []


@pytest.mark.parametrize("sql", [
    "profile select 1", "analyze workload report", "show trace",
    "show metrics", "explain analyze select 1"])
def test_measurement_plane_statements_raise(sql):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        TSession(device="cpu").execute(sql)


# ---------------------------------------------------------------------------
# the SF1 chip run's surface statements, at SF0.01 against SQLite
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    tables, jtypes = gen_tpch(sf=0.01)
    _t, ttypes = tgen_tpch(sf=0.01)
    js, ts = JSession(), TSession(device="cpu")
    for s, types in ((js, jtypes), (ts, ttypes)):
        for name, arrays in tables.items():
            s.catalog.load_numpy(
                name, arrays, primary_key=TPCH_PRIMARY_KEYS[name],
                types={k: v for k, v in types.items() if k in arrays})
    return js, ts, load_sqlite(tables, ttypes)


@pytest.mark.parametrize("name", sorted(sq.READS))
def test_surface_reads_match(tpch, name, monkeypatch):
    js, ts, conn = tpch
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)
    sql = sq.READS[name]
    got = ts.execute(sql).rows()
    want, _n = run_oracle_stmt(conn, sql)
    ok, why = rows_match(got, want, ordered=name in sq.ORDERED,
                         rtol=sq.RTOL.get(name, 1e-6))
    assert ok, why
    ok, why = rows_match(got, js.execute(sql).rows(), ordered=True,
                         rtol=1e-12)
    assert ok, why
    assert len(got) == {"W1": 33, "U2": 35}.get(name, len(got))


def test_d1_script_matches_sqlite(tpch):
    """Each statement's rowcount equals SQLite's, and the final group-by
    equals SQLite's, the new '6-NONE' group included."""
    _js, ts, conn = tpch
    for step, sql in sq.D1:
        res = ts.execute(sql)
        rows, count = run_oracle_stmt(conn, sql)
        if step == "select":
            ok, why = rows_match(res.rows(), rows, ordered=True)
            assert ok, why
            assert "6-NONE" in [r[0] for r in res.rows()]
        elif step != "create":
            assert res.rowcount == count, step
    ts.execute("drop table ocopy")
    conn.execute("drop table ocopy")
