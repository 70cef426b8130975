"""The port's session plan cache against the JAX package's on the CPU.

``test_plan_cache_hit_and_invalidation`` is the reference's case
(``tests/test_topn_plancache.py``).  Then one statement sequence — with
DDL, ``nextval``, parameters, a transaction and a small
``plan_cache_mem_limit`` — runs on both packages, and after every
statement the plan-cache hits, misses and evictions have moved alike
(the reference counts them in its metrics plane, the port on the
session).  Last, a cached plan is run again through every route that
reads it (the access path, an index probe, the capacity-retry ladder
and the spill tier) and its fingerprint and text do not change: no
execution step mutates a cached plan in place.
"""

import pytest
import torch

from oceanbase_tpu.server import metrics as jmetrics
from oceanbase_tpu_torch.sql.session import format_plan
from test_torch_database import Pair

torch.set_num_threads(2)


def _jcounts():
    return tuple(jmetrics.counter_value(f"plan_cache.{k}")
                 for k in ("hits", "misses", "evictions"))


def _tcounts(s):
    st = s.plan_cache_stats
    return st["hits"], st["misses"], st["evictions"]


def _step(p, sql, params=None):
    """Run ``sql`` on both packages -> (reference, port) counter moves,
    and check the rows agree."""
    j0, t0 = _jcounts(), _tcounts(p.ts[0])
    if params is None:
        p.run(sql)
    else:
        want = p.js[0].execute(sql, params=params).rows()
        assert p.ts[0].execute(sql, params=params).rows() == want, sql
    j1, t1 = _jcounts(), _tcounts(p.ts[0])
    return (tuple(b - a for a, b in zip(j0, j1)),
            tuple(b - a for a, b in zip(t0, t1)))


def test_plan_cache_hit_and_invalidation(tmp_path):
    p = Pair(tmp_path)
    for s in (p.js[0], p.ts[0]):
        s.execute("create table t (k int primary key, v int)")
        s.execute("insert into t values (1, 10), (2, 20)")
        q = "select sum(v) from t where k >= ?"
        assert s.execute(q, params=[1]).rows() == [(30,)]
        n_entries = len(s.plan_cache)
        assert n_entries >= 1
        assert s.execute(q, params=[1]).rows() == [(30,)]
        assert len(s.plan_cache) == n_entries
        s.execute("insert into t values (3, 5)")
        assert s.execute(q, params=[1]).rows() == [(35,)]
        s.execute("create table u (z int)")
        assert s.execute(q, params=[1]).rows() == [(35,)]
    assert [k[1:] for k in p.ts[0].plan_cache] == \
        [k[1:] for k in p.js[0].plan_cache]
    p.close()


SEQUENCE = [
    ("create table t (k int primary key, v int, s varchar(8))", None),
    ("insert into t values (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'a')", None),
    ("select sum(v) from t", None),
    ("select sum(v) from t", None),                      # hit
    ("select k from t where v > ? order by k", [15]),
    ("select k from t where v > ? order by k", [15]),    # hit
    ("select k from t where v > ? order by k", [25]),    # new params
    ("create sequence sq start 100 increment 1", None),
    ("select nextval('sq') as n", None),                 # never cached
    ("select nextval('sq') as n", None),
    ("select s, count(*) from t group by s order by s", None),
    ("create index iv on t (v)", None),                  # schema change
    ("select sum(v) from t", None),                      # miss again
    ("select k from t where k = (select max(k) from t)", None),
    ("begin", None),
    ("update t set v = v + 1 where k = 2", None),
    ("select sum(v) from t", None),
    ("commit", None),
    ("select count(*) from t where s = 'a'", None),
    ("select k, v from t order by v desc", None),        # evicts
    ("select sum(v) from t", None),
    ("select max(v) from t", None),
    ("select min(v) from t", None),
    ("select sum(v) from t", None),
    ("drop table t", None),
]


@pytest.mark.parametrize("limit", [512 << 20, 9000])
def test_same_hits_misses_and_evictions(tmp_path, limit):
    """The sequence moves the counters alike; under a 9000-byte limit
    (three or four plans) LRU evictions come in too."""
    p = Pair(tmp_path)
    p.run(f"alter system set plan_cache_mem_limit = {limit}")
    moves = []
    for sql, params in SEQUENCE:
        jm, tm = _step(p, sql, params)
        assert tm == jm, (sql, tm, jm)
        moves.append(tm)
    hits = sum(m[0] for m in moves)
    evictions = sum(m[2] for m in moves)
    # the small limit evicts the LRU entries the later repeats would hit
    assert hits >= (4 if limit > 1 << 20 else 2)
    assert (evictions > 0) == (limit < 1 << 20)
    assert len(p.ts[0].plan_cache) == len(p.js[0].plan_cache)
    p.close()


def test_cache_off_binds_every_time(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 10)")
    p.run("alter system set enable_plan_cache = false")
    for _ in range(3):
        jm, tm = _step(p, "select sum(v) from t")
        assert tm == jm == (0, 0, 0)
    assert len(p.ts[0].plan_cache) == 0
    p.close()


def test_cached_plan_is_not_mutated_by_execution(tmp_path):
    """Every route that runs a cached plan leaves it as it was bound."""
    p = Pair(tmp_path)
    s = p.ts[0]
    s.execute("create table t (k int primary key, v int, w int)")
    s.execute("create index iw on t (w)")
    s.execute("create table u (w int primary key, name varchar(8))")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 13}, {i % 50})" for i in range(3000)))
    s.execute("insert into u values " + ", ".join(
        f"({i}, 'n{i}')" for i in range(50)))
    for t in ("t", "u"):
        s.execute(f"analyze table {t}")
    queries = [
        "select v from t where k = 77",                    # access path
        "select count(*) from t, u where t.w = u.w and u.name = 'n7'",
        "select t.k, u.name from t join u on t.w = u.w where t.k < 40 "
        "order by t.k",
        "select v, count(*) from t group by v order by v",
    ]
    routes = set()

    def cached(q):
        (key, entry), = [(k, e) for k, e in s.plan_cache.items()
                         if k[0] == q]
        return key, entry, (entry[0].fingerprint(), format_plan(entry[0]))

    for q in queries:
        first = s.execute(q).rows()
        key, entry, before = cached(q)
        assert s.execute(q).rows() == first
        routes |= set(c.kind for c in s.last_access_paths.values())
        routes |= {"index_probe"} if "IndexProbe" in before[1] else set()
        s.execute("alter system set sql_work_area_rows = 512")
        assert sorted(s.execute(q).rows()) == sorted(first)
        routes |= {"spill"} if s.last_spill is not None else set()
        s.execute("alter system set sql_work_area_rows = 4194304")
        assert s.plan_cache[key] is entry
        assert cached(q)[2] == before
    # the retry ladder: rows added under a cached plan overflow its
    # join, which re-plans at 4x and keeps the cached plan as it was
    q = "select count(*) from t a, t b where a.v = b.v and a.k < 100"
    assert s.execute(q).rows() == [(23079,)] and s.last_retries == 0
    key, entry, before = cached(q)
    s.execute("insert into t values " + ", ".join(
        f"({i}, 0, 0)" for i in range(3000, 9000)))
    assert s.execute(q).rows() == [(71079,)] and s.last_retries >= 1
    assert s.plan_cache[key] is entry and cached(q)[2] == before
    assert routes == {"primary", "index_probe", "spill"}
    assert s.plan_cache_stats["hits"] == 2 * len(queries) + 1
    p.close()
