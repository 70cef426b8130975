"""The seeded differential fuzzer of ``tests/test_fuzz_sqlite.py`` on the
port: the same 60 random queries (projection, filter, join, aggregate,
window, CTE, set operation, outer join, string functions) over the same
tables, each diffed row for row against SQLite, with the port's
``Session`` on the CPU.  The query generator is that file's own,
imported, so both packages face one fuzzer."""

import sqlite3

import numpy as np
import pytest
import torch

from oceanbase_tpu_torch.sql import Session
from test_fuzz_sqlite import N_QUERIES, _gen_query, _normalize, _oracle_sql

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def env():
    # the reference fuzzer's tables, from the same seed
    rng = np.random.default_rng(11)
    n1, n2 = 400, 120
    t1 = {
        "a": rng.integers(-20, 20, n1),
        "b": rng.integers(0, 8, n1),
        "f": np.round(rng.uniform(-10, 10, n1), 3),
        "s": rng.choice(np.array(["red", "green", "blue", "teal"]), n1),
    }
    nulls = rng.random(n1) < 0.15
    t2 = {
        "x": rng.integers(0, 8, n2),
        "y": rng.integers(-5, 5, n2),
        "w": rng.choice(np.array(["red", "blue", "pink"]), n2),
    }
    s = Session(device="cpu")
    s.catalog.load_numpy("t1", t1, valids={"b": ~nulls})
    s.catalog.load_numpy("t2", t2)
    conn = sqlite3.connect(":memory:")
    conn.execute("create table t1 (a, b, f, s)")
    conn.executemany(
        "insert into t1 values (?,?,?,?)",
        [(int(t1["a"][i]), None if nulls[i] else int(t1["b"][i]),
          float(t1["f"][i]), str(t1["s"][i])) for i in range(n1)])
    conn.execute("create table t2 (x, y, w)")
    conn.executemany("insert into t2 values (?,?,?)",
                     list(zip(t2["x"].tolist(), t2["y"].tolist(),
                              t2["w"].tolist())))
    # MySQL functions SQLite lacks: the reference fuzzer's oracle impls
    conn.create_function("repeat", 2, lambda s_, n: None if s_ is None
                         else str(s_) * max(int(n), 0))
    conn.create_function(
        "lpad", 3, lambda s_, n, p: None if s_ is None else
        (str(s_)[:n] if len(str(s_)) >= n
         else (str(p) * n)[: n - len(str(s_))] + str(s_)))
    conn.create_function(
        "concat_ws", -1,
        lambda sep, *xs: sep.join(str(x) for x in xs if x is not None))
    conn.create_function("isnull", 1, lambda x: 1 if x is None else 0)
    conn.create_function("if", 3, lambda c, a, b: a if c else b)
    conn.create_function(
        "substring_index", 3, lambda s_, d, k: None if s_ is None else
        (d.join(str(s_).split(d)[:k]) if k >= 0
         else d.join(str(s_).split(d)[k:])))
    return s, conn


def test_fuzz_vs_sqlite(env):
    s, conn = env
    rng = np.random.default_rng(99)
    failures = []
    for _qi in range(N_QUERIES):
        sql = _gen_query(rng)
        try:
            got = _normalize(s.execute(sql).rows())
            want = _normalize(
                [tuple(r) for r in conn.execute(_oracle_sql(sql))])
        except Exception as e:  # noqa: BLE001
            failures.append((sql, f"exception {type(e).__name__}: {e}"))
            continue
        if len(got) != len(want):
            failures.append((sql, f"rowcount {len(got)} != {len(want)}"))
            continue
        for g, w in zip(got, want):
            ok = len(g) == len(w) and all(
                (a == pytest.approx(b, rel=1e-6)
                 if isinstance(a, float) or isinstance(b, float)
                 else a == b)
                for a, b in zip(g, w)
                if not (a is None and b is None))
            if not ok:
                failures.append((sql, f"row diff: {g} != {w}"))
                break
    assert not failures, "\n".join(f"{q}\n  -> {why}"
                                   for q, why in failures[:5])
