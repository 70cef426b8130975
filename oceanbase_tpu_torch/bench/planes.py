"""What the five measurement-plane benches share: the reference's TPC-H
slice, its two loads, its timers and its knob handling.

``scripts/{trace,metrics,profile,workload,planqual}_bench.py`` each carry
a copy of the same slice (a 6-column ``lineitem``, seed 1, and the q6 and
q1 texts); ``bench/{trace,metrics,profile,workload,planqual}.py`` port
those scripts and read it from here.  Everything takes any package's
``Session`` or ``Database``: nothing here imports a package's engine.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

#: the slice's two statements (``trace_bench.py:36-47``, and the same
#: texts at ``metrics_bench.py:37``, ``profile_bench.py:50``,
#: ``workload_bench.py:48``, ``planqual_bench.py:55``)
QUERIES = {
    "q6": ("select sum(l_extendedprice * l_discount) from lineitem"
           " where l_shipdate >= 8766 and l_shipdate < 9131"
           " and l_discount >= 5 and l_discount <= 7"
           " and l_quantity < 24"),
    "q1": ("select l_returnflag, l_linestatus, sum(l_quantity),"
           " sum(l_extendedprice), avg(l_discount), count(*)"
           " from lineitem where l_shipdate <= 10000"
           " group by l_returnflag, l_linestatus"
           " order by l_returnflag, l_linestatus"),
}
SEED = 1                        # ``trace_bench.py:49``
#: the INSERT route's statement size (``trace_bench.py:66``)
INSERT_ROWS = 2000
#: warm-up passes before any timed window (``trace_bench.py:99``)
WARM = 3
#: every overhead half's contract (``trace_bench.py:219-221``)
BOUND_PCT = 2.0
#: the cluster halves' rows (``BENCH_CLUSTER_ROWS``, ``trace_bench.py:217``)
CLUSTER_ROWS = 20_000


def gen(n_rows: int, seed: int = SEED) -> dict:
    """The slice's columns (``trace_bench.py:49-57``)."""
    rng = np.random.default_rng(seed)
    return {
        "l_quantity": rng.integers(1, 50, n_rows),
        "l_extendedprice": rng.integers(1000, 100000, n_rows),
        "l_discount": rng.integers(0, 10, n_rows),
        "l_shipdate": rng.integers(8766, 10227, n_rows),
        "l_returnflag": rng.integers(0, 3, n_rows),
        "l_linestatus": rng.integers(0, 2, n_rows),
    }


#: the slice's 7-column table (``trace_bench.py:61-64``)
CREATE_SQL = ("create table lineitem (l_id int primary key, l_quantity int,"
              " l_extendedprice int, l_discount int, l_shipdate int,"
              " l_returnflag int, l_linestatus int)")


def insert_sql(cols: dict, s: int, e: int) -> str:
    """One INSERT of rows ``s:e`` of ``gen``'s columns, ``l_id`` the
    row number (``trace_bench.py:65-71``)."""
    return "insert into lineitem values " + ", ".join(
        f"({i}, {cols['l_quantity'][i]}, {cols['l_extendedprice'][i]},"
        f" {cols['l_discount'][i]}, {cols['l_shipdate'][i]},"
        f" {cols['l_returnflag'][i]}, {cols['l_linestatus'][i]})"
        for i in range(s, e))


def load_inserts(sess, n_rows: int) -> None:
    """CREATE TABLE and 2,000-row INSERTs (``trace_bench.py:61-71``)."""
    cols = gen(n_rows)
    sess.execute(CREATE_SQL)
    for s in range(0, n_rows, INSERT_ROWS):
        sess.execute(insert_sql(cols, s, min(s + INSERT_ROWS, n_rows)))


def load_numpy(sess, n_rows: int) -> None:
    """The same rows as one direct load (``profile_bench.py:95-98``)."""
    sess.catalog.load_numpy("lineitem",
                            {"l_id": np.arange(n_rows), **gen(n_rows)},
                            primary_key=["l_id"])


def time_queries(sess, repeats: int, queries=QUERIES) -> float:
    """Seconds for ``repeats`` passes over the slice
    (``trace_bench.py:76-81``); a statement returns a result already on
    the host, so each pass ends with its answers read."""
    t0 = time.monotonic()
    for _ in range(repeats):
        for q in queries.values():
            sess.execute(q)
    return time.monotonic() - t0


def answers(sess, queries=QUERIES) -> dict:
    """{name: rows} of one pass over the slice."""
    return {k: [tuple(r) for r in sess.execute(q).rows()]
            for k, q in queries.items()}


def median(xs):
    """The reference's median (``profile_bench.py:129-133``); None of
    an empty list."""
    if not xs:
        return None
    xs = sorted(xs)
    k = len(xs) // 2
    return xs[k] if len(xs) % 2 else (xs[k - 1] + xs[k]) / 2


def trimmed_mean(xs):
    """The 25%-trimmed mean (``workload_bench.py:130-134``)."""
    xs = sorted(xs)
    k = len(xs) // 4
    xs = xs[k:len(xs) - k] or xs
    return sum(xs) / len(xs)


def alter(sess, name: str, value) -> None:
    """``ALTER SYSTEM SET name = value``, as the reference flips a knob."""
    if isinstance(value, bool):
        value = "true" if value else "false"
    sess.execute(f"alter system set {name} = {value}")


@contextlib.contextmanager
def kept(db, names):
    """Put every knob in ``names`` back as it was on the way out: the
    metrics switch and the time split are process-global, so a half that
    left one off would run every later statement of the process without
    it."""
    saved = {n: db.config[n] for n in names}
    try:
        yield
    finally:
        for n, v in saved.items():
            db.config.set(n, v)


def pct(on_s: float, off_s: float) -> float:
    """(on - off) / off in percent."""
    return (on_s - off_s) / off_s * 100.0


def load_tpch(sess, tables: dict, types: dict, primary_keys: dict) -> None:
    """Each TPC-H table direct-loaded, then ANALYZEd
    (``profile_bench.py:165-171``); ``types`` are the package's own."""
    for name, arrays in tables.items():
        sess.catalog.load_numpy(
            name, arrays,
            types={k: v for k, v in types.items() if k in arrays},
            primary_key=primary_keys[name])
    for name in tables:
        sess.execute(f"analyze table {name}")
