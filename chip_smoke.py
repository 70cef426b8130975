#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``oceanbase_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # TPC-H SF1, as the port's users run it
    OB_SMOKE_SF=0.1 python3 chip_smoke.py   # a quicker, smaller run

Phases, each printing its own lines:

1. environment: torch, CUDA, the card's name and power limit;
2. build: the path's CUDA kernel, from the source in this checkout;
3. kernels against their plain torch versions on the card, exact, at
   small and ragged sizes and at the main path's shapes, with CUDA-event
   timings beside each kernel's bound;
4. the main path: TPC-H generated from its seed, the lineitem and part
   columns put on the card, the Q6/Q1/Q14 plans run by ``execute_plan``,
   read back and held against numpy oracles, each plan timed;
5. kernel mode (the JAX package's ``BENCH_MODE=pallas``): the fused Q6
   kernel on the device-resident lineitem columns against the Q6 oracle;
5b. stream (the JAX package's ``BENCH_MODE=stream``): the Q6 and Q1
   plans through ``exec/granule.py::execute_streamed`` over the lineitem
   columns in 2^21-row granules (pinned host buffers, a copy stream),
   against the numpy oracles, timed beside phase 4's whole-table rows/s,
   with the host-to-device bytes and the copy and compute stream times;
6. sql: all eight TPC-H tables in the port's ``Catalog`` on the card,
   ANALYZEd, and the 22 TPC-H queries through ``Session.execute(sql).rows()``, each
   held against the SQLite oracle (built and run meanwhile, from the
   same seed, in two more processes that share out every SQL statement
   of phases 6-8) and timed, with its capacity re-plans and peak device
   memory;
6b. spill (the JAX package's ``Database`` at its default work area of
   2^22 rows): the plans phase 6 ran for the 11 TPC-H queries its spill
   tier runs, through ``exec/spill_exec.py::execute_spilled`` with
   lineitem streamed from the host, held against SQLite; the 8 queries
   it refuses raise ``NotDistributable``; the S1 external sort against
   SQLite and the J1 co-partitioned disk join against numpy (one timed
   run each after the warm-up); each with its ``SpillStats`` and peak
   device memory;
7. sql-index: on the same catalog, a secondary index on every ``*key``
   column (the JAX package's SF1 parity configuration,
   ``scripts/sf_parity.py``), each sorted sidecar built and timed, then
   the 22 queries again and the index-probe join IP1, each held against
   SQLite, with the ``IndexProbe`` nodes of the plan that ran;
8. sql-surface: window functions, unions and a DML script
   (``bench/surface_queries.py``) on the same catalog, each statement's
   rows and rowcount held against SQLite's;
8b. db: the port's ``Database`` (LSM storage, the PALF WAL, MVCC
   transactions) in a temporary directory on the card at its defaults:
   the eight tables direct-loaded through ``catalog.load_numpy`` and
   ANALYZEd, 12 TPC-H queries through ``db.session()`` held against
   SQLite (the 11 that run in memory, and Q6: lineitem's rows
   exceed the 2^22-row work area, so they stream from the LSM through
   the spill tier; phases load and server run all 22 that way), each
   printed with its route, an OLTP mix on ``orders`` (autocommit
   primary-key point UPDATEs and SELECTs with statement and WAL-commit
   latencies, a multi-statement transaction, a rolled-back one, a write
   conflict between two sessions), a checkpoint, more commits, and a
   reopen from the same directory without ``close()`` that replays the
   WAL tail and must read back every committed row and Q6;
8c. load: the eight tables written as ``|``-delimited files and loaded
   by LOAD DATA INFILE (the native CSV tokenizer) into a fresh
   ``Database`` whose lineitem and orders are RANGE-partitioned on the
   order key into 8 partitions, ANALYZEd, the 22 queries against
   SQLite, then a refused duplicate INSERT, REPLACE, a partition-moving
   UPDATE, AUTO_INCREMENT and a sequence, SAVEPOINT over lineitem, ALTER
   TABLE ADD/DROP COLUMN, LOCK TABLES between two sessions and an XA
   branch left prepared, and a reopen without ``close()`` that commits
   the branch and reads all of it back with Q1 and Q6; the rows those
   statements changed are then put back as loaded;
8d. server: phase load's database behind the port's ``MySQLServer`` on
   127.0.0.1, driven by this script's own 4.1 client (``WireClient``):
   the 22 queries as root against SQLite, each DECIMAL cell's text
   equal to the in-process scaled int with its scale; the 11 in-memory
   queries again (plan-cache hits) and with the plan cache off; 200
   prepared point SELECTs on orders; CREATE USER and a refused wrong
   password; four connections at once; admission with 2 slots (QUEUED
   and RUNNING in SHOW PROCESSLIST, then ServerBusy at a queue limit
   of 1); KILL QUERY by the greeting's connection id during a spilled
   Q1 and a plain KILL; a 0.5 s statement timeout; a procedure CALLed
   over the wire; a second tenant loading four tables for Q11; a DBMS
   job; and a restart without a checkpoint that keeps the tenant, the
   user and the procedure;
8e. measure: the measurement plane on the card (at its defaults in
   every phase above).  The audit ring of phase server's database (a
   trace id on every statement, device_s on the in-memory queries,
   queue_s on the admission rounds) and its trace ring; the database
   phase server restarted, the orders its procedure added deleted and
   the tables ANALYZEd again (the restart drops statistics), SHOW
   TRACE after Q3 and the gv$sysstat families; PROFILE of Q1, Q9, Q13
   and Q18 in memory (a work area over lineitem's rows) and of a
   spilled Q6, each with the profiler's kernel time against the
   execution's device_s (a CUDA event pair) and its wall time, and the
   card's idle share; EXPLAIN ANALYZE of Q3, Q18 and Q6 with the time
   split on and off, each held against the plan monitor, its root's rows
   against SQLite's answer and its scans' rows against the tables' row
   counts; ALTER SYSTEM CALIBRATE with gv$cost_units inside its bounds
   (the stream peak 30-105% of 3.35 TB/s, the launch floor 2-200 us),
   the 22 plans' logical hashes before and after it and the 11
   in-memory queries against SQLite after it; the synchronizing calls
   of one ``execute_plan`` of Q1, Q6 and Q14 with the plane on and off
   (equal); the plane's overhead on the 11 in-memory queries (5
   interleaved pairs); ``q6_filter_sum`` under the profiler;
8f. vector (after durability; a ``Database`` of its own): 1,000,000
   VECTOR(128) rows (ANN-Benchmarks' SIFT1M size; synthetic,
   integer-valued and clustered, from a seed, so float32 holds every
   distance exactly) direct-loaded by ``catalog.load_numpy``; 100
   top-10 ``l2_distance`` queries with no index, through an exact vector
   index (its scan's monitor rows at the 64 candidates) and through an
   IVF-Flat index (recall@10 gated at 0.99), each answer against numpy,
   and one query of each path under PROFILE;
   20 cosine queries and the inner products; 1,000 rows inserted by
   50-row INSERTs and 10 deleted; a dropped and re-created side table; a
   fulltext index over the part comments against a host oracle; a
   reopen without ``close()``; and VECTOR cells over the wire;
9. one JSON line of the kernels with their launch counts on the main
   path (phases 4-5; counts are reset just before each phase from 4 on
   and printed after it: the stream, spill, SQL, server, durability and
   vector paths, like the JAX package's, reach no hand-written kernel,
   and measure makes one profiled launch), and each phase's seconds;
10. the card's name and power limit, then the result line.

Any mismatch or error exits nonzero before the result line.  Without a
CUDA device, or without the package beside this file, it exits nonzero
and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
PLAN_RUNS = 5
SQL_RUNS = 3                     # timed runs per query, after a warm-up
STREAM_RUNS = 5                  # timed streamed runs, after a warm-up
# timed spilled runs after a warm-up: one, since phase durability the
# whole run has to stay inside its limit
SPILL_RUNS = 1
# the spilled S1 sort and J1 join (about 23 and 12 s a run) time one run
# after the warm-up: with phase "server" the whole run has to stay inside
# its limit
SPILL_LONG_RUNS = 1
# bench.py's BENCH_MODE=stream: its granule size and the columns it streams
STREAM_CHUNK_ROWS = 1 << 21
STREAM_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                  "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
# the JAX package's Database default work area (sql_work_area_rows)
SPILL_BUDGET_ROWS = 1 << 22
# phase db: the work area its Database runs with (None: the default,
# 2^22 rows), its autocommit point statements on orders, and its seed
DB_WORK_AREA_ROWS = None
DB_POINT_OPS = 200
DB_SEED = 11
# the TPC-H queries its spill tier runs with lineitem streamed, and those
# it refuses (NotDistributable)
# phase load: RANGE partitions of lineitem and orders on the order key,
# and the autocommit INSERTs of new orders keys it times
LOAD_PARTITIONS = 8
LOAD_POINT_INSERTS = 50
SPILL_QUERIES = (1, 3, 5, 6, 7, 8, 9, 10, 12, 14, 19)
SPILL_REFUSED = (4, 13, 15, 17, 18, 20, 21, 22)
# phase db runs Q6 of the spilled queries and the 11 that run in
# memory: phases "load", "server" and "durability" run the spilled ones
# through the LSM, and the whole run has to stay inside its limit
DB_QUERIES = tuple(q for q in range(1, 23)
                   if q not in SPILL_QUERIES or q == 6)
J1_PARTITIONS = 16


def _batched_ms(torch, fn, batch=50, reps=5) -> float:
    """Time per call, in ms, with ``batch`` calls queued back to back
    between two CUDA events (median over ``reps``, after one warm-up
    call): the wrapper's host work overlaps the previous launch, so this
    reads the device's time whenever the host enqueues faster than the
    device drains."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / batch)
    return statistics.median(times)


def _q6_columns(torch, n, seed, dev):
    """Random int32 Q6 columns with dead lanes (the kernel-test cases)."""
    from oceanbase_tpu_torch.datatypes import date_to_days

    rng = np.random.default_rng(seed)
    cols = [
        rng.integers(date_to_days("1992-01-01"),
                     date_to_days("1998-12-01"), n),
        rng.integers(0, 11, n),
        rng.integers(1, 51, n) * 100,
        rng.integers(90_000, 10_000_000, n),
        np.ones(n, dtype=np.int64),
    ]
    cols[4][::17] = 0
    return [torch.from_numpy(c.astype(np.int32)).to(dev) for c in cols]


def phase_kernels(torch, dev, sf_cols):
    """Phase 3: each kernel against its plain version on the card."""
    from oceanbase_tpu_torch.bench.oracle_np import Q6_BOUNDS
    from oceanbase_tpu_torch.ops import scan_kernels as sk

    b = Q6_BOUNDS
    cases = [(f"random n={n}", _q6_columns(torch, n, 100 + n, dev), b)
             for n in (1, 100, 8192, 8193, 100_000)]
    const = [torch.full((8193,), v, dtype=torch.int32, device=dev)
             for v in (b["ship_lo"] + 100, 6, 100, 1_000_000, 1)]
    cases.append(("ragged constant n=8193", const, b))
    cases.append(("all filtered n=8193", _q6_columns(torch, 8193, 5, dev),
                  dict(b, ship_lo=0, ship_hi=1)))
    # offset by one element: the pointers lose 16-byte alignment and the
    # kernel takes its element-wise path
    cases.append(("unaligned n=100000",
                  [c[1:] for c in _q6_columns(torch, 100_001, 6, dev)], b))
    cases.append((f"SF lineitem n={sf_cols[0].shape[0]}", sf_cols, b))

    max_err = 0
    for name, cols, bounds in cases:
        got = sk.q6_filter_sum(*cols, **bounds)
        want = sk.q6_filter_sum_reference(*cols, **bounds)
        torch.cuda.synchronize()
        err = abs(int(got) - int(want))
        print(f"[kernels] q6_filter_sum {name}: kernel={int(got)} "
              f"plain={int(want)} abs_err={err}")
        if err != 0:
            raise AssertionError(f"q6_filter_sum disagrees on {name}")
        max_err = max(max_err, err)

    n = sf_cols[0].shape[0]

    def kernel():
        return sk.q6_filter_sum(*sf_cols, **b)

    def plain():
        return sk.q6_filter_sum_reference(*sf_cols, **b)

    ms, plain_ms = _batched_ms(torch, kernel), _batched_ms(torch, plain)
    # a 20 B/row streaming scan: the bytes bound is the bound (its eight
    # integer operations a row take 50x less time at the card's peak)
    nbytes = 5 * 4 * n + 8            # five int32 columns in, one int64 out
    rec = {
        "name": "q6_filter_sum",
        "route": "cuda",
        "source": "oceanbase_tpu_torch/ops/csrc/q6_filter_sum.cu",
        "replaces": "oceanbase_tpu/ops/scan_kernels.py:111",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,   # no single PyTorch call computes it
    }
    print(f"[kernels] q6_filter_sum n={n}: back to back: kernel {ms:.6f} "
          f"ms, plain {plain_ms:.6f} ms; bound {rec['bound_ms']:.6f} ms "
          f"({rec['bound_by']}, {nbytes} B)")
    return [rec]


def _check_q1(res, want):
    for k, v in want.items():
        got = np.asarray(res[k])
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got, v, rtol=1e-12, err_msg=k)
        elif got.tolist() != v.tolist():
            raise AssertionError(f"Q1 {k}: {got.tolist()} != {v.tolist()}")


def phase_main_path(torch, dev, tables, types, card):
    """Phases 4-5: the executor's Q6/Q1/Q14 and kernel mode at scale."""
    from oceanbase_tpu_torch.bench import oracle_np
    from oceanbase_tpu_torch.bench.queries import (
        q1_plan, q14_plan, q6_plan, slice_tables,
    )
    from oceanbase_tpu_torch.exec.plan import execute_plan
    from oceanbase_tpu_torch.ops import q6_filter_sum
    from oceanbase_tpu_torch.vector import to_numpy

    li, part = tables["lineitem"], tables["part"]
    n = len(li["l_orderkey"])
    t0 = time.perf_counter()
    dev_tables = slice_tables(tables, types, device=dev)
    torch.cuda.synchronize()
    on_card = sum(c.data.numel() * c.data.element_size()
                  for r in dev_tables.values() for c in r.columns.values())
    print(f"[main] from_numpy: {on_card} bytes on {dev} in "
          f"{time.perf_counter() - t0:.3f} s")

    plans = {"q6": q6_plan(), "q1": q1_plan(), "q14": q14_plan(n)}
    results = {}
    for qname, plan in plans.items():
        res = to_numpy(execute_plan(plan, dev_tables))
        results[qname] = res
        if qname == "q6":
            want = oracle_np.numpy_q6(li)
            if int(res["revenue"][0]) != want:
                raise AssertionError(f"Q6 {res['revenue']} != {want}")
        elif qname == "q1":
            _check_q1(res, oracle_np.numpy_q1(li))
        else:
            want = oracle_np.numpy_q14(li, part)
            np.testing.assert_allclose(res["promo_revenue"][0], want,
                                       rtol=1e-9)
        for k, v in res.items():
            if np.asarray(v).dtype.kind == "f" and \
                    not np.isfinite(np.asarray(v)).all():
                raise AssertionError(f"{qname} {k} is not finite: {v}")
        shown = {k: np.asarray(v).tolist() for k, v in res.items()
                 if not k.startswith("__")}
        print(f"[main] {qname}: matches the numpy oracle {shown}")

    timings = {}
    for qname, plan in plans.items():
        ms = _batched_ms(torch, lambda p=plan: execute_plan(p, dev_tables),
                         batch=1, reps=PLAN_RUNS)
        timings[qname] = ms
        print(f"[main] {qname} SF lineitem rows={n}: {ms:.3f} ms/plan, "
              f"{n / (ms / 1e3):.1f} rows/s on {card}")

    # kernel mode: the fused Q6 kernel on the device-resident columns
    ld = dev_tables["lineitem"].columns
    kcols = [ld[c].data.to(torch.int32) for c in
             ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")]
    live = torch.ones(n, dtype=torch.int32, device=dev)
    got = int(q6_filter_sum(*kcols, live, **oracle_np.Q6_BOUNDS))
    want = oracle_np.numpy_q6(li)
    if got != want:
        raise AssertionError(f"kernel-mode Q6 {got} != oracle {want}")
    print(f"[main] kernel mode q6_filter_sum: {got} matches the oracle")
    return timings


def phase_stream(torch, dev, tables, types, card, whole_ms):
    """Phase stream: the JAX package's ``BENCH_MODE=stream`` at its own
    settings — the Q6 and Q1 plans through ``execute_streamed`` over the
    lineitem columns ``bench.py`` streams, in 2^21-row granules, one
    cache across runs — checked against the numpy oracles and timed
    beside phase 4's whole-table rows/s."""
    from oceanbase_tpu_torch.bench import oracle_np
    from oceanbase_tpu_torch.bench.harness import pcie_link
    from oceanbase_tpu_torch.bench.queries import q1_plan, q6_plan
    from oceanbase_tpu_torch.exec.granule import (
        StreamStats, execute_streamed, numpy_chunk_provider,
    )
    from oceanbase_tpu_torch.vector import to_numpy

    li = tables["lineitem"]
    n = len(li["l_orderkey"])
    arrays = {k: li[k] for k in STREAM_COLUMNS}
    btypes = {k: v for k, v in types.items() if k in STREAM_COLUMNS}
    provider = numpy_chunk_provider(arrays)
    for qname, plan in (("q6", q6_plan()), ("q1", q1_plan())):
        cache = {}

        def run(stats=None):
            return execute_streamed(plan, provider,
                                    chunk_rows=STREAM_CHUNK_ROWS,
                                    types=btypes, cache=cache, device=dev,
                                    stats=stats)

        def check(res):
            if qname == "q6":
                want = oracle_np.numpy_q6(li)
                if int(res["revenue"][0]) != want:
                    raise AssertionError(
                        f"streamed Q6 {res['revenue']} != {want}")
            else:
                _check_q1(res, oracle_np.numpy_q1(li))

        t0 = time.perf_counter()
        check(to_numpy(run()))  # the warm-up: dictionaries, pinned ring
        first_s = time.perf_counter() - t0
        times, runs = [], []
        for _ in range(STREAM_RUNS):
            stats = StreamStats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = run(stats)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            runs.append(stats)
            check(to_numpy(out))
        ms = statistics.median(times)
        st = runs[-1]  # granules and bytes are the same every run
        copy_ms = statistics.median([r.copy_ms() for r in runs])
        compute_ms = statistics.median([r.compute_ms() for r in runs])
        link, link_gbs, basis = pcie_link()
        print(f"[stream] {qname}: {st.granules} granules of "
              f"{STREAM_CHUNK_ROWS} rows (last {n % STREAM_CHUNK_ROWS} "
              f"live) match the numpy oracle; first run {first_s:.3f} s "
              f"(dictionary pre-pass included)")
        print(f"[stream] {qname}: {ms:.3f} ms/run (median of {STREAM_RUNS}), "
              f"{n / (ms / 1e3):.1f} rows/s; whole-table plan (phase 4) "
              f"{n / (whole_ms[qname] / 1e3):.1f} rows/s; {card}")
        print(f"[stream] {qname}: H2D {st.h2d_bytes} B/run, copy "
              f"{copy_ms:.3f} ms on the copy stream = "
              f"{_gbs(st.h2d_bytes, copy_ms):.3f} GB/s "
              f"({_gbs(st.h2d_bytes, ms):.3f} GB/s over the run); "
              f"granule programs {compute_ms:.3f} ms on the compute stream; "
              f"host link gen,width,max gen,max width = {link} "
              f"(nominal {link_gbs:.3f} GB/s, {basis} link); {card}",
              flush=True)


def _gbs(nbytes, ms) -> float:
    return nbytes / ms / 1e6 if ms > 0 else float("nan")


def _timed_spill(torch, fn, runs):
    """One checked warm-up (peak memory from it), then the median of
    ``runs`` -> (warm-up result, ms, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    return res, statistics.median(times), peak


def _stats_text(st) -> str:
    return (f"kind={st.kind} runs={st.runs} bytes={st.bytes} "
            f"spilled_rows={st.spilled_rows} batches={st.batches} "
            f"host_reads={st.host_reads}")


def phase_spill(torch, dev, sess, tables, card, sql_stats, want):
    """Phase spill: the JAX package's spill tier at its ``Database``'s
    default work area (2^22 rows), lineitem the one over-budget table:
    the 11 TPC-H queries the tier runs, the S1 external sort and the J1
    co-partitioned disk join, each held against SQLite or numpy; the 8
    queries the tier refuses must raise NotDistributable."""
    import tempfile

    from oceanbase_tpu_torch.bench.harness import (
        spill_inputs, spilled_result, timed_statement,
    )
    from oceanbase_tpu_torch.bench.oracle import rows_match
    from oceanbase_tpu_torch.bench.surface_queries import S1
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.exec.granule import numpy_chunk_provider
    from oceanbase_tpu_torch.exec.spill import partitioned_join_spilled
    from oceanbase_tpu_torch.exec.spill_exec import SpillStats, execute_spilled
    from oceanbase_tpu_torch.px.planner import NotDistributable
    from oceanbase_tpu_torch.storage.tmpfile import TempFileStore

    host = {"lineitem": tables["lineitem"]}

    def spilled(plan, outputs):
        providers, device_tables, types_by_table = spill_inputs(
            sess.catalog, plan, host)
        with tempfile.TemporaryDirectory(prefix="ob_spill_") as d:
            arrays, valids, dtypes, st = execute_spilled(
                plan, providers, os.path.join(d, "q"), SPILL_BUDGET_ROWS,
                device_tables, types_by_table, set(host),
                chunk_rows=STREAM_CHUNK_ROWS, device=dev)
        return spilled_result(arrays, valids, dtypes, outputs), st

    def statement(name, sql, ordered, mem_ms, runs=SPILL_RUNS):
        label = f"q{name}" if isinstance(name, int) else name
        sess.execute(sql)  # the plan phase "sql" ran, re-plans included
        plan, outputs = sess.last_plan, sess.last_outputs
        (res, st), ms, peak = _timed_spill(
            torch, lambda: spilled(plan, outputs), runs)
        ok, why = rows_match(res.rows(), want[name][0], ordered=ordered)
        if not ok:
            raise AssertionError(f"spilled {label} differs from SQLite: "
                                 f"{why}")
        print(f"[spill] {label}: {ms:.3f} ms/query (median of {runs}), "
              f"rows={len(res.rows())} equal SQLite, {_stats_text(st)}, "
              f"peak_mem={peak} B; in memory {mem_ms}; {card}", flush=True)
        return ms

    total = 0.0
    for q in SPILL_QUERIES:
        sql = QUERIES[q]
        ordered = "order by" in sql.lower() and q not in (2, 18, 21)
        total += statement(q, sql, ordered,
                           f"{sql_stats[q][0]:.3f} ms (phase sql)")
    print(f"[spill] all {len(SPILL_QUERIES)} queries equal SQLite; "
          f"{total:.3f} ms in all (sum of medians) on {card}")
    for q in SPILL_REFUSED:
        sess.execute(QUERIES[q])
        try:
            spilled(sess.last_plan, sess.last_outputs)
        except NotDistributable as e:
            print(f"[spill] q{q}: NotDistributable ({e})")
            continue
        raise AssertionError(f"the spill tier ran Q{q}, which the JAX "
                             f"package's refuses")
    _res, s1_ms, _retries, _peak = timed_statement(sess, S1, SQL_RUNS)
    statement("S1", S1, True, f"{s1_ms:.3f} ms (median of {SQL_RUNS})",
              runs=SPILL_LONG_RUNS)

    # J1: lineitem ⋈ orders co-partitioned through disk
    li, od = tables["lineitem"], tables["orders"]
    left = {"l_orderkey": li["l_orderkey"],
            "l_extendedprice": li["l_extendedprice"]}
    right = {"o_orderkey": od["o_orderkey"], "o_orderdate": od["o_orderdate"]}

    def j1():
        st = SpillStats(kind="join")
        rows = price = 0
        with tempfile.TemporaryDirectory(prefix="ob_spill_") as d, \
                TempFileStore(os.path.join(d, "j1")) as store:
            for arrays, _valids in partitioned_join_spilled(
                    numpy_chunk_provider(left)("lineitem", STREAM_CHUNK_ROWS),
                    numpy_chunk_provider(right)("orders", STREAM_CHUNK_ROWS),
                    ["l_orderkey"], ["o_orderkey"], store, how="inner",
                    n_partitions=J1_PARTITIONS, budget_rows=SPILL_BUDGET_ROWS,
                    device=dev, stats=st):
                st.batches += 1
                rows += len(arrays["l_orderkey"])
                price += int(arrays["l_extendedprice"].sum())
            st.runs, st.bytes = store._next, store.bytes_written
        return rows, price, st

    (rows, price, st), ms, peak = _timed_spill(torch, j1, SPILL_LONG_RUNS)
    hit = np.isin(li["l_orderkey"], od["o_orderkey"])
    want_rows, want_price = int(hit.sum()), int(li["l_extendedprice"][hit].sum())
    if (rows, price) != (want_rows, want_price):
        raise AssertionError(f"J1 ({rows}, {price}) != numpy ({want_rows}, "
                             f"{want_price})")
    print(f"[spill] J1: {ms:.3f} ms (median of {SPILL_LONG_RUNS}), {rows} "
          f"rows, sum(l_extendedprice)={price} equal numpy, {_stats_text(st)}, "
          f"peak_mem={peak} B; {card}", flush=True)


# The SQLite oracle runs in two processes beside the card's phases
# (SQLite is single-threaded).  The first takes these TPC-H queries and
# the statements of bench/surface_queries.py but S1, the second the other
# TPC-H queries and S1: about equal SQLite time each, by per-query times
# taken at SF0.1.
ORACLE_FIRST = (1, 2, 3, 4, 5, 6, 7, 10, 11, 12, 13)


def oracle_jobs() -> list:
    """[(key, sql)] for each oracle process; a key is a TPC-H query
    number or a ``bench/surface_queries.py`` name, in the order run."""
    from oceanbase_tpu_torch.bench import surface_queries as sq
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES

    first = [(q, QUERIES[q]) for q in ORACLE_FIRST]
    first += [("IP1", sq.IP1)] + sorted(sq.READS.items()) + sq.D1
    second = [(q, sql) for q, sql in sorted(QUERIES.items())
              if q not in ORACLE_FIRST] + [("S1", sq.S1)]
    return [first, second]


def _oracle_worker(repo, sf, stmts, queue):
    """One oracle process: regenerate TPC-H from the same seed, load it
    into SQLite and run ``stmts`` -> {key: (rows, rowcount)}."""
    sys.path.insert(0, repo)
    from oceanbase_tpu_torch.bench.oracle import load_sqlite, run_oracle_stmt
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    tables, types = gen_tpch(sf=sf)
    t0 = time.perf_counter()
    conn = load_sqlite(tables, types)
    load_s = time.perf_counter() - t0
    del tables
    t0 = time.perf_counter()
    out = {key: run_oracle_stmt(conn, sql) for key, sql in stmts}
    queue.put((load_s, time.perf_counter() - t0, out))


def start_oracles(repo, sf) -> list:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    oracles = []
    for stmts in oracle_jobs():
        queue = ctx.Queue()
        proc = ctx.Process(target=_oracle_worker,
                           args=(repo, sf, stmts, queue), daemon=True)
        proc.start()
        oracles.append((proc, queue))
    return oracles


def oracle_results(oracles) -> dict:
    """Wait for every oracle process's answers; each must exit cleanly."""
    want = {}
    for i, (proc, queue) in enumerate(oracles):
        load_s, run_s, out = queue.get(timeout=900)
        proc.join(timeout=60)
        if proc.exitcode != 0:
            raise RuntimeError(f"oracle process exited {proc.exitcode}")
        print(f"[sql] set-up: SQLite oracle {i + 1} loaded in {load_s:.3f} "
              f"s, ran its {len(out)} statements in {run_s:.3f} s")
        want.update(out)
    return want


def phase_sql(dev, tables, types, card, oracles):
    """Phase 6: the 22 TPC-H queries through the port's SQL session."""
    from oceanbase_tpu_torch.bench.harness import (
        timed_statement, tpch_session,
    )
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES

    sess, load_s, analyze_s = tpch_session(tables, types, device=dev)
    print(f"[sql] catalog: {len(tables)} tables, "
          f"{sess.catalog.device_bytes()} bytes on {dev} in "
          f"{load_s:.3f} s")
    print(f"[sql] set-up: ANALYZE of {len(tables)} tables in "
          f"{analyze_s:.3f} s")

    got, stats = {}, {}
    for q, sql in sorted(QUERIES.items()):
        # the first run is the warm-up, checked below
        res, ms, retries, peak = timed_statement(sess, sql, SQL_RUNS)
        got[q] = res.rows()
        stats[q] = (ms, len(got[q]), retries, peak)
        print(f"[sql] q{q}: {ms:.3f} ms/query (median of {SQL_RUNS}, bind "
              f"included), rows={len(got[q])}, retries={retries}, "
              f"peak_mem={peak} B; {card}", flush=True)

    want = oracle_results(oracles)
    check_tpch(got, want, "")
    total_ms = sum(st[0] for st in stats.values())
    print(f"[sql] all 22 queries match SQLite; {total_ms:.3f} ms in all "
          f"(sum of medians) on {card}")
    return sess, want, stats


def check_tpch(got, want, tag):
    from oceanbase_tpu_torch.bench.oracle import rows_match
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES

    for q in sorted(got):
        sql = QUERIES[q]
        ordered = "order by" in sql.lower() and q not in (2, 18, 21)
        ok, why = rows_match(got[q], want[q][0], ordered=ordered)
        if not ok:
            raise AssertionError(f"Q{q}{tag} differs from the SQLite "
                                 f"oracle: {why}")


def phase_sql_index(torch, sess, tables, want, card):
    """Phase 7: the SF1 parity run's secondary indexes, each sidecar
    built and timed, then the 22 queries and IP1 again."""
    from oceanbase_tpu_torch.bench.harness import (
        key_indexes, timed_statement,
    )
    from oceanbase_tpu_torch.bench.surface_queries import IP1
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.exec.plan import (
        IndexProbe, TableScan, index_probes, prepare_index_probes,
    )
    from oceanbase_tpu_torch.expr import ir

    for ix, name, c in key_indexes(tables):
        sess.execute(f"create index {ix} on {name} ({c})")
        # build the sidecar now, as the first probe of it would
        rel = sess.catalog.table_data(name)
        side = {name: rel}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepare_index_probes(sess.catalog, IndexProbe(
            TableScan(name), name, ix, ir.col(c)), side)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        sc = side[IndexProbe.sidecar_name(name, ix)]
        nbytes = sum(col.data.numel() * col.data.element_size()
                     for col in sc.columns.values())
        print(f"[sql-index] sidecar {ix}: {ms:.3f} ms, {nbytes} B "
              f"({sc.capacity} lanes for {rel.capacity} rows); {card}")

    got, total_ms, total_probes = {}, 0.0, 0
    for q, sql in sorted(QUERIES.items()):
        res, ms, retries, peak = timed_statement(sess, sql, SQL_RUNS)
        got[q] = res.rows()
        probes = len(index_probes(sess.last_plan))
        total_ms += ms
        total_probes += probes
        print(f"[sql-index] q{q}: {ms:.3f} ms/query (median of {SQL_RUNS}), "
              f"rows={len(got[q])}, retries={retries}, peak_mem={peak} B, "
              f"index_probes={probes}; {card}", flush=True)
    check_tpch(got, want, " (indexed)")
    print(f"[sql-index] all 22 queries match SQLite; {total_ms:.3f} ms in "
          f"all (sum of medians), {total_probes} IndexProbe nodes; {card}")

    res, ms, retries, peak = timed_statement(sess, IP1, SQL_RUNS)
    probes = len(index_probes(sess.last_plan))
    print(f"[sql-index] IP1: {ms:.3f} ms/query (median of {SQL_RUNS}), "
          f"rows={len(res.rows())}, retries={retries}, peak_mem={peak} B, "
          f"index_probes={probes}; {card}")
    if probes < 1:
        raise AssertionError("IP1 did not plan an IndexProbe")
    return res.rows()


def phase_sql_surface(sess, card, ip1_rows, want):
    """Phase 8: window functions, unions and the D1 DML script on the
    same catalog, each held against SQLite (rows and rowcounts)."""
    from oceanbase_tpu_torch.bench import surface_queries as sq
    from oceanbase_tpu_torch.bench.harness import timed_statement
    from oceanbase_tpu_torch.bench.oracle import rows_match

    got = {}
    for name, sql in sorted(sq.READS.items()):
        res, ms, retries, peak = timed_statement(sess, sql, SQL_RUNS)
        got[name] = res.rows()
        print(f"[sql-surface] {name}: {ms:.3f} ms/query (median of "
              f"{SQL_RUNS}), rows={len(got[name])}, retries={retries}, "
              f"peak_mem={peak} B; {card}", flush=True)
    counts = {}
    for name, sql in sq.D1:
        res, ms, _retries, peak = timed_statement(sess, sql, 0)
        counts[name] = res.rowcount
        if name == "select":
            got[name] = res.rows()
        print(f"[sql-surface] D1 {name}: {ms:.3f} ms (one run), "
              f"rowcount={res.rowcount}, peak_mem={peak} B; {card}",
              flush=True)

    checks = [("IP1", ip1_rows, False)] + \
        [(n, got[n], n in sq.ORDERED) for n in sorted(sq.READS)] + \
        [("select", got["select"], True)]
    for name, rows, ordered in checks:
        ok, why = rows_match(rows, want[name][0], ordered=ordered,
                             rtol=sq.RTOL.get(name, 1e-6))
        if not ok:
            raise AssertionError(f"{name} differs from SQLite: {why}")
    for name, _sql in sq.D1:
        if name not in ("create", "select") and \
                counts[name] != want[name][1]:
            raise AssertionError(f"D1 {name}: rowcount {counts[name]} != "
                                 f"SQLite's {want[name][1]}")
    if "6-NONE" not in [r[0] for r in got["select"]]:
        raise AssertionError("D1's UPDATE lost the new '6-NONE' value")
    print(f"[sql-surface] IP1, {len(sq.READS)} reads and every D1 step "
          f"match SQLite, rowcounts included; {card}")


def _dir_bytes(root) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(root) for f in files)


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def phase_db(torch, dev, tables, types, card, want):
    """Phase db: the port's ``Database`` at TPC-H scale on the card — load,
    ANALYZE, the 22 queries (spilled or in memory, each against SQLite),
    the OLTP mix on orders, checkpoint, more commits, and a reopen that
    replays the WAL tail and reads back what was committed."""
    import gc
    import shutil
    import tempfile

    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.tx.errors import WriteConflict

    root = tempfile.mkdtemp(prefix="ob_db_")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        db = Database(root, device=dev)
        boot_s = time.perf_counter() - t0
        if DB_WORK_AREA_ROWS is not None:
            db.config.set("sql_work_area_rows", DB_WORK_AREA_ROWS)
        budget = int(db.config["sql_work_area_rows"])
        t0 = time.perf_counter()
        for name, arrays in tables.items():
            db.catalog.load_numpy(
                name, arrays, primary_key=TPCH_PRIMARY_KEYS[name],
                types={k: v for k, v in types.items() if k in arrays})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"[db] boot {boot_s:.3f} s; load of {len(tables)} tables into "
              f"the LSM {load_s:.3f} s, {_dir_bytes(root)} bytes on disk; "
              f"work area {budget} rows; {card}", flush=True)
        sess = db.session()
        t0 = time.perf_counter()
        for name in tables:
            sess.execute(f"analyze table {name}")
        torch.cuda.synchronize()
        print(f"[db] ANALYZE of {len(tables)} tables {time.perf_counter() - t0:.3f}"
              f" s; cached relations {db.catalog.device_bytes()} B")
        for name in tables:
            rel = db.catalog.table_data(name)
            if rel.device.type != dev.type:
                raise AssertionError(f"{name}'s relation is on {rel.device}")
        print(f"[db] table_data relations of all {len(tables)} tables on "
              f"{dev}")

        got, total_ms, n_spilled = {}, 0.0, 0
        for q in DB_QUERIES:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = sess.execute(QUERIES[q])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            got[q] = res.rows()
            total_ms += ms
            st = sess.last_spill
            n_spilled += st is not None
            route = f"spilled ({_stats_text(st)})" if st is not None \
                else f"in memory (retries={sess.last_retries})"
            print(f"[db] q{q}: {ms:.3f} ms (one run), rows={len(got[q])}, "
                  f"{route}; {card}", flush=True)
        check_tpch(got, want, " (db)")
        print(f"[db] all {len(got)} queries match SQLite, {n_spilled} "
              f"through the spill route; {total_ms:.3f} ms in all")

        # -- OLTP on orders ----------------------------------------------
        od = tables["orders"]
        n_ord = len(od["o_orderkey"])
        rng = np.random.default_rng(DB_SEED)
        picks = rng.choice(n_ord, DB_POINT_OPS + 8, replace=False)
        keys = [int(od["o_orderkey"][i]) for i in picks]
        price = {k: int(od["o_totalprice"][i]) for k, i in zip(keys, picks)}
        commit_ms = []
        commit = db.tx.commit

        def timed_commit(tx):
            t = time.perf_counter()
            out = commit(tx)
            commit_ms.append((time.perf_counter() - t) * 1e3)
            return out

        db.tx.commit = timed_commit
        upd_ms = []
        for k in keys[:DB_POINT_OPS]:
            t1 = time.perf_counter()
            n = sess.execute(f"update orders set o_totalprice = o_totalprice"
                             f" + 1.00 where o_orderkey = {k}").rowcount
            upd_ms.append((time.perf_counter() - t1) * 1e3)
            price[k] += 100
            if n != 1 or sess.last_access_paths.get(
                    "orders") is None:
                raise AssertionError(f"point UPDATE of {k}: rowcount {n}, "
                                     f"path {sess.last_access_paths}")
        print(f"[db] {DB_POINT_OPS} autocommit point UPDATEs: statement "
              f"p50 {_pct(upd_ms, 50):.3f} ms p99 {_pct(upd_ms, 99):.3f} ms; "
              f"WAL commit p50 {_pct(commit_ms, 50):.3f} ms p99 "
              f"{_pct(commit_ms, 99):.3f} ms (3 replicas, fsync each); "
              f"relation {sess.last_dml_capacity} lanes via the "
              f"{sess.last_access_paths['orders'].kind} key path; {card}")
        sel_ms = []
        for k in keys[:DB_POINT_OPS]:
            t1 = time.perf_counter()
            rows = sess.execute(f"select o_totalprice from orders where "
                                f"o_orderkey = {k}").rows()
            sel_ms.append((time.perf_counter() - t1) * 1e3)
            if rows != [(price[k] / 100,)]:
                raise AssertionError(f"point SELECT of {k}: {rows}")
        print(f"[db] {DB_POINT_OPS} point SELECTs: the first {sel_ms[0]:.3f}"
              f" ms (re-materializes orders after the UPDATEs), then p50 "
              f"{_pct(sel_ms[1:], 50):.3f} ms p99 {_pct(sel_ms[1:], 99):.3f}"
              f" ms; {card}")

        k1, k2, k3, k4, k5, k6, k7, k8 = keys[DB_POINT_OPS:]
        new_key = int(od["o_orderkey"].max()) + 1
        sess.execute("begin")
        sess.execute(f"update orders set o_totalprice = o_totalprice + 5.00"
                     f" where o_orderkey in ({k1}, {k2})")
        sess.execute(f"insert into orders values ({new_key}, 1, 'O', 123.45,"
                     f" '1998-01-01', '1-URGENT', 'Clerk#000000001', 0, "
                     f"'port db phase')")
        sess.execute("commit")
        price[k1] += 500
        price[k2] += 500
        price[new_key] = 12345
        sess.execute("begin")
        sess.execute(f"update orders set o_totalprice = 0 where o_orderkey"
                     f" = {k3}")
        sess.execute(f"delete from orders where o_orderkey = {k4}")
        sess.execute("rollback")
        for k in (k3, k4):
            if sess.execute(f"select o_totalprice from orders where "
                            f"o_orderkey = {k}").rows() != [(price[k] / 100,)]:
                raise AssertionError(f"rolled-back write to {k} visible")
        s2 = db.session()
        sess.execute("begin")
        sess.execute(f"update orders set o_totalprice = o_totalprice + 2.00"
                     f" where o_orderkey = {k5}")
        try:
            s2.execute(f"update orders set o_totalprice = 1 where "
                       f"o_orderkey = {k5}")
        except WriteConflict as e:
            print(f"[db] write conflict between two sessions raised: {e}")
        else:
            raise AssertionError("the second writer of a key did not "
                                 "conflict")
        sess.execute("commit")
        price[k5] += 200
        print("[db] multi-statement transaction committed, rolled-back "
              "one invisible")

        t0 = time.perf_counter()
        db.checkpoint()
        ckpt_s = time.perf_counter() - t0
        for k in (k6, k7):
            sess.execute(f"update orders set o_totalprice = o_totalprice + "
                         f"3.00 where o_orderkey = {k}")
            price[k] += 300
        sess.execute(f"delete from orders where o_orderkey = {k8}")
        del price[k8]
        n_live = n_ord  # one row inserted, one deleted
        peak = torch.cuda.max_memory_allocated()
        print(f"[db] checkpoint {ckpt_s:.3f} s, then 3 more commits; peak "
              f"device memory {peak} B; {_dir_bytes(root)} bytes on disk")

        # -- drop without close() and reopen: WAL tail replay -------------
        del sess, s2, db
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        db = Database(root, device=dev)
        reopen_s = time.perf_counter() - t0
        print(f"[db] reopen {reopen_s:.3f} s, replayed "
              f"{db.tenant().replayed_entries} WAL entries")
        sess = db.session()
        for k, p in sorted(price.items()):
            rows = sess.execute(f"select o_totalprice from orders where "
                                f"o_orderkey = {k}").rows()
            if rows != [(p / 100,)]:
                raise AssertionError(f"reopened: key {k} reads {rows}, "
                                     f"committed {p / 100}")
        if sess.execute(f"select count(*) from orders where o_orderkey = "
                        f"{k8}").rows() != [(0,)]:
            raise AssertionError("reopened: the deleted row is back")
        if sess.execute("select count(*) from orders").rows() != \
                [(n_live,)]:
            raise AssertionError("reopened: orders' row count differs")
        reread = {}
        for q in (6,):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            reread[q] = sess.execute(QUERIES[q]).rows()
            torch.cuda.synchronize()
            print(f"[db] reopened q{q}: {(time.perf_counter() - t1) * 1e3:.3f}"
                  f" ms, route {'spilled' if sess.last_spill else 'in memory'}")
        check_tpch(reread, want, " (reopened db)")
        print(f"[db] the reopened database reads back all {len(price)} "
              f"committed point rows, orders' {n_live} rows and Q6; "
              f"{card}")
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _order_row(k, price="123.45", note="load phase") -> str:
    return (f"({k}, 1, 'O', {price}, '1998-01-01', '1-URGENT', "
            f"'Clerk#000000001', 0, '{note}')")


def phase_load(torch, dev, tables, types, card, want, root):
    """Phase load: TPC-H as OceanBase's users load it — ``|``-delimited
    files, ``lineitem`` and ``orders`` RANGE-partitioned on the order key
    (``LOAD_PARTITIONS`` partitions of equal key width), LOAD DATA INFILE
    through the native tokenizer into a fresh ``Database`` on the card,
    ANALYZE, the 22 queries against SQLite; then the statement surface on
    the loaded data (the duplicate-key check, REPLACE, a partition-moving
    UPDATE, AUTO_INCREMENT and a sequence, SAVEPOINT, ALTER TABLE, LOCK
    TABLES, an XA branch left prepared) and a reopen without ``close()``
    that recovers all of it.  Last, the rows the statement surface
    changed are put back as loaded, and the open database, its ``.tbl``
    files (under ``root``) and the 22 in-process results go on to phase
    server."""
    import gc
    import threading

    from oceanbase_tpu_torch.bench.tbl import create_table_sql, write_tbl
    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.tx.errors import DuplicateKey, WriteConflict

    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        print(f"[load] step {name}: {steps[name]:.3f} s", flush=True)

    t0 = time.perf_counter()
    files = {}
    for name, arrays in tables.items():
        files[name] = os.path.join(root, f"{name}.tbl")
        write_tbl(files[name], arrays,
                  {k: v for k, v in types.items() if k in arrays})
    step("write .tbl files", t0)
    torch.cuda.reset_peak_memory_stats()
    db = Database(os.path.join(root, "db"), device=dev)
    sess = db.session()
    od = tables["orders"]
    top = int(od["o_orderkey"].max()) + 1
    bounds = [top * i // LOAD_PARTITIONS
              for i in range(1, LOAD_PARTITIONS)]
    t0 = time.perf_counter()
    for name, arrays in tables.items():
        part = None
        if name in ("orders", "lineitem"):
            part = (name[0] + "_orderkey", bounds)
        sess.execute(create_table_sql(
            name, arrays, {k: v for k, v in types.items()
                           if k in arrays},
            TPCH_PRIMARY_KEYS[name], part))
        nbytes = os.path.getsize(files[name])
        t1 = time.perf_counter()
        res = sess.execute(f"load data infile '{files[name]}' into "
                           f"table {name} fields terminated by '|'")
        secs = time.perf_counter() - t1
        n = len(next(iter(arrays.values())))
        if res.rowcount != n or sess.last_load["route"] != "native":
            raise AssertionError(f"LOAD DATA {name}: {res.rowcount} "
                                 f"rows of {n}, {sess.last_load}")
        print(f"[load] {name}: {n} rows, {nbytes} bytes in "
              f"{secs:.3f} s ({nbytes / secs / 1e6:.1f} MB/s), native "
              f"tokenizer{', ' + str(LOAD_PARTITIONS) + ' partitions' if part else ''}",
              flush=True)
    step("LOAD DATA of 8 tables", t0)
    for name in ("orders", "lineitem"):
        parts = db.engine.tables[name].tablet.partitions
        print(f"[load] {name} rows per partition: "
              f"{[sum(sg.n_rows for sg in p.segments) for p in parts]}")
    t0 = time.perf_counter()
    for name in tables:
        sess.execute(f"analyze table {name}")
    torch.cuda.synchronize()
    step("ANALYZE", t0)
    for name in tables:
        rel = db.catalog.table_data(name)
        if rel.device.type != dev.type:
            raise AssertionError(f"{name}'s relation is on {rel.device}")
    print(f"[load] table_data relations of all {len(tables)} tables on "
          f"{dev}")

    t0 = time.perf_counter()
    got, total_ms, n_spilled = {}, 0.0, 0
    results, load_ms, spill_stats = {}, {}, {}
    for q, sql in sorted(QUERIES.items()):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = sess.execute(sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        got[q] = res.rows()
        results[q], load_ms[q] = res, ms
        total_ms += ms
        st = sess.last_spill
        spill_stats[q] = st
        n_spilled += st is not None
        route = f"spilled ({_stats_text(st)})" if st is not None \
            else f"in memory (retries={sess.last_retries})"
        print(f"[load] q{q}: {ms:.3f} ms (one run), rows={len(got[q])},"
              f" {route}; {card}", flush=True)
    check_tpch(got, want, " (load)")
    print(f"[load] all 22 queries match SQLite, {n_spilled} through "
          f"the spill route over the chained partitions; "
          f"{total_ms:.3f} ms in all")
    step("22 queries", t0)

    # -- the statement surface on the loaded data ---------------------
    t0 = time.perf_counter()
    n_ord = len(od["o_orderkey"])
    dup = int(od["o_orderkey"][n_ord // 3])
    try:
        sess.execute(f"insert into orders values {_order_row(dup)}")
    except DuplicateKey as e:
        print(f"[load] INSERT of loaded key {dup} refused: {e}")
    else:
        raise AssertionError("a duplicate INSERT over the loaded "
                             "baseline committed")
    ins_ms = []
    fresh = [top + 10 + i for i in range(LOAD_POINT_INSERTS)]
    for k in fresh:
        t1 = time.perf_counter()
        sess.execute(f"insert into orders values {_order_row(k)}")
        ins_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"[load] {LOAD_POINT_INSERTS} autocommit INSERTs of new "
          f"orders keys (the duplicate check over memtables and "
          f"segments): p50 {_pct(ins_ms, 50):.3f} ms p99 "
          f"{_pct(ins_ms, 99):.3f} ms; {card}")
    rep_old = int(od["o_orderkey"][n_ord // 2])
    rep_new = top + 5
    sess.execute(f"replace into orders values "
                 f"{_order_row(rep_old, '7.77', 'replaced')}, "
                 f"{_order_row(rep_new, '8.88', 'replaced')}")
    for k, p in ((rep_old, 7.77), (rep_new, 8.88)):
        rows = sess.execute(f"select o_totalprice, o_comment from "
                            f"orders where o_orderkey = {k}").rows()
        if rows != [(p, "replaced")]:
            raise AssertionError(f"REPLACE of {k} reads {rows}")
    mv_old = int(od["o_orderkey"][5])          # partition 0
    mv_new = top + 1                            # the last partition
    n = sess.execute(f"update orders set o_orderkey = {mv_new} where "
                     f"o_orderkey = {mv_old}").rowcount
    moved = sess.execute(f"select count(*) from orders where "
                         f"o_orderkey in ({mv_old}, {mv_new})").rows()
    a = sess.execute(f"select o_custkey from orders where o_orderkey = "
                     f"{mv_new}").rows()
    if n != 1 or moved != [(1,)] or \
            a != [(int(od["o_custkey"][5]),)]:
        raise AssertionError(f"partition-moving UPDATE: {n}, {moved}, "
                             f"{a}")
    n_orders = n_ord + LOAD_POINT_INSERTS + 1   # + fresh + rep_new
    print(f"[load] REPLACE of an existing and a new key, and the "
          f"partition-moving UPDATE of {mv_old} -> {mv_new} read back")

    sess.execute("create table ev (id int primary key auto_increment, "
                 "okey int, note varchar(16))")
    sess.execute("create sequence seq start 1000 increment 10")
    sess.execute(f"insert into ev (okey, note) values ({mv_new}, "
                 f"'moved'), ({rep_new}, 'replaced')")
    sess.execute("insert into ev values (nextval('seq'), 0, 'seq')")
    ev_rows = sess.execute("select id, okey, note from ev order by "
                           "id").rows()
    if [r[0] for r in ev_rows] != [1, 2, 1000]:
        raise AssertionError(f"AUTO_INCREMENT/sequence ids {ev_rows}")
    sess.execute("alter table ev add column tag varchar(8)")

    lk = (int(tables["lineitem"]["l_orderkey"][7]),
          int(tables["lineitem"]["l_linenumber"][7]))
    where = f"l_orderkey = {lk[0]} and l_linenumber = {lk[1]}"
    sess.execute("begin")
    sess.execute(f"update lineitem set l_comment = 'kept' where {where}")
    sess.execute("savepoint sp")
    sess.execute(f"delete from lineitem where {where}")
    sess.execute("rollback to savepoint sp")
    sess.execute("commit")
    rows = sess.execute(f"select l_comment from lineitem where "
                        f"{where}").rows()
    if rows != [("kept",)]:
        raise AssertionError(f"SAVEPOINT over lineitem reads {rows}")
    print("[load] AUTO_INCREMENT ids 1, 2 and nextval 1000; SAVEPOINT "
          "/ ROLLBACK TO in a transaction writing lineitem kept the "
          "update and undid the delete")

    sess.execute("alter table orders add column o_note varchar(16)")
    sess.execute(f"update orders set o_note = 'moved' where "
                 f"o_orderkey = {mv_new}")
    notes = sess.execute("select o_note, count(*) from orders group by "
                         "o_note order by o_note").rows()
    if notes != [(None, n_orders - 1), ("moved", 1)]:
        raise AssertionError(f"ADD COLUMN reads {notes}")
    sess.execute("alter table orders drop column o_note")
    if "o_note" in [c.name for c in db.catalog.table_def(
            "orders").columns]:
        raise AssertionError("DROP COLUMN left o_note")
    print(f"[load] ALTER TABLE orders ADD COLUMN reads NULL for the "
          f"{n_orders - 1} loaded rows and the set value, then DROP "
          f"COLUMN")

    s2 = db.session()
    sess.execute("set global lock_wait_timeout_s = 0.5")
    sess.execute("lock tables orders write")
    try:
        s2.execute(f"insert into orders values {_order_row(top + 2)}")
    except WriteConflict as e:
        print(f"[load] a second session's INSERT under LOCK TABLES "
              f"orders WRITE timed out: {e}")
    else:
        raise AssertionError("a write under another session's LOCK "
                             "TABLES WRITE did not wait")
    sess.execute("set global lock_wait_timeout_s = 60")
    done = {}

    def blocked_write():
        s2.execute(f"insert into orders values {_order_row(top + 2)}")
        done["at"] = time.perf_counter()

    th = threading.Thread(target=blocked_write, daemon=True)
    th.start()
    time.sleep(0.5)
    if done:
        raise AssertionError("the write did not wait for UNLOCK")
    released = time.perf_counter()
    sess.execute("unlock tables")
    th.join(timeout=60)
    if "at" not in done:
        raise AssertionError("the write did not proceed after UNLOCK")
    n_orders += 1
    print(f"[load] after UNLOCK TABLES the waiting INSERT went on in "
          f"{(done['at'] - released) * 1e3:.3f} ms")

    s3 = db.session()
    xa_key = top + 3
    for sql in ("xa start 'load-x1'",
                f"insert into orders values {_order_row(xa_key)}",
                "xa end 'load-x1'", "xa prepare 'load-x1'"):
        s3.execute(sql)
    if sess.execute("xa recover").rows() != [("load-x1",)]:
        raise AssertionError("XA RECOVER misses the prepared branch")
    step("statement surface", t0)
    peak = torch.cuda.max_memory_allocated()
    print(f"[load] peak device memory {peak} B; {_dir_bytes(root)} "
          f"bytes on disk")

    # -- drop without close() and reopen ------------------------------
    del sess, s2, s3, db
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db = Database(os.path.join(root, "db"), device=dev)
    print(f"[load] reopen {time.perf_counter() - t0:.3f} s, replayed "
          f"{db.tenant().replayed_entries} WAL entries")
    sess = db.session()
    if sess.execute("xa recover").rows() != [("load-x1",)]:
        raise AssertionError("reopened: XA RECOVER misses the branch")
    sess.execute("xa commit 'load-x1'")
    n_orders += 1
    checks = {
        "select count(*) from orders": [(n_orders,)],
        f"select count(*) from orders where o_orderkey in ({mv_old}, "
        f"{dup})": [(1,)],
        f"select o_custkey from orders where o_orderkey = {mv_new}":
            [(int(od["o_custkey"][5]),)],
        f"select o_totalprice from orders where o_orderkey = "
        f"{rep_old}": [(7.77,)],
        f"select count(*) from orders where o_orderkey = {xa_key}":
            [(1,)],
        f"select l_comment from lineitem where {where}": [("kept",)],
    }
    for sql, rows in checks.items():
        got_rows = sess.execute(sql).rows()
        if got_rows != rows:
            raise AssertionError(f"reopened: {sql} -> {got_rows}, "
                                 f"want {rows}")
    sess.execute("insert into ev (okey, note, tag) values (0, 'after', "
                 "'reopen')")
    ev_rows = sess.execute("select id, tag from ev order by id").rows()
    if ev_rows != [(1, None), (2, None), (1000, None),
                   (1001, "reopen")]:
        raise AssertionError(f"reopened: ev reads {ev_rows}")
    reread = {}
    for q in (1, 6):
        reread[q] = sess.execute(QUERIES[q]).rows()
    check_tpch(reread, want, " (reopened load)")
    print(f"[load] the reopened database reads back every committed "
          f"row ({n_orders} orders), commits the prepared XA branch, "
          f"keeps ev's added column and AUTO_INCREMENT counter (next "
          f"id 1001), and Q1 and Q6 equal SQLite; {card}")

    # -- put back the rows the statement surface changed ---------------
    t0 = time.perf_counter()
    sess.execute(f"update orders set o_orderkey = {mv_old} where "
                 f"o_orderkey = {mv_new}")
    sess.execute(f"delete from orders where o_orderkey >= {top}")
    sess.execute(f"replace into orders values "
                 f"{_loaded_row(od, types, n_ord // 2)}")
    comment = tables["lineitem"]["l_comment"][7].replace("'", "''")
    sess.execute(f"update lineitem set l_comment = '{comment}' where "
                 f"{where}")
    back = sess.execute("select count(*) from orders").rows()
    if back != [(n_ord,)]:
        raise AssertionError(f"restored orders count {back}")
    sess.close()
    step("restore the loaded rows", t0)
    print(f"[load] steps: " + ", ".join(f"{k} {v:.3f} s"
                                        for k, v in steps.items()))
    return {"db": db, "files": files, "results": results,
            "load_ms": load_ms, "spill": spill_stats, "top": top}


def _loaded_row(arrays, types, i) -> str:
    """Row ``i`` of a generated table as a VALUES tuple (DECIMAL from
    its scaled int, DATE as text, strings quoted)."""
    from oceanbase_tpu_torch.datatypes import TypeKind, days_to_date
    from oceanbase_tpu_torch.server.mysql_protocol import format_decimal

    out = []
    for c, a in arrays.items():
        t = types.get(c)
        x = a[i]
        if t is not None and t.kind == TypeKind.DECIMAL:
            out.append(format_decimal(int(x), t.scale))
        elif t is not None and t.kind == TypeKind.DATE:
            out.append(f"'{days_to_date(int(x))}'")
        elif isinstance(x, str):
            out.append("'" + x.replace("'", "''") + "'")
        else:
            out.append(str(int(x)))
    return "(" + ", ".join(out) + ")"


# ---------------------------------------------------------------------------
# phase server: the MySQL wire protocol over phase load's Database
# ---------------------------------------------------------------------------

# column types of the text protocol's column definitions
_MYSQL_INT, _MYSQL_DOUBLE, _MYSQL_NEWDECIMAL = 8, 5, 246
SERVER_PREPARED = 200            # prepared point SELECTs on orders
SERVER_CONNS = 4                 # concurrent connections, step 5
SERVER_ADMISSION_CONNS = 6       # Q6 senders per admission round


class WireError(RuntimeError):
    """An ERR packet: its code and message."""


class WireClient:
    """A minimal MySQL 4.1 client over a raw socket: handshake with
    mysql_native_password, COM_QUERY (text rows), COM_STMT_PREPARE /
    EXECUTE with one LONGLONG parameter (binary rows), COM_QUIT."""

    def __init__(self, host, port, user="root", password=""):
        import hashlib
        import socket
        import struct

        self._struct = struct
        self.sock = socket.create_connection((host, port), timeout=600)
        # buffered reads: a result set is many small packets, and a
        # system call per packet header would time the client, not the
        # server
        self._rf = self.sock.makefile("rb")
        self.seq = 0
        greeting = self._read()
        end = greeting.index(b"\x00", 1)
        self.connection_id = struct.unpack_from("<I", greeting, end + 1)[0]
        p = end + 5
        salt = greeting[p:p + 8]
        rest = greeting[p + 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10:]
        salt += rest[:rest.index(b"\x00")]
        token = b""
        if password:
            sha = hashlib.sha1(password.encode()).digest()
            mask = hashlib.sha1(salt[:20] +
                                hashlib.sha1(sha).digest()).digest()
            token = bytes(a ^ b for a, b in zip(sha, mask))
        self._send(struct.pack("<IIB", 0x0200 | 0x8000, 1 << 24, 0x21) +
                   b"\x00" * 23 + user.encode() + b"\x00" +
                   bytes([len(token)]) + token)
        ok = self._read()
        if ok[0] != 0x00:
            raise PermissionError(f"login of {user!r} refused: "
                                  f"{ok[9:].decode(errors='replace')}")

    def _read_n(self, n):
        buf = self._rf.read(n)
        if len(buf) < n:
            raise ConnectionError("server closed the connection")
        return buf

    def _read(self):
        hdr = self._read_n(4)
        (ln,) = self._struct.unpack("<I", hdr[:3] + b"\x00")
        self.seq = hdr[3] + 1
        return self._read_n(ln)

    def _send(self, payload):
        self.sock.sendall(self._struct.pack("<I", len(payload))[:3] +
                          bytes([self.seq & 0xFF]) + payload)
        self.seq += 1

    @staticmethod
    def _lenenc(buf, pos):
        import struct

        c = buf[pos]
        if c < 251:
            return c, pos + 1
        if c == 0xFC:
            return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
        if c == 0xFD:
            return struct.unpack("<I", buf[pos + 1:pos + 4] + b"\x00")[0], \
                pos + 4
        return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9

    def _result(self, binary=False):
        """-> (columns [(name, type, decimals)], rows of text or None),
        or the affected rows of an OK packet."""
        first = self._read()
        if first[0] == 0xFF:
            raise WireError(first[9:].decode(errors="replace"))
        if first[0] == 0x00:
            return self._lenenc(first, 1)[0]
        ncols, _ = self._lenenc(first, 0)
        cols = []
        for _ in range(ncols):
            pkt, pos, strs = self._read(), 0, []
            for _ in range(6):
                ln, pos = self._lenenc(pkt, pos)
                strs.append(pkt[pos:pos + ln].decode())
                pos += ln
            cols.append((strs[4], pkt[pos + 7], pkt[pos + 10]))
        self._read()  # EOF
        rows = []
        while True:
            pkt = self._read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return cols, rows
            rows.append(self._binary_row(pkt, cols) if binary
                        else self._text_row(pkt))

    def _text_row(self, pkt):
        pos, row = 0, []
        while pos < len(pkt):
            if pkt[pos] == 0xFB:
                row.append(None)
                pos += 1
            else:
                ln, pos = self._lenenc(pkt, pos)
                row.append(pkt[pos:pos + ln].decode())
                pos += ln
        return row

    def _binary_row(self, pkt, cols):
        nulls = pkt[1:1 + (len(cols) + 9) // 8]
        pos, row = 1 + len(nulls), []
        for i, (_n, mtype, _d) in enumerate(cols):
            if nulls[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                row.append(None)
            elif mtype == _MYSQL_INT:
                row.append(self._struct.unpack_from("<q", pkt, pos)[0])
                pos += 8
            elif mtype == _MYSQL_DOUBLE:
                row.append(self._struct.unpack_from("<d", pkt, pos)[0])
                pos += 8
            else:
                ln, pos = self._lenenc(pkt, pos)
                row.append(pkt[pos:pos + ln].decode())
                pos += ln
        return row

    def query(self, sql):
        self.seq = 0
        self._send(b"\x03" + sql.encode())
        return self._result()

    def prepare(self, sql) -> int:
        self.seq = 0
        self._send(b"\x16" + sql.encode())
        ok = self._read()
        if ok[0] != 0x00:
            raise WireError(ok[9:].decode(errors="replace"))
        stmt_id, _ncols, nparams = self._struct.unpack_from("<IHH", ok, 1)
        for _ in range(nparams + (1 if nparams else 0)):
            self._read()  # parameter definitions, EOF
        return stmt_id

    def execute(self, stmt_id, value: int):
        self.seq = 0
        self._send(b"\x17" + self._struct.pack("<IBI", stmt_id, 0, 1) +
                   b"\x00\x01" + self._struct.pack("<Hq", 8, value))
        return self._result(binary=True)

    def close(self):
        try:
            self.seq = 0
            self._send(b"\x01")
        except OSError:
            pass
        self._rf.close()
        self.sock.close()


def _wire_values(cols, rows):
    """Text rows -> Python values by column type, for the SQLite check
    (DECIMAL as float, as ``Result.rows()`` gives it)."""
    conv = []
    for _name, mtype, _dec in cols:
        conv.append(int if mtype == _MYSQL_INT else
                    float if mtype in (_MYSQL_DOUBLE, _MYSQL_NEWDECIMAL)
                    else str)
    return [tuple(None if v is None else f(v) for f, v in zip(conv, r))
            for r in rows]


def _decimal_cells_exact(cols, rows, res, q):
    """Every DECIMAL cell's text on the wire equals the in-process
    scaled int formatted with its scale (ROADMAP Queue 3 #16) -> the
    number of cells checked."""
    from oceanbase_tpu_torch.datatypes import TypeKind
    from oceanbase_tpu_torch.server.mysql_protocol import format_decimal

    n = 0
    for j, name in enumerate(res.names):
        t = res.dtypes.get(name)
        if t is None or t.kind != TypeKind.DECIMAL:
            continue
        if cols[j][1] != _MYSQL_NEWDECIMAL or cols[j][2] != t.scale:
            raise AssertionError(f"Q{q} column {name}: {cols[j]} on the "
                                 f"wire for {t}")
        valid = res.valids.get(name)
        want = sorted(format_decimal(int(x), t.scale)
                      for i, x in enumerate(res.arrays[name])
                      if valid is None or valid[i])
        got = sorted(r[j] for r in rows if r[j] is not None)
        if got != want:
            raise AssertionError(f"Q{q} column {name}: DECIMAL text on the "
                                 f"wire differs from the scaled ints")
        n += len(got)
    return n


def _in_threads(fns):
    """Run each callable on its own thread, all started together ->
    their results (an exception is a result)."""
    import threading

    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 — checked by the caller
            out[i] = e

    ths = [threading.Thread(target=run, args=(i, fn), daemon=True)
           for i, fn in enumerate(fns)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(600)
        if th.is_alive():
            raise AssertionError("a wire client thread did not finish")
    return out


def _wire_worker(host, port, stmts, barrier, queue):
    """One client process of the concurrency step: connect, wait for
    the others, run ``stmts`` [(key, sql)] -> queue.put((start, end,
    {key: (cols, rows, ms)})).  The clients run outside the server's
    process, so their reading does not share its interpreter lock."""
    c = WireClient(host, port)
    barrier.wait(timeout=600)
    out = {}
    start = time.perf_counter()
    for key, sql in stmts:
        t1 = time.perf_counter()
        cols, rows = c.query(sql)
        out[key] = (cols, rows, (time.perf_counter() - t1) * 1e3)
    end = time.perf_counter()
    c.close()
    queue.put((start, end, out))


def _poll(cond, what, timeout_s=120.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def phase_server(torch, dev, tables, types, card, want, loaded):
    """Phase server: phase load's SF1 ``Database`` behind the port's
    ``MySQLServer`` on 127.0.0.1, driven by ``WireClient`` connections:
    the 22 queries as root (SQLite answers, exact DECIMAL text), the
    plan cache, prepared point SELECTs, a user, four concurrent
    connections, admission (QUEUED rows, ServerBusy), KILL QUERY by the
    greeting's connection id, a statement timeout, a procedure, a second
    tenant, a DBMS job, and a restart without a checkpoint."""
    from oceanbase_tpu_torch.bench.oracle import rows_match
    from oceanbase_tpu_torch.bench.tbl import create_table_sql
    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.server.mysql_protocol import MySQLServer

    db, top = loaded["db"], loaded["top"]
    steps = {}
    ordered = {q: "order by" in QUERIES[q].lower() and q not in (2, 18, 21)
               for q in QUERIES}
    in_memory = [q for q in sorted(QUERIES) if loaded["spill"][q] is None]
    if len(in_memory) != 11:
        raise AssertionError(f"phase load ran {in_memory} in memory")

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        print(f"[server] step {name}: {steps[name]:.3f} s", flush=True)

    def check(q, cols, rows, tag):
        ok, why = rows_match(_wire_values(cols, rows), want[q][0],
                             ordered=ordered[q])
        if not ok:
            raise AssertionError(f"Q{q}{tag} over the wire differs from "
                                 f"SQLite: {why}")

    def timed(c, sql):
        t1 = time.perf_counter()
        out = c.query(sql)
        return out, (time.perf_counter() - t1) * 1e3

    # phase load's reopen left the tables without optimizer statistics
    # (ANALYZE results are not persisted); gather them again, as after
    # the load
    t0 = time.perf_counter()
    sess = db.session()
    for name in tables:
        sess.execute(f"analyze table {name}")
    sess.close()
    torch.cuda.synchronize()
    step("ANALYZE", t0)
    srv = MySQLServer(db, host="127.0.0.1", port=0).start()
    print(f"[server] MySQLServer on {srv.host}:{srv.port} over phase "
          f"load's database (tenants {sorted(db.tenants)}, device "
          f"{db.device})")
    try:
        # 1. the 22 queries over the wire -----------------------------------
        t0 = time.perf_counter()
        c = WireClient(srv.host, srv.port)
        wire_ms, n_dec = {}, 0
        for q, sql in sorted(QUERIES.items()):
            (cols, rows), ms = timed(c, sql)
            wire_ms[q] = ms
            check(q, cols, rows, "")
            n_dec += _decimal_cells_exact(cols, rows, loaded["results"][q],
                                          q)
            route = "spilled" if loaded["spill"][q] is not None \
                else "in memory"
            print(f"[server] q{q}: {ms:.3f} ms over the wire (one run, "
                  f"{route}), in-process {loaded['load_ms'][q]:.3f} ms "
                  f"(phase load), rows={len(rows)}; {card}", flush=True)
        for name in tables:
            rel = db.catalog.table_data(name)
            if rel.device.type != dev.type:
                raise AssertionError(f"{name}'s relation is on "
                                     f"{rel.device}")
        print(f"[server] all 22 queries over the wire match SQLite; "
              f"{n_dec} DECIMAL cells equal the in-process scaled ints "
              f"with their scale; {sum(wire_ms.values()):.3f} ms over the "
              f"wire against {sum(loaded['load_ms'].values()):.3f} ms "
              f"in-process; relations of all {len(tables)} tables on "
              f"{dev}")
        step("22 queries over the wire", t0)

        # 2. the plan cache --------------------------------------------------
        t0 = time.perf_counter()
        sess = srv.session(c.connection_id)
        cache0 = db.catalog._cache.stats()
        hit_ms, off_ms, hit = {}, {}, {}
        for q in in_memory:
            h0 = sess.plan_cache_stats["hits"]
            (cols, rows), hit_ms[q] = timed(c, QUERIES[q])
            hit[q] = sess.plan_cache_stats["hits"] - h0
            check(q, cols, rows, " (second run)")
        hits = sum(hit.values())
        cache1 = db.catalog._cache.stats()
        if hits < 1:
            raise AssertionError("no plan-cache hit on the second run")
        db.config.set("enable_plan_cache", False)
        for q in in_memory:
            (cols, rows), off_ms[q] = timed(c, QUERIES[q])
            check(q, cols, rows, " (plan cache off)")
        db.config.set("enable_plan_cache", True)
        for q in in_memory:
            kind = "hit" if hit[q] else "miss (a plan that folded a " \
                "subquery's value at bind time is never cached)"
            print(f"[server] plan cache q{q}: first {wire_ms[q]:.3f} ms, "
                  f"second {hit_ms[q]:.3f} ms ({kind}), cache off "
                  f"{off_ms[q]:.3f} ms")
        first_ms = sum(wire_ms[q] for q in in_memory)
        print(f"[server] plan cache: {hits} hits of {len(in_memory)} on the "
              f"second run; sums first {first_ms:.3f} ms, second "
              f"{sum(hit_ms.values()):.3f} ms (relation cache "
              f"{cache1['misses'] - cache0['misses']} misses), off "
              f"{sum(off_ms.values()):.3f} ms; {card}")
        step("plan cache", t0)

        # 3. prepared point SELECTs ------------------------------------------
        t0 = time.perf_counter()
        od = tables["orders"]
        keys = np.random.default_rng(DB_SEED).choice(
            od["o_orderkey"], SERVER_PREPARED, replace=False)
        psql = ("select o_orderkey, o_custkey, o_totalprice, o_orderdate, "
                "o_orderstatus from orders where o_orderkey = ?")
        stmt_id = c.prepare(psql)
        lat, got_rows = [], []
        for k in keys:
            t1 = time.perf_counter()
            _cols, rows = c.execute(stmt_id, int(k))
            lat.append((time.perf_counter() - t1) * 1e3)
            got_rows.append(rows)
        ins = db.session()
        for k, rows in zip(keys, got_rows):
            ref = ins.execute(psql.replace("?", str(int(k)))).rows()
            wire = [(r[0], r[1], float(r[2]), r[3], r[4]) for r in rows]
            if wire != ref:
                raise AssertionError(f"prepared SELECT of {k}: {wire} != "
                                     f"{ref}")
        ins.close()
        print(f"[server] {SERVER_PREPARED} COM_STMT_EXECUTEs of a prepared "
              f"point SELECT on orders (keys from seed {DB_SEED}): p50 "
              f"{_pct(lat, 50):.3f} ms p99 {_pct(lat, 99):.3f} ms, rows "
              f"equal the in-process answers; {card}")
        step("prepared statements", t0)

        # 4. users --------------------------------------------------------------
        t0 = time.perf_counter()
        c.query("create user smoke identified by 'smoke-pw'")
        u = WireClient(srv.host, srv.port, user="smoke", password="smoke-pw")
        if u.query("select count(*) from region")[1] != [["5"]]:
            raise AssertionError("the new user's SELECT")
        u.close()
        try:
            WireClient(srv.host, srv.port, user="smoke", password="wrong")
        except PermissionError as e:
            print(f"[server] user smoke connects with its password; a "
                  f"wrong password is refused: {e}")
        else:
            raise AssertionError("a wrong password was accepted")
        step("users", t0)

        # 5. concurrent connections ---------------------------------------------
        t0 = time.perf_counter()
        import multiprocessing as mp

        orders = [in_memory[i:] + in_memory[:i] if i % 2 == 0 else
                  (in_memory[i:] + in_memory[:i])[::-1]
                  for i in range(SERVER_CONNS)]
        ctx = mp.get_context("spawn")
        barrier, queue = ctx.Barrier(SERVER_CONNS), ctx.Queue()
        procs = [ctx.Process(target=_wire_worker, daemon=True, args=(
            srv.host, srv.port, [(q, QUERIES[q]) for q in o], barrier,
            queue)) for o in orders]
        cache0 = db.catalog._cache.stats()
        for pr in procs:
            pr.start()
        outs = [queue.get(timeout=600) for _ in procs]
        for pr in procs:
            pr.join(timeout=60)
            if pr.exitcode != 0:
                raise AssertionError(f"a client process exited "
                                     f"{pr.exitcode}")
        cache1 = db.catalog._cache.stats()
        wall = max(o[1] for o in outs) - min(o[0] for o in outs)
        slowest = (0.0, 0)
        for _start, _end, out in outs:
            for q, (cols, rows, ms) in out.items():
                check(q, cols, rows, " (concurrent)")
                slowest = max(slowest, (ms, q))
        serial = SERVER_CONNS * sum(hit_ms.values()) / 1e3
        print(f"[server] {SERVER_CONNS} connections (a client process "
              f"each) x {len(in_memory)} in-memory queries at once, in "
              f"different orders: all match SQLite; {wall:.3f} s wall "
              f"against {serial:.3f} s serial "
              f"({SERVER_CONNS} x the second run's sum); slowest statement "
              f"q{slowest[1]} {slowest[0]:.3f} ms; relation cache "
              f"{cache1['misses'] - cache0['misses']} misses, "
              f"{cache1['evictions'] - cache0['evictions']} evictions "
              f"({cache1['bytes']} of {cache1['limit_bytes']} B); {card}")
        step("concurrency", t0)

        # 6. admission --------------------------------------------------------
        t0 = time.perf_counter()
        q6 = QUERIES[6]
        seen = set()

        def watch(obs, stop):
            while not stop.is_set():
                for _id, state, info in obs.query("show processlist")[1]:
                    if info == q6[:120]:  # the list shows 120 chars
                        seen.add(state)
                time.sleep(0.005)

        def admission_round(queue_limit):
            import threading

            db.config.set("admission_slots", 2)
            db.config.set("admission_queue_limit", queue_limit)
            db.config.set("admission_queue_timeout_s", 120.0)
            seen.clear()
            senders = [WireClient(srv.host, srv.port)
                       for _ in range(SERVER_ADMISSION_CONNS)]
            obs = WireClient(srv.host, srv.port)
            stop = threading.Event()
            wt = threading.Thread(target=watch, args=(obs, stop),
                                  daemon=True)
            wt.start()
            t1 = time.perf_counter()
            outs = _in_threads([lambda cc=cc: cc.query(q6)
                                for cc in senders])
            secs = time.perf_counter() - t1
            stop.set()
            wt.join(60)
            for cc in senders + [obs]:
                cc.close()
            db.config.set("admission_slots", 32)
            db.config.set("admission_queue_limit", 64)
            db.config.set("admission_queue_timeout_s", 10.0)
            busy = [o for o in outs if isinstance(o, WireError)
                    and "ServerBusy" in str(o)]
            fine = [o for o in outs if not isinstance(o, Exception)]
            if len(busy) + len(fine) != len(outs):
                raise AssertionError(f"admission round: {outs}")
            for cols, rows in fine:
                check(6, cols, rows, " (admission)")
            return secs, fine, busy

        secs, fine, busy = admission_round(64)
        if busy or not {"QUEUED", "RUNNING"} <= seen:
            raise AssertionError(f"admission round 1: {len(busy)} "
                                 f"ServerBusy, states seen {seen}")
        print(f"[server] admission_slots=2: {len(fine)} Q6 (spilled) from "
              f"{SERVER_ADMISSION_CONNS} connections at once all match "
              f"SQLite in {secs:.3f} s; SHOW PROCESSLIST showed "
              f"{sorted(seen)}; {card}")
        secs, fine, busy = admission_round(1)
        if len(fine) != 3 or len(busy) != 3 or "QUEUED" not in seen:
            raise AssertionError(f"admission round 2: {len(fine)} admitted, "
                                 f"{len(busy)} ServerBusy, seen {seen}")
        print(f"[server] admission_slots=2, admission_queue_limit=1: 2 ran "
              f"and 1 queued ({len(fine)} answers match SQLite), "
              f"{len(busy)} got ServerBusy: {str(busy[0])[:120]}; "
              f"{secs:.3f} s")
        step("admission", t0)

        # 7. KILL QUERY by the greeting's connection id ---------------------
        t0 = time.perf_counter()
        a = WireClient(srv.host, srv.port)
        b = WireClient(srv.host, srv.port)
        q1 = QUERIES[1]
        res = {}

        def victim():
            try:
                res["out"] = a.query(q1)
            except WireError as e:
                res["err"] = e
            res["at"] = time.perf_counter()

        import threading

        th = threading.Thread(target=victim, daemon=True)
        th.start()
        _poll(lambda: [str(a.connection_id), "RUNNING", q1[:120]] in
              b.query("show processlist")[1], "A RUNNING")
        time.sleep(0.5)  # inside the spill tier's batches
        t_kill = time.perf_counter()
        b.query(f"kill query {a.connection_id}")
        th.join(600)
        if "QueryKilled" not in str(res.get("err")):
            raise AssertionError(f"KILL QUERY: A got {res}")
        kill_ms = (res["at"] - t_kill) * 1e3
        st = loaded["spill"][1]
        bps = st.batches / (loaded["load_ms"][1] / 1e3)
        print(f"[server] KILL QUERY {a.connection_id} (A's greeting id) "
              f"-> A's ERR in {kill_ms:.3f} ms: {str(res['err'])[:100]}; "
              f"Q1 takes {wire_ms[1]:.3f} ms over the wire, the spill tier "
              f"{st.batches} batches in {loaded['load_ms'][1]:.3f} ms "
              f"({bps:.3f} batches/s); {card}")
        cols, rows = a.query(q6)
        check(6, cols, rows, " (after KILL QUERY)")
        b.query(f"kill {a.connection_id}")
        try:
            a.query("select 1")
        except WireError as e:
            print(f"[server] A runs Q6 correctly after the KILL QUERY; a "
                  f"plain KILL evicts A's session: {str(e)[:100]}")
        else:
            raise AssertionError("A's statement ran after a plain KILL")
        a.close()
        step("KILL", t0)

        # 8. statement timeout ------------------------------------------------
        t0 = time.perf_counter()
        b.query("set query_timeout_s = 0.5")
        t1 = time.perf_counter()
        try:
            b.query(q1)
        except WireError as e:
            if "QueryTimeout" not in str(e):
                raise
            print(f"[server] SET query_timeout_s = 0.5: Q1 -> "
                  f"{str(e)[:100]} after {time.perf_counter() - t1:.3f} s")
        else:
            raise AssertionError("Q1 finished under a 0.5 s timeout")
        b.query("set query_timeout_s = 3600")
        step("timeout", t0)

        # 9. a procedure ----------------------------------------------------------
        t0 = time.perf_counter()
        base = top + 1000
        b.query("create procedure add_orders(in base int, in n int) begin "
                "declare i int default 0; while i < n do insert into orders "
                "values (base + i, 1, 'O', 1.00, '1998-01-01', '1-URGENT', "
                "'Clerk#000000001', 0, 'proc'); set i = i + 1; end while; "
                "select count(*) from orders where o_orderkey >= base; end")
        if b.query(f"call add_orders({base}, 5)")[1] != [["5"]]:
            raise AssertionError("CALL add_orders")
        rows = c.query(f"select o_orderkey, o_comment from orders where "
                       f"o_orderkey >= {base} order by o_orderkey")[1]
        if rows != [[str(base + i), "proc"] for i in range(5)]:
            raise AssertionError(f"the procedure's rows read {rows}")
        print(f"[server] CALL add_orders over the wire inserted 5 orders "
              f"keys from {base}, visible to another connection")
        step("procedure", t0)
        b.close()

        # 10. a second tenant ------------------------------------------------
        t0 = time.perf_counter()
        c.query("create tenant t2")
        ts2 = db.session(tenant="t2")
        for name in ("nation", "region", "supplier", "partsupp"):
            arrays = tables[name]
            ts2.execute(create_table_sql(
                name, arrays, {k: v for k, v in types.items()
                               if k in arrays}, TPCH_PRIMARY_KEYS[name]))
            ts2.execute(f"load data infile '{loaded['files'][name]}' into "
                        f"table {name} fields terminated by '|'")
            ts2.execute(f"analyze table {name}")
            if db.tenant("t2").catalog.table_data(name).device.type != \
                    dev.type:
                raise AssertionError(f"t2's {name} is not on {dev}")
        res11 = ts2.execute(QUERIES[11]).rows()
        ok, why = rows_match(res11, want[11][0], ordered=ordered[11])
        if not ok:
            raise AssertionError(f"Q11 in t2 differs from SQLite: {why}")
        try:
            ts2.execute("select count(*) from lineitem")
        except KeyError as e:
            isolated = str(e)
        else:
            raise AssertionError("tenant t2 sees sys's lineitem")
        ts2.close()
        print(f"[server] tenant t2: LOAD DATA of nation, region, supplier "
              f"and partsupp, Q11 ({len(res11)} rows) equals SQLite, and "
              f"t2 cannot see lineitem ({isolated}); {card}")
        step("tenant", t0)

        # 11. a DBMS job ---------------------------------------------------------
        t0 = time.perf_counter()
        db.jobs.schedule("smoke_analyze", 1.0, "analyze table nation")
        db.jobs.start()
        _poll(lambda: db.jobs.jobs["smoke_analyze"]["runs"] >= 1,
              "the analyze job", timeout_s=10.0)
        db.jobs.stop()
        runs = [h for h in db.jobs.history if h["job"] == "smoke_analyze"]
        if not all(h["ok"] for h in runs):
            raise AssertionError(f"the analyze job failed: {runs}")
        print(f"[server] job smoke_analyze (analyze table nation, every "
              f"1 s) ran {len(runs)} time(s) within "
              f"{time.perf_counter() - t0:.3f} s, then the scheduler "
              f"stopped")
        step("job", t0)
        c.close()
    finally:
        srv.stop()

    # 12. restart without a checkpoint ----------------------------------------
    t0 = time.perf_counter()
    db_root = db.root
    # the measurement plane's stores of the database that served the wire
    # statements: phase measure reads them after this database is gone
    served = {"root": db_root, "in_memory": in_memory, "audit": db.audit,
              "trace": db.trace_registry, "top": top}
    db.close()
    del db, loaded["db"]
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    db = Database(db_root, device=dev)
    print(f"[server] reopen {time.perf_counter() - t1:.3f} s: tenants "
          f"{sorted(db.tenants)}, users {sorted(db.users)}")
    if set(db.tenants) != {"sys", "t2"} or "smoke" not in db.users:
        raise AssertionError("tenant t2 or user smoke lost in the restart")
    srv = MySQLServer(db, host="127.0.0.1", port=0).start()
    try:
        u = WireClient(srv.host, srv.port, user="smoke", password="smoke-pw")
        if u.query(f"call add_orders({top + 2000}, 2)")[1] != [["2"]]:
            raise AssertionError("CALL after the restart")
        cols, rows = u.query(QUERIES[6])
        check(6, cols, rows, " (after the restart)")
        u.close()
    finally:
        srv.stop()
    print(f"[server] after the restart: user smoke connects, CALL "
          f"add_orders works, Q6 over the wire equals SQLite; {card}")
    step("restart", t0)
    print(f"[server] steps: " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in steps.items()))
    # phase measure runs on the restarted database, which stays open
    served["db"] = db
    return served


# phase measure: the queries PROFILE runs in memory, the interleaved
# pairs of the overhead check, and the card's HBM rate the calibrated
# stream peak is held against
MEASURE_PROFILED = (1, 9, 13, 18)
MEASURE_PAIRS = 5
MEASURE_WORK_AREA_ROWS = 1 << 23  # over SF1's 6,001,215 lineitem rows
# the knobs the overhead check turns off, with their "off" values
MEASURE_PLANE_OFF = {"enable_metrics": False,
                     "enable_sql_plan_monitor": False,
                     "enable_profiling": False, "trace_sample_rate": 0.0}


def _sync_calls(torch, fn) -> int:
    """Synchronizing CUDA calls ``fn`` makes, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own one-time "prototype feature" warning is not a call
    return sum("called a synchronizing" in str(w.message) for w in caught)


def phase_measure(torch, dev, tables, types, card, want, served):
    """Phase measure: the measurement plane on the card.  The audit and
    trace of phase server's wire statements; on phase server's
    restarted database, ANALYZEd again, PROFILE of Q1, Q9, Q13 and Q18 in memory and of a
    spilled Q6, each execution's device_s against the profiler's kernel
    time and the statement's wall time (the card's idle share); EXPLAIN
    ANALYZE of Q3, Q18 and Q6, with the time split on and off, against
    the plan monitor, SQLite's row counts and the tables'; ALTER SYSTEM
    CALIBRATE with gv$cost_units inside its bounds, the 22 plans'
    logical hashes before and after it and the 11 in-memory queries
    against SQLite after it; the synchronizing calls of one
    ``execute_plan`` of Q1, Q6 and Q14 with the plane at its defaults
    and with it off; the plane's overhead on the 11 in-memory queries;
    and ``q6_filter_sum`` under the profiler."""
    from oceanbase_tpu_torch.bench import queries as bq
    from oceanbase_tpu_torch.bench.oracle import rows_match
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.exec import plan as qplan
    from oceanbase_tpu_torch.ops import scan_kernels as sk
    from oceanbase_tpu_torch.server import metrics as qmetrics
    from oceanbase_tpu_torch.server import profiler as qprofiler
    from oceanbase_tpu_torch.server import trace as qtrace
    from oceanbase_tpu_torch.sql.parser import parse_sql

    on_card = dev.type == "cuda"
    in_memory = served["in_memory"]
    ordered = {q: "order by" in QUERIES[q].lower() and q not in (2, 18, 21)
               for q in QUERIES}
    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        print(f"[measure] step {name}: {steps[name]:.3f} s", flush=True)

    def check(q, rows, tag):
        ok, why = rows_match(rows, want[q][0], ordered=ordered[q])
        if not ok:
            raise AssertionError(f"Q{q}{tag} differs from SQLite: {why}")

    # 1. the audit and trace of phase server's wire statements ------------
    t0 = time.perf_counter()
    recs = served["audit"].recent(None)
    # a statement refused before it began (the KILLed session's next
    # one) opened no span, so it keeps no tree
    untraced = [r.sql[:60] for r in recs if not r.trace_id and
                not r.error]
    if not recs or untraced:
        raise AssertionError(f"gv$sql_audit of phase server: {len(recs)} "
                             f"rows, untraced {untraced[:3]}")
    by_sql: dict = {}
    for r in recs:
        by_sql.setdefault(r.sql, []).append(r)
    dev_s = {q: [r.device_s for r in by_sql.get(QUERIES[q], [])]
             for q in in_memory}
    bad = {q: v for q, v in dev_s.items()
           if not v or (on_card and min(v) <= 0.0)}
    if bad:
        raise AssertionError(f"in-memory queries without device_s: {bad}")
    queued = [r.queue_s for r in by_sql.get(QUERIES[6], [])
              if r.queue_s > 0.0]
    if not queued:
        raise AssertionError("no admission-round Q6 with queue_s > 0")
    kept = {r.trace_id for r in recs}
    spans = [sp for sp in served["trace"].recent() if sp.trace_id in kept]
    names = {sp.name for sp in spans}
    if not {"statement", "plan.execute", "spill.execute"} <= names or \
            not any(n.startswith("op.") for n in names):
        raise AssertionError(f"phase server's trace ring: {sorted(names)}")
    print(f"[measure] gv$sql_audit of phase server: {len(recs)} statements, "
          f"{sum(bool(r.trace_id) for r in recs)} with a trace_id (the "
          f"others failed before they began); the 11 in-memory queries' device_s "
          f"(median over their {sum(map(len, dev_s.values()))} runs "
          f"{statistics.median([x for v in dev_s.values() for x in v]):.6f}"
          f" s); {len(queued)} admission-round Q6 with queue_s > 0 (max "
          f"{max(queued):.3f} s); {len(spans)} spans in their trees")

    t1 = time.perf_counter()
    db = served["db"]  # phase server's restarted database, still open
    s = db.session()
    # the orders phase server's procedure added: without them every
    # answer is SQLite's again
    added = s.execute(f"delete from orders where o_orderkey > "
                      f"{served['top']}").rowcount
    # the restart dropped the optimizer statistics (not persisted);
    # in memory, Q9 over lineitem without them overflows the card
    for name in tables:
        s.execute(f"analyze table {name}")
    print(f"[measure] on phase server's restarted database: the {added} "
          f"orders its procedure added deleted, {len(tables)} tables "
          f"ANALYZEd in {time.perf_counter() - t1:.3f} s")
    # the profiled queries run in memory: a work area over lineitem's rows
    db.config.set("sql_work_area_rows", MEASURE_WORK_AREA_ROWS)
    db.config.set("kv_cache_limit_bytes", 16 << 30)
    res3 = s.execute(QUERIES[3]).rows()
    check(3, res3, "")
    tree = s.execute("show trace").rows()
    ops = [op.strip() for op, *_ in tree]
    if not tree or ops[0] != "statement" or "plan.execute" not in ops or \
            not any(o.startswith("op.") for o in ops):
        raise AssertionError(f"SHOW TRACE after Q3: {ops}")
    print(f"[measure] SHOW TRACE after Q3: " + " > ".join(
        f"{op}" for op in ops[:12]) + (" ..." if len(ops) > 12 else ""))
    flat = qmetrics.sysstat_dict()
    fams = {f: sum(v for k, v in flat.items() if k.startswith(f + "."))
            for f in ("palf", "admission", "plan", "spill")}
    if not all(fams.values()):
        raise AssertionError(f"gv$sysstat families: {fams}")
    n_sys = s.execute("select count(*) from gv$sysstat").rows()[0][0]
    print(f"[measure] gv$sysstat: {n_sys} series; counter sums by family "
          + ", ".join(f"{k}.* {v:.0f}" for k, v in fams.items()))
    step("audit and trace", t0)

    # 2. the host/device split against the profiler -----------------------
    t0 = time.perf_counter()

    def profiled(q, tag, warm=True):
        if warm:
            s.execute(QUERIES[q])  # relations cached, first executions
        s.execute(QUERIES[q])
        # the wall of an unprofiled run: the profiler's own start, stop
        # and parse sit inside the PROFILE statement's wall
        wall = db.audit.recent(1)[-1].elapsed_s
        out = s.execute("profile " + QUERIES[q])
        check(q, out.rows(), f" (PROFILE{tag})")
        rec = db.audit.recent(1)[-1]
        prof = db.device_profiles.get(s._last_profile_trace_id)
        rows = prof.rows if prof is not None else []
        compute = sum(r["total_s"] for r in rows if r["kind"] == "kernel"
                      and not r["kernel"].startswith(("Memcpy", "Memset")))
        copies = sum(r["total_s"] for r in rows if r["kind"] == "kernel"
                     and r["kernel"].startswith(("Memcpy", "Memset")))
        if on_card and compute <= 0.0:
            raise AssertionError(f"PROFILE Q{q}{tag}: no kernel rows "
                                 f"({prof.note if prof else 'no capture'})")
        if on_card and not (compute <= rec.device_s * 1.05 and
                            rec.device_s <= rec.elapsed_s):
            raise AssertionError(
                f"Q{q}{tag}: kernel {compute:.6f} s, device_s "
                f"{rec.device_s:.6f} s, wall {rec.elapsed_s:.6f} s")
        idle = 1.0 - (compute + copies) / wall
        print(f"[measure] PROFILE q{q}{tag}: kernels {compute * 1e3:.3f} ms "
              f"+ copies {copies * 1e3:.3f} ms (gv$device_profile, "
              f"{sum(r['kind'] == 'kernel' for r in rows)} kernel rows), "
              f"device_s {rec.device_s * 1e3:.3f} ms, host_s "
              f"{rec.host_s * 1e3:.3f} ms, wall {wall * 1e3:.3f} ms "
              f"unprofiled ({rec.elapsed_s * 1e3:.3f} ms under PROFILE); "
              f"idle share {idle:.4f}; {card}", flush=True)
        return idle

    idle = {q: profiled(q, " in memory") for q in MEASURE_PROFILED}
    db.config.set("sql_work_area_rows", SPILL_BUDGET_ROWS)
    idle["6 spilled"] = profiled(6, " spilled", warm=False)
    if s.last_spill is None:
        raise AssertionError("Q6 did not take the spill route")
    db.config.set("sql_work_area_rows", MEASURE_WORK_AREA_ROWS)
    print(f"[measure] idle share (1 - device busy / wall): " + ", ".join(
        f"q{k}: {v:.4f}" for k, v in idle.items()))
    step("profile", t0)

    # 3. EXPLAIN ANALYZE against the plan monitor, SQLite and the tables --
    t0 = time.perf_counter()
    n_rows = {name: s.execute(f"select count(*) from {name}").rows()[0][0]
              for name in tables}
    # with the time split off an execution without overflow lanes (Q6)
    # reads its monitor counts through the pinned copy's own fence
    for q, split in ((3, True), (18, True), (6, True), (6, False),
                     (3, False)):
        db.config.set("enable_profiling", split)
        try:
            text = s.execute("explain analyze " + QUERIES[q]).plan_text
        finally:
            db.config.set("enable_profiling", True)
        rec = db.plan_monitor.recent(1)[-1]
        lines = [t for t in text.splitlines()
                 if "act=" in t and not t.startswith("worst")]
        acts = [int(t.split("act=")[1].split()[0]) for t in lines]
        if sorted(acts) != sorted(r["rows"] for r in rec.op_stats):
            raise AssertionError(f"EXPLAIN ANALYZE Q{q}: rows {acts} vs "
                                 f"the monitor's {rec.op_stats}")
        # counts the monitor does not produce: the root's rows are the
        # answer's rows in SQLite, each scan's its table's live rows
        if acts[0] != len(want[q][0]):
            raise AssertionError(f"EXPLAIN ANALYZE Q{q} (split {split}): "
                                 f"root act={acts[0]}, SQLite "
                                 f"{len(want[q][0])} rows")
        scans = [(t.split("table='")[1].split("'")[0], a)
                 for t, a in zip(lines, acts) if "TableScan(" in t]
        wrong = [(name, a, n_rows[name]) for name, a in scans
                 if a != n_rows[name]]
        if not scans or wrong:
            raise AssertionError(f"EXPLAIN ANALYZE Q{q} (split {split}): "
                                 f"scans (table, act, rows) {wrong}")
        print(f"[measure] explain analyze q{q} (time split {split}): root "
              f"act={acts[0]} = SQLite's {len(want[q][0])} rows, "
              f"{len(scans)} scans equal their tables' row counts")
        for ln in text.splitlines():
            if ln.startswith(("roofline", "worst")):
                print(f"[measure] explain analyze q{q}: {ln}")
            elif "act=" in ln:
                op = ln.strip().split("(")[0]
                print(f"[measure] explain analyze q{q}: {op} "
                      f"[{ln.rsplit('[', 1)[1]}")
    step("explain analyze", t0)

    # 4. ALTER SYSTEM CALIBRATE -------------------------------------------
    t0 = time.perf_counter()

    def hashes():
        out = {}
        for q in sorted(QUERIES):
            plan = s._binder(None).bind_select(parse_sql(QUERIES[q]))[0]
            out[q] = qplan.logical_hash(plan)
        return out

    before = hashes()
    consts = dict(s.execute("alter system calibrate").rows())
    after = hashes()
    cu = s.execute("select kind, name, rows, device_s, value, unit from "
                   "gv$cost_units").rows()
    for kind, name, rows, dsec, value, unit in cu:
        print(f"[measure] gv$cost_units {kind} {name} rows={rows} "
              f"device_s={dsec:.9f} value={value:.6g} {unit}")
    units = db.cost_units
    frac = units.peak_bytes_s / HBM_BYTES_PER_S
    if on_card and not (0.30 <= frac <= 1.05):
        raise AssertionError(f"peak_bytes_s {units.peak_bytes_s:.4g} is "
                             f"{frac:.3f} of {HBM_BYTES_PER_S:.3g} B/s")
    if on_card and not (2e-6 <= units.launch_overhead_s <= 200e-6):
        raise AssertionError(f"launch_overhead_s "
                             f"{units.launch_overhead_s:.3g}")
    print(f"[measure] calibrate ({units.preset}, {units.probe_s:.3f} s): "
          f"{consts}; peak_bytes_s {frac:.4f} of 3.35 TB/s; {card}")
    print(f"[measure] logical_hash before/after calibration: " + " ".join(
        f"q{q}={before[q]}/{after[q]}" for q in sorted(before)))
    print(f"[measure] {sum(before[q] != after[q] for q in before)} of 22 "
          f"plans changed with the calibrated units")
    for q in in_memory:
        check(q, s.execute(QUERIES[q]).rows(), " (after calibration)")
    print(f"[measure] the 11 in-memory queries equal SQLite after "
          f"calibration")
    step("calibrate", t0)

    # 5. the plane adds no sync -------------------------------------------
    t0 = time.perf_counter()
    st = bq.slice_tables(tables, types, device=dev)
    n_li = len(tables["lineitem"]["l_orderkey"])
    plans = {"q1": bq.q1_plan(), "q6": bq.q6_plan(),
             "q14": bq.q14_plan(n_li)}
    counts = {}
    for name, plan in plans.items():
        qplan.execute_plan(plan, st)  # first execution at the signature
        qplan.execute_plan(plan, st, monitor_out=[])
        qplan.resolve_pending(block=True)  # the warm-ups' statement end

        def on(plan=plan):
            ctx = qtrace.TraceCtx("sync-count")
            with qtrace.activate(ctx), qtrace.span("statement"):
                qplan.execute_plan(plan, st, monitor_out=[])

        def off(plan=plan):
            qplan.execute_plan(plan, st)

        qplan.reset_exec_times()
        n_on = _sync_calls(torch, on) if on_card else 0
        qplan.resolve_pending(block=True)
        qplan.set_time_split(False)
        qmetrics.set_enabled(False)
        try:
            n_off = _sync_calls(torch, off) if on_card else 0
        finally:
            qplan.set_time_split(True)
            qmetrics.set_enabled(True)
        counts[name] = (n_on, n_off)
        if n_on != n_off:
            raise AssertionError(f"{name}: {n_on} synchronizing calls with "
                                 f"the plane on, {n_off} with it off")
    qplan.reset_exec_times()
    del st
    print(f"[measure] synchronizing calls of one execute_plan (plane on / "
          f"off): " + ", ".join(f"{k} {a}/{b}" for k, (a, b) in
                                counts.items()))
    step("sync count", t0)

    # 6. overhead on the 11 in-memory queries ------------------------------
    t0 = time.perf_counter()

    def set_plane(on):
        for k, v in MEASURE_PLANE_OFF.items():
            db.config.set(k, (1.0 if k == "trace_sample_rate" else True)
                          if on else v)

    def run_all():
        torch.cuda.synchronize() if on_card else None
        t1 = time.perf_counter()
        for q in in_memory:
            s.execute(QUERIES[q])
        return time.perf_counter() - t1

    run_all()  # warm both settings' paths
    times = {"on": [], "off": []}
    for _ in range(MEASURE_PAIRS):
        for mode in ("on", "off"):
            set_plane(mode == "on")
            times[mode].append(run_all())
    set_plane(True)
    med_on = statistics.median(times["on"])
    med_off = statistics.median(times["off"])
    print(f"[measure] 11 in-memory queries, {MEASURE_PAIRS} interleaved "
          f"pairs: plane on median {med_on * 1e3:.3f} ms, off "
          f"{med_off * 1e3:.3f} ms, ratio {med_on / med_off:.4f} (the "
          f"reference's budget 1.02); {card}")
    step("overhead", t0)

    # 7. the kernel under the profiler -------------------------------------
    t0 = time.perf_counter()
    if on_card:
        from oceanbase_tpu_torch.bench.oracle_np import Q6_BOUNDS

        cols = _q6_columns(torch, 1 << 20, 7, dev)
        got, rows, note = qprofiler.profile_statement(
            lambda: sk.q6_filter_sum(*cols, **Q6_BOUNDS), cuda=True)
        want6 = sk.q6_filter_sum_reference(*cols, **Q6_BOUNDS)
        mine = [r for r in rows if "q6_filter_sum" in r["kernel"]
                and r["kind"] == "kernel"]
        if not mine or int(got) != int(want6):
            raise AssertionError(f"q6_filter_sum under the profiler: "
                                 f"{rows[:4]} {note}")
        r = mine[0]
        print(f"[measure] q6_filter_sum under the profiler: kernel "
              f"{r['kernel']}, {r['occurrences']} launch, "
              f"{r['total_s'] * 1e3:.6f} ms, {r['pct']:.1f}% of the "
              f"capture's device time; {card}")
    step("kernel profile", t0)
    s.close()
    print(f"[measure] steps: " + ", ".join(f"{k} {v:.3f} s"
                                           for k, v in steps.items()))
    # phase durability runs on this database, which stays open
    return db


# phase durability: the memstore budget the INSERT burst crosses, the
# burst's rows and rows per statement, the spill budget that kills S1,
# and the keys of the rows the phase adds to orders (above every
# generated and procedure-added key)
DURABILITY_MEMSTORE_BYTES = 384 << 10
DURABILITY_BURST_ROWS = 20_000
DURABILITY_BURST_STMT_ROWS = 50
DURABILITY_SPILL_LIMIT = 1 << 20
# the throttle's cost at its defaults: interleaved rounds of autocommit
# single-row INSERTs with it on and off
DURABILITY_AB_ROUNDS = 4
DURABILITY_AB_INSERTS = 50
DURABILITY_KEY_OFFSET = 10_000_000


class DurabilityInjected(RuntimeError):
    """The error phase durability arms its ERRSIM points with."""


def _orders_values(od, i, key) -> str:
    """Row ``i`` of the generated orders as a VALUES tuple under a new
    order key (an order without lineitems: no TPC-H answer moves)."""
    return (f"({key}, {int(od['o_custkey'][i])}, "
            f"'{od['o_orderstatus'][i]}', "
            f"{int(od['o_totalprice'][i]) / 100:.2f}, date '1998-12-31', "
            f"'{od['o_orderpriority'][i]}', '{od['o_clerk'][i]}', "
            f"{int(od['o_shippriority'][i])}, 'durability')")


def phase_durability(torch, dev, tables, types, card, want, served, db,
                     files, root):
    """Phase durability: the durability and fault plane on phase
    measure's database (phase server's restarted SF1 database, lineitem
    and orders in 8 RANGE partitions): workload snapshots around the 11
    in-memory queries with ANALYZE and SHOW WORKLOAD REPORT; a full
    backup, commits on orders, an incremental backup and a WAL archive,
    restored into a new root, overlaid and cut to a point between two
    commits, booted on the card and ANALYZEd, with Q1, Q6, Q3 and Q18
    against SQLite and the cut's rows; a seeded bitflip of the next
    orders segment flush that a scrub round detects, quarantines and
    rewrites from memory; the log budget at the log surface's floor
    (read-only: writes refused, Q6 and Q14 still served) and back; a
    spill budget that kills S1 with no residue; gv$disk against du;
    ERRSIM on tx.commit and storage.flush; a 20,000-row INSERT burst
    into a copy of orders under a small memstore budget; one reopen that
    boots clean, reads back every acknowledged row and the workload
    snapshots, and answers Q3; and TPC-H Q4 and Q13 over an external
    table on phase load's orders.tbl."""
    import gc
    import shutil

    from oceanbase_tpu_torch.bench.oracle import rows_match
    from oceanbase_tpu_torch.bench.surface_queries import S1
    from oceanbase_tpu_torch.bench.tbl import create_table_sql
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.net.faults import FaultPlane
    from oceanbase_tpu_torch.server import backup
    from oceanbase_tpu_torch.server import metrics as qmetrics
    from oceanbase_tpu_torch.server.admission import MemstoreFull
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.server.diskmgr import (
        SpillBudgetExceeded,
        TenantReadOnly,
    )
    from oceanbase_tpu_torch.server.errsim import ERRSIM
    from oceanbase_tpu_torch.server.monitor import SqlAudit
    from oceanbase_tpu_torch.storage.integrity import CorruptionError

    on_card = dev.type == "cuda"
    in_memory = served["in_memory"]
    top = served["top"]
    od = tables["orders"]
    ordered = {q: "order by" in QUERIES[q].lower() and q not in (2, 18, 21)
               for q in QUERIES}
    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        print(f"[durability] step {name}: {steps[name]:.3f} s", flush=True)

    def check(q, rows, tag):
        ok, why = rows_match(rows, want[q][0], ordered=ordered[q])
        if not ok:
            raise AssertionError(f"Q{q}{tag} differs from SQLite: {why}")

    def du(path):
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _s, fs in os.walk(path) for f in fs)

    s = db.session()
    t_sys = db.tenant("sys")
    acked: list[int] = []      # orders keys this phase committed
    key = [top + DURABILITY_KEY_OFFSET]

    def add_order(sess, i=0):
        """INSERT one order under the next key; the key is acknowledged
        only when the statement returns."""
        key[0] += 1
        sess.execute(f"insert into orders values "
                     f"{_orders_values(od, i % len(od['o_orderkey']), key[0])}")
        acked.append(key[0])
        return key[0]

    # the memstore throttle has been on at its defaults since phase db:
    # what it did there (process-wide counters)
    print(f"[durability] before this phase, under the throttle's defaults "
          f"since phase db: admission.throttle_sleeps "
          f"{qmetrics.counter_value('admission.throttle_sleeps'):.0f}, "
          f"admission.memstore_full "
          f"{qmetrics.counter_value('admission.memstore_full'):.0f}")

    # 1. workload snapshots around the 11 in-memory queries ---------------
    t0 = time.perf_counter()
    # the phase's statements go to an audit ring of their own (the
    # earlier phases' ring is put back after), so the report's top SQL
    # is this phase's executions
    ring = db.audit
    db.audit = SqlAudit(len(ring) + 10000)
    snap_a = db.workload.snapshot(cluster=False)
    for q in in_memory:
        check(q, s.execute(QUERIES[q]).rows(), " (workload)")
    snap_b = db.workload.snapshot(cluster=False)
    rep = s.execute(f"analyze workload report from {snap_a['id']} to "
                    f"{snap_b['id']}").rows()
    top_sql = {r[1]: r[3] for r in rep if r[0] == "top_sql"}
    texts = {QUERIES[q][:200]: q for q in in_memory}
    listed = {texts[t]: d for t, d in top_sql.items() if t in texts}
    if len(listed) != min(10, len(in_memory)) or len(top_sql) != len(listed):
        raise AssertionError(f"top SQL of the report: {sorted(listed)} of "
                             f"{len(top_sql)} rows")
    for q, detail in listed.items():
        fields = dict(x.split("=", 1) for x in detail.split())
        if int(fields["calls"]) != 1 or \
                (on_card and float(fields["device_s"]) <= 0.0):
            raise AssertionError(f"Q{q} in the report's top SQL: {detail}")
    tree = s.execute("show workload report").rows()
    if not tree or not tree[0][0].startswith(
            f"workload report from={snap_a['id']} to={snap_b['id']}"):
        raise AssertionError(f"SHOW WORKLOAD REPORT: {tree[:2]}")
    sections = sorted({r[0] for r in rep})
    db.audit = ring
    print(f"[durability] workload: snapshots {snap_a['id']} and "
          f"{snap_b['id']} around the 11 in-memory queries (each equal to "
          f"SQLite); ANALYZE WORKLOAD REPORT {len(rep)} rows in sections "
          f"{sections}; top SQL {len(listed)} of the queries, each calls=1 "
          f"with device_s > 0; SHOW WORKLOAD REPORT {len(tree)} lines")
    step("workload", t0)

    # 2. backup, incremental, archive, restore, point-in-time cut ---------
    t0 = time.perf_counter()
    bk = os.path.join(root, "backup")
    t1 = time.perf_counter()
    full = backup.full_backup(db, os.path.join(bk, "full"))
    full_s = time.perf_counter() - t1
    full_bytes = du(full)
    before_cut = [add_order(s, i) for i in range(3)]
    t1 = time.perf_counter()
    inc = backup.incremental_backup(db, os.path.join(bk, "inc"), full)
    inc_s = time.perf_counter() - t1
    with open(os.path.join(inc, backup.MANIFEST)) as fh:
        manifest = json.load(fh)
    if manifest["kind"] != "incremental" or manifest["skipped"] <= 0:
        raise AssertionError(f"incremental backup: {manifest['kind']}, "
                             f"skipped {manifest['skipped']}")
    # the cut falls between two commits after the increment's
    # checkpoint (the archive carries them)
    before_cut += [add_order(s, 3)]
    cut_version = db.tx.gts.current()
    after_cut = [add_order(s, i) for i in range(4, 6)]
    t1 = time.perf_counter()
    archive = backup.archive_wal(db, os.path.join(bk, "arch"))
    arch_s = time.perf_counter() - t1
    inc_bytes, arch_bytes = du(inc), du(archive)
    print(f"[durability] backup: full {full_bytes} bytes in {full_s:.3f} s "
          f"({full_bytes / full_s / 1e6:.1f} MB/s); incremental "
          f"{inc_bytes} bytes in {inc_s:.3f} s, {manifest['skipped']} "
          f"files skipped; WAL archive {arch_bytes} bytes in "
          f"{arch_s:.3f} s; {card}")
    target = os.path.join(root, "restored")
    t1 = time.perf_counter()
    backup.restore_chain(inc, target)
    backup.overlay_archive(archive, target)
    backup.pitr_cut(target, cut_version)
    restore_s = time.perf_counter() - t1
    # the restored tree keeps phase measure's in-memory work area: put
    # the default back, so Q1 and Q6 stream from the LSM
    with open(os.path.join(target, "config.json")) as fh:
        cfg = json.load(fh)
    cfg.pop("sql_work_area_rows", None)
    with open(os.path.join(target, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    t1 = time.perf_counter()
    rdb = Database(target, device=dev)
    boot_s = time.perf_counter() - t1
    rs = rdb.session()
    t1 = time.perf_counter()
    for name in tables:
        rs.execute(f"analyze table {name}")
    analyze_s = time.perf_counter() - t1
    routes = {}
    for q in (1, 6, 3, 18):
        t1 = time.perf_counter()
        check(q, rs.execute(QUERIES[q]).rows(), " (restored, cut)")
        routes[q] = ("spilled" if rs.last_spill is not None else
                     "in memory", (time.perf_counter() - t1) * 1e3)
    if routes[1][0] != "spilled" or routes[6][0] != "spilled":
        raise AssertionError(f"restored Q1/Q6 routes: {routes}")
    got = {r[0] for r in rs.execute(
        f"select o_orderkey from orders where o_orderkey > "
        f"{top + DURABILITY_KEY_OFFSET}").rows()}
    if got != set(before_cut):
        raise AssertionError(f"the cut kept orders {sorted(got)}, want "
                             f"{before_cut} (not {after_cut})")
    rs.close()
    rdb.close()
    del rdb, rs
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(target, ignore_errors=True)
    print(f"[durability] restore: chain + archive + cut in {restore_s:.3f} "
          f"s, boot {boot_s:.3f} s, ANALYZE {analyze_s:.3f} s; " +
          ", ".join(f"Q{q} {r} {ms:.3f} ms" for q, (r, ms) in
                    routes.items()) +
          f" equal to SQLite; the {len(before_cut)} orders before the cut "
          f"present, the {len(after_cut)} after it absent; {card}")
    shutil.rmtree(bk, ignore_errors=True)
    step("backup and restore", t0)

    # 3. scrub: a seeded bitflip of the next orders segment flush ----------
    t0 = time.perf_counter()
    db.config.set("enable_disk_faults", True)
    eng = t_sys.engine
    # a flip can land in the zip container's don't-care bytes, which
    # corrupt nothing: the seed moves on until one lands in checked bytes
    # (as the reference's bit-flip tests pick theirs)
    for seed in range(DB_SEED, DB_SEED + 8):
        fp = FaultPlane(seed=seed)
        fp.disk("bitflip", kind="segment", count=1)
        db.arm_disk_faults(fp)
        try:
            for i in range(6, 11):
                add_order(s, i)
            seg = eng.freeze_and_flush("orders", t_sys.tx.flush_snapshot())
        finally:
            db.arm_disk_faults(None)
        if fp.rules()[0]["fired"] != 1 or seg is None:
            raise AssertionError(f"the bitflip rule: {fp.rules()}")
        try:
            type(seg).load(eng._segment_file("orders", seg.segment_id))
        except CorruptionError:
            break
        print(f"[durability] bitflip seed {seed} landed in bytes no "
              f"checksum covers; next seed")
    else:
        raise AssertionError("no seed corrupted checked bytes")
    scrubber = db.scrubber()
    summary = scrubber.run_once()
    if [c[0] for c in summary["corrupt"]] != ["orders"] or \
            summary["repaired"] != ["orders"] or summary["failed"] or \
            t_sys.engine.quarantined:
        raise AssertionError(f"scrub round: {summary}")
    phases = [r[0] for r in s.execute(
        "select phase from gv$scrub order by ts").rows()]
    if phases != ["quarantine", "repair", "verify"]:
        raise AssertionError(f"gv$scrub phases: {phases}")
    again = scrubber.run_once()
    if again["corrupt"] or again["repaired"]:
        raise AssertionError(f"second scrub round: {again}")
    print(f"[durability] scrub: {summary['segments']} segments, "
          f"{summary['bytes']} bytes verified in {summary['elapsed_s']:.3f} "
          f"s ({summary['bytes'] / summary['elapsed_s'] / 1e9:.3f} GB/s); "
          f"the bitflipped orders segment quarantined and rewritten from "
          f"memory; gv$scrub {phases}; a second round "
          f"({again['bytes'] / again['elapsed_s'] / 1e9:.3f} GB/s, raw "
          f"crc of known files) clean; {card}")
    step("scrub", t0)

    # 4. disk pressure: read-only and back, the spill budget, gv$disk -----
    t0 = time.perf_counter()
    dm = t_sys.diskmgr
    t_sys.reclaim_log_disk()          # the log surface at its floor
    floor = dm._walk_surface("log")
    db.config.set("log_disk_limit_bytes", floor)
    t1 = time.perf_counter()
    dm.poll(force=True)
    enter_s = time.perf_counter() - t1
    if not dm.read_only:
        raise AssertionError(f"log {floor} bytes at its limit: not "
                             f"read-only")
    try:
        add_order(s)        # refused: its key is never acknowledged
        raise AssertionError("a write committed in read-only")
    except TenantReadOnly:
        pass
    for q in (6, 14):
        check(q, s.execute(QUERIES[q]).rows(), " (read-only)")
    db.config.set("log_disk_limit_bytes", 1 << 40)
    t1 = time.perf_counter()
    dm.poll(force=True)
    exit_s = time.perf_counter() - t1
    if dm.read_only:
        raise AssertionError("the tenant stayed read-only")
    add_order(s)
    db.config.set("log_disk_limit_bytes", 0)
    print(f"[durability] log budget {floor} bytes (the surface's floor "
          f"after checkpoint + recycle): read-only entered in "
          f"{enter_s * 1e3:.3f} ms, an INSERT refused TenantReadOnly, Q6 "
          f"and Q14 equal to SQLite meanwhile; budget raised: left in "
          f"{exit_s * 1e3:.3f} ms and an INSERT committed")
    db.config.set("sql_work_area_rows", SPILL_BUDGET_ROWS)
    db.config.set("spill_disk_limit_bytes", DURABILITY_SPILL_LIMIT)
    t1 = time.perf_counter()
    try:
        s.execute(S1)
        raise AssertionError("S1 spilled past the spill budget")
    except SpillBudgetExceeded:
        kill_s = time.perf_counter() - t1
    tmp = os.path.join(db.root, "tmpfile")
    left = [f for _d, _s, fs in os.walk(tmp) for f in fs] \
        if os.path.isdir(tmp) else []
    if left or dm.usage("spill") != 0 or dm.read_only:
        raise AssertionError(f"spill kill residue: {left[:3]}, "
                             f"{dm.usage('spill')} bytes")
    check(6, s.execute(QUERIES[6]).rows(), " (after the spill kill)")
    db.config.set("spill_disk_limit_bytes", 0)
    db.config.set("sql_work_area_rows", MEASURE_WORK_AREA_ROWS)
    print(f"[durability] spill budget {DURABILITY_SPILL_LIMIT} bytes: S1 "
          f"killed SpillBudgetExceeded after {kill_s * 1e3:.3f} ms, no "
          f"temp file, 0 spill bytes accounted, the next Q6 equal to "
          f"SQLite; {card}")
    db.config.set("log_disk_limit_bytes", 1 << 40)
    db.config.set("data_disk_limit_bytes", 1 << 40)
    gv = {r[0]: r[1] for r in s.execute(
        "select surface, used_bytes from gv$disk"
        " where tenant = 'sys'").rows()}
    walked = {"log": du(dm.paths["log"][0]),
              "data": du(dm.paths["data"][0]),
              "spill": du(tmp) if os.path.isdir(tmp) else 0}
    for surface, d in walked.items():
        if abs(gv[surface] - d) > max(1, d) * 0.05:
            raise AssertionError(f"gv$disk {surface} {gv[surface]} vs du "
                                 f"{d}")
    db.config.set("log_disk_limit_bytes", 0)
    db.config.set("data_disk_limit_bytes", 0)
    print(f"[durability] gv$disk against du: " + ", ".join(
        f"{k} {gv[k]} / {v}" for k, v in walked.items()))
    step("disk pressure", t0)

    # 5. ERRSIM on tx.commit and storage.flush ------------------------------
    t0 = time.perf_counter()
    ERRSIM.reset()
    try:
        ERRSIM.arm("tx.commit", error=DurabilityInjected("tx.commit"),
                   count=1)
        try:
            add_order(s)
            raise AssertionError("the armed tx.commit did not fire")
        except DurabilityInjected:
            pass
        add_order(s)
        ERRSIM.arm("storage.flush",
                   error=DurabilityInjected("storage.flush"), count=1)
        try:
            db.checkpoint()
            raise AssertionError("the armed storage.flush did not fire")
        except DurabilityInjected:
            pass
        add_order(s)
        view = s.execute("select tracepoint, hits, fired from v$errsim"
                         " where fired > 0 order by tracepoint").rows()
    finally:
        ERRSIM.reset()
    if [(r[0], r[2]) for r in view] != [("storage.flush", 1),
                                         ("tx.commit", 1)]:
        raise AssertionError(f"v$errsim: {view}")
    print(f"[durability] ERRSIM: tx.commit failed its INSERT and "
          f"storage.flush its checkpoint with DurabilityInjected; "
          f"v$errsim {view}")
    step("errsim", t0)

    # 6. the memstore throttle under an INSERT burst -------------------------
    t0 = time.perf_counter()
    s.execute(create_table_sql(
        "orders_burst", od, {k: v for k, v in types.items() if k in od},
        ["o_orderkey"]))
    # the throttle's own cost at its defaults: autocommit single-row
    # INSERTs with it on and off, in interleaved rounds
    cost = {True: [], False: []}
    n_ins = 0
    for _round in range(DURABILITY_AB_ROUNDS):
        for on in (True, False):
            db.config.set("enable_rate_limit", on)
            for _ in range(DURABILITY_AB_INSERTS):
                n_ins += 1
                t1 = time.perf_counter()
                s.execute(f"insert into orders_burst values "
                          f"{_orders_values(od, n_ins, -1 - n_ins)}")
                cost[on].append((time.perf_counter() - t1) * 1e3)
    db.config.set("enable_rate_limit", True)
    s.execute("delete from orders_burst")
    p50 = {on: statistics.median(v) for on, v in cost.items()}
    p99 = {on: sorted(v)[int(0.99 * (len(v) - 1))] for on, v in cost.items()}
    print(f"[durability] throttle at its defaults, {DURABILITY_AB_ROUNDS} "
          f"interleaved rounds of {DURABILITY_AB_INSERTS} autocommit "
          f"INSERTs each way: on p50 {p50[True]:.3f} ms p99 "
          f"{p99[True]:.3f} ms, off p50 {p50[False]:.3f} ms p99 "
          f"{p99[False]:.3f} ms; {card}")
    db.config.set("memstore_limit_bytes", DURABILITY_MEMSTORE_BYTES)
    thr = t_sys.throttle
    thr.reset_peak()
    c0 = {m: qmetrics.counter_value(m) for m in
          ("admission.throttle_sleeps", "admission.memstore_full")}
    sleeps0, full0 = thr.throttle_sleeps, thr.full_rejections
    lat, refused, burst_acked = [], 0, 0
    rows_per = DURABILITY_BURST_STMT_ROWS
    # an open transaction pins the flush horizon, as a long writer does:
    # the pressure flushes cannot take the burst's rows, so the writers
    # ride the ramp into MemstoreFull; at the first refusal the pin
    # commits and the next pressure flush catches up
    pin = db.session()
    pin.execute("begin")
    pin.execute(f"insert into orders_burst values "
                f"{_orders_values(od, 0, -1)}")
    for b in range(DURABILITY_BURST_ROWS // rows_per):
        vals = ", ".join(_orders_values(od, i % len(od["o_orderkey"]), i)
                         for i in range(b * rows_per, (b + 1) * rows_per))
        while True:
            t1 = time.perf_counter()
            try:
                s.execute(f"insert into orders_burst values {vals}")
                lat.append((time.perf_counter() - t1) * 1e3)
                burst_acked += rows_per
                break
            except MemstoreFull:
                refused += 1
                if pin is not None:
                    pin.execute("commit")
                    pin.close()
                    pin = None
                    burst_acked += 1
                time.sleep(0.01)   # the flush catches up, then retry
    if pin is not None:
        raise AssertionError("the pinned burst never reached MemstoreFull")
    sleeps = thr.throttle_sleeps - sleeps0
    full = thr.full_rejections - full0
    c1 = {m: qmetrics.counter_value(m) - c0[m] for m in c0}
    if not (sleeps and full) or thr.peak_bytes > DURABILITY_MEMSTORE_BYTES \
            or thr.used_bytes() >= thr.trigger_bytes():
        raise AssertionError(f"the burst's throttle: {thr.stats()}")
    n_burst = s.execute("select count(*) from orders_burst").rows()
    if n_burst != [(burst_acked,)]:
        raise AssertionError(f"burst rows {n_burst}, acknowledged "
                             f"{burst_acked}")
    lat.sort()
    print(f"[durability] memstore throttle at {DURABILITY_MEMSTORE_BYTES} "
          f"bytes: {burst_acked} rows in {len(lat)} INSERTs of {rows_per}, "
          f"p50 {statistics.median(lat):.3f} ms, p99 "
          f"{lat[int(0.99 * (len(lat) - 1))]:.3f} ms; throttle sleeps "
          f"{sleeps}, MemstoreFull {full} ({refused} statements retried "
          f"after the pin committed); "
          f"admission.* {c1}; peak {thr.peak_bytes} bytes; {card}")
    db.config.set("memstore_limit_bytes", 256 << 20)
    step("memstore throttle", t0)

    # one reopen for steps 1, 3, 5 and 6: it boots clean (the rewritten
    # segment verifies), every acknowledged row reads back, the workload
    # snapshots load crc-clean, and Q3 equals SQLite
    t0 = time.perf_counter()
    s.close()
    root_db = db.root
    db.close()
    del db, s, t_sys
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    db = Database(root_db, device=dev)
    reopen_s = time.perf_counter() - t1
    s = db.session()
    for sid in (snap_a["id"], snap_b["id"]):
        db.workload.load(sid)
    got = sorted(r[0] for r in s.execute(
        f"select o_orderkey from orders where o_orderkey > "
        f"{top + DURABILITY_KEY_OFFSET}").rows())
    if got != sorted(acked):
        raise AssertionError(f"after the reopen: orders {got}, "
                             f"acknowledged {sorted(acked)}")
    if s.execute("select count(*) from orders_burst").rows() != \
            [(burst_acked,)]:
        raise AssertionError("the burst's rows after the reopen")
    s.execute(f"delete from orders where o_orderkey > "
              f"{top + DURABILITY_KEY_OFFSET}")
    s.execute("drop table orders_burst")
    for name in ("customer", "orders", "lineitem"):
        s.execute(f"analyze table {name}")
    check(3, s.execute(QUERIES[3]).rows(), " (after the reopen)")
    print(f"[durability] reopen {reopen_s:.3f} s: booted clean, "
          f"{len(acked)} acknowledged orders and {burst_acked} burst rows "
          f"read back, workload snapshots {snap_a['id']} and "
          f"{snap_b['id']} crc-clean, Q3 equal to SQLite")
    step("reopen", t0)

    # 7. an external table over phase load's orders.tbl ----------------------
    t0 = time.perf_counter()
    ddl = create_table_sql("orders_ext", od,
                           {k: v for k, v in types.items() if k in od}, [])
    s.execute(ddl.replace("create table", "create external table", 1) +
              f" location '{files['orders']}' fields terminated by '|'")
    nbytes = os.path.getsize(files["orders"])
    t1 = time.perf_counter()
    rel = db.catalog.table_data("orders_ext")
    read_s = time.perf_counter() - t1
    if rel.capacity < len(od["o_orderkey"]):
        raise AssertionError(f"orders_ext capacity {rel.capacity}")
    del rel
    for q, old in ((4, "from orders\n"), (13, "join orders\n")):
        sql = QUERIES[q].replace(old, old.replace("orders", "orders_ext"))
        if sql == QUERIES[q]:
            raise AssertionError(f"Q{q} does not read orders")
        t1 = time.perf_counter()
        check(q, s.execute(sql).rows(), " over orders_ext")
        print(f"[durability] Q{q} over orders_ext equal to SQLite's Q{q} "
              f"in {(time.perf_counter() - t1) * 1e3:.3f} ms")
    print(f"[durability] external table over orders.tbl: "
          f"{len(od['o_orderkey'])} rows, {nbytes} bytes read and put on "
          f"the card in {read_s:.3f} s ({nbytes / read_s / 1e6:.1f} MB/s); "
          f"{card}")
    s.execute("drop table orders_ext")
    step("external table", t0)
    s.close()
    db.close()
    print(f"[durability] steps: " + ", ".join(f"{k} {v:.3f} s"
                                              for k, v in steps.items()))


# -- phase vector: VECTOR columns and the ANN access path at SIFT1M size --

VECTOR_ROWS = 1_000_000          # ANN-Benchmarks sift-128-euclidean
VECTOR_DIM = 128
VECTOR_CENTRES = 1_000           # the synthetic data's clusters
VECTOR_SPREAD = 12.0             # per-coordinate noise around a centre
VECTOR_QUERIES = 100             # of SIFT1M's 10,000 (cut for time)
VECTOR_K = 10
VECTOR_COSINE_QUERIES = 20
VECTOR_INSERTS = 1_000
VECTOR_INSERT_STMT_ROWS = 50
VECTOR_DELETES = 10
#: the JAX package's IvfFlatIndex reads recall@10 1.0 on this generator
#: (100,000 rows on the CPU); its clusters sit far apart, so the gate
#: catches a lost bucket, not IVF's approximation
VECTOR_RECALL_GATE = 0.99
VECTOR_SEED = 20240601
FULLTEXT_TERMS = ("furiously regular", "carefully ironic packages")


def sift_like(rng, n, d, centres):
    """Integer-valued vectors in [0, 255] around ``centres`` random
    centres, as float32: every squared distance and dot product of two
    of them is an integer below 2^24, which float32 holds exactly."""
    out = np.empty((n, d), dtype=np.float32)
    step = 1 << 18
    for lo in range(0, n, step):
        m = min(step, n - lo)
        x = centres[rng.integers(0, len(centres), m)]
        x += rng.standard_normal((m, d), dtype=np.float32) * VECTOR_SPREAD
        np.clip(np.rint(x, out=x), 0, 255, out=out[lo:lo + m])
    return out


def _vtext(v) -> str:
    return "[" + ",".join(str(int(x)) for x in v) + "]"


def _sq_dists(base, q):
    """Exact squared l2 distances [len(q), n] (float64 of integers)."""
    b = base.astype(np.float64)
    qq = np.asarray(q, dtype=np.float64)
    return ((qq * qq).sum(1)[:, None] - 2.0 * (qq @ b.T)
            + (b * b).sum(1)[None, :])


def _check_topk(rows, base, ids_live, q, d2_row, tag, exact=True):
    """An ORDER BY l2_distance LIMIT k answer against the oracle: each
    returned id's own distance right, ascending, and (``exact``) the k
    distances the oracle's k smallest, as a multiset.  -> the oracle's
    k-th distance."""
    ids = np.array([r[0] for r in rows], dtype=np.int64)
    got = np.array([r[1] for r in rows], dtype=np.float64)
    if len(rows) != VECTOR_K:
        raise AssertionError(f"{tag}: {len(rows)} rows, want {VECTOR_K}")
    pos = np.searchsorted(ids_live, ids)
    if (pos >= len(ids_live)).any() or (ids_live[np.minimum(
            pos, len(ids_live) - 1)] != ids).any():
        raise AssertionError(f"{tag}: ids {ids} not all live")
    own = np.sqrt(np.maximum(_sq_dists(base[pos], q[None, :])[0], 0.0))
    if not np.array_equal(own, got):
        raise AssertionError(f"{tag}: distances {got} != own {own}")
    if (np.diff(got) < 0).any():
        raise AssertionError(f"{tag}: distances not ascending {got}")
    want = np.sqrt(np.sort(np.partition(d2_row, VECTOR_K)[:VECTOR_K]))
    if exact and not np.array_equal(got, want):
        raise AssertionError(f"{tag}: {got} != oracle {want}")
    return want[-1]


def phase_vector(torch, dev, tables, card):
    """Phase vector: VECTOR(128) columns, the distance functions, the
    exact and IVF-Flat vector indexes behind ORDER BY <distance> LIMIT k,
    and a fulltext index, through a ``Database`` on the card at the size
    of ANN-Benchmarks' SIFT1M (1,000,000 x 128, k = 10; synthetic,
    integer-valued, clustered data from a seed; 100 of its 10,000
    queries), each answer held against numpy."""
    import gc
    import re
    import shutil
    import tempfile

    from oceanbase_tpu_torch.datatypes import SqlType
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.server.mysql_protocol import MySQLServer
    from oceanbase_tpu_torch.share.vector_index import IvfFlatIndex

    rng = np.random.default_rng(VECTOR_SEED)
    t0 = time.perf_counter()
    centres = rng.integers(0, 256, (VECTOR_CENTRES, VECTOR_DIM)).astype(
        np.float32)
    base = sift_like(rng, VECTOR_ROWS, VECTOR_DIM, centres)
    queries = sift_like(rng, VECTOR_QUERIES, VECTOR_DIM, centres)
    d2 = _sq_dists(base, queries)
    gen_s = time.perf_counter() - t0
    ids_live = np.arange(VECTOR_ROWS, dtype=np.int64)
    print(f"[vector] {VECTOR_ROWS} x {VECTOR_DIM} vectors around "
          f"{VECTOR_CENTRES} centres and {VECTOR_QUERIES} queries made, "
          f"numpy oracle {gen_s:.3f} s")
    root = tempfile.mkdtemp(prefix="ob_vector_")
    qsql = ("select id, l2_distance(emb, '{}') as d from items "
            "order by d limit {}")

    def timed(sess, sql):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows = sess.execute(sql).rows()
        torch.cuda.synchronize()
        return rows, (time.perf_counter() - t1) * 1e3

    def run_queries(sess, tag, path, exact=True):
        """Query 0 (warm-up, printed alone), then all VECTOR_QUERIES
        timed; every answer checked -> (p50, p99, recall@k, first ms)."""
        ms, hits, first_ms = [], 0, None
        for i in [0] + list(range(VECTOR_QUERIES)):
            rows, t = timed(sess, qsql.format(_vtext(queries[i]), VECTOR_K))
            if sess.last_ann_path != path:
                raise AssertionError(f"{tag}: query {i} took path "
                                     f"{sess.last_ann_path}, want {path}")
            kth = _check_topk(rows, base, ids_live, queries[i], d2[i],
                              f"{tag} query {i}", exact)
            if first_ms is None:
                first_ms = t
                continue
            ms.append(t)
            # recall@k as ANN-Benchmarks counts it: a returned row whose
            # distance is within the oracle's k-th distance is a hit
            got = np.array([r[1] for r in rows])
            hits += int((got <= kth + 1e-3).sum())
        return (_pct(ms, 50), _pct(ms, 99),
                hits / (VECTOR_K * VECTOR_QUERIES), first_ms)

    def profile_one(sess, tag, path):
        """Query 0 (already run, so its plan is cached) once unprofiled
        and once under PROFILE: the kernels' and copies' device time
        against the unprofiled wall, and the three longest kernels."""
        sql = qsql.format(_vtext(queries[0]), VECTOR_K)
        _r, wall = timed(sess, sql)
        out = sess.execute("profile " + sql)
        if sess.last_ann_path != path:
            raise AssertionError(f"PROFILE {tag}: path {sess.last_ann_path}")
        _check_topk(out.rows(), base, ids_live, queries[0], d2[0],
                    f"PROFILE {tag}", path != "ivf")
        prof = db.device_profiles.get(sess._last_profile_trace_id)
        rows = [r for r in (prof.rows if prof is not None else [])
                if r["kind"] == "kernel"]
        copy = ("Memcpy", "Memset")
        kern = sum(r["total_s"] for r in rows
                   if not r["kernel"].startswith(copy)) * 1e3
        copies = sum(r["total_s"] for r in rows
                     if r["kernel"].startswith(copy)) * 1e3
        if dev.type == "cuda" and kern <= 0.0:
            raise AssertionError(f"PROFILE {tag}: no kernel rows "
                                 f"({prof.note if prof else 'no capture'})")
        top = sorted((r for r in rows if not r["kernel"].startswith(copy)),
                     key=lambda r: -r["total_s"])[:3]
        print(f"[vector] PROFILE {tag}: kernels {kern:.3f} ms + copies "
              f"{copies:.3f} ms of a {wall:.3f} ms unprofiled wall, idle "
              f"share {1.0 - (kern + copies) / wall:.4f}; longest: " +
              "; ".join(f"{r['kernel'][:60]} x{r['occurrences']} "
                        f"{r['total_s'] * 1e3:.3f} ms" for r in top) +
              f"; {card}", flush=True)

    try:
        db = Database(root, device=dev)
        sess = db.session()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db.catalog.load_numpy(
            "items", {"id": ids_live, "emb": base}, primary_key=["id"],
            types={"emb": SqlType.vector(VECTOR_DIM)})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        on_disk = _dir_bytes(root)
        td = db.catalog.table_def("items")
        if [(c.name, c.dtype.kind.value, c.dtype.precision)
                for c in td.columns] != [("id", "int", 0),
                                         ("emb", "vector", VECTOR_DIM)]:
            raise AssertionError(f"items' columns: {td.columns}")
        print(f"[vector] step 1 load: items (id int primary key, emb "
              f"vector({VECTOR_DIM})) through catalog.load_numpy "
              f"{load_s:.3f} s, {base.nbytes / load_s / 1e6:.1f} MB/s of "
              f"vectors, {on_disk} bytes on disk; {card}", flush=True)

        # -- step 2: no index, the full sort ---------------------------
        p50, p99, _r, first = run_queries(sess, "no index", None)
        rel = db.catalog.table_data("items")
        print(f"[vector] step 2 no index: {VECTOR_QUERIES} top-{VECTOR_K} "
              f"queries equal numpy; first {first:.3f} ms (the table onto "
              f"the card, {rel.capacity} lanes, "
              f"{db.catalog.device_bytes()} B cached), p50 {p50:.3f} ms, "
              f"p99 {p99:.3f} ms; {card}", flush=True)
        full_p50 = p50
        profile_one(sess, "no index", None)

        # -- step 3: an exact vector index -----------------------------
        sess.execute("create vector index iv on items (emb) "
                     "with (metric = 'l2')")
        p50, p99, _r, first = run_queries(sess, "exact index", "exact")
        print(f"[vector] step 3 exact index iv: {VECTOR_QUERIES} queries "
              f"equal numpy; first {first:.3f} ms, p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms (no index p50 {full_p50:.3f} ms); {card}")
        profile_one(sess, "exact index", "exact")
        fetch = max(4 * VECTOR_K, 64)
        # a query text not run before, so the monitor samples it
        sql = qsql.format(_vtext(queries[1][::-1]), VECTOR_K)
        prev = db.plan_monitor.recent(1)
        sess.execute(sql)
        rec = db.plan_monitor.recent(1)[-1]
        if prev and rec is prev[-1]:
            raise AssertionError("the plan monitor skipped the query")
        scans = [x["rows"] for x in rec.op_stats if x["op"] == "TableScan"]
        text = sess.execute("explain analyze " + sql).plan_text
        scan_line = next(ln for ln in text.splitlines() if "TableScan" in ln)
        if scans != [fetch] or f"act={fetch}" not in scan_line:
            raise AssertionError(f"ANN scan rows {scans}, EXPLAIN ANALYZE "
                                 f"{scan_line!r}; want {fetch}")
        print(f"[vector] step 3 plan monitor: the scan reads {scans[0]} "
              f"rows (max(4k, 64)), not {VECTOR_ROWS}; EXPLAIN ANALYZE "
              f"{scan_line.strip()}")

        # -- step 4: IVF-Flat ------------------------------------------
        sess.execute("drop index iv on items")
        sess.execute("create vector index ia on items (emb) "
                     "with (metric = 'l2', approximate = true)")
        p50, p99, recall, first = run_queries(sess, "ivf", "ivf",
                                              exact=False)
        ivf = db.catalog.sidecar("items", ("ann", "emb", "l2"),
                                 db.catalog.table_data("items"))
        if not isinstance(ivf, IvfFlatIndex):
            raise AssertionError(f"ia's structure is {type(ivf)}")
        print(f"[vector] step 4 approximate index ia: first query "
              f"{first:.3f} ms (k-means, 10 iterations, c = "
              f"{ivf.n_clusters}, built in it), bucket capacity {ivf.cap}; "
              f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, recall@{VECTOR_K} "
              f"{recall:.4f} (gate {VECTOR_RECALL_GATE}); {card}",
              flush=True)
        if recall < VECTOR_RECALL_GATE:
            raise AssertionError(f"IVF recall {recall} under the gate")
        del ivf
        profile_one(sess, "ivf index", "ivf")

        # -- step 5: cosine, inner products ----------------------------
        sess.execute("create vector index ic on items (emb) "
                     "with (metric = 'cosine')")
        bn = np.linalg.norm(base.astype(np.float64), axis=1)
        cos_ms = []
        for i in range(VECTOR_COSINE_QUERIES):
            q = queries[i].astype(np.float64)
            rows, t = timed(sess, "select id, cosine_distance(emb, '{}') as "
                            "d from items order by d limit {}".format(
                                _vtext(queries[i]), VECTOR_K))
            if sess.last_ann_path != "exact":
                raise AssertionError(f"cosine query {i}: path "
                                     f"{sess.last_ann_path}")
            cd = 1.0 - (base.astype(np.float64) @ q) / (bn * np.linalg.norm(q))
            ids = np.array([r[0] for r in rows])
            got = np.array([r[1] for r in rows])
            want = np.sort(np.partition(cd, VECTOR_K)[:VECTOR_K])
            if not (np.allclose(got, cd[ids], rtol=0, atol=1e-6)
                    and np.allclose(got, want, rtol=0, atol=1e-6)):
                raise AssertionError(f"cosine query {i}: {got} vs {want}")
            cos_ms.append(t)
        q = queries[0]
        rows = sess.execute(
            "select id, inner_product(emb, '{0}'), negative_inner_product("
            "emb, '{0}') from items where id < 5 order by id".format(
                _vtext(q))).rows()
        ip = base[:5].astype(np.int64) @ q.astype(np.int64)
        if rows != [(i, float(ip[i]), float(-ip[i])) for i in range(5)]:
            raise AssertionError(f"inner products {rows} vs {ip}")
        print(f"[vector] step 5 cosine index ic: {VECTOR_COSINE_QUERIES} "
              f"queries equal numpy at 1e-6, p50 {_pct(cos_ms, 50):.3f} ms;"
              f" inner_product and negative_inner_product of ids 0-4 "
              f"exact; {card}")

        # -- step 6: writes --------------------------------------------
        new = sift_like(rng, VECTOR_INSERTS, VECTOR_DIM, centres)
        new_ids = np.arange(VECTOR_ROWS, VECTOR_ROWS + VECTOR_INSERTS)
        ins_ms = []
        for lo in range(0, VECTOR_INSERTS, VECTOR_INSERT_STMT_ROWS):
            vals = ", ".join(f"({new_ids[j]}, '{_vtext(new[j])}')"
                             for j in range(lo, lo + VECTOR_INSERT_STMT_ROWS))
            _r, t = timed(sess, f"insert into items values {vals}")
            ins_ms.append(t)
        j = 417
        rows, t = timed(sess, qsql.format(_vtext(new[j]), VECTOR_K))
        if rows[0][0] != new_ids[j] or rows[0][1] != 0.0:
            raise AssertionError(f"query of new row {new_ids[j]}: {rows[:2]}")
        print(f"[vector] step 6 {VECTOR_INSERTS} rows in "
              f"{len(ins_ms)} INSERTs of {VECTOR_INSERT_STMT_ROWS}: p50 "
              f"{_pct(ins_ms, 50):.3f} ms per statement; the query of new "
              f"row {new_ids[j]} returns it first, path "
              f"{sess.last_ann_path}, {t:.3f} ms (table and IVF rebuilt on "
              f"the new data version)")
        gone = np.arange(VECTOR_DELETES) + VECTOR_ROWS // 2
        n_del = sess.execute(f"delete from items where id >= {gone[0]} and "
                             f"id <= {gone[-1]}").rowcount
        if n_del != VECTOR_DELETES:
            raise AssertionError(f"deleted {n_del} rows")
        keep = np.ones(VECTOR_ROWS, dtype=bool)
        keep[gone] = False
        base = np.concatenate([base[keep], new])
        ids_live = np.concatenate([ids_live[keep], new_ids])
        probe = base[np.searchsorted(ids_live, gone[0] - 1)]
        for tag, sql, exact in (
                ("after the delete (ANN)", qsql.format(
                    _vtext(probe), VECTOR_K), False),
                ("after the delete (filtered, full sort)",
                 "select id, l2_distance(emb, '{}') as d from items where "
                 "id >= 0 order by d limit {}".format(_vtext(probe),
                                                     VECTOR_K), True)):
            rows, t = timed(sess, sql)
            path = sess.last_ann_path
            _check_topk(rows, base, ids_live, probe,
                        _sq_dists(base, probe[None, :])[0], tag, exact)
            print(f"[vector] step 6 delete of ids {gone[0]}-{gone[-1]}: "
                  f"query {tag} right, path {path}, {t:.3f} ms")

        # -- step 7: DROP and CREATE -----------------------------------
        side_rng = np.random.default_rng(VECTOR_SEED + 7)
        qv = np.array([0.5, -0.5, 0.25, 1.0], np.float32)
        for rnd in range(2):
            side = side_rng.normal(size=(200, 4)).astype(np.float32)
            sess.execute("create table side (id int primary key, "
                         "e vector(4))")
            sess.execute("insert into side values " + ", ".join(
                f"({i}, '[{', '.join(repr(float(x)) for x in v)}]')"
                for i, v in enumerate(side)))
            sess.execute("create vector index sv on side (e) "
                         "with (metric = 'l2')")
            got = [r[0] for r in sess.execute(
                "select id, l2_distance(e, '[0.5, -0.5, 0.25, 1.0]') as d "
                "from side order by d limit 5").rows()]
            want = np.argsort(np.linalg.norm(side - qv, axis=1),
                              kind="stable")[:5].tolist()
            if got != want or sess.last_ann_path != "exact":
                raise AssertionError(f"side table round {rnd}: {got} vs "
                                     f"{want} ({sess.last_ann_path})")
            sess.execute("drop table side")
        print("[vector] step 7 DROP and CREATE of a 200-row side table "
              "with a vector index: both rounds equal numpy")

        # -- step 8: fulltext ------------------------------------------
        part = tables["part"]
        sess.catalog.load_numpy(
            "docs", {"p_partkey": part["p_partkey"],
                     "p_comment": part["p_comment"]},
            primary_key=["p_partkey"])
        sess.execute("create fulltext index ft on docs (p_comment)")
        toks = [set(re.split(r"\W+", str(c).lower()))
                for c in part["p_comment"]]
        for terms in FULLTEXT_TERMS:
            qt = [t for t in re.split(r"\W+", terms.lower()) if t]
            score = np.array([sum(t in tk for t in qt) for tk in toks],
                             dtype=np.float64)
            order = np.lexsort((part["p_partkey"], -score))
            order = order[score[order] > 0][:20]
            want = [(int(part["p_partkey"][i]), float(score[i]))
                    for i in order]
            m = f"match(p_comment) against('{terms}')"
            rows, t = timed(sess, f"select p_partkey, {m} as s from docs "
                            f"where {m} > 0 order by s desc, p_partkey "
                            "limit 20")
            cnt = sess.execute(f"select count(*) from docs where {m} > 0"
                               ).rows()
            if rows != want or cnt != [(int((score > 0).sum()),)]:
                raise AssertionError(f"fulltext {terms!r}: {rows[:3]} "
                                     f"{cnt} vs {want[:3]}")
            print(f"[vector] step 8 fulltext {terms!r} over "
                  f"{len(toks)} part comments: top 20 and count "
                  f"{cnt[0][0]} equal the host oracle, {t:.3f} ms")

        # -- step 9: reopen without close() -----------------------------
        cos_sql = ("select id, cosine_distance(emb, '{}') as d from items "
                   "order by d limit {}")
        before = {i: [r[0] for r in sess.execute(cos_sql.format(
            _vtext(queries[i]), VECTOR_K)).rows()] for i in (0, 1)}
        del sess, db, rel
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        db = Database(root, device=dev)
        reopen_s = time.perf_counter() - t0
        sess = db.session()
        shown = {r[0] for t_ in ("items", "docs")
                 for r in sess.execute(f"show index from {t_}").rows()}
        if not {"ia", "ic", "ft"} <= shown or "iv" in shown:
            raise AssertionError(f"SHOW INDEX after the reopen: {shown}")
        back = sess.execute(
            f"select id, emb from items where id >= {VECTOR_ROWS} "
            "order by id").rows()
        if len(back) != VECTOR_INSERTS or any(
                not np.array_equal(np.asarray(v, np.float32), new[k])
                for k, (_i, v) in enumerate(back)):
            raise AssertionError("the inserted rows did not come back")
        rows, t = timed(sess, qsql.format(_vtext(queries[3]), VECTOR_K))
        if sess.last_ann_path != "ivf":
            raise AssertionError(f"reopened: path {sess.last_ann_path}")
        _check_topk(rows, base, ids_live, queries[3],
                    _sq_dists(base, queries[3][None, :])[0],
                    "reopened ivf", exact=False)
        for i, ids in before.items():
            got = [r[0] for r in sess.execute(cos_sql.format(
                _vtext(queries[i]), VECTOR_K)).rows()]
            if got != ids or sess.last_ann_path != "exact":
                raise AssertionError(f"reopened cosine {i}: {got} vs {ids}")
        print(f"[vector] step 9 reopen {reopen_s:.3f} s ("
              f"{db.tenant().replayed_entries} WAL entries): SHOW INDEX "
              f"lists ia, ic, ft; the {VECTOR_INSERTS} inserted rows are "
              f"back; ia rebuilt ({t:.3f} ms, IVF) and ic answer as "
              f"before; {card}", flush=True)

        # -- step 10: the wire -----------------------------------------
        srv = MySQLServer(db, host="127.0.0.1", port=0).start()
        try:
            c = WireClient(srv.host, srv.port)
            _cols, wrows = c.query("select id, emb from items where id < 3 "
                                   "order by id")
            c.close()
        finally:
            srv.stop()
        for i, (wid, cell) in enumerate(wrows):
            vals = np.array([float(x) for x in cell[1:-1].split(",")],
                            dtype=np.float32)
            if int(wid) != i or not (cell.startswith("[") and
                                     cell.endswith("]")) or \
                    not np.array_equal(vals, base[i]):
                raise AssertionError(f"wire row {i}: {wid} {cell[:40]}")
        print(f"[vector] step 10 the wire: {wrows[0][1][:32]}... parses "
              f"back to the stored floats for ids 0-2")
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.bench.tpch import gen_tpch
    from oceanbase_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {card}")

    t0 = time.perf_counter()
    log = _build.build("q6_filter_sum")
    print(f"[build] q6_filter_sum.cu built for sm_90a in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"[build] {line.strip()}")

    sf = float(os.environ.get("OB_SMOKE_SF", "1"))
    oracles = start_oracles(here, sf)
    t0 = time.perf_counter()
    tables, types = gen_tpch(sf=sf)
    li = tables["lineitem"]
    print(f"[setup] gen_tpch sf={sf}: {len(li['l_orderkey'])} lineitem "
          f"rows in {time.perf_counter() - t0:.3f} s")

    sf_cols = [torch.from_numpy(li[c].astype(np.int32)).to(dev) for c in
               ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")]
    sf_cols.append(torch.ones(len(li["l_orderkey"]), dtype=torch.int32,
                              device=dev))
    kernels = phase_kernels(torch, dev, sf_cols)
    del sf_cols

    def timed_phase(name, fn, *args):
        """Run one phase with the launch counts set to 0 just before it;
        print its seconds -> (its result, its launch counts)."""
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(f"[time] phase {name}: {time.perf_counter() - t0:.3f} s")
        return out, _build.launch_counts()

    whole_ms, counts = timed_phase("main", phase_main_path, torch, dev,
                                   tables, types, card)
    for rec in kernels:
        rec["launches"] = counts.get(rec["name"], 0)
        if rec["launches"] < 1:
            raise AssertionError(
                f"{rec['name']} was not launched on the main path")

    _, counts = timed_phase("stream", phase_stream, torch, dev, tables,
                            types, card, whole_ms)
    print(f"[stream] kernel launches: {counts}")
    (sess, want, sql_stats), counts = timed_phase(
        "sql", phase_sql, dev, tables, types, card, oracles)
    print(f"[sql] kernel launches on the SQL path: {counts}")
    _, counts = timed_phase("spill", phase_spill, torch, dev, sess, tables,
                            card, sql_stats, want)
    print(f"[spill] kernel launches: {counts}")
    ip1_rows, counts = timed_phase("sql-index", phase_sql_index, torch, sess,
                                   tables, want, card)
    print(f"[sql-index] kernel launches: {counts}")
    _, counts = timed_phase("sql-surface", phase_sql_surface, sess, card,
                            ip1_rows, want)
    print(f"[sql-surface] kernel launches: {counts}")
    del sess  # the catalog-only session's tables leave the card
    torch.cuda.empty_cache()
    _, counts = timed_phase("db", phase_db, torch, dev, tables, types, card,
                            want)
    print(f"[db] kernel launches: {counts}")
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="ob_load_")
    try:
        loaded, counts = timed_phase("load", phase_load, torch, dev, tables,
                                     types, card, want, root)
        print(f"[load] kernel launches: {counts}")
        served, counts = timed_phase("server", phase_server, torch, dev,
                                     tables, types, card, want, loaded)
        print(f"[server] kernel launches: {counts}")
        measured, counts = timed_phase("measure", phase_measure, torch,
                                       dev, tables, types, card, want,
                                       served)
        print(f"[measure] kernel launches (q6_filter_sum once under the "
              f"profiler): {counts}")
        _, counts = timed_phase("durability", phase_durability, torch, dev,
                                tables, types, card, want, served, measured,
                                loaded["files"], root)
        print(f"[durability] kernel launches: {counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    _, counts = timed_phase("vector", phase_vector, torch, dev, tables, card)
    print(f"[vector] kernel launches: {counts}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernels]}))
    print(f"[done] {time.perf_counter() - t_start:.3f} s in all")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
