"""The trace plane's standing contract, single-node half.

Port of ``scripts/trace_bench.py``'s overhead half (``bench_overhead``,
:84-125), over any package's ``Database``: the slice's q6 and q1 answer
the same with full-link tracing on and off, then run in 4 blocks of
alternating order (off/on, on/off, ...) at ``trace_sample_rate = 1.0``,
every statement collecting and keeping its span tree in the on blocks.
The contract is ``overhead_pct <= 2.0`` (``trace_bench.py:214-221``).

The cluster half (``bench_attribution``, :127-207) runs over any
package's node processes (``bench/cluster.py``): a 400 ms ``delay`` on
node 1's send of ``dtl.execute`` toward peer 2, the q6 answer the same
with and without it, and the statement's gv$sql_audit row joined to its
gv$trace tree by ``trace_id``, whose slowest span below the statement
chain must be ``rpc.dtl.execute`` toward peer 2, at least the delay
long.
"""

from __future__ import annotations

import json
import time

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.bench.cluster import lead_from, rows as rows_of

ROWS = 100_000          # ``trace_bench.py:211`` (BENCH_ROWS)
REPEATS = 40            # ``trace_bench.py:212`` (BENCH_REPEATS)
BLOCKS = 4              # ``trace_bench.py:104``
SAMPLE_RATE = 1.0       # ``trace_bench.py:102``
KNOBS = ("enable_query_trace", "trace_sample_rate")
DELAY_MS = 400.0        # ``trace_bench.py:167``
DELAY_PEER = 2          # ``trace_bench.py:169``
#: the spans that hold the whole delay above the injected call
#: (``trace_bench.py:188``)
CHAIN = {"statement", "execute", "dtl.exchange", "dtl.slice"}
#: each statement's wall bound (``trace_bench.py:140``)
QUERY_S = 60.0


def overhead(db, repeats: int = REPEATS) -> dict:
    """The overhead half on ``db``, whose ``lineitem`` holds the slice
    -> the reference's record, with the answers beside it."""
    s = db.session()
    with planes.kept(db, KNOBS):
        planes.alter(s, "enable_query_trace", True)
        on_rows = planes.answers(s)
        planes.alter(s, "enable_query_trace", False)
        off_rows = planes.answers(s)
        planes.time_queries(s, planes.WARM)
        planes.alter(s, "trace_sample_rate", SAMPLE_RATE)
        off_s = on_s = 0.0
        per_block = max(repeats // BLOCKS, 1)
        for b in range(BLOCKS):
            order = (False, True) if b % 2 == 0 else (True, False)
            for mode in order:
                planes.alter(s, "enable_query_trace", mode)
                dt = planes.time_queries(s, per_block)
                if mode:
                    on_s += dt
                else:
                    off_s += dt
        n_spans = len(db.trace_registry.recent(100000))
    s.close()
    return {"repeats": per_block * BLOCKS,
            "off_s": round(off_s, 4), "on_s": round(on_s, 4),
            "overhead_pct": round(planes.pct(on_s, off_s), 3),
            "spans_in_ring": n_spans,
            "rows_equal": on_rows == off_rows, "answers": on_rows}


def attribution(c, rows: int, node: int = 1) -> dict:
    """The cluster half on ``c`` (a ``ClusterClient`` whose ``lineitem``
    holds ``rows`` rows of the slice, ``dtl_min_rows = 1``), every
    statement on ``node`` -> the reference's record."""
    lead_from(c, node)

    def sql(text):
        return c.execute(node, text, deadline_s=QUERY_S)

    baseline = rows_of(sql(planes.QUERIES["q6"]))
    sql(planes.QUERIES["q6"])  # the pushdown path warm
    c.clients[node].call("fault.inject", where="send", action="delay",
                         verb="dtl.execute", peer=DELAY_PEER,
                         delay_ms=DELAY_MS)
    try:
        t0 = time.monotonic()
        faulted = rows_of(sql(planes.QUERIES["q6"]))
        q6_s = time.monotonic() - t0
    finally:
        c.clients[node].call("fault.clear")
    audit = rows_of(sql("select trace_id, sql, start_ts from gv$sql_audit"))
    trace_id = next(
        tid for tid, q, _ts in sorted(audit, key=lambda r: -r[2])
        if tid and q.startswith("select sum(l_extendedprice"))
    spans = rows_of(sql(
        f"select span_name, node, elapsed_s, tags from gv$trace"
        f" where trace_id = '{trace_id}' order by elapsed_s desc"))
    slowest = next(sp for sp in spans if sp[0] not in CHAIN)
    tags = json.loads(slowest[3]) if slowest[3] else {}
    ok = (slowest[0] == "rpc.dtl.execute"
          and int(tags.get("peer", -1)) == DELAY_PEER
          and float(slowest[2]) >= DELAY_MS / 1000.0)
    return {"rows": rows, "delay_ms": DELAY_MS,
            "q6_under_fault_s": round(q6_s, 3),
            "trace_id": trace_id, "trace_spans": len(spans),
            "slowest_span": slowest[0], "slowest_span_tags": tags,
            "slowest_elapsed_s": round(float(slowest[2]), 3),
            "attribution_ok": bool(ok), "parity": faulted == baseline}


def run(db, rows: int = ROWS, repeats: int = REPEATS,
        cluster_half=None) -> dict:
    """The reference's line: the slice INSERTed into ``db`` (a fresh
    Database of either package), then the overhead half; then
    ``cluster_half()`` (``attribution`` on a cluster of its own) unless
    it is None, as ``TRACE_BENCH_SKIP_CLUSTER`` skips it."""
    s = db.session()
    planes.load_inserts(s, rows)
    s.close()
    out = {"metric": "trace_bench",
           "overhead": {"rows": rows, **overhead(db, repeats)}}
    ok = out["overhead"]["overhead_pct"] <= planes.BOUND_PCT
    if cluster_half is not None:
        out["attribution"] = cluster_half()
        ok = ok and out["attribution"]["attribution_ok"]
    out["ok"] = bool(ok)
    return out


def failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate ``rec`` (the overhead record) breaks, by name; with
    ``timing`` False the 2% bound is left to the caller to report."""
    bad = []
    if not rec.get("rows_equal"):
        bad.append("rows_equal: tracing changed results")
    if timing and not rec.get("overhead_pct", float("inf")) <= \
            planes.BOUND_PCT:
        bad.append(f"overhead_pct {rec.get('overhead_pct')} > "
                   f"{planes.BOUND_PCT}")
    return bad


def attribution_failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the attribution record ``rec`` breaks, by name (it
    reads no overhead: ``timing`` changes nothing)."""
    bad = []
    if not rec.get("parity"):
        bad.append("parity: the delay changed the answer")
    if not rec.get("attribution_ok"):
        bad.append(f"attribution_ok: the slowest span "
                   f"{rec.get('slowest_span')} "
                   f"{rec.get('slowest_span_tags')} "
                   f"{rec.get('slowest_elapsed_s')} s")
    return bad
