"""The trace plane's standing contract, single-node half.

Port of ``scripts/trace_bench.py``'s overhead half (``bench_overhead``,
:84-125), over any package's ``Database``: the slice's q6 and q1 answer
the same with full-link tracing on and off, then run in 4 blocks of
alternating order (off/on, on/off, ...) at ``trace_sample_rate = 1.0``,
every statement collecting and keeping its span tree in the on blocks.
The contract is ``overhead_pct <= 2.0`` (``trace_bench.py:214-221``).

The reference's other half (a delay on one peer's ``dtl.execute`` named
by the slowest span of a 3-node cluster's trace) waits for ROADMAP
Queue 1 item 3.
"""

from __future__ import annotations

from oceanbase_tpu_torch.bench import planes

ROWS = 100_000          # ``trace_bench.py:211`` (BENCH_ROWS)
REPEATS = 40            # ``trace_bench.py:212`` (BENCH_REPEATS)
BLOCKS = 4              # ``trace_bench.py:104``
SAMPLE_RATE = 1.0       # ``trace_bench.py:102``
KNOBS = ("enable_query_trace", "trace_sample_rate")


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


def run(db, rows: int = ROWS, repeats: int = REPEATS) -> dict:
    """The reference's line with its cluster half skipped: the slice
    INSERTed into ``db`` (a fresh Database of either package), then the
    overhead half."""
    s = db.session()
    planes.load_inserts(s, rows)
    s.close()
    rec = {"rows": rows, **overhead(db, repeats)}
    return {"metric": "trace_bench", "overhead": rec,
            "attribution": planes.CLUSTER_SKIPPED,
            "ok": rec["overhead_pct"] <= planes.BOUND_PCT}


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
