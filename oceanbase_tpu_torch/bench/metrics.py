"""The metrics plane's standing contract, single-node half.

Port of ``scripts/metrics_bench.py``'s overhead half (``bench_overhead``,
:85-128), over any package's ``Database`` and the metrics module of the
same package (the port's by default): the slice's q6 and q1 answer the
same with ``enable_metrics`` on and off, then run in 4 blocks of
alternating order, every statement updating the statement, plan and
plan-cache series in the on blocks.  The contract is ``overhead_pct <=
2.0`` (``metrics_bench.py:220-227``).

The reference's other half (a 3-node cluster's merged ``rpc.bytes``
scrape against gv$px_exchange) waits for ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.server import metrics as port_metrics

ROWS = 100_000          # ``metrics_bench.py:217`` (BENCH_ROWS)
REPEATS = 40            # ``metrics_bench.py:218`` (BENCH_REPEATS)
BLOCKS = 4              # ``metrics_bench.py:105``
KNOBS = ("enable_metrics",)


def overhead(db, repeats: int = REPEATS, metrics=port_metrics) -> dict:
    """The overhead half on ``db``, whose ``lineitem`` holds the slice
    -> the reference's record, with the answers beside it."""
    s = db.session()
    with planes.kept(db, KNOBS):
        planes.alter(s, "enable_metrics", True)
        on_rows = planes.answers(s)
        planes.alter(s, "enable_metrics", False)
        off_rows = planes.answers(s)
        planes.time_queries(s, planes.WARM)
        off_s = on_s = 0.0
        per_block = max(repeats // BLOCKS, 1)
        for b in range(BLOCKS):
            order = (False, True) if b % 2 == 0 else (True, False)
            for mode in order:
                planes.alter(s, "enable_metrics", mode)
                dt = planes.time_queries(s, per_block)
                if mode:
                    on_s += dt
                else:
                    off_s += dt
        planes.alter(s, "enable_metrics", True)
        n_series = len(metrics.sysstat_dict())
    s.close()
    return {"repeats": per_block * BLOCKS,
            "off_s": round(off_s, 4), "on_s": round(on_s, 4),
            "overhead_pct": round(planes.pct(on_s, off_s), 3),
            "series": n_series,
            "rows_equal": on_rows == off_rows, "answers": on_rows}


def run(db, rows: int = ROWS, repeats: int = REPEATS,
        metrics=port_metrics) -> dict:
    """The reference's line with its cluster half skipped: the slice
    INSERTed into ``db`` (a fresh Database of either package), then the
    overhead half."""
    s = db.session()
    planes.load_inserts(s, rows)
    s.close()
    rec = {"rows": rows, **overhead(db, repeats, metrics)}
    return {"metric": "metrics_bench", "overhead": rec,
            "scrape": planes.CLUSTER_SKIPPED,
            "ok": rec["overhead_pct"] <= planes.BOUND_PCT}


def failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate ``rec`` (the overhead record) breaks, by name; with
    ``timing`` False the 2% bound is left to the caller to report."""
    bad = []
    if not rec.get("rows_equal"):
        bad.append("rows_equal: metrics changed results")
    if timing and not rec.get("overhead_pct", float("inf")) <= \
            planes.BOUND_PCT:
        bad.append(f"overhead_pct {rec.get('overhead_pct')} > "
                   f"{planes.BOUND_PCT}")
    return bad
