"""The metrics plane's standing contract, single-node half.

Port of ``scripts/metrics_bench.py``'s overhead half (``bench_overhead``,
:85-128), over any package's ``Database`` and the metrics module of the
same package (the port's by default): the slice's q6 and q1 answer the
same with ``enable_metrics`` on and off, then run in 4 blocks of
alternating order, every statement updating the statement, plan and
plan-cache series in the on blocks.  The contract is ``overhead_pct <=
2.0`` (``metrics_bench.py:220-227``).

The cluster half (``bench_scrape``, :129-213) runs over any package's
node processes (``bench/cluster.py``): three pushed-down q6 runs on
node 1, every node's ``metrics.scrape`` merged with the port's
``merge_wire``, and the merged ``rpc.bytes{verb=dtl.execute}`` held
within 1% of the pushdown ``bytes_shipped`` of node 1's gv$px_exchange;
gv$sysstat's SQL face at least 0.99 of the raw scrape, and the
Prometheus face printing lines.
"""

from __future__ import annotations

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.bench.cluster import lead_from, rows as rows_of
from oceanbase_tpu_torch.server import metrics as port_metrics

ROWS = 100_000          # ``metrics_bench.py:217`` (BENCH_ROWS)
REPEATS = 40            # ``metrics_bench.py:218`` (BENCH_REPEATS)
BLOCKS = 4              # ``metrics_bench.py:105``
KNOBS = ("enable_metrics",)
RUNS = 3                # ``metrics_bench.py:168``: pushdown traffic
DRIFT_PCT = 1.0         # ``metrics_bench.py:206``
SQL_FACE = 0.99         # ``metrics_bench.py:207``
DTL_SERIES = "rpc.bytes{verb=dtl.execute}"
QUERY_S = 60.0
SCRAPE_S = 30.0         # each scrape's deadline (the verb's is 5 s)


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


def scrape(c, rows: int, node: int = 1) -> dict:
    """The cluster half on ``c`` (a ``ClusterClient`` whose ``lineitem``
    holds ``rows`` rows of the slice, ``dtl_min_rows = 1``), every
    statement on ``node`` -> the reference's record."""
    lead_from(c, node)

    def sql(text):
        return c.execute(node, text, deadline_s=QUERY_S)

    for _ in range(RUNS):
        sql(planes.QUERIES["q6"])
    merged: dict = {"counters": [], "gauges": [], "hists": []}
    for i in sorted(c.clients):
        merged = port_metrics.merge_wire(merged, c.clients[i].call(
            "metrics.scrape", _deadline_s=SCRAPE_S)["wire"])
    flat = port_metrics.wire_to_flat(merged)
    rpc_dtl_bytes = flat.get(DTL_SERIES, 0)
    dtl_bytes = c.pushdown_bytes()
    drift_pct = abs(rpc_dtl_bytes - dtl_bytes) / max(dtl_bytes, 1) * 100.0
    face = rows_of(sql("select stat_name, value from gv$sysstat"
                       f" where stat_name = '{DTL_SERIES}'"))
    sql_face = int(face[0][1]) if face else 0
    prom = c.clients[node].call("metrics.scrape", format="prom",
                                _deadline_s=SCRAPE_S)
    return {"rows": rows, "nodes": len(c.clients),
            "series_merged": len(flat),
            "rpc_dtl_bytes": int(rpc_dtl_bytes),
            "px_exchange_bytes": int(dtl_bytes),
            "drift_pct": round(drift_pct, 4),
            "sysstat_sql_face": sql_face,
            "prom_lines": len(prom["text"].splitlines()),
            "reconciled": bool(drift_pct <= DRIFT_PCT and dtl_bytes > 0
                               and sql_face >= rpc_dtl_bytes * SQL_FACE)}


def run(db, rows: int = ROWS, repeats: int = REPEATS,
        metrics=port_metrics, cluster_half=None) -> dict:
    """The reference's line: the slice INSERTed into ``db`` (a fresh
    Database of either package), then the overhead half; then
    ``cluster_half()`` (``scrape`` on a cluster of its own) unless it is
    None, as ``METRICS_BENCH_SKIP_CLUSTER`` skips it."""
    s = db.session()
    planes.load_inserts(s, rows)
    s.close()
    out = {"metric": "metrics_bench",
           "overhead": {"rows": rows, **overhead(db, repeats, metrics)}}
    ok = out["overhead"]["overhead_pct"] <= planes.BOUND_PCT
    if cluster_half is not None:
        out["scrape"] = cluster_half()
        ok = ok and out["scrape"]["reconciled"]
    out["ok"] = bool(ok)
    return out


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


def scrape_failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the scrape record ``rec`` breaks, by name (it reads no
    time: ``timing`` changes nothing)."""
    if rec.get("reconciled"):
        return []
    return [f"reconciled: rpc.bytes {rec.get('rpc_dtl_bytes')} against "
            f"gv$px_exchange {rec.get('px_exchange_bytes')} (drift "
            f"{rec.get('drift_pct')}%), gv$sysstat "
            f"{rec.get('sysstat_sql_face')}"]
