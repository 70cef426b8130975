"""The workload repository's standing contracts, single-node.

Port of ``scripts/workload_bench.py``'s first three lanes (its constants,
record fields and gates, each cited by line), over any package's
``Database``:

  overhead  the snapshot thread (``enable_workload_repo``) off against on
            at ``workload_snapshot_interval_s = 1.0``, one slice pass per
            knob flip with the order alternating, compared by 25%-trimmed
            means (``workload_bench.py:94-150``); the contract is <= 2%;
  phases    the sys tenant's gv$time_model delta over a pure query loop:
            queue, bind, sidecar, lower, compile, dispatch, merge and
            device seconds summed against ``elapsed_s``, within 90-110%
            (``workload_bench.py:140-167``);
  restart   a snapshot taken before close is crc-verified by
            ``workload.load`` after a reopen and delta-reportable
            against a fresh one (``workload_bench.py:170-203``).

  cluster   over any package's node processes (``bench/cluster.py``):
            three pushed-down q6 runs on node 1, then ``analyze workload
            report`` there, whose snapshot merges every node (``nodes=``
            three) and whose ``rpc.bytes{verb=dtl.execute}`` row lies
            within 1% of node 1's gv$px_exchange pushdown bytes; ``show
            workload report`` renders it (``workload_bench.py:206-278``).
"""

from __future__ import annotations

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.bench.cluster import lead_from, rows as rows_of

ROWS = 100_000          # ``workload_bench.py:282`` (BENCH_ROWS)
REPEATS = 40            # ``workload_bench.py:283`` (BENCH_REPEATS)
RESTART_ROWS = 20_000   # ``workload_bench.py:286``
PARITY_INTERVAL_S = 0.2     # ``workload_bench.py:105``
INTERVAL_S = 1.0        # ``workload_bench.py:114``
MIN_ROUNDS = 24         # ``workload_bench.py:120``
MIN_LOOP = 5            # ``workload_bench.py:145``
#: the phases summed against the wall (``workload_bench.py:148-151``)
PHASES = ("queue_s", "bind_s", "sidecar_build_s", "lower_s", "compile_s",
          "dispatch_s", "merge_s", "device_s")
BAND_PCT = (90.0, 110.0)    # ``workload_bench.py:164``
KNOBS = ("enable_workload_repo", "workload_snapshot_interval_s")
CLUSTER_RUNS = 3        # ``workload_bench.py:243``: pushdown traffic
CLUSTER_NODES = 3       # ``workload_bench.py:271``
DRIFT_PCT = 1.0         # ``workload_bench.py:272``
DTL_SERIES = "rpc.bytes{verb=dtl.execute}"
QUERY_S = 60.0


def overhead_and_phases(db, repeats: int = REPEATS) -> dict:
    """The overhead and phase lanes on ``db``, whose ``lineitem`` holds
    the slice -> the reference's record, with the answers and each
    phase's seconds beside it."""
    s = db.session()
    with planes.kept(db, KNOBS):
        planes.alter(s, "workload_snapshot_interval_s", PARITY_INTERVAL_S)
        planes.alter(s, "enable_workload_repo", True)
        on_rows = planes.answers(s)
        planes.alter(s, "enable_workload_repo", False)
        off_rows = planes.answers(s)
        planes.alter(s, "workload_snapshot_interval_s", INTERVAL_S)
        planes.time_queries(s, planes.WARM)
        rounds = max(repeats, MIN_ROUNDS)
        samples = {False: [], True: []}
        for r in range(rounds):
            for mode in ((False, True) if r % 2 == 0 else (True, False)):
                planes.alter(s, "enable_workload_repo", mode)
                samples[mode].append(planes.time_queries(s, 1))
        planes.alter(s, "enable_workload_repo", False)
    off_s, on_s = sum(samples[False]), sum(samples[True])
    overhead_pct = planes.pct(planes.trimmed_mean(samples[True]),
                              planes.trimmed_mean(samples[False]))
    # the tenant's account is monotonic: its delta around a loop of the
    # slice alone leaves the load and knob statements out
    tm0 = db.time_model.snapshot()["sys"]
    planes.time_queries(s, max(repeats // 2, MIN_LOOP))
    tm1 = db.time_model.snapshot()["sys"]
    s.close()
    tm = {k: tm1[k] - tm0[k] for k in tm1}
    phase_sum = sum(tm[p] for p in PHASES)
    coverage_pct = phase_sum / max(tm["elapsed_s"], 1e-12) * 100.0
    return {"repeats": rounds,
            "off_s": round(off_s, 4), "on_s": round(on_s, 4),
            "overhead_pct": round(overhead_pct, 3),
            "snapshots_taken": len(db.workload.snapshot_ids()),
            "phase_sum_s": round(phase_sum, 4),
            "elapsed_s": round(tm["elapsed_s"], 4),
            "statements": int(tm["statements"]),
            "phase_coverage_pct": round(coverage_pct, 2),
            "phases_reconcile":
                bool(BAND_PCT[0] <= coverage_pct <= BAND_PCT[1]),
            "phases": {p: round(tm[p], 6) for p in PHASES},
            "time_model_names": sorted(tm),
            "rows_equal": on_rows == off_rows, "answers": on_rows}


def restart(open_db, path: str, rows: int = RESTART_ROWS) -> dict:
    """The restart lane on a fresh Database at ``path`` (opened by
    ``open_db(path)``, twice) -> the reference's record."""
    db = open_db(path)
    s = db.session()
    planes.load_inserts(s, rows)
    for q in planes.QUERIES.values():
        s.execute(q)
    pre_id = db.workload.snapshot(cluster=False)["id"]
    s.close()
    db.close()
    db2 = open_db(path)
    s2 = db2.session(tenant="sys")
    for q in planes.QUERIES.values():
        s2.execute(q)
    loaded = db2.workload.load(pre_id)  # crc-verified or raises
    rep = db2.workload.build_report(from_id=pre_id, to_id=-1)
    s2.close()
    db2.close()
    return {"rows": rows, "pre_restart_id": pre_id,
            "post_restart_to_id": rep["to_id"],
            "report_rows": len(rep["rows"]),
            "crc_verified_after_restart": loaded["id"] == pre_id,
            "delta_reportable": bool(
                loaded["id"] == pre_id and rep["from_id"] == pre_id
                and rep["to_id"] > pre_id and len(rep["rows"]) > 0)}


def cluster(c, rows: int, node: int = 1) -> dict:
    """The cluster lane on ``c`` (a ``ClusterClient`` whose ``lineitem``
    holds ``rows`` rows of the slice, ``dtl_min_rows = 1``), every
    statement on ``node`` -> the reference's record."""
    lead_from(c, node)

    def sql(text):
        return c.execute(node, text, deadline_s=QUERY_S)

    for _ in range(CLUSTER_RUNS):
        sql(planes.QUERIES["q6"])
    rep = rows_of(sql("analyze workload report"))
    by_item = {(r[0], r[1]): r[2] for r in rep}
    detail = next((r[3] for r in rep if r[0] == "report"), "")
    nodes = detail.split("nodes=")[-1].split(",") \
        if "nodes=" in detail else []
    rpc_dtl = float(by_item.get(("sysstat", DTL_SERIES), 0.0))
    dtl_bytes = c.pushdown_bytes()
    drift_pct = abs(rpc_dtl - dtl_bytes) / max(dtl_bytes, 1) * 100.0
    tree = rows_of(sql("show workload report"))
    return {"rows": rows, "nodes_merged": len(nodes),
            "report_rows": len(rep), "tree_lines": len(tree),
            "rpc_dtl_bytes": int(rpc_dtl),
            "px_exchange_bytes": int(dtl_bytes),
            "drift_pct": round(drift_pct, 4),
            "reconciled": bool(len(nodes) == CLUSTER_NODES
                               and dtl_bytes > 0
                               and drift_pct <= DRIFT_PCT)}


def run(db, open_db, restart_path: str, rows: int = ROWS,
        repeats: int = REPEATS, cluster_half=None) -> dict:
    """The reference's line: the slice INSERTed into ``db`` (a fresh
    Database of either package) for the overhead and phase lanes, the
    restart lane at ``restart_path`` on ``min(rows, 20,000)`` rows, then
    ``cluster_half()`` (``cluster`` on a cluster of its own) unless it
    is None, as ``WORKLOAD_BENCH_SKIP_CLUSTER`` skips it."""
    s = db.session()
    planes.load_inserts(s, rows)
    s.close()
    out = {"metric": "workload_bench",
           "overhead": {"rows": rows, **overhead_and_phases(db, repeats)},
           "restart": restart(open_db, restart_path,
                              min(rows, RESTART_ROWS))}
    ok = (out["overhead"]["overhead_pct"] <= planes.BOUND_PCT
          and out["overhead"]["phases_reconcile"]
          and out["restart"]["delta_reportable"])
    if cluster_half is not None:
        out["cluster"] = cluster_half()
        ok = ok and out["cluster"]["reconciled"]
    out["ok"] = bool(ok)
    return out


def failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the line ``rec`` breaks, by name (its cluster lane's
    where it ran); with ``timing`` False the 2% bound and the phase band
    are left to the caller to report."""
    bad = cluster_failures(rec["cluster"]) if "cluster" in rec else []
    o, r = rec.get("overhead", {}), rec.get("restart", {})
    if not o.get("rows_equal"):
        bad.append("rows_equal: the snapshot thread changed results")
    if not r.get("crc_verified_after_restart"):
        bad.append("crc_verified_after_restart")
    if not r.get("delta_reportable"):
        bad.append("delta_reportable")
    if timing:
        if not o.get("overhead_pct", float("inf")) <= planes.BOUND_PCT:
            bad.append(f"overhead_pct {o.get('overhead_pct')} > "
                       f"{planes.BOUND_PCT}")
        if not o.get("phases_reconcile"):
            bad.append(f"phases_reconcile: phase_coverage_pct "
                       f"{o.get('phase_coverage_pct')} outside "
                       f"{BAND_PCT}")
    return bad


def cluster_failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the cluster record ``rec`` breaks, by name (it reads no
    time: ``timing`` changes nothing)."""
    if rec.get("reconciled"):
        return []
    return [f"reconciled: {rec.get('nodes_merged')} nodes merged, "
            f"rpc.bytes {rec.get('rpc_dtl_bytes')} against gv$px_exchange "
            f"{rec.get('px_exchange_bytes')} (drift "
            f"{rec.get('drift_pct')}%)"]

