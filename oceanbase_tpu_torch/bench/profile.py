"""The profiling plane's standing contracts, single-node.

Port of ``scripts/profile_bench.py`` (its constants, record fields and
gates, each cited by line), over any package's ``Database``:

  overhead  the host/device split (``enable_profiling``) off against on
            over the slice's q6 and q1, in tightly interleaved samples of
            4 passes with the order alternating, compared by the median
            per mode (``profile_bench.py:88-147``); the contract is <= 2%;
  roofline  after ONE ``ALTER SYSTEM CALIBRATE`` with
            ``plan_monitor_sample_every = 1``, each TPC-H query run twice
            and its second execution's ``device_s``, ``pred_s``,
            ``time_q`` and ``path`` read from the plan monitor; the
            median time q-error over the queries is <= 4x; the largest
            ``achieved_gflops`` in gv$plan_cache is > 0; ``PROFILE`` of
            Q6 joins at least one gv$device_profile row by the audit's
            trace_id (``profile_bench.py:153-233``).

On the card the port's ``device_s`` is a CUDA event span from an
execution's first launch to its last kernel's end; on the CPU it is 0,
so no query is priced there and the two rate gates fail by definition.
"""

from __future__ import annotations

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
from oceanbase_tpu_torch.server import metrics as port_metrics

SF = 0.1                # ``profile_bench.py:45`` (PROFILE_SF)
REPEATS = 96            # ``profile_bench.py:48`` (PROFILE_REPEATS)
ROWS = 20_000           # ``profile_bench.py:88``
PER_SAMPLE = 4          # ``profile_bench.py:116``
MIN_SAMPLES = 8         # ``profile_bench.py:117``
TIME_Q_BOUND = 4.0      # ``profile_bench.py:249``
PROFILED = 6            # ``profile_bench.py:206``
OVERHEAD_KNOBS = ("enable_profiling",)
ROOFLINE_KNOBS = ("plan_monitor_sample_every",)


def overhead(db, repeats: int = REPEATS) -> dict:
    """The overhead half on ``db``, whose ``lineitem`` holds the slice
    -> the reference's record, with the answers beside it."""
    s = db.session()
    with planes.kept(db, OVERHEAD_KNOBS):
        planes.alter(s, "enable_profiling", True)
        on_rows = planes.answers(s)
        planes.alter(s, "enable_profiling", False)
        off_rows = planes.answers(s)
        planes.time_queries(s, planes.WARM)
        samples = max(repeats // PER_SAMPLE, MIN_SAMPLES)
        off_times, on_times = [], []
        for i in range(samples):
            for mode in ((False, True) if i % 2 == 0 else (True, False)):
                planes.alter(s, "enable_profiling", mode)
                dt = planes.time_queries(s, PER_SAMPLE)
                (on_times if mode else off_times).append(dt)
        planes.alter(s, "enable_profiling", True)
    s.close()
    off_m, on_m = planes.median(off_times), planes.median(on_times)
    return {"repeats": samples * PER_SAMPLE,
            "off_s": round(sum(off_times), 4),
            "on_s": round(sum(on_times), 4),
            "mean_overhead_pct": round(
                planes.pct(sum(on_times), sum(off_times)), 2),
            "overhead_pct": round(planes.pct(on_m, off_m), 2),
            "rows_equal": on_rows == off_rows, "answers": on_rows}


def roofline(db, calibrate: bool = True, queries=QUERIES) -> dict:
    """The roofline, rate and deep-profile halves on ``db``, whose TPC-H
    tables are loaded and ANALYZEd.  ``calibrate`` False prices with the
    units of the caller's own ``ALTER SYSTEM CALIBRATE`` just before
    -> the reference's record (without its generation seconds)."""
    s = db.session()
    with planes.kept(db, ROOFLINE_KNOBS):
        planes.alter(s, "plan_monitor_sample_every", 1)
        if calibrate:
            s.execute("alter system calibrate")
        units = db.cost_units
        per_query, tqs = {}, []
        for qnum in sorted(queries):
            s.execute(queries[qnum])  # warm: first execution outside
            s.execute(queries[qnum])
            rec = db.plan_monitor.recent(1)[-1]
            per_query[f"q{qnum}"] = {
                "device_ms": round(rec.device_s * 1e3, 3),
                "pred_ms": round(rec.pred_s * 1e3, 3),
                "host_ms": round(rec.host_s * 1e3, 3),
                "time_q": round(rec.time_q, 2),
                "path": rec.path}
            if rec.time_q > 0.0:
                tqs.append(rec.time_q)
        gflops = db.virtual_tables.plan_cache()["achieved_gflops"]
        max_gflops = float(gflops.max()) if len(gflops) else 0.0
        # whitespace-normalized: the audit's LIKE probe matches one line
        s.execute("profile " + " ".join(queries[PROFILED].split()))
        tid_rows = s.execute(
            "select trace_id from gv$sql_audit where sql like"
            " 'profile%' order by start_ts desc limit 1").rows()
    s.close()
    trace_id = tid_rows[0][0] if tid_rows else ""
    prof = db.device_profiles.get(trace_id) if trace_id else None
    median_tq = planes.median(tqs) or 0.0
    return {
        "queries": len(per_query), "with_time_q": len(tqs),
        "median_time_q": round(median_tq, 2),
        "worst_time_q": round(max(tqs), 2) if tqs else 0.0,
        "calibration": None if units is None else {
            "preset": units.preset,
            "peak_gflops": round(units.peak_flops_s / 1e9, 2),
            "peak_gbps": round(units.peak_bytes_s / 1e9, 2),
            "launch_overhead_us": round(units.launch_overhead_s * 1e6, 2),
            "probe_s": units.probe_s},
        "max_achieved_gflops": round(max_gflops, 4),
        "profile": {"trace_id": trace_id,
                    "rows": len(prof.rows) if prof is not None else 0},
        "per_query": per_query,
    }


def checks(roof: dict, ovh: dict) -> dict:
    """The reference's gate (``profile_bench.py:246-253``)."""
    return {"overhead_le_2pct": ovh["overhead_pct"] <= planes.BOUND_PCT,
            **roofline_checks(roof)}


def roofline_checks(roof: dict) -> dict:
    """The gate's checks of the roofline halves."""
    return {
        "all_queries_priced": roof["with_time_q"] == roof["queries"],
        "median_time_q_le_4x":
            0.0 < roof["median_time_q"] <= TIME_Q_BOUND,
        "achieved_gflops_nonzero": roof["max_achieved_gflops"] > 0.0,
        "profile_rows_joined": roof["profile"]["rows"] >= 1
                               and bool(roof["profile"]["trace_id"]),
    }


#: the checks that read a time against a bound
TIMING = ("overhead_le_2pct", "median_time_q_le_4x")


def run(tpch_db, slice_db, backend: dict, sf: float = SF,
        repeats: int = REPEATS, metrics=port_metrics) -> dict:
    """The reference's line: the roofline halves on ``tpch_db`` (its
    tables loaded and ANALYZEd at ``sf``), the overhead half on
    ``slice_db`` (fresh; the slice is direct-loaded into it);
    ``backend`` is the package's ``resolve_backend`` of the device."""
    result = {"metric": "profile_bench", "sf": sf, "backend": backend}
    roof = roofline(tpch_db)
    result["roofline"] = {"sf": sf, **roof}
    s = slice_db.session()
    planes.load_numpy(s, ROWS)
    s.close()
    result["overhead"] = {"rows": ROWS, **overhead(slice_db, repeats)}
    result["checks"] = checks(roof, result["overhead"])
    result["ok"] = all(result["checks"].values())
    result["sysstat"] = metrics.sysstat_dict()
    return result


def failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the line ``rec`` breaks, by name: the overhead half's
    answers, then the reference's checks (those in ``TIMING`` only with
    ``timing``)."""
    bad = []
    if not rec.get("overhead", {}).get("rows_equal"):
        bad.append("rows_equal: profiling changed results")
    for name, ok in rec.get("checks", {}).items():
        if not ok and (timing or name not in TIMING):
            bad.append(name)
    return bad
