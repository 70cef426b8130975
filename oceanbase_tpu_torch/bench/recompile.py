"""First executions per query over a growing table, shape buckets on
and off.

Port of ``scripts/recompile_bench.py`` (its constants, record fields and
gate, each cited by line): the OLTP-interleaved loop (INSERT a batch,
then the same group-by SELECT) runs ``steps`` times on two fresh
databases, one with ``enable_shape_buckets`` off and one with it on,
and the record keeps the reference's names.  In the reference
``compiles_*`` count XLA traces; in the port they count first
executions per (plan fingerprint, capacity signature), the
``xla_traces`` of ``exec/plan.py``'s plan-cache entries, which
``gv$plan_cache`` serves as ``xla_trace_count``.  Without buckets every
INSERT that changes the table's cardinality gives a new signature;
with them the signature moves only at a bucket boundary.

The loop runs over any package's ``Database``: the caller passes a
function that opens one at a root and that package's ``exec.plan`` and
metrics modules (the port's by default, on ``device``).
"""

from __future__ import annotations

import os
import time

from oceanbase_tpu_torch.exec import plan as port_plan
from oceanbase_tpu_torch.server import metrics as port_metrics

#: the loop's SELECT (``recompile_bench.py:36-37``)
QUERY = ("select grp, sum(v), count(*), avg(v) from t"
         " group by grp order by grp")
STEPS = 100                     # ``recompile_bench.py:83``
ROWS_PER_STEP = 50              # ``recompile_bench.py:84``
GATE_STEPS = 100                # the 10x gate's loop (:117-121)
GATE_RATIO = 10


def run_loop(root: str, steps: int, rows_per_step: int, buckets: bool,
             device: str = "cuda", open_db=None, plan=port_plan) -> dict:
    """One loop on a fresh Database at ``root`` (``recompile_bench.py:
    40-80``) -> first executions and executions from the plan-cache
    counters, taken before gv$plan_cache's own query runs, the same sums
    from gv$plan_cache, the loop's results and seconds."""
    if open_db is None:
        from oceanbase_tpu_torch.server.database import Database

        def open_db(path):
            return Database(path, device=device)

    plan.reset_plan_cache_stats()
    db = open_db(root)
    try:
        s = db.session()
        s.execute(f"alter system set enable_shape_buckets = "
                  f"{'true' if buckets else 'false'}")
        s.execute("create table t (id int primary key, v int, grp int)")
        results = []
        t0 = time.monotonic()
        next_id = 0
        for _step in range(steps):
            vals = ", ".join(
                f"({next_id + i}, {(next_id + i) * 7 % 101}, "
                f"{(next_id + i) % 5})" for i in range(rows_per_step))
            next_id += rows_per_step
            s.execute(f"insert into t values {vals}")
            results.append(s.execute(QUERY).rows())
        elapsed = time.monotonic() - t0
        stats = plan.plan_cache_stats()
        traces = sum(e.xla_traces for e in stats)
        execs = sum(e.executions for e in stats)
        vt = s.execute("select plan_text, executions, hit_count,"
                       " xla_trace_count from gv$plan_cache"
                       " order by executions desc").rows()
    finally:
        db.close()
    return {"traces": traces, "executions": execs,
            "vt_traces": sum(int(x[3]) for x in vt),
            "vt_executions": sum(int(x[1]) for x in vt),
            "results": results, "elapsed_s": elapsed}


def run(root: str, steps: int = STEPS, rows_per_step: int = ROWS_PER_STEP,
        device: str = "cuda", open_db=None, plan=port_plan,
        metrics=port_metrics) -> dict:
    """Both loops (exact first, as the reference runs them) -> the
    reference's record (``recompile_bench.py:99-113``) with each loop's
    gv$plan_cache sums beside its counters."""
    ex = run_loop(os.path.join(root, "exact"), steps, rows_per_step,
                  False, device, open_db, plan)
    bk = run_loop(os.path.join(root, "bucketed"), steps, rows_per_step,
                  True, device, open_db, plan)
    return {
        "metric": "recompile_amortization",
        "steps": steps,
        "rows_per_step": rows_per_step,
        "final_rows": steps * rows_per_step,
        "compiles_exact": ex["traces"],
        "compiles_bucketed": bk["traces"],
        "compile_ratio": round(ex["traces"] / max(bk["traces"], 1), 2),
        "executions_exact": ex["executions"],
        "executions_bucketed": bk["executions"],
        "loop_s_exact": round(ex["elapsed_s"], 3),
        "loop_s_bucketed": round(bk["elapsed_s"], 3),
        "results_match": ex["results"] == bk["results"],
        "plan_cache_exact": [ex["vt_traces"], ex["vt_executions"]],
        "plan_cache_bucketed": [bk["vt_traces"], bk["vt_executions"]],
        "sysstat": metrics.sysstat_dict(),
    }


def failures(rec: dict) -> list[str]:
    """Each invariant ``rec`` breaks, by name: the results equal both
    ways, gv$plan_cache equal to the counters, and at 100 steps or more
    at least 10x fewer first executions with buckets
    (``recompile_bench.py:114-121``)."""
    bad = []
    if not rec.get("results_match"):
        bad.append("results_match")
    for mode in ("exact", "bucketed"):
        want = [rec.get(f"compiles_{mode}"), rec.get(f"executions_{mode}")]
        if rec.get(f"plan_cache_{mode}") != want:
            bad.append(f"gv$plan_cache {mode} {rec.get(f'plan_cache_{mode}')}"
                       f" against {want}")
    if rec.get("steps", 0) >= GATE_STEPS and \
            rec.get("compiles_exact", 0) < GATE_RATIO * rec.get(
                "compiles_bucketed", 0):
        bad.append(f"compile amortization below {GATE_RATIO}x: "
                   f"{rec.get('compiles_exact')} exact against "
                   f"{rec.get('compiles_bucketed')} bucketed")
    return bad
