#!/usr/bin/env python3
"""A short check of the port's measurement plane on the GPU.

    python3 scripts/torch_measure_probe.py          # TPC-H SF0.1
    OB_PROBE_SF=1 python3 scripts/torch_measure_probe.py

Three parts, each printing JSON lines:

1. ``server/calibrate.py``'s probe suite, "boot" and "full" presets: the
   machine constants and each probe's device time (CUDA graphs replayed
   between CUDA events);
2. a ``Database`` on the card with the TPC-H tables direct-loaded:
   PROFILE of Q1 and Q18 with the kernel time from gv$device_profile
   beside the statement's ``device_s`` (the CUDA event pair of
   ``exec/plan.py``) and wall time;
3. the synchronizing calls (``torch.cuda.set_sync_debug_mode("warn")``)
   of one ``execute_plan`` of the hand-built Q1, Q6 and Q14 with the
   plane on (monitor lanes, a trace, metrics, the time split) and off.

Needs a CUDA device; imports nothing of JAX.  ``chip_smoke.py`` phase
"measure" makes the same checks at SF1 with their bounds.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_measure_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench import queries as bq
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.exec import plan as qplan
    from oceanbase_tpu_torch.server import calibrate as qcal
    from oceanbase_tpu_torch.server import metrics as qmetrics
    from oceanbase_tpu_torch.server import trace as qtrace
    from oceanbase_tpu_torch.server.database import Database

    dev = torch.device("cuda", 0)
    card = card_line()
    for preset in ("boot", "full"):
        t0 = time.perf_counter()
        u = qcal.run_probe(preset, dev)
        print(json.dumps({
            "preset": preset, "seconds": time.perf_counter() - t0,
            "peak_bytes_s": u.peak_bytes_s,
            "peak_bytes_share_of_3.35TB/s": u.peak_bytes_s / 3.35e12,
            "eff_bytes_s": u.eff_bytes_s, "peak_flops_s": u.peak_flops_s,
            "launch_overhead_s": u.launch_overhead_s,
            "measurements": u.measurements, "card": card}))

    sf = float(os.environ.get("OB_PROBE_SF", "0.1"))
    tables, types = gen_tpch(sf=sf)
    root = tempfile.mkdtemp(prefix="ob_measure_probe_")
    db = Database(root, device=dev)
    try:
        for name, arrays in tables.items():
            db.catalog.load_numpy(
                name, arrays, primary_key=TPCH_PRIMARY_KEYS[name],
                types={k: v for k, v in types.items() if k in arrays})
        s = db.session()
        for q in (1, 18):
            s.execute(QUERIES[q])
            s.execute("profile " + QUERIES[q])
            prof = db.device_profiles.get(s._last_profile_trace_id)
            rec = db.audit.recent(1)[-1]
            kernels = [r for r in prof.rows if r["kind"] == "kernel"]
            print(json.dumps({
                "query": q, "sf": sf, "kernel_rows": len(kernels),
                "kernel_s": sum(r["total_s"] for r in kernels),
                "device_s": rec.device_s, "host_s": rec.host_s,
                "wall_s": rec.elapsed_s, "note": prof.note,
                "card": card}))
        s.close()
    finally:
        db.close()
        shutil.rmtree(root, ignore_errors=True)

    st = bq.slice_tables(tables, types, device=dev)
    n = len(tables["lineitem"]["l_orderkey"])
    for name, plan in (("q1", bq.q1_plan()), ("q6", bq.q6_plan()),
                       ("q14", bq.q14_plan(n))):
        qplan.execute_plan(plan, st)
        qplan.execute_plan(plan, st, monitor_out=[])
        qplan.resolve_pending(block=True)

        def on(plan=plan):
            ctx = qtrace.TraceCtx("probe")
            with qtrace.activate(ctx), qtrace.span("statement"):
                qplan.execute_plan(plan, st, monitor_out=[])

        def off(plan=plan):
            qplan.execute_plan(plan, st)

        n_on = chip_smoke._sync_calls(torch, on)
        qplan.resolve_pending(block=True)
        qplan.set_time_split(False)
        qmetrics.set_enabled(False)
        try:
            n_off = chip_smoke._sync_calls(torch, off)
        finally:
            qplan.set_time_split(True)
            qmetrics.set_enabled(True)
        print(json.dumps({"plan": name, "sf": sf, "sync_calls_on": n_on,
                          "sync_calls_off": n_off, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
