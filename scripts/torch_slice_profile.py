#!/usr/bin/env python3
"""Where the port's Q6/Q1/Q14 plans spend their time on the GPU.

    python3 scripts/torch_slice_profile.py

Puts the TPC-H SF1 lineitem and part columns on the card, warms each plan
up, then runs it ``RUNS`` times under ``torch.profiler``.
Prints one JSON line per plan: host wall time per run (ending in a
synchronise), device-busy time per run (the sum of its CUDA kernels and
copies), the idle share, and the kernels that took the most device time.
Writes the same records to ``chiprun_out/torch_slice_profile.json``.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TOP = 8
SF = 1.0
RUNS = 3


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_plan(torch, plan, tables, runs):
    from oceanbase_tpu_torch.exec.plan import execute_plan

    return profile_calls(torch, lambda: execute_plan(plan, tables), runs)


def profile_calls(torch, fn, runs):
    """Warm ``fn`` up once, then profile ``runs`` calls of it: host wall
    time per call (ending in a synchronise), device-busy time per call,
    idle share and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # the device's own events (kernels, copies, fills): the aten ops that
    # launched them carry the same device time and would count it twice
    device_evts = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in device_evts)
    top = sorted(device_evts, key=_device_us, reverse=True)[:TOP]
    return {
        "wall_ms_per_run": wall_s * 1e3 / runs,
        "device_busy_ms_per_run": busy_us / 1e3 / runs,
        "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_s),
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_run": _device_us(e) / 1e3 / runs,
                         "calls_per_run": e.count / runs} for e in top],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from oceanbase_tpu_torch.bench.queries import (
        q1_plan, q14_plan, q6_plan, slice_tables,
    )
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    tables, types = gen_tpch(sf=SF)
    n = len(tables["lineitem"]["l_orderkey"])
    dev_tables = slice_tables(tables, types, device="cuda")
    # the card's name and power limit, as nvidia-smi reports them
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    records = []
    for qname, plan in (("q6", q6_plan()), ("q1", q1_plan()),
                        ("q14", q14_plan(n))):
        rec = {"plan": qname, "sf": SF, "lineitem_rows": n, "card": card,
               **profile_plan(torch, plan, dev_tables, RUNS)}
        records.append(rec)
        print(json.dumps(rec))
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_slice_profile.json").write_text(
        json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
