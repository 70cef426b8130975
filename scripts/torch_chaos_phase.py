#!/usr/bin/env python3
"""Phases "cluster" and "chaos" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_chaos_phase.py            # SF1's first 200,000
    OB_SMOKE_SF=0.1 python3 scripts/torch_chaos_phase.py

Spawns the three ``python -m oceanbase_tpu_torch.net.node --device cuda``
processes of phase cluster, loads its lineitem rows from a loader
process, runs phase cluster's steps a-g and then, on the same nodes and
rows, phase chaos: ``bench/chaos.py``'s five nemesis scenarios (a
partitioned leader, a follower killed and restarted with durable XA,
segment, WAL-entry and manifest rot, an admission storm under a node
kill, a full log disk with a leader takeover and an ENOSPC-failed
append), each record held to the reference's invariants.  Prints the
phases' lines, each step's seconds, each phase's seconds and the card's
name and power limit.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_chaos_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    card = card_line()
    sf = float(os.environ.get("OB_SMOKE_SF", "1"))
    t0 = time.perf_counter()
    tables, types = gen_tpch(sf=sf)
    rows, ctypes = chip_smoke.cluster_slice(tables, types)
    print(f"[setup] gen_tpch sf={sf} {time.perf_counter() - t0:.3f} s; "
          f"the cluster's slice {len(rows['l_orderkey'])} rows")
    t0 = time.perf_counter()
    cluster = chip_smoke.start_cluster()
    loader = chip_smoke.start_cluster_loader(str(REPO), cluster, rows,
                                             ctypes)
    try:
        workload = chip_smoke.phase_cluster(torch, cluster, loader, rows,
                                            ctypes, card)
        print(f"[time] phase cluster with its boot and load: "
              f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        chip_smoke.phase_chaos(torch, cluster, workload, card)
        print(f"[time] phase chaos: {time.perf_counter() - t0:.3f} s")
    finally:
        cluster.close()
        for i in (1, 2, 3):  # each boot's split, one line per start
            print(f"[chaos] node {i} log:\n{cluster.log_tail(i, 4000)}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
