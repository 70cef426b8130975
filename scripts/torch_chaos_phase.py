#!/usr/bin/env python3
"""Phases "cluster" and "chaos" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_chaos_phase.py            # SF1's first 200,000
    OB_SMOKE_SF=0.1 python3 scripts/torch_chaos_phase.py
    python3 scripts/torch_chaos_phase.py --want answers.pickle

Spawns the three ``python -m oceanbase_tpu_torch.net.node --device cuda``
processes of phase cluster, loads its lineitem rows from a loader
process, runs phase cluster's steps a-g and then, on the same nodes and
rows, phase chaos: ``bench/chaos.py``'s five nemesis scenarios (a
partitioned leader, a follower killed and restarted with durable XA,
segment, WAL-entry and manifest rot, an admission storm under a node
kill, a full log disk with a leader takeover and an ENOSPC-failed
append), each record held to the reference's invariants.  With
``--want PATH`` (a pickle of ``chip_smoke.oracle_results``, the SQLite
answers) it is the whole run's side process: phase db (a ``Database`` of
its own at TPC-H scale, checked against those answers) runs while the
loader loads the nodes, phase planes after phase chaos while three fresh
nodes boot, and phase planes-cluster on those nodes last.  Prints the
phases' lines, each step's seconds, each phase's seconds and the
kernels' launch counts in this process (set to 0 just before each phase
and read just after; the nodes run the SQL path, which reaches no
hand-written kernel), and the card's name and power limit, and exits
nonzero at any launch.  ``chip_smoke.py``
runs it with ``--want`` beside its card phases; a SIGTERM closes the
nodes on the way out.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import pickle
import signal
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_chaos_phase: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--want", help="the SQLite answers (a pickle): also "
                    "run phases db and planes")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.bench.tpch import gen_tpch
    from oceanbase_tpu_torch.ops import _build

    # a SIGTERM unwinds through the finally below (and the atexit that
    # removes the nodes' directory) instead of orphaning the nodes
    signal.signal(signal.SIGTERM, lambda *_a: sys.exit(143))
    card = card_line()
    sf = float(os.environ.get("OB_SMOKE_SF", "1"))
    t0 = time.perf_counter()
    cluster = chip_smoke.start_cluster()  # the nodes boot meanwhile
    tables, types = gen_tpch(sf=sf)
    rows, ctypes = chip_smoke.cluster_slice(tables, types)
    print(f"[setup] gen_tpch sf={sf} {time.perf_counter() - t0:.3f} s; "
          f"the cluster's slice {len(rows['l_orderkey'])} rows")
    loader = chip_smoke.start_cluster_loader(str(REPO), cluster, rows,
                                             ctypes)
    dev = torch.device("cuda", 0)
    launched = {}

    def phase(name, fn, *a):
        """One phase with the launch counts set to 0 just before it and
        read just after -> its result."""
        _build.reset_launch_counts()
        t1 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        counts = launched[name] = _build.launch_counts()
        print(f"[time] phase {name}: {time.perf_counter() - t1:.3f} s; "
              f"kernel launches {counts}", flush=True)
        return out

    try:
        if args.want:
            with open(args.want, "rb") as fh:
                want = pickle.load(fh)
            phase("db (beside the loader)", chip_smoke.phase_db, torch, dev,
                  tables, types, card, want)
            torch.cuda.empty_cache()
        del tables
        workload = phase("cluster", chip_smoke.phase_cluster, torch,
                         cluster, loader, rows, ctypes, card)
        print(f"[time] the nodes' spawn to phase cluster's end: "
              f"{time.perf_counter() - t0:.3f} s")
        phase("chaos", chip_smoke.phase_chaos, torch, cluster, workload,
              card)
        if args.want:
            planes_cluster = chip_smoke.start_planes_cluster()
            phase("planes", chip_smoke.phase_planes, torch, dev, card)
            phase("planes-cluster", chip_smoke.phase_planes_cluster, torch,
                  planes_cluster, card)
    finally:
        cluster.close()
        for i in (1, 2, 3):  # each boot's split, one line per start
            print(f"[chaos] node {i} log:\n{cluster.log_tail(i, 4000)}")
    print(f"[time] the side process's phases: "
          f"{time.perf_counter() - t0:.3f} s")
    print(card, flush=True)
    return 1 if any(any(c.values()) for c in launched.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
