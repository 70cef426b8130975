#!/usr/bin/env python3
"""Phase "cluster" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_cluster_phase.py            # SF1's first 200,000
    python3 scripts/torch_cluster_phase.py --sql-ab   # + the load's cost
    OB_SMOKE_SF=0.1 python3 scripts/torch_cluster_phase.py

Spawns three ``python -m oceanbase_tpu_torch.net.node --device cuda``
processes (a 3-replica PALF log stream, lease 1500 ms), loads the first
200,000 rows of TPC-H lineitem (``gen_tpch(sf=1)``, all 16 columns) on
node 1 in 2,000-row INSERTs from a loader process, and runs steps a-g
of phase cluster: boot, load and convergence, Q6 and Q1 pushed down
over DTL against numpy, the seeded drop, a dead follower, a dead leader,
restarts, a wiped node's rebuild, a scrub repair, merged gv$sysstat and
remote trace spans.  Prints the phase's lines, each step's seconds and
the card's name and power limit.

With ``--sql-ab`` it first times phase sql's 22 TPC-H queries on a
catalog-only session (one pass, after a warm pass) alone, then again
while the nodes boot and the loader loads beside them: what overlapping
the cluster's boot and load costs the host-bound phases of a whole run.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _sql_pass(torch, sess, queries) -> float:
    t0 = time.perf_counter()
    for q in sorted(queries):
        sess.execute(queries[q]).rows()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sql-ab", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_cluster_phase: no CUDA device", file=sys.stderr)
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
    if args.sql_ab:
        from oceanbase_tpu_torch.bench.harness import tpch_session
        from oceanbase_tpu_torch.bench.tpch_queries import QUERIES

        sess, load_s, analyze_s = tpch_session(
            tables, types, device=torch.device("cuda", 0))
        print(f"[sql-ab] catalog session: load {load_s:.3f} s, ANALYZE "
              f"{analyze_s:.3f} s")
        _sql_pass(torch, sess, QUERIES)  # warm
        alone = _sql_pass(torch, sess, QUERIES)
    t0 = time.perf_counter()
    cluster = chip_smoke.start_cluster()
    loader = chip_smoke.start_cluster_loader(str(REPO), cluster, rows,
                                             ctypes)
    try:
        if args.sql_ab:
            beside = _sql_pass(torch, sess, QUERIES)
            print(f"[sql-ab] the 22 TPC-H queries, one pass: {alone:.3f} s "
                  f"alone, {beside:.3f} s while the 3 nodes boot and the "
                  f"loader loads ({beside / alone:.3f}x; loader still "
                  f"running at the end: {loader[0].is_alive()}); {card}")
            del sess
            torch.cuda.empty_cache()
        chip_smoke.phase_cluster(torch, cluster, loader, rows, ctypes, card)
    finally:
        cluster.close()
    print(f"[time] phase cluster with its boot and load: "
          f"{time.perf_counter() - t0:.3f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
