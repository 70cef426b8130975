#!/usr/bin/env python3
"""The workload repository's contracts, on the port.

    python3 scripts/torch_workload_bench.py                 # on the card
    python3 scripts/torch_workload_bench.py --device cpu
    BENCH_ROWS=2000 BENCH_REPEATS=8 BENCH_CLUSTER_ROWS=2000 python3 scripts/torch_workload_bench.py --device cpu
    WORKLOAD_BENCH_SKIP_CLUSTER=1 python3 scripts/torch_workload_bench.py

The port's twin of ``scripts/workload_bench.py``
(``oceanbase_tpu_torch/bench/workload.py``): ``BENCH_ROWS`` rows of the
TPC-H slice (default 100,000) INSERTed into one in-process ``Database``;
the snapshot thread off and on at a 1 s interval over
``max(BENCH_REPEATS, 24)`` interleaved rounds (default 40), compared by
25%-trimmed means; gv$time_model's phases summed against the wall over a
query loop; a snapshot, a restart, its crc-verified load and a delta
report on ``min(BENCH_ROWS, 20,000)`` rows; then, unless
``WORKLOAD_BENCH_SKIP_CLUSTER`` is set, three
``oceanbase_tpu_torch.net.node`` processes on the same device with
``BENCH_CLUSTER_ROWS`` rows of the slice (default 20,000) INSERTed on
node 1, whose merged ``analyze workload report`` must name three nodes
and reconcile ``rpc.bytes{verb=dtl.execute}`` with gv$px_exchange within
1%.  Prints the reference's one JSON line and exits 1 where it would
(overhead over 2%, phases outside 90-110% of the wall, no delta report,
not reconciled) or where the thread changed an answer.  ``--out PATH``
also writes the line there; the reference's ``WORKLOAD_BENCH.json`` is
not touched, and nothing else is written outside a temporary directory.
Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from oceanbase_tpu_torch.bench import cluster, planes, workload
    from oceanbase_tpu_torch.server.database import Database

    rows = int(os.environ.get("BENCH_ROWS", str(workload.ROWS)))
    repeats = int(os.environ.get("BENCH_REPEATS", str(workload.REPEATS)))
    n = int(os.environ.get("BENCH_CLUSTER_ROWS", str(planes.CLUSTER_ROWS)))
    root = tempfile.mkdtemp(prefix="torch_workload_bench_")

    def half():
        return cluster.run_half(lambda c, _load: workload.cluster(c, n),
                                os.path.join(root, "cluster"), args.device,
                                slice_rows=n)

    def open_db(path):
        return Database(path, device=args.device)

    try:
        db = open_db(os.path.join(root, "db"))
        try:
            rec = workload.run(
                db, open_db, os.path.join(root, "restart"), rows, repeats,
                None if os.environ.get("WORKLOAD_BENCH_SKIP_CLUSTER")
                else half)
        finally:
            db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    bad = workload.failures(rec)
    if bad:
        print(f"torch_workload_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["ok"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
