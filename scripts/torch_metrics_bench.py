#!/usr/bin/env python3
"""The metrics plane's standing contract, on the port.

    python3 scripts/torch_metrics_bench.py                 # on the card
    python3 scripts/torch_metrics_bench.py --device cpu
    BENCH_ROWS=2000 BENCH_REPEATS=8 BENCH_CLUSTER_ROWS=2000 python3 scripts/torch_metrics_bench.py --device cpu
    METRICS_BENCH_SKIP_CLUSTER=1 python3 scripts/torch_metrics_bench.py

The port's twin of ``scripts/metrics_bench.py``
(``oceanbase_tpu_torch/bench/metrics.py``).  Overhead: ``BENCH_ROWS``
rows of the TPC-H slice (default 100,000) INSERTed into one in-process
``Database``, then q6 and q1 in 4 alternating blocks of ``BENCH_REPEATS /
4`` passes (default 40) with ``enable_metrics`` off and on.  Scrape,
unless ``METRICS_BENCH_SKIP_CLUSTER`` is set: three
``oceanbase_tpu_torch.net.node`` processes on the same device,
``BENCH_CLUSTER_ROWS`` rows of the slice (default 20,000) INSERTed on
node 1, three pushed-down q6 runs, and every node's ``metrics.scrape``
merged, whose ``rpc.bytes{verb=dtl.execute}`` must lie within 1% of
gv$px_exchange's pushdown bytes.  Prints the reference's one JSON line
and exits 1 where it would (``overhead_pct > 2``, not reconciled) or
where metrics changed an answer.  ``--out PATH`` also writes the line
there; nothing else is written outside a temporary directory.  Runs on
the card unless ``--device cpu``; imports nothing of JAX.
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
    from oceanbase_tpu_torch.bench import cluster, metrics, planes
    from oceanbase_tpu_torch.server.database import Database

    rows = int(os.environ.get("BENCH_ROWS", str(metrics.ROWS)))
    repeats = int(os.environ.get("BENCH_REPEATS", str(metrics.REPEATS)))
    n = int(os.environ.get("BENCH_CLUSTER_ROWS", str(planes.CLUSTER_ROWS)))
    root = tempfile.mkdtemp(prefix="torch_metrics_bench_")

    def half():
        return cluster.run_half(lambda c, _load: metrics.scrape(c, n),
                                os.path.join(root, "cluster"), args.device,
                                slice_rows=n)

    try:
        db = Database(os.path.join(root, "db"), device=args.device)
        try:
            rec = metrics.run(db, rows, repeats, cluster_half=None if
                              os.environ.get("METRICS_BENCH_SKIP_CLUSTER")
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
    bad = metrics.failures(rec["overhead"])
    if "scrape" in rec:
        bad += metrics.scrape_failures(rec["scrape"])
    if bad:
        print(f"torch_metrics_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["ok"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
