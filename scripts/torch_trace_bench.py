#!/usr/bin/env python3
"""The trace plane's standing contract, on the port.

    python3 scripts/torch_trace_bench.py                 # on the card
    python3 scripts/torch_trace_bench.py --device cpu
    BENCH_ROWS=2000 BENCH_REPEATS=8 BENCH_CLUSTER_ROWS=2000 python3 scripts/torch_trace_bench.py --device cpu
    TRACE_BENCH_SKIP_CLUSTER=1 python3 scripts/torch_trace_bench.py

The port's twin of ``scripts/trace_bench.py``
(``oceanbase_tpu_torch/bench/trace.py``).  Overhead: ``BENCH_ROWS`` rows
of the TPC-H slice (default 100,000) INSERTed into one in-process
``Database``, then q6 and q1 in 4 alternating blocks of ``BENCH_REPEATS /
4`` passes (default 40) with full-link tracing off and on at
``trace_sample_rate = 1.0``.  Attribution, unless
``TRACE_BENCH_SKIP_CLUSTER`` is set: three ``oceanbase_tpu_torch.net.node``
processes on the same device, ``BENCH_CLUSTER_ROWS`` rows of the slice
(default 20,000) INSERTed on node 1, and a 400 ms delay on its
``dtl.execute`` toward node 2, which must be the slowest span of the q6
statement's trace.  Prints the reference's one JSON line and exits 1
where it would (``overhead_pct > 2``, attribution missed) or where the
tracing or the delay changed an answer.  ``--out PATH`` also writes the
line there; nothing else is written outside a temporary directory.  Runs
on the card unless ``--device cpu``; imports nothing of JAX.
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
    from oceanbase_tpu_torch.bench import cluster, planes, trace
    from oceanbase_tpu_torch.server.database import Database

    rows = int(os.environ.get("BENCH_ROWS", str(trace.ROWS)))
    repeats = int(os.environ.get("BENCH_REPEATS", str(trace.REPEATS)))
    n = int(os.environ.get("BENCH_CLUSTER_ROWS", str(planes.CLUSTER_ROWS)))
    root = tempfile.mkdtemp(prefix="torch_trace_bench_")

    def half():
        return cluster.run_half(lambda c, _load: trace.attribution(c, n),
                                os.path.join(root, "cluster"), args.device,
                                slice_rows=n)

    try:
        db = Database(os.path.join(root, "db"), device=args.device)
        try:
            rec = trace.run(db, rows, repeats, None if os.environ.get(
                "TRACE_BENCH_SKIP_CLUSTER") else half)
        finally:
            db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    bad = trace.failures(rec["overhead"])
    if "attribution" in rec:
        bad += trace.attribution_failures(rec["attribution"])
    if bad:
        print(f"torch_trace_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["ok"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
