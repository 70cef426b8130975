#!/usr/bin/env python3
"""First executions per query over a growing table, buckets on and off,
on the port.

    python3 scripts/torch_recompile_bench.py                # on the card
    python3 scripts/torch_recompile_bench.py --device cpu
    BENCH_STEPS=30 BENCH_ROWS_PER_STEP=20 python3 scripts/torch_recompile_bench.py --device cpu

The port's twin of ``scripts/recompile_bench.py``
(``oceanbase_tpu_torch/bench/recompile.py``): ``BENCH_STEPS`` (default
100) rounds of an INSERT of ``BENCH_ROWS_PER_STEP`` rows (default 50)
and the same group-by SELECT, on a fresh ``Database`` with
``enable_shape_buckets`` off and on one with it on.  ``compiles_*``
count first executions per (plan fingerprint, capacity signature).
Prints the reference's one JSON line and exits 1 where it would: the
results differ, or at 100 steps or more the buckets save less than 10x;
also where gv$plan_cache disagrees with the counters.  Writes no file
outside its temporary directory.  Runs on the card unless ``--device
cpu``; imports nothing of JAX.
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
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from oceanbase_tpu_torch.bench import recompile

    steps = int(os.environ.get("BENCH_STEPS", str(recompile.STEPS)))
    per_step = int(os.environ.get("BENCH_ROWS_PER_STEP",
                                  str(recompile.ROWS_PER_STEP)))
    root = tempfile.mkdtemp(prefix="torch_recompile_bench_")
    try:
        rec = recompile.run(root, steps, per_step, device=args.device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(rec))
    bad = recompile.failures(rec)
    if bad:
        print(f"torch_recompile_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
