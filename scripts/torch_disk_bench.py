#!/usr/bin/env python3
"""The disk plane's standing contract, on the port.

    python3 scripts/torch_disk_bench.py                     # on the card
    python3 scripts/torch_disk_bench.py --device cpu
    BENCH_ROWS=2000 python3 scripts/torch_disk_bench.py --device cpu

The port's twin of ``scripts/disk_bench.py`` over ``BENCH_ROWS`` rows
(default 4,000; ``oceanbase_tpu_torch/bench/disk.py``): the budgets'
overhead on a write workload (24 off/on block pairs, medians, <= 2%),
one seeded ENOSPC on each of wal, slog, segment, manifest, spill and
backup (typed ``DiskFull``, the retry succeeds), an unreachable log
budget (read-only, reads served, auto-exit), gv$disk against ``du``
within 5%, and a restart with equal ``count(*), sum(v)``.  Prints the
reference's one JSON line and exits 1 where it would (the gate is
``pass``, the 2% included).  Writes no file outside its temporary
directory.  Runs on the card unless ``--device cpu``; imports nothing of
JAX.
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
    from oceanbase_tpu_torch.bench import disk
    from oceanbase_tpu_torch.server.database import Database

    rows = int(os.environ.get("BENCH_ROWS", "4000"))
    tmp = tempfile.mkdtemp(prefix="torch_disk_bench_")
    try:
        rec = disk.run(lambda path: Database(path, device=args.device),
                       tmp, rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(rec))
    bad = disk.failures(rec)
    if bad:
        print(f"torch_disk_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["pass"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
