#!/usr/bin/env python3
"""The serving plane under 4x offered load, on the port.

    python3 scripts/torch_overload_bench.py                 # on the card
    python3 scripts/torch_overload_bench.py --device cpu
    BENCH_ROWS=2000 BENCH_WINDOW_S=2 python3 scripts/torch_overload_bench.py --device cpu

The port's twin of ``scripts/overload_bench.py``: one in-process
``Database`` with two tenants, a storm of 8 + 2 closed-loop clients over
2 admission slots for ``BENCH_WINDOW_S`` seconds (default 8), a KILL of
a spilled scan, and a write flood of 4 writers against a 200,000-byte
memstore budget (``oceanbase_tpu_torch/bench/overload.py``), over
``BENCH_ROWS`` rows per tenant (default 20,000, as the reference),
each tenant's table in 40 segments, so the KILLed scan streams 40
granules.  Prints the reference's one JSON line and exits 1 where it
would (the gate is ``ok``) or where ``overload.failures`` names a broken
invariant: an admitted answer off numpy, a rerun off numpy, or a KILL
that lands only at the scan's last checkpoint.  Writes no file outside its temporary directory.  Runs on the card unless
``--device cpu``; imports nothing of JAX.
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
    from oceanbase_tpu_torch.bench import overload
    from oceanbase_tpu_torch.server.database import Database

    rows = int(os.environ.get("BENCH_ROWS", "20000"))  # overload_bench.py:82
    window_s = float(os.environ.get("BENCH_WINDOW_S", "8"))
    root = tempfile.mkdtemp(prefix="torch_overload_bench_")
    try:
        db = Database(os.path.join(root, "db"), device=args.device)
        try:
            rec = overload.run(db, rows, window_s,
                               overload.kill_work_area(rows))
        finally:
            db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(rec))
    bad = overload.failures(rec)
    if bad:
        print(f"torch_overload_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["ok"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
