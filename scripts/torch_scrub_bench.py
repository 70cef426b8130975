#!/usr/bin/env python3
"""The data-integrity plane's standing contract, on the port.

    python3 scripts/torch_scrub_bench.py                 # on the card
    python3 scripts/torch_scrub_bench.py --device cpu
    BENCH_ROWS=2000 BENCH_REPEATS=8 python3 scripts/torch_scrub_bench.py --device cpu

The port's twin of ``scripts/scrub_bench.py``
(``oceanbase_tpu_torch/bench/scrub.py``): three
``oceanbase_tpu_torch.net.node`` processes on the device, ``BENCH_ROWS``
rows of the TPC-H slice (default 20,000) INSERTed on node 1 and
checkpointed on every node; q6 and q1 on node 1 in 8 alternating blocks
of ``BENCH_REPEATS / 8`` passes (default 32) with the scrubber off and
on at a 2 s cadence; then a seeded bit flip in node 3's ``lineitem``
segment, one ``scrub.run`` that must detect, quarantine and repair it
from a peer, and node 3's answers held to SQLite.  Prints the
reference's one JSON line and exits 1 where it would (overhead over 2%,
the flip missed or not repaired, an answer off SQLite) or where a
mended file fails its checksums.  ``--out PATH`` also writes the line
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
    from oceanbase_tpu_torch.bench import cluster, scrub

    rows = int(os.environ.get("BENCH_ROWS", str(scrub.ROWS)))
    repeats = int(os.environ.get("BENCH_REPEATS", str(scrub.REPEATS)))
    root = tempfile.mkdtemp(prefix="torch_scrub_bench_")
    try:
        rec = cluster.run_half(
            lambda c, load: scrub.run(c, rows, repeats, load["load_s"]),
            os.path.join(root, "cluster"), args.device, slice_rows=rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    bad = scrub.failures(rec)
    if bad:
        print(f"torch_scrub_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["pass"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
