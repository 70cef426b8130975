#!/usr/bin/env python3
"""The plan-quality plane's contracts, on the port.

    python3 scripts/torch_planqual_bench.py                 # on the card
    python3 scripts/torch_planqual_bench.py --device cpu
    PLANQUAL_SF=0.01 PLANQUAL_REPEATS=16 python3 scripts/torch_planqual_bench.py --device cpu
    PLANQUAL_SKIP_CLUSTER=1 python3 scripts/torch_planqual_bench.py

The port's twin of ``scripts/planqual_bench.py``
(``oceanbase_tpu_torch/bench/planqual.py``): TPC-H at ``PLANQUAL_SF``
(default 0.1) direct-loaded into one in-process ``Database``, ANALYZEd
and given the ``*key`` indexes, each of the 22 queries' operators held
to an estimate, and gv$plan_choice's counts and ranking; the plan
monitor and feedback off and on over 20,000 rows of the slice in
interleaved samples (``PLANQUAL_REPEATS``, default 96); the seeded 100 x
100 duplicate-key join with feedback on and off; then, unless
``PLANQUAL_SKIP_CLUSTER`` is set, DTL slice skew on three
``oceanbase_tpu_torch.net.node`` processes on the same device (3,000
rows per table: a skewed ``slice_skew`` >= 3.0, a uniform one < 1.5).
Prints the reference's one JSON line and exits 1 where it would (any of
its checks false) or where an answer differs.  ``--out PATH`` also
writes the line there; nothing else is written outside a temporary
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
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from oceanbase_tpu_torch.bench import cluster, planes, planqual
    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
    from oceanbase_tpu_torch.server.database import Database

    sf = float(os.environ.get("PLANQUAL_SF", str(planqual.SF)))
    repeats = int(os.environ.get("PLANQUAL_REPEATS", str(planqual.REPEATS)))
    tables, types = gen_tpch(sf=sf)
    root = tempfile.mkdtemp(prefix="torch_planqual_bench_")

    def half():
        return cluster.run_half(lambda c, _load: planqual.skew(c),
                                os.path.join(root, "cluster"), args.device)

    def open_db(path):
        return Database(path, device=args.device)

    try:
        tpch = open_db(os.path.join(root, "tpch"))
        slice_db = open_db(os.path.join(root, "slice"))
        try:
            s = tpch.session()
            planes.load_tpch(s, tables, types, TPCH_PRIMARY_KEYS)
            for ix, name, c in planqual.key_indexes(tables):
                s.execute(f"create index {ix} on {name} ({c})")
            s.close()
            rec = planqual.run(tpch, slice_db, open_db,
                               os.path.join(root, "feedback"), sf,
                               repeats=repeats, cluster_half=None if
                               os.environ.get("PLANQUAL_SKIP_CLUSTER")
                               else half)
        finally:
            slice_db.close()
            tpch.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    bad = planqual.failures(rec)
    if bad:
        print(f"torch_planqual_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["ok"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
