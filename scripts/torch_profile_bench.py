#!/usr/bin/env python3
"""The profiling plane's contracts, on the port.

    python3 scripts/torch_profile_bench.py                 # on the card
    python3 scripts/torch_profile_bench.py --device cpu
    PROFILE_SF=0.01 PROFILE_REPEATS=24 python3 scripts/torch_profile_bench.py --device cpu

The port's twin of ``scripts/profile_bench.py``
(``oceanbase_tpu_torch/bench/profile.py``): TPC-H at ``PROFILE_SF``
(default 0.1) direct-loaded into one in-process ``Database`` and
ANALYZEd, one ``ALTER SYSTEM CALIBRATE``, each of the 22 queries run
twice with its second execution's time q-error read from the plan
monitor, gv$plan_cache's largest ``achieved_gflops``, and a PROFILE of
Q6 joined to gv$device_profile by trace_id; then the host/device split
off and on over 20,000 rows of the slice in interleaved samples
(``PROFILE_REPEATS``, default 96).  Prints the reference's one JSON line
and exits 1 where it would (any of its checks false) or where the split
changed an answer.  On the CPU ``device_s`` is 0, so no query is priced
and the rate checks fail there by definition.  ``--out PATH`` also
writes the line there; the reference's ``PROFILE_BENCH.json`` is not
touched, and nothing else is written outside a temporary directory.
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
    import torch

    from oceanbase_tpu_torch.bench import planes, profile
    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
    from oceanbase_tpu_torch.server.backend_info import resolve_backend
    from oceanbase_tpu_torch.server.database import Database

    sf = float(os.environ.get("PROFILE_SF", str(profile.SF)))
    repeats = int(os.environ.get("PROFILE_REPEATS", str(profile.REPEATS)))
    tables, types = gen_tpch(sf=sf)
    root = tempfile.mkdtemp(prefix="torch_profile_bench_")
    try:
        tpch = Database(os.path.join(root, "tpch"), device=args.device)
        slice_db = Database(os.path.join(root, "slice"), device=args.device)
        try:
            s = tpch.session()
            planes.load_tpch(s, tables, types, TPCH_PRIMARY_KEYS)
            s.close()
            rec = profile.run(tpch, slice_db,
                              resolve_backend(torch.device(args.device)),
                              sf, repeats)
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
    bad = profile.failures(rec)
    if bad:
        print(f"torch_profile_bench: {', '.join(bad)}", file=sys.stderr)
    return 0 if rec["ok"] and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
