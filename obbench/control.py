"""The control of a configuration's correctness check, at its own size.

    python3 obbench/control.py --config tpch_sf1 --seeds 1,2,3
    python3 obbench/control.py --config bigann10m --seeds 1,2,3 \\
        --queries 300

The control is the plain reference put in the program's place and
computed in the precision below the one the configuration states: TPC-H
with every decimal a float32 instead of an exact scaled int64, the
vector search with its distances in bfloat16 instead of float32.  Its
answers are judged as a run judges the program's, and each seed prints
one JSON line of the numbers the check compares.  A limit lies between
the largest reading of sound runs and the smallest of the control.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402

from obbench import harness  # noqa: E402


def tpch_control(cfg: dict, seed: int) -> dict:
    from obbench.datasets import tpch
    from obbench.reference.tpch import Ref

    data = tpch.make(cfg, seed, "cpu")
    control = Ref(data["tables"], money=np.float32)
    samples = []
    for q in range(1, 23):
        e = control.run(q)
        samples.append((q, e.rows[: e.limit or len(e.rows)]))
    out = tpch.judge(cfg, data, samples, "cpu")
    # Q1 alone, the whole of the tpch_sf1.q1 cell's traffic
    out["q1"] = tpch.judge(cfg, data, samples[:1], "cpu")
    return out


def knn_control(cfg: dict, seed: int, n_queries: int, device) -> dict:
    from obbench.datasets import vectors
    from obbench.reference import vectors as vref

    data = vectors.make(cfg, seed, device)
    keys = np.random.default_rng(seed).permutation(
        len(data["queries"]))[:n_queries].tolist()
    rows = vref.control_rows(data["base"], data["queries"], int(cfg["k"]),
                             keys, device)
    return vectors.judge(cfg, data, list(zip(keys, rows)), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=300)
    args = ap.parse_args(argv)
    import torch

    cfg = harness.load_config(args.config)
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in (int(s) & harness.SEED_MASK
                 for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cfg["dataset"] == "tpch":
            numbers = tpch_control(cfg, seed)
        else:
            numbers = knn_control(cfg, seed, args.queries, device)
        print(json.dumps({"config": args.config, "seed": seed,
                          "control": numbers, "limits": cfg["limits"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
