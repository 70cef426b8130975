#!/usr/bin/env python3
"""Phases "sql" and "px" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_px_phase.py            # TPC-H SF1
    OB_SMOKE_SF=0.1 python3 scripts/torch_px_phase.py

Phase sql loads the eight TPC-H tables into a catalog-only ``Session``
on the card, ANALYZEs them and times the 22 queries serially against
SQLite (four oracle processes); phase px then runs them with
``px_dop = 8`` over an 8-shard mesh on the same card, each against
SQLite and beside its serial ms, and the Q1-shaped step, the skewed
range sort and the hot-key join against numpy.  Prints both phases'
lines, their seconds and the card's name and power limit.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_px_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    card = card_line()
    dev = torch.device("cuda", 0)
    sf = float(os.environ.get("OB_SMOKE_SF", "1"))
    oracles = chip_smoke.start_oracles(str(REPO), sf)
    tables, types = gen_tpch(sf=sf)
    t0 = time.perf_counter()
    sess, got, stats = chip_smoke.phase_sql(dev, tables, types, card)
    want = chip_smoke.phase_sql_check(got, stats, card, oracles)
    torch.cuda.synchronize()
    print(f"[time] phase sql: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    chip_smoke.phase_px(torch, dev, sess, tables, card, stats, want)
    torch.cuda.synchronize()
    print(f"[time] phase px: {time.perf_counter() - t0:.3f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
