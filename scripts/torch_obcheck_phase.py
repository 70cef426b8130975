#!/usr/bin/env python3
"""Phase "obcheck" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_obcheck_phase.py            # TPC-H SF1
    OB_SMOKE_SF=0.1 python3 scripts/torch_obcheck_phase.py

Loads the eight TPC-H tables into a catalog-only ``Session`` on the card
and ANALYZEs them (``bench/harness.py::tpch_session``, as phase sql
does), then runs phase obcheck on it: the static gate
(``scripts/torch_obcheck.py --ci --json``), the poison-lane invariant
over bucket-padded tables (22 TPC-H plans, the hand-built Q1/Q6/Q14, and
four PX plans on an 8-shard mesh), and each of the 22 plans' warm
synchronizing calls held against ``trace.host-sync``.  Prints the
phase's lines, its seconds and the card's name and power limit.  Needs
a CUDA device; imports nothing of JAX.
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
        print("torch_obcheck_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench.harness import card_line, tpch_session
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    card = card_line()
    dev = torch.device("cuda", 0)
    sf = float(os.environ.get("OB_SMOKE_SF", "1"))
    tables, types = gen_tpch(sf=sf)
    sess, load_s, analyze_s = tpch_session(tables, types, device=dev)
    print(f"[setup] sf={sf}: load {load_s:.3f} s, ANALYZE {analyze_s:.3f} s")
    t0 = time.perf_counter()
    chip_smoke.phase_obcheck(torch, dev, sess, tables, card, str(REPO))
    torch.cuda.synchronize()
    print(f"[time] phase obcheck: {time.perf_counter() - t0:.3f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
