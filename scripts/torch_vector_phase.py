#!/usr/bin/env python3
"""Phase "vector" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_vector_phase.py

VECTOR(128) columns, the distance functions, the exact and IVF-Flat
vector indexes behind ORDER BY <distance> LIMIT k, and a fulltext index
over TPC-H SF1's part comments, through a ``Database`` on the card at
the size of ANN-Benchmarks' SIFT1M (1,000,000 x 128 synthetic vectors
from a seed, 100 queries, k = 10), every answer held against numpy.
Prints the phase's ``[vector]`` lines, its seconds and the card's name
and power limit.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_vector_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    card = card_line()
    tables, _types = gen_tpch(sf=1.0)
    t0 = time.perf_counter()
    chip_smoke.phase_vector(torch, torch.device("cuda", 0), tables, card)
    torch.cuda.synchronize()
    print(f"[time] phase vector: {time.perf_counter() - t0:.3f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
