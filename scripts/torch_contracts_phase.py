#!/usr/bin/env python3
"""Phase "contracts" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_contracts_phase.py

Runs ``chip_smoke.phase_contracts``: the reference's overload, disk and
recompile contracts (``bench/{overload,disk,recompile}.py``) on the card,
each on a ``Database`` of its own in a temporary directory, with the
kernels' launch counts set to 0 just before and printed after.  Prints
the phase's lines, its seconds and the card's name and power limit, and
exits nonzero at the first broken invariant or at any launch of
``q6_filter_sum`` (the phase reaches no hand-written kernel).  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_contracts_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.ops import _build

    card = card_line()
    dev = torch.device("cuda", 0)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    chip_smoke.phase_contracts(torch, dev, card)
    torch.cuda.synchronize()
    print(f"[time] phase contracts: {time.perf_counter() - t0:.3f} s")
    counts = _build.launch_counts()
    print(f"[contracts] kernel launches: {counts}")
    if counts.get("q6_filter_sum", 0):
        print(f"torch_contracts_phase: launched {counts}", file=sys.stderr)
        return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
