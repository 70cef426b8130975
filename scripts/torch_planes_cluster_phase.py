#!/usr/bin/env python3
"""Phase "planes-cluster" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_planes_cluster_phase.py

Boots three ``oceanbase_tpu_torch.net.node`` processes on the card as
the reference's benches boot theirs (``chip_smoke.start_planes_cluster``)
and runs ``chip_smoke.phase_planes_cluster`` on them: the slice's
``chip_smoke.PLANES_CLUSTER_ROWS`` rows INSERTed on node 1, then the
cluster halves of the reference's trace, metrics, workload and
plan-quality benches and its scrub bench whole.
The kernels' launch counts are set to 0 just before and printed after.
Prints the phase's lines, its seconds and the card's name and power
limit, and exits nonzero at the first broken non-timing gate or at any
launch.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import signal
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_planes_cluster_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.ops import _build

    # a SIGTERM unwinds through the phase's finally, which closes the nodes
    signal.signal(signal.SIGTERM, lambda *_a: sys.exit(143))
    card = card_line()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    cluster = chip_smoke.start_planes_cluster()
    chip_smoke.phase_planes_cluster(torch, cluster, card)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"[time] phase planes-cluster (its boot included): "
          f"{time.perf_counter() - t0:.3f} s; kernel launches {counts}")
    print(card, flush=True)
    return 1 if any(counts.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
