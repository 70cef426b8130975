#!/usr/bin/env python3
"""Repeated PROFILE captures in one process on the GPU.

    python3 scripts/torch_profile_repeat.py [--captures 6]

Runs one fixed workload (16 elementwise kernels, a sort, a reduction and
one device-to-host read) under ``server/profiler.py::profile_statement``
again and again in one process, in rounds of ``--captures`` captures:
the capture as it is, then with a warm-up kernel and a synchronize
inside the capture before the workload, then as it is again.  Prints
per capture the kernel launches and kernel ms it saw: a capture that
keeps every kernel sees the same launches each time.  With
``TEARDOWN_CUPTI=1`` in the environment it runs the capture as torch
leaves it by default (CUPTI detached after every capture).  Then the
card's name and power limit.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_repeat: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.server.profiler import profile_statement

    ap = argparse.ArgumentParser()
    ap.add_argument("--captures", type=int, default=6)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    x = torch.rand(1 << 20, device=dev)

    def work():
        y = x
        for _ in range(16):
            y = y * 1.0001
        s = torch.sort(y).values
        return float(s.sum())

    def warm_work():
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
        return work()

    work()
    torch.cuda.synchronize()
    for label, fn in (("as is", work), ("warm-up", warm_work),
                      ("as is", work)):
        for i in range(args.captures):
            _out, rows, note = profile_statement(fn, cuda=True)
            kern = [r for r in rows if r["kind"] == "kernel"
                    and not r["kernel"].startswith(("Memcpy", "Memset"))]
            launches = sum(r["occurrences"] for r in kern)
            ms = sum(r["total_s"] for r in kern) * 1e3
            print(f"[profile] {label} capture {i + 1}: {launches} kernel "
                  f"launches in {len(kern)} rows, {ms:.3f} ms; note "
                  f"{note!r}", flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
