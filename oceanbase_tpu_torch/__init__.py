"""oceanbase_tpu_torch — the PyTorch/CUDA port of the oceanbase_tpu executor.

The package mirrors ``oceanbase_tpu``'s module layout so each ported piece
sits where its JAX counterpart does:

- ``vector/``  masked columnar ``Column``/``Relation`` on torch tensors
- ``expr/``    expression IR + eager torch evaluator
- ``exec/``    vectorized operators, plan nodes and the plan executor
- ``ops/``     hand-written CUDA kernels (built with nvcc at first use)
- ``bench/``   TPC-H generator, hand-built plans and numpy oracles

It imports torch and numpy only.  Integers are int64 wherever the JAX
package relies on ``jax_enable_x64``; every promotion is explicit.

Entry points take a ``device``; the default is ``"cuda"``.  Running on the
CPU happens only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def default_device(device=None) -> torch.device:
    """Resolve ``device`` (None means ``"cuda"``) to a torch.device.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is available: the port never falls back to the CPU
    on its own.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "oceanbase_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the CPU")
    return dev
