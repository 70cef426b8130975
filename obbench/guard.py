"""What a run may not load, and where its caches go.

The JAX package is the port's reference and is never benchmarked: a run
that finds ``jax``, ``jaxlib``, ``flax`` or the JAX package among its
loaded modules fails.  Names are compared by their top-level part (the
part before the first dot) as a whole word, so ``oceanbase_tpu_torch``
is not ``oceanbase_tpu``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "oceanbase_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """-> the loaded module names whose top-level part is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def pin_caches(checkout: Path) -> None:
    """Every build and kernel cache at a fixed folder inside the
    checkout (``.obbench_cache/``), so a second run of a cell finds what
    the first one built.  The port builds its own libraries into
    ``oceanbase_tpu_torch/_build/``, also inside the checkout."""
    cache = checkout / ".obbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
