"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled
on its own for ``sm_90a`` into ``oceanbase_tpu_torch/_build/`` (listed in
``.gitignore``) at first use.  The library's file name carries a hash of
the source and the flags, so an edited source is rebuilt.

Nothing here falls back: a missing nvcc or a failed build raises.

The launch counters live here too: every kernel wrapper calls
``count_launch`` where it launches its kernel, and nowhere else, so a run
can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# one build and load at a time: a server's connection threads can reach
# a kernel's first use together (≙ native.py's _lib_lock)
_LIBS_LOCK = threading.Lock()

_LAUNCHES: dict[str, int] = {}


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in list(_LAUNCHES):
        _LAUNCHES[name] = 0


def find_nvcc() -> str:
    """Path of nvcc: CUDA_HOME as torch resolves it, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME/bin or PATH); the port's CUDA kernels "
        "are built from source at first use and need the CUDA toolkit")


def library_path(name: str) -> tuple[Path, Path]:
    """(source, shared library) for kernel source ``name``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile source ``name`` unless its library is current; returns
    nvcc's output (the ptxas register/spill report), or "" when cached."""
    src, lib = library_path(name)
    if lib.exists():
        return ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: {name} (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel source ``name`` (built first
    when missing or stale)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)[1]))
            _LIBS[name] = lib
    return lib
