"""ctypes bridge to the native host-runtime codecs (``native/``).

Port of ``oceanbase_tpu/native.py`` for the codecs the storage and WAL
planes use: ``crc64`` (WAL entries, segment chunks, manifest and slog
records), the delta + zigzag + varint integer codec (segment payloads)
and the run-length scan.  The CSV tokenizer and field parsers wait for
LOAD DATA (ROADMAP Queue 1 item 5b).

The library is compiled from ``native/obtpu_native.cpp`` with the host
C++ compiler into ``oceanbase_tpu_torch/_build/`` at first use, under a
file name carrying a hash of the source and the flags (the idiom of
``ops/_build.py``), so an edited source is rebuilt.  Every entry point
keeps its pure-numpy path beside the library, as the reference does:
these are host functions, and both paths give identical bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / \
    "obtpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False

_MASK64 = (1 << 64) - 1


def library_path() -> Path:
    """The shared library built from the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libobtpu_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is current -> its path.  Raises
    when no C++ compiler is found or the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or \
        shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (CXX, g++ or c++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _build_attempted
    if _lib is not None:  # lock-free fast path (hot on the WAL append path)
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists() and not _build_attempted:
            _build_attempted = True
            try:
                build()
            except Exception:  # noqa: BLE001 — the numpy paths serve
                return None
        if not path.exists():
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.obtpu_crc64.restype = ctypes.c_uint64
        lib.obtpu_crc64.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_uint64]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.obtpu_delta_varint_encode.restype = ctypes.c_uint64
        lib.obtpu_delta_varint_encode.argtypes = [
            i64p, ctypes.c_uint64, u8p, ctypes.c_uint64]
        lib.obtpu_delta_varint_decode.restype = ctypes.c_uint64
        lib.obtpu_delta_varint_decode.argtypes = [
            u8p, ctypes.c_uint64, i64p, ctypes.c_uint64]
        lib.obtpu_rle_runs_i64.restype = ctypes.c_uint64
        lib.obtpu_rle_runs_i64.argtypes = [
            i64p, ctypes.c_uint64, u64p, ctypes.c_uint64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# crc64 (log/segment integrity)
# ---------------------------------------------------------------------------

_PY_TABLE = None


def _py_crc64_table():
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = np.uint64(0xC96C5795D7870F42)
        table = np.zeros(256, dtype=np.uint64)
        for i in range(256):
            crc = np.uint64(i)
            for _ in range(8):
                crc = (crc >> np.uint64(1)) ^ (
                    poly if crc & np.uint64(1) else np.uint64(0))
            table[i] = crc
        _PY_TABLE = table
    return _PY_TABLE


def crc64(data: bytes, seed: int = 0, use_native: bool = True) -> int:
    lib = _load() if use_native else None
    if lib is not None:
        return int(lib.obtpu_crc64(data, len(data), seed))
    # numpy path (byte-at-a-time through the table)
    table = _py_crc64_table()
    crc = np.uint64(~seed & 0xFFFFFFFFFFFFFFFF)
    for b in data:
        crc = table[int((crc ^ np.uint64(b)) & np.uint64(0xFF))] ^ \
            (crc >> np.uint64(8))
    return int(~crc & 0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# delta + zigzag + varint codec (segment persistence)
# ---------------------------------------------------------------------------


def delta_varint_encode(values: np.ndarray, use_native: bool = True
                        ) -> bytes:
    values = np.ascontiguousarray(values, dtype=np.int64)
    lib = _load() if use_native else None
    if lib is not None:
        out = np.empty(len(values) * 10 + 16, dtype=np.uint8)
        n = int(lib.obtpu_delta_varint_encode(values, len(values), out,
                                              len(out)))
        if n:
            return out[:n].tobytes()
    # python path: deltas in wrapping 64-bit arithmetic (matches the
    # native codec for full-range values like MAX-MIN)
    out_b = bytearray()
    prev = 0
    for v in values.tolist():
        d = (v - prev) & _MASK64
        if d >= 1 << 63:
            d -= 1 << 64  # back to signed
        u = ((d << 1) ^ (d >> 63)) & _MASK64
        prev = v
        while True:
            b = u & 0x7F
            u >>= 7
            out_b.append(b | (0x80 if u else 0))
            if not u:
                break
    return bytes(out_b)


def delta_varint_decode(buf: bytes, n: int, use_native: bool = True
                        ) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    lib = _load() if use_native else None
    if lib is not None:
        arr = np.frombuffer(buf, dtype=np.uint8)
        out = np.empty(n, dtype=np.int64)
        used = int(lib.obtpu_delta_varint_decode(
            np.ascontiguousarray(arr), len(arr), out, n))
        if used == 0:
            raise ValueError("corrupt varint payload (native decode failed)")
        return out
    out_l = np.empty(n, dtype=np.int64)
    pos = 0
    prev = 0
    try:
        for i in range(n):
            u = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                u |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
                if shift > 63:
                    raise ValueError("corrupt varint payload")
            d = (u >> 1) ^ -(u & 1)
            prev = (prev + d) & _MASK64
            if prev >= 1 << 63:
                prev -= 1 << 64
            out_l[i] = prev
    except IndexError:
        raise ValueError("corrupt varint payload (truncated)") from None
    return out_l


def rle_run_starts(values: np.ndarray, use_native: bool = True
                   ) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.int64)
    lib = _load() if use_native else None
    if lib is not None:
        starts = np.empty(len(values), dtype=np.uint64)
        n = int(lib.obtpu_rle_runs_i64(values, len(values), starts,
                                       len(starts)))
        return starts[:n].astype(np.int64)
    if len(values) == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.empty(len(values), dtype=bool)
    change[0] = True
    np.not_equal(values[1:], values[:-1], out=change[1:])
    return np.nonzero(change)[0]


__all__ = ["build", "crc64", "delta_varint_decode", "delta_varint_encode",
           "library_path", "native_available", "rle_run_starts"]
