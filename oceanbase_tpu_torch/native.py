"""ctypes bridge to the native host-runtime codecs (``native/``).

Port of ``oceanbase_tpu/native.py`` for the codecs the storage and WAL
planes use: ``crc64`` (WAL entries, segment chunks, manifest and slog
records), the delta + zigzag + varint integer codec (segment payloads)
the run-length scan, and the CSV tokenizer and field parsers LOAD DATA
runs on (``csv_tokenize``, ``parse_int64_fields``, ``field_strings``).
``field_strings`` reads ASCII fields through a fixed-width byte view in
numpy, where the reference decodes one field at a time; the strings are
the same.

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
from decimal import Decimal
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
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.obtpu_csv_tokenize.restype = ctypes.c_uint64
        lib.obtpu_csv_tokenize.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint8, ctypes.c_uint64,
            u64p, u32p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.obtpu_parse_int64_fields.restype = ctypes.c_uint64
        lib.obtpu_parse_int64_fields.argtypes = [
            u8p, u64p, u32p, ctypes.c_uint64, ctypes.c_int64, i64p, u8p]
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


# ---------------------------------------------------------------------------
# CSV tokenizer + field parsers (direct-load fast path; the python csv
# module remains the fallback and the oracle for quoting semantics)
# ---------------------------------------------------------------------------


def csv_tokenize(data: bytes, n_cols: int, delimiter: str = ",",
                 use_native: bool = True):
    """-> (buf, offsets[n_rows*n_cols], lengths, n_rows) or None when the
    native library is unavailable or the file is ragged (caller falls
    back to the python csv module)."""
    lib = _load() if use_native else None
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    # upper bound on rows: every row ends with \n or a lone \r (counting
    # \r\n twice only over-allocates)
    approx_rows = data.count(b"\n") + data.count(b"\r") + 2
    offsets = np.empty(approx_rows * n_cols, dtype=np.uint64)
    lengths = np.empty(approx_rows * n_cols, dtype=np.uint32)
    err = ctypes.c_uint64(0)
    n_rows = int(lib.obtpu_csv_tokenize(
        np.ascontiguousarray(buf), len(buf), ord(delimiter), n_cols,
        offsets, lengths, approx_rows, ctypes.byref(err)))
    if n_rows == 0 and err.value:
        return None
    return buf, offsets[:n_rows * n_cols], lengths[:n_rows * n_cols], n_rows


def parse_int64_fields(buf: np.ndarray, offsets, lengths, scale: int = 0,
                       use_native: bool = True):
    """Batch-parse tokenized fields into scaled int64 + validity."""
    lib = _load() if use_native else None
    n = len(offsets)
    out = np.empty(n, dtype=np.int64)
    valid = np.empty(n, dtype=np.uint8)
    if lib is None:
        for i in range(n):
            ln = int(lengths[i]) & 0x7FFFFFFF
            s = bytes(buf[int(offsets[i]):int(offsets[i]) + ln]).decode()
            try:
                if scale:
                    out[i] = int(Decimal(s).scaleb(scale))
                else:
                    out[i] = int(s)
                valid[i] = 1
            except Exception:  # noqa: BLE001
                out[i] = 0
                valid[i] = 0
        return out, valid.astype(bool)
    lib.obtpu_parse_int64_fields(
        np.ascontiguousarray(buf), np.ascontiguousarray(offsets),
        np.ascontiguousarray(lengths), n, 10 ** scale, out, valid)
    return out, valid.astype(bool)


def field_bytes(buf, offsets, lengths):
    """Tokenized fields as a fixed-width bytes (``S``) array, or None
    when a field is quoted with ``""`` escapes, holds a NUL or a
    non-ASCII byte (``field_strings`` then decodes them one by one).

    The buffer is viewed as one ``S<w>`` string starting at every byte
    (a stride-1 view, no copy), so gathering the fields is one fancy
    index; the bytes past each field's length are then zeroed."""
    lengths = np.asarray(lengths)
    if (lengths & 0x80000000).any():
        return None
    lens = (lengths & 0x7FFFFFFF).astype(np.int64)
    n = len(lens)
    w = int(lens.max()) if n else 0
    if w == 0:
        return np.zeros(n, dtype="S1")
    data = bytes(buf) if not isinstance(buf, (bytes, bytearray)) else buf
    if len(data) < w:
        data = data + b"\0" * w  # a tiny buffer: pad it
    m = len(data) - w + 1  # windows that fit inside the buffer
    windows = np.ndarray(shape=(m,), dtype=f"S{w}", buffer=data,
                         strides=(1,))
    offs = np.asarray(offsets).astype(np.int64)
    out = windows[np.minimum(offs, m - 1)]
    for i in np.nonzero(offs >= m)[0]:
        # a field in the buffer's last w bytes: copied on its own
        o = int(offs[i])
        out[i] = data[o:o + int(lens[i])]
    mat = out.view(np.uint8).reshape(n, w)
    cols = np.arange(w, dtype=np.int64)
    step = max(1, (1 << 24) // w)  # rows per block: ~16M bytes checked
    for s in range(0, n, step):
        e = min(s + step, n)
        tail = cols[None, :] >= lens[s:e, None]
        block = mat[s:e]
        block[tail] = 0
        if (block >= 0x80).any() or ((block == 0) & ~tail).any():
            return None
    return out


def field_strings(buf, offsets, lengths) -> np.ndarray:
    """Materialize tokenized fields as python strings (unescaping the rare
    quoted-quote fields flagged in the length high bit).  ``buf`` may be
    the original bytes object (no copy) or a uint8 array."""
    fixed = field_bytes(buf, offsets, lengths)
    if fixed is not None:
        return fixed.astype("U").astype(object)
    out = np.empty(len(offsets), dtype=object)
    data = buf if isinstance(buf, (bytes, bytearray)) else buf.tobytes()
    for i in range(len(offsets)):
        ln = int(lengths[i])
        esc = bool(ln & 0x80000000)
        ln &= 0x7FFFFFFF
        o = int(offsets[i])
        s = data[o:o + ln].decode(errors="replace")
        out[i] = s.replace('""', '"') if esc else s
    return out


__all__ = ["build", "crc64", "csv_tokenize", "delta_varint_decode",
           "delta_varint_encode", "field_bytes", "field_strings",
           "library_path", "native_available", "parse_int64_fields",
           "rle_run_starts"]
