"""Data-integrity primitives: checksums at every persistence boundary.

Reference analog: the per-macro-block / per-micro-block checksums the
blocksstable layer verifies on every read plus the per-replica column
checksums compared at major freeze (src/storage/ob_sstable_struct.h
ObSSTableColumnChecksum* — replica checksum verification), reduced to
three primitives:

- ``CorruptionError``: the ONE typed error every read path raises when
  stored or shipped bytes fail their checksum — callers either repair
  (scrub plane, DTL slice fallback) or fail loudly; poisoned rows are
  never served.
- byte digests (crc64, the PALF log's polynomial) for physical
  artifacts: segment chunks/footers, manifests, slog records, rebuild
  transfer chunks, DTL exchange payloads.
- an order- and layout-independent **logical table digest** for
  cross-replica comparison: replicas flush memtables on their own
  schedules, so their segment FILES differ bit-for-bit while holding the
  same rows — the scrub plane compares content, not files
  (``storage/scrub.py``; ≙ replica checksum at major freeze).

Port of ``oceanbase_tpu/storage/integrity.py``: the segment, manifest,
slog and WAL checks, the quarantine retention, the workload snapshots'
byte digest and the logical table digest.  The DTL reply digest
(``arrays_crc``) comes with the exchange (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import os
import time

import numpy as np

from oceanbase_tpu_torch.native import crc64

#: default quarantine (.corrupt) retention bounds shared by every
#: quarantining boundary (WAL dir, data/segments dir): keep the newest
#: few for forensics, never grow a directory without bound
QUARANTINE_KEEP = 4
QUARANTINE_MAX_AGE_S = 7 * 24 * 3600.0


def prune_quarantine(dirpath: str, keep: int = QUARANTINE_KEEP,
                     max_age_s: float = QUARANTINE_MAX_AGE_S):
    """Cap .corrupt quarantine files in ``dirpath`` by count AND age
    (newest first)."""
    try:
        names = sorted(
            (n for n in os.listdir(dirpath) if ".corrupt" in n),
            key=lambda n: os.path.getmtime(os.path.join(dirpath, n)),
            reverse=True)
    except OSError:
        return
    now = time.time()
    for i, n in enumerate(names):
        p = os.path.join(dirpath, n)
        try:
            if i >= keep or now - os.path.getmtime(p) > max_age_s:
                os.remove(p)
        except OSError:
            continue


class CorruptionError(RuntimeError):
    """Stored or shipped bytes failed an integrity checksum.

    Raised instead of returning poisoned rows; carries enough context
    (artifact kind + path/table) for the scrub plane to quarantine and
    repair the artifact."""

    def __init__(self, message: str, kind: str = "", path: str = ""):
        super().__init__(message)
        self.kind = kind
        self.path = path


# ---------------------------------------------------------------------------
# physical digests (crc64 over bytes)
# ---------------------------------------------------------------------------


def bytes_crc(data: bytes) -> int:
    return crc64(bytes(data))


def chunk_crc(payload: dict, valid, encoding: str, n: int) -> int:
    """Digest of one encoded column chunk (EncodedColumn wire state):
    the encoding tag, row count, every payload buffer in key order, and
    the validity bitmap.  Computed at save time and re-computed from the
    loaded buffers at load time (storage/segment.py)."""
    crc = crc64(f"{encoding}:{n}".encode())
    for k in sorted(payload):
        v = np.asarray(payload[k])
        if v.dtype == object or v.dtype.kind in "US":
            body = "\x00".join("" if x is None else str(x)
                               for x in v.tolist()).encode("utf-8")
        else:
            body = np.ascontiguousarray(v).tobytes()
        crc = crc64(body, seed=crc64(k.encode(), seed=crc))
    if valid is not None:
        crc = crc64(np.ascontiguousarray(
            np.asarray(valid, dtype=bool)).tobytes(), seed=crc)
    return crc


# ---------------------------------------------------------------------------
# logical table digest (cross-replica scrub)
# ---------------------------------------------------------------------------


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (the same mixer the
    DTL slice hash uses — px/dtl.py — duplicated here so the storage
    layer never imports the execution stack)."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _col_hash(vals: np.ndarray) -> np.ndarray:
    if vals.dtype.kind in "iub":
        return _mix64(vals.astype(np.int64).astype(np.uint64))
    if vals.dtype.kind == "f":
        return _mix64(vals.astype(np.float64).view(np.uint64))
    import zlib

    return _mix64(np.fromiter(
        (zlib.crc32(str(v).encode("utf-8", "surrogatepass"))
         for v in vals), np.uint64, len(vals)))


def table_digest(arrays: dict, valids: dict | None = None) -> dict:
    """-> {"rows": n, "crc": int} — an ORDER-INDEPENDENT digest of a
    table snapshot: per-row hashes (mixing column name + value + NULL
    bit) XOR-reduced, so two replicas whose physically different
    segment layouts enumerate the same rows in different orders agree
    bit-for-bit.  NULL lanes hash by name only (their filler values are
    replica-local noise and must not contribute)."""
    n = len(next(iter(arrays.values()))) if arrays else 0
    if n == 0:
        return {"rows": 0, "crc": 0}
    h = np.zeros(n, dtype=np.uint64)
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        if a.ndim > 1:
            ch = np.zeros(n, dtype=np.uint64)
            for j in range(a.shape[1]):
                ch = _mix64(ch ^ _col_hash(a[:, j]))
        else:
            ch = _col_hash(a)
        name_h = np.uint64(crc64(name.encode()))
        v = (valids or {}).get(name)
        if v is not None:
            ch = np.where(np.asarray(v, dtype=bool), ch, np.uint64(0))
        h ^= _mix64(ch ^ name_h)
    row_h = _mix64(h)
    crc = int(np.bitwise_xor.reduce(row_h))
    return {"rows": int(n), "crc": crc}
