"""Data-integrity primitives: checksums at every persistence boundary.

Port of the part of ``oceanbase_tpu/storage/integrity.py`` the storage
and WAL planes use (≙ the per-micro-block checksums the blocksstable
layer verifies on every read):

- ``CorruptionError``: the one typed error every read path raises when
  stored bytes fail their checksum; poisoned rows are never served.
- ``chunk_crc``: the crc64 (the PALF log's polynomial) of one encoded
  segment chunk, stored at save and re-checked at load.
- ``prune_quarantine``: retention of the ``.corrupt`` files the WAL
  recovery moves aside.

The logical table digest, the DTL payload digest and the scrub plane
that uses them wait for ROADMAP Queue 1 item 5b.
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
