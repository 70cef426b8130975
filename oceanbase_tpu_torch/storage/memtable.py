"""MVCC memtable: the mutable head of each tablet's LSM.

A copy of ``oceanbase_tpu/storage/memtable.py``.

Reference analog: ObMemtable + the MVCC engine
(src/storage/memtable/ob_memtable.h:182, set at ob_memtable.cpp:542,
mvcc chains in src/storage/memtable/mvcc/ob_mvcc_engine.h).

Host-side by design (the north star keeps MVCC off-TPU): a dict keyed by
primary key holding per-key version chains, newest first.  Reads at a
snapshot version walk the chain to the first visible version; uncommitted
versions are visible only to their own transaction.  ``freeze()`` swaps
the active memtable for an immutable one that mini-compaction turns into
an L0 segment (≙ ObFreezer, src/storage/ls/ob_freezer.h:177).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Version:
    """One MVCC version of a row (≙ ObMvccTransNode)."""

    commit_version: int          # 0 while uncommitted
    tx_id: int
    op: str                      # insert | update | delete
    values: dict                 # column -> python value (None = NULL)
    prev: Optional["Version"] = None
    stmt_seq: int = 0            # statement sequence within the tx
                                 # (savepoint granularity for stmt rollback)


class MemTable:
    """Version-chained rows for one tablet."""

    def __init__(self, mt_id: int = 0):
        self.mt_id = mt_id
        self._rows: dict[tuple, Version] = {}
        self._lock = threading.RLock()
        self.frozen = False
        self.min_version = 2**63
        self.max_version = 0

    def __len__(self):
        return len(self._rows)

    # ------------------------------------------------------------------
    # write path (called under a transaction; ≙ mvcc_write_)
    # ------------------------------------------------------------------
    def write(self, key: tuple, op: str, values: dict, tx_id: int,
              stmt_seq: int = 0, snapshot: int | None = None):
        """MVCC write.  With ``snapshot`` set, enforces snapshot-isolation
        rules: first-committer-wins (a commit newer than the writer's
        snapshot conflicts — prevents lost updates) and duplicate-key
        rejection for inserts over a visible live row."""
        with self._lock:
            if self.frozen:
                raise RuntimeError("memtable frozen")
            head = self._rows.get(key)
            from oceanbase_tpu_torch.tx.errors import DuplicateKey, WriteConflict

            # write-write conflict: another live tx has an uncommitted head
            if head is not None and head.commit_version == 0 and \
                    head.tx_id != tx_id:
                raise WriteConflict(f"key {key} locked by tx {head.tx_id}")
            if snapshot is not None and head is not None and \
                    head.commit_version > snapshot:
                raise WriteConflict(
                    f"key {key} modified after snapshot {snapshot} "
                    f"(committed at {head.commit_version})")
            if snapshot is not None and op == "insert" and head is not None:
                vis = self.visible_version(key, snapshot, tx_id)
                if vis is not None and vis.op != "delete":
                    raise DuplicateKey(f"duplicate key {key}")
            v = Version(0, tx_id, op, dict(values), prev=head,
                        stmt_seq=stmt_seq)
            self._rows[key] = v
            return v

    def commit(self, tx_id: int, commit_version: int, keys):
        with self._lock:
            for key in keys:
                v = self._rows.get(key)
                while v is not None:
                    if v.tx_id == tx_id and v.commit_version == 0:
                        v.commit_version = commit_version
                    v = v.prev
            self.min_version = min(self.min_version, commit_version)
            self.max_version = max(self.max_version, commit_version)

    def abort(self, tx_id: int, keys, min_stmt_seq: int = 0):
        """Drop uncommitted versions of ``tx_id`` (whole-tx rollback), or
        only those with stmt_seq >= min_stmt_seq (statement-level rollback,
        ≙ the reference's savepoint rollback in the tx callback list)."""
        with self._lock:
            for key in keys:
                head = self._rows.get(key)
                while head is not None and head.commit_version == 0 and \
                        head.tx_id == tx_id and head.stmt_seq >= min_stmt_seq:
                    head = head.prev
                if head is None:
                    self._rows.pop(key, None)
                else:
                    self._rows[key] = head

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def visible_version(self, key: tuple, snapshot: int,
                        tx_id: int = 0) -> Optional[Version]:
        v = self._rows.get(key)
        while v is not None:
            if v.commit_version == 0:
                if tx_id and v.tx_id == tx_id:
                    return v  # own uncommitted write
            elif v.commit_version <= snapshot:
                return v
            v = v.prev
        return None

    def snapshot_rows(self, snapshot: int, tx_id: int = 0) -> dict:
        """-> {key: Version} of all visible versions at ``snapshot``."""
        out = {}
        with self._lock:
            for key in self._rows:
                v = self.visible_version(key, snapshot, tx_id)
                if v is not None:
                    out[key] = v
        return out

    def freeze(self) -> "MemTable":
        """Make this memtable immutable; caller installs a fresh active one
        (≙ ObFreezer tablet freeze)."""
        with self._lock:
            self.frozen = True
        return self

    def to_arrays(self, columns: list, types: dict, snapshot: int):
        """Materialize ALL committed versions (<= snapshot) as host arrays
        for segment build (mini compaction input) — multi-version flush so
        live older snapshots keep reading their versions from the segment.
        Version GC happens at minor/major merge (newest-wins dedup), the
        undo-retention boundary.  Rows carry __deleted__ tombstone markers
        and per-row __version__ commit versions; per key, versions are
        emitted oldest-first so newest-wins stacking order holds."""
        with self._lock:
            chains = []
            for key in sorted(self._rows):
                vers = []
                v = self._rows[key]
                while v is not None:
                    if v.commit_version != 0 and v.commit_version <= snapshot:
                        vers.append(v)
                    v = v.prev
                vers.reverse()  # oldest first
                chains.append(vers)
        n = sum(len(vs) for vs in chains)
        arrays = {c: [] for c in columns}
        deleted = np.zeros(n, dtype=bool)
        versions = np.zeros(n, dtype=np.int64)
        valids = {c: np.ones(n, dtype=bool) for c in columns}
        i = 0
        for vers in chains:
            for v in vers:
                deleted[i] = v.op == "delete"
                versions[i] = v.commit_version
                for c in columns:
                    val = v.values.get(c)
                    if val is None:
                        valids[c][i] = False
                        arrays[c].append(types[c].null_fill)
                    else:
                        arrays[c].append(val)
                i += 1
        out = {}
        for c in columns:
            out[c] = types[c].host_array(arrays[c])
        out["__deleted__"] = deleted
        out["__version__"] = versions
        return out, valids

    def leftover_versions(self, snapshot: int) -> dict:
        """Version chains NOT captured by a flush at ``snapshot``:
        uncommitted versions and versions committed after the snapshot.
        The returned heads are cut below the capture boundary (older
        versions live in the flushed segment)."""
        out: dict[tuple, Version] = {}
        with self._lock:
            for key, head in self._rows.items():
                keep = []
                v = head
                while v is not None and (v.commit_version == 0 or
                                         v.commit_version > snapshot):
                    keep.append(v)
                    v = v.prev
                if keep:
                    keep[-1].prev = None  # cut: older history is flushed
                    out[key] = keep[0]
        return out
