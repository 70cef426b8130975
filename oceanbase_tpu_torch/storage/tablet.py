"""Tablet: one partition's LSM — memtables + leveled segments.

Port of ``oceanbase_tpu/storage/tablet.py``; the newest-wins dedup of
``snapshot_arrays`` is ``segment.keep_last`` (the same rows as the
reference's per-row loop, vectorized).

Reference analog: ObTablet (src/storage/tablet) owning memtables and an
SSTable table-store; freeze/mini/minor/major compaction driven by the
tenant scheduler (src/storage/compaction/ob_tenant_tablet_scheduler.h:140).

Read path: ``snapshot_arrays`` fuses base segments (oldest..newest,
newest-wins by primary key) with the visible memtable overlay — the TPU
build's version of ObMultipleScanMerge fusing memtable + SSTables
(src/storage/access/ob_multiple_merge.cpp:507), done column-wise on host
metadata before the device upload instead of row-at-a-time.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np

from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.storage.memtable import MemTable
from oceanbase_tpu_torch.storage.segment import (
    Segment,
    keep_last,
    merge_segments,
    sort_rows_by_keys,
)
from oceanbase_tpu_torch.tx.errors import WriteConflict


class SegIdAlloc:
    """Monotonic segment-id allocator that can be bumped past ids seen
    on recovery/repair installs: a restarted tablet must never mint an
    id that collides with a persisted segment file (the fresh segment
    would silently overwrite the old one on disk)."""

    def __init__(self, start: int = 1):
        self.n = start

    def __next__(self) -> int:
        v = self.n
        self.n += 1
        return v

    def bump_past(self, seg_id: int):
        self.n = max(self.n, int(seg_id) + 1)


class Tablet:
    def __init__(self, tablet_id: int, columns: list[str],
                 types: dict[str, SqlType], key_cols: list[str]):
        self.tablet_id = tablet_id
        self.columns = list(columns)
        self.types = dict(types)
        self.key_cols = list(key_cols)
        self.active = MemTable(0)
        self.frozen: list[MemTable] = []
        self.segments: list[Segment] = []   # oldest first
        self._next_mt = itertools.count(1)
        self._next_seg = SegIdAlloc(1)
        self._lock = threading.RLock()
        self._auto_key = itertools.count()  # rowid for keyless tables
        self.data_version = 0               # bumps on any visible change

    # ------------------------------------------------------------------
    def make_key(self, values: dict) -> tuple:
        if self.key_cols == ["__rowid__"] and "__rowid__" not in values:
            values["__rowid__"] = self.next_rowid(1)
        return tuple(values[k] for k in self.key_cols)

    def next_rowid(self, n: int) -> int:
        """Allocate n consecutive hidden rowids (restart-safe: seeded from
        the max persisted rowid on first use)."""
        with self._lock:
            if not hasattr(self, "_rowid_base"):
                base = 0
                for seg in self.segments:
                    chunks = seg.columns.get("__rowid__")
                    if chunks:
                        for ec in chunks:
                            if ec.zone.vmax is not None:
                                base = max(base, int(ec.zone.vmax) + 1)
                # rows replayed from the WAL live only in memtables
                if self.key_cols == ["__rowid__"]:
                    for mt in [self.active] + self.frozen:
                        for key in mt._rows:
                            base = max(base, int(key[0]) + 1)
                self._rowid_base = base
            out = self._rowid_base
            self._rowid_base += n
            return out

    def write(self, key: tuple, op: str, values: dict, tx_id: int,
              stmt_seq: int = 0, snapshot: int | None = None):
        with self._lock:
            # invariant: stored values always carry their key columns
            # (callers that copied the dict before make_key would
            # otherwise persist NULL rowids that dedup collapses)
            if any(values.get(kc) is None for kc in self.key_cols):
                values = dict(values)
                for kc, kv in zip(self.key_cols, key):
                    if values.get(kc) is None:
                        values[kc] = kv
            # SI conflict checks look at frozen memtables too: the key's
            # newest version may have been frozen mid-transaction
            if snapshot is not None:
                for mt in self.frozen:
                    head = mt._rows.get(key)
                    if head is not None and head.commit_version > snapshot:
                        raise WriteConflict(
                            f"key {key} modified after snapshot {snapshot}")
            v = self.active.write(key, op, values, tx_id, stmt_seq,
                                  snapshot=snapshot)
            return v

    def commit(self, tx_id: int, commit_version: int, keys):
        with self._lock:
            self.active.commit(tx_id, commit_version, keys)
            for mt in self.frozen:
                mt.commit(tx_id, commit_version, keys)
            self.data_version += 1

    def abort(self, tx_id: int, keys, min_stmt_seq: int = 0):
        with self._lock:
            self.active.abort(tx_id, keys, min_stmt_seq)
            for mt in self.frozen:
                mt.abort(tx_id, keys, min_stmt_seq)

    # ------------------------------------------------------------------
    # compaction (≙ mini/minor/major merge DAGs)
    # ------------------------------------------------------------------
    def freeze(self):
        with self._lock:
            if len(self.active) == 0:
                return None
            mt = self.active.freeze()
            self.frozen.append(mt)
            self.active = MemTable(next(self._next_mt))
            return mt

    def mini_compact(self, snapshot: int):
        """Frozen memtables -> one L0 segment.

        Versions the flush snapshot cannot capture (uncommitted, or
        committed after the snapshot) are CARRIED OVER into the active
        memtable instead of being dropped — a frozen memtable may hold a
        live transaction's writes (≙ the reference's freeze waiting on
        active tx handover; we migrate instead of waiting)."""
        with self._lock:
            if not self.frozen:
                return None
            parts = []
            leftovers: list[dict] = []
            for mt in self.frozen:
                arrays, valids = mt.to_arrays(self.columns, self.types,
                                              snapshot)
                parts.append((arrays, valids, mt))
                leftovers.append(mt.leftover_versions(snapshot))
            merged_arrays, merged_valids = _stack_parts(parts, self.columns,
                                                        self.types)
            merged_arrays, merged_valids = sort_rows_by_keys(
                merged_arrays, merged_valids, self.key_cols)
            seg = Segment.build(
                next(self._next_seg), 0, merged_arrays,
                {**self.types, "__deleted__": SqlType.bool_(),
                 "__version__": SqlType.int_()},
                merged_valids,
                min_version=min((mt.min_version for _, _, mt in parts
                                 if mt.max_version > 0), default=snapshot),
                max_version=max((mt.max_version for _, _, mt in parts),
                                default=snapshot),
            )
            self.segments.append(seg)
            self.frozen = []
            for lo in leftovers:
                self._graft_versions(lo)
            self.data_version += 1
            return seg

    def _graft_versions(self, chains: dict):
        """Attach carried-over version chains under the active memtable's
        chains (active versions are strictly newer)."""
        for key, head in chains.items():
            cur = self.active._rows.get(key)
            if cur is None:
                self.active._rows[key] = head
            else:
                tail = cur
                while tail.prev is not None:
                    tail = tail.prev
                tail.prev = head

    def minor_compact(self):
        """All L0 segments -> one L1 (≙ minor merge).  Tombstones are
        RETAINED: the rows they shadow may live in lower levels outside
        this merge."""
        with self._lock:
            l0 = [s for s in self.segments if s.level == 0]
            if len(l0) < 2:
                return None
            keep = [s for s in self.segments if s.level != 0]
            merged = merge_segments(next(self._next_seg), 1, l0,
                                    self.key_cols, drop_tombstones=False)
            # place after existing L1/L2 so order stays oldest-first
            self.segments = keep + [merged]
            self.data_version += 1
            return merged

    def major_compact(self):
        """Everything -> one L2 baseline (≙ daily major merge); the merge
        covers every level, so tombstones fall out here."""
        with self._lock:
            if not self.segments:
                return None
            merged = merge_segments(next(self._next_seg), 2, self.segments,
                                    self.key_cols, drop_tombstones=True)
            self.segments = [merged]
            self.data_version += 1
            return merged

    # ------------------------------------------------------------------
    # snapshot read
    # ------------------------------------------------------------------
    def snapshot_arrays(self, snapshot: int, tx_id: int = 0, prune=None):
        """-> (arrays, valids) visible at ``snapshot`` (plus own tx).

        ``prune``: optional {key_col: (lo, hi)} inclusive ranges used for
        zone-map chunk pruning (≙ blockscan skipping via index blocks).
        SOUNDNESS: pruning columns MUST be key columns — every version of
        a key (including tombstones) carries identical key-column values,
        so a chunk mask derived from key ranges either keeps every version
        of a key or drops every version; newest-wins dedup stays correct
        for all surviving keys.  Pruning on a non-key column could split a
        version chain and resurrect stale rows."""
        if prune:
            assert set(prune) <= set(self.key_cols), \
                "zone-map pruning is only sound on key columns"
        with self._lock:
            seg_parts = []
            for seg in self.segments:
                if seg.min_version > snapshot:
                    continue  # wholly invisible at this snapshot
                if prune:
                    cm = np.ones(seg.n_chunks, dtype=bool)
                    for pc, (lo, hi) in prune.items():
                        cm &= seg.prune_chunks(pc, lo, hi)
                    if not cm.any():
                        continue
                    a, v = seg.decode(chunk_mask=None if cm.all() else cm)
                else:
                    a, v = seg.decode()
                if seg.max_version > snapshot and "__version__" in a:
                    vis = a["__version__"] <= snapshot
                    a = {k: arr[vis] for k, arr in a.items()}
                    v = {k: (vv[vis] if vv is not None else None)
                         for k, vv in v.items()}
                seg_parts.append((a, v, None))
            mt_parts = []
            for mt in self.frozen + [self.active]:
                rows = mt.snapshot_rows(snapshot, tx_id)
                if rows:
                    a, v = _rows_to_arrays(rows, self.columns, self.types)
                    mt_parts.append((a, v, None))
        parts = seg_parts + mt_parts
        if not parts:
            return ({c: self.types[c].host_zeros(0) for c in self.columns},
                    {c: None for c in self.columns})
        arrays, valids = _stack_parts(parts, self.columns, self.types)
        n = len(next(iter(arrays.values())))
        keep = np.ones(n, dtype=bool)
        if self.key_cols and n:
            # newest last -> wins
            keep = keep_last([arrays[k] for k in self.key_cols])
        if "__deleted__" in arrays:
            keep &= ~arrays["__deleted__"].astype(bool)
        out_a = {c: arrays[c][keep] for c in self.columns}
        out_v = {c: (valids[c][keep] if valids.get(c) is not None else None)
                 for c in self.columns}
        return out_a, out_v

    def row_count_estimate(self) -> int:
        return sum(s.n_rows for s in self.segments) + len(self.active) + \
            sum(len(m) for m in self.frozen)

    def memtables(self):
        """Active + frozen memtables, newest-first (interface shared with
        PartitionedTablet for point-lookup/streaming paths)."""
        return [self.active] + self.frozen[::-1]

    # -- segment management hooks (shared with PartitionedTablet) --------
    def add_segment(self, seg, part_idx=None):
        # segment list + data_version guard reads through THIS tablet's
        # lock; callers under the engine lock still must not bypass it
        with self._lock:
            self.segments.append(seg)
            self._next_seg.bump_past(seg.segment_id)
            self.data_version += 1

    def remove_segments(self, ids):
        ids = set(ids)
        with self._lock:
            self.segments = [s for s in self.segments
                             if s.segment_id not in ids]
            self.data_version += 1

    def segment_locations(self):
        """-> [(Segment, partition_idx|None)] for manifest checkpoints."""
        return [(s, None) for s in self.segments]

    def max_commit_version(self) -> int:
        """Largest commit version any row in this tablet carries; a read
        at snapshot >= this sees the same data as a latest-commit read."""
        v = max((s.max_version for s in self.segments), default=0)
        for mt in [self.active] + self.frozen:
            v = max(v, mt.max_version)
        return v


def _rows_to_arrays(rows: dict, columns, types):
    n = len(rows)
    arrays = {c: [] for c in columns}
    valids = {c: np.ones(n, dtype=bool) for c in columns}
    deleted = np.zeros(n, dtype=bool)
    for i, (key, v) in enumerate(sorted(rows.items())):
        deleted[i] = v.op == "delete"
        for c in columns:
            val = v.values.get(c)
            if val is None:
                valids[c][i] = False
                arrays[c].append(types[c].null_fill)
            else:
                arrays[c].append(val)
    out = {}
    for c in columns:
        out[c] = types[c].host_array(arrays[c])
    out["__deleted__"] = deleted
    return out, valids


def _stack_parts(parts, columns, types):
    """Stack (arrays, valids, _) parts preserving the hidden __deleted__
    tombstone and __version__ commit-version columns.

    A part MISSING a real column (segments written before an ALTER TABLE
    ADD COLUMN) contributes NULLs for it — schema evolution without
    rewriting old segments."""
    cols = list(columns) + ["__deleted__", "__version__"]
    arrays = {}
    valids = {}
    for c in cols:
        arrs = []
        missing = []  # parallel flags: part lacked this column entirely
        for a, v, _ in parts:
            if c in a:
                arrs.append(a[c])
                missing.append(False)
            else:
                n = len(next(iter(a.values())))
                if c == "__deleted__":
                    arrs.append(np.zeros(n, dtype=bool))
                elif c == "__version__":
                    arrs.append(np.zeros(n, dtype=np.int64))
                else:
                    arrs.append(types[c].host_zeros(n))
                missing.append(True)
        if any(x.dtype == object for x in arrs):
            arrs = [x.astype(object) for x in arrs]
        arrays[c] = np.concatenate(arrs) if arrs else np.zeros(0)
        if c not in ("__deleted__", "__version__"):
            vparts = []
            has = any(v.get(c) is not None for _, v, _ in parts) or \
                any(m for m in missing)
            if has:
                for (a, v, _), m, arr in zip(parts, missing, arrs):
                    n = len(arr)
                    if m:
                        vparts.append(np.zeros(n, dtype=bool))  # NULLs
                    else:
                        vv = v.get(c)
                        vparts.append(vv if vv is not None
                                      else np.ones(n, dtype=bool))
                valids[c] = np.concatenate(vparts)
            else:
                valids[c] = None
    return arrays, valids
