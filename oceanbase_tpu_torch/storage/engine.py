"""StorageEngine: tables -> tablets, manifest + redo (slog analog),
checkpoint/recovery, and the catalog bridge feeding the executor.

Port of ``oceanbase_tpu/storage/engine.py``: the same slog records,
manifest format, crc checks, segment files and recovery order.  The
``StorageCatalog`` materializes tablet snapshots as the port's device
relations on its device (``cuda`` unless the caller passes ``"cpu"``).
Range-partitioned tables (``storage/partition.py``), ALTER TABLE
ADD/DROP COLUMN, the transient (``gv$``) tables and the external tables
of the catalog come with it, as do the scrub and repair hooks (the
quarantine corrupt-segment policy, ``scrub_verify_table``,
``rewrite_segment_from_memory``, ``repair_table_segments``), the
disk-fault plane's write checks, the disk manager's typed errors
(``DiskFull``/``DiskIOError`` out of every durable writer), the ERRSIM
point of ``freeze_and_flush``, the memstore throttle's flush
listener, the vector and fulltext index specs (``aux_index`` and
``drop_aux_index`` slog records) and the DDL log-stream hook a cluster
node wires (``ddl_wal_cb``).

Reference analog:
- slog + slog_ckpt (src/storage/slog, ob_server_checkpoint_slog_handler.h):
  here a JSONL redo of metadata ops + segment files named by id, with an
  atomic manifest checkpoint; boot = manifest + slog replay.
- ObLSService restart (SURVEY §3.1): ``StorageEngine.open`` reloads
  persisted segments; memtable contents are re-applied by the tx plane's
  log replay (palf WAL), not by this layer.
- direct load (src/storage/direct_load): ``bulk_load`` builds an L2
  baseline segment straight from host arrays, bypassing the memtable.

The engine also backs ``StorageCatalog`` — the Catalog implementation that
materializes device Relations from tablet snapshots with caching keyed on
(data_version, snapshot), so analytics over a quiet table hit the cached
HBM-resident columns (≙ KV cache framework serving block cache hits).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from oceanbase_tpu_torch.catalog import (
    Catalog,
    ColumnDef,
    IndexDef,
    TableDef,
    sampled_ndv,
)
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.native import crc64
from oceanbase_tpu_torch.server.diskmgr import wrap_disk_error
from oceanbase_tpu_torch.server.errsim import ERRSIM
from oceanbase_tpu_torch.share.kvcache import KvCache, relation_bytes
from oceanbase_tpu_torch.storage.integrity import (
    CorruptionError,
    prune_quarantine,
)
from oceanbase_tpu_torch.storage.lookup import range_rows
from oceanbase_tpu_torch.storage.memtable import MemTable
from oceanbase_tpu_torch.storage.partition import PartitionedTablet
from oceanbase_tpu_torch.storage.segment import Segment, sort_rows_by_keys
from oceanbase_tpu_torch.storage.tablet import Tablet
from oceanbase_tpu_torch.tx.errors import DuplicateKey
from oceanbase_tpu_torch.vector import Relation, from_numpy
from oceanbase_tpu_torch.vector.column import (
    DEFAULT_BUCKET_FLOOR,
    DEFAULT_BUCKET_GROWTH,
    bucket_capacity,
)

log = logging.getLogger("oceanbase_tpu_torch.storage.engine")


@dataclass
class TableStore:
    tdef: TableDef
    tablet: Tablet  # single tablet per table in round 1; split comes with LS


# ---------------------------------------------------------------------------
# checksummed metadata files (manifest + slog) — module-level so the
# rebuild client (net/rebuild.py) can pre-verify a baseline without an
# engine instance
# ---------------------------------------------------------------------------


def load_manifest(path: str) -> dict:
    """Read + verify a checkpoint manifest.  New files are
    {"crc", "m"} with the crc over the sorted-key serialization of the
    body; legacy (pre-integrity) files load unverified."""
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptionError(f"manifest unreadable: {path} ({e})",
                              kind="manifest", path=path) from e
    if not isinstance(d, dict):
        raise CorruptionError(f"manifest malformed: {path}",
                              kind="manifest", path=path)
    if "crc" not in d or "m" not in d:
        return d  # legacy manifest
    inner = json.dumps(d["m"], sort_keys=True)
    if crc64(inner.encode()) != d["crc"]:
        raise CorruptionError(f"manifest digest mismatch: {path}",
                              kind="manifest", path=path)
    return d["m"]


def read_slog(path: str):
    """Yield verified slog ops.  A torn FINAL line (crash mid-append) is
    tolerated and ends the scan, exactly like the WAL torn-tail scan; a
    checksum mismatch on a well-formed record is corruption and raises."""
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        last = i == len(lines) - 1
        try:
            d = json.loads(line)
        except ValueError as e:
            if last and not line.endswith("\n"):
                return  # torn tail: the append never finished
            raise CorruptionError(
                f"slog record {i} unreadable: {path}",
                kind="slog", path=path) from e
        if isinstance(d, dict) and "rec" in d and "crc" in d:
            if crc64(d["rec"].encode()) != d["crc"]:
                raise CorruptionError(
                    f"slog record {i} crc mismatch: {path}",
                    kind="slog", path=path)
            yield json.loads(d["rec"])
        else:
            yield d  # legacy unwrapped record


def quarantine_file(path: str) -> str:
    """Move a corrupt artifact aside (never delete — forensics) under a
    unique .corrupt suffix, retention-capping the directory's older
    quarantines by count/age; -> the quarantine path."""
    qpath = f"{path}.corrupt.{time.time_ns():x}"
    os.replace(path, qpath)
    prune_quarantine(os.path.dirname(qpath))
    return qpath


class StorageEngine:
    def __init__(self, root: str | None = None,
                 corrupt_policy: str = "raise"):
        """``corrupt_policy`` decides what boot does with a segment file
        that fails its checksum: ``"raise"`` (single node — no repair
        source, fail loudly) or ``"quarantine"`` (move the file aside,
        boot without it, and let the scrub plane repair it;
        storage/scrub.py)."""
        self.root = root
        self.corrupt_policy = corrupt_policy
        self.tables: dict[str, TableStore] = {}
        self.meta: dict = {}  # checkpointed runtime meta (wal replay point…)
        # table -> WAL LSN of the newest TRUNCATE whose slog record this
        # engine has already applied; WAL replay must not re-apply
        # truncate barriers at/below these (they would drop direct-load
        # segments the slog restored AFTER the truncate)
        self.truncate_barriers: dict[str, int] = {}
        # segments quarantined at boot or by the scrubber, pending
        # repair: [{"table", "segment_id", "part", "path"}]
        self.quarantined: list[dict] = []
        # scrub fast path: raw-file crc64 of fully verified segment
        # files (path -> crc); a later round that re-reads identical
        # bytes skips the decode-and-recheck
        self._verified_files: dict[str, int] = {}
        # disk-fault plane hook (net/faults.py FaultPlane or None):
        # consulted around every persistence write so seeded enospc/eio/
        # bitflip/truncate rules can target artifacts by kind
        self.faults = None
        # flush listener (tenant wiring): called AFTER freeze_and_flush
        # with (table, rows still resident in the memtables) so the
        # memstore write-backpressure accounting re-bases when a flush
        # clears pressure (server/admission.py::MemstoreThrottle)
        self.flush_listener = None
        self._lock = threading.RLock()
        self._slog_f = None
        # segments installed in memory whose durable save (or slog
        # publish) failed typed (DiskFull/DiskIOError): memory keeps
        # serving them, and every flush/compact/checkpoint entry point
        # re-attempts the persist FIRST — a manifest must never
        # reference a segment file that does not exist on disk
        self._pending_segs: list[tuple[str, object, dict]] = []
        # multi-node hook: logical DDL ops also replicate through the
        # tenant's log stream (net/node.py wires this; followers apply
        # via _replay) — physical segment ops stay node-local
        self.ddl_wal_cb = None
        if root is not None:
            os.makedirs(os.path.join(root, "segments"), exist_ok=True)
            self._open_or_recover()

    # ------------------------------------------------------------------
    # metadata persistence (slog + checkpoint)
    # ------------------------------------------------------------------
    def _slog_path(self):
        return os.path.join(self.root, "slog.jsonl")

    def _manifest_path(self):
        return os.path.join(self.root, "manifest.json")

    def _log_meta(self, op: dict):
        if self.ddl_wal_cb is not None:
            self.ddl_wal_cb(op)
        if self.root is None:
            return
        if self._slog_f is None:
            self._slog_f = open(self._slog_path(), "a")
        # each record ships as {"crc", "rec"} with the crc computed over
        # the EXACT serialized op string — replay verifies before apply
        # (≙ slog entry checksums)
        rec = json.dumps(op)
        self._slog_f.flush()
        pre_off = os.path.getsize(self._slog_path())
        try:
            if self.faults is not None:
                self.faults.check_write("slog", self._slog_path())
            self._slog_f.write(json.dumps(
                {"crc": crc64(rec.encode()), "rec": rec}) + "\n")
            self._slog_f.flush()
            os.fsync(self._slog_f.fileno())
        except OSError as exc:
            # crash-safe unwind: truncate the line back so the slog
            # never carries a torn record (replay would reject it by
            # crc, but the NEXT append would land mid-line)
            self._unwind_slog(pre_off)
            raise wrap_disk_error(exc, "slog append") from exc
        self._disk_fault("slog", self._slog_path())

    def log_sequence(self, name: str, state: dict | None):
        """Slog a sequence's definition and high-water mark (None: the
        sequence was dropped); replay restores ``meta["sequences"]``."""
        with self._lock:
            self._log_meta({"op": "sequence", "name": name,
                            "state": state})

    def _unwind_slog(self, pre_off: int):
        """Truncate the slog back to its pre-append offset after a
        failed write (the buffered handle is poisoned — reopen)."""
        try:
            if self._slog_f is not None:
                self._slog_f.close()
        except OSError:
            pass
        self._slog_f = None
        try:
            with open(self._slog_path(), "a") as f:
                f.truncate(pre_off)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            log.warning("slog unwind to offset %d failed", pre_off)

    def _flush_pending_locked(self):
        """Re-persist segments whose earlier save failed (disk
        pressure): save is an idempotent overwrite, so a seg whose file
        landed but whose slog record didn't simply saves again.  Raises
        typed when the disk is still failing — the caller sheds."""
        while self._pending_segs:
            name, seg, op = self._pending_segs[0]
            self._save_segment(name, seg)
            self._log_meta(op)
            self._pending_segs.pop(0)

    def _persist_segs_locked(self, name: str, segs, make_op):
        """Persist freshly minted in-memory segments; on a typed disk
        failure the unsaved remainder parks in ``_pending_segs`` (the
        next flush/compact/checkpoint re-attempts before anything else
        trusts the segment list)."""
        for i, (part, seg) in enumerate(segs):
            op = make_op(part, seg, i)
            try:
                self._save_segment(name, seg)
                self._log_meta(op)
            except Exception:
                self._pending_segs.append((name, seg, op))
                for j, (p2, s2) in enumerate(segs[i + 1:], start=i + 1):
                    self._pending_segs.append(
                        (name, s2, make_op(p2, s2, j)))
                raise

    def _disk_fault(self, kind: str, path: str):
        """Consult the disk-fault plane after a persistence write (no-op
        unless a caller armed bitflip/truncate rules)."""
        if self.faults is not None:
            self.faults.act_disk(kind, path)

    def checkpoint(self):
        """Write an atomic manifest and truncate the slog
        (≙ tenant meta checkpoint advancing the slog recycle point)."""
        if self.root is None:
            return
        with self._lock:
            # a manifest must never reference a segment whose file is
            # missing (an earlier save failed under disk pressure)
            self._flush_pending_locked()
            m = {"tables": {}, "meta": self.meta}
            for name, ts in self.tables.items():
                m["tables"][name] = {
                    "columns": [[c.name, c.dtype.kind.value,
                                 c.dtype.precision, c.dtype.scale,
                                 c.nullable] for c in ts.tdef.columns],
                    "primary_key": ts.tdef.primary_key,
                    "partition": (list(ts.tdef.partition)
                                  if ts.tdef.partition else None),
                    "auto_increment": list(ts.tdef.auto_increment_cols),
                    "indexes": [[ix.name, list(ix.columns), ix.unique]
                                for ix in ts.tdef.indexes],
                    "aux_indexes": {n: {k: v for k, v in spec.items()
                                        if k != "runtime"}
                                    for n, spec in
                                    ts.tdef.aux_indexes.items()},
                    "segments": [[s.segment_id, s.level, part]
                                 for s, part in
                                 ts.tablet.segment_locations()],
                }
            # checkpoint digest: the manifest body travels beside a crc
            # over its canonical (sorted-key) serialization; boot
            # verifies before trusting the table/segment list
            inner = json.dumps(m, sort_keys=True)
            tmp = self._manifest_path() + ".tmp"
            try:
                if self.faults is not None:
                    self.faults.check_write("manifest",
                                            self._manifest_path())
                with open(tmp, "w") as f:
                    json.dump({"crc": crc64(inner.encode()), "m": m}, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._manifest_path())
            except OSError as exc:
                # the previous manifest generation is still intact (the
                # tmp never published) — drop the partial tmp and raise
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                # typed so the checkpoint caller sheds, not crashes
                raise wrap_disk_error(exc, "manifest checkpoint") from exc
            self._disk_fault("manifest", self._manifest_path())
            if self._slog_f:
                self._slog_f.close()
                self._slog_f = None
            # reset (not recreate) the slog: append-mode + truncate keeps
            # this an in-place recycle of an existing artifact rather
            # than an unsynced create of a new generation
            with open(self._slog_path(), "a") as f:
                f.truncate(0)

    def _open_or_recover(self):
        mpath = self._manifest_path()
        if os.path.exists(mpath):
            m = load_manifest(mpath)
            self.meta = m.get("meta", {})
            for name, t in m["tables"].items():
                cols = [ColumnDef(n, SqlType(TypeKind(k), p, s), nl)
                        for n, k, p, s, nl in t["columns"]]
                part = t.get("partition")
                tdef = TableDef(name, cols, primary_key=t["primary_key"],
                                partition=tuple(part) if part else None,
                                auto_increment_cols=t.get("auto_increment",
                                                          []))
                self._install_table(tdef, log=False)
                ts = self.tables[name]
                for iname, icols, iuniq in t.get("indexes", []):
                    ts.tdef.indexes.append(IndexDef(
                        iname, name, list(icols), iuniq,
                        self.index_storage_name(name, iname)))
                ts.tdef.aux_indexes.update(t.get("aux_indexes", {}))
                for entry in t["segments"]:
                    seg_id, level = entry[0], entry[1]
                    part_idx = entry[2] if len(entry) > 2 else None
                    path = self._segment_file(name, seg_id)
                    if os.path.exists(path):
                        self._load_or_quarantine(name, seg_id, part_idx,
                                                 path)
                ts.tdef.row_count = ts.tablet.row_count_estimate()
        # replay metadata ops logged after the checkpoint (each record
        # crc-verified; a torn FINAL line is a crash artifact and
        # truncates like a torn WAL tail, a bad crc anywhere is
        # corruption and raises)
        if os.path.exists(self._slog_path()):
            for op in read_slog(self._slog_path()):
                self._replay(op)

    def _load_or_quarantine(self, table: str, seg_id: int, part_idx,
                            path: str):
        """Boot-time segment load honoring ``corrupt_policy``: a file
        failing its checksum either fails the boot loudly or moves
        aside so the scrub plane can repair it."""
        ts = self.tables[table]
        try:
            ts.tablet.add_segment(Segment.load(path), part_idx)
        except CorruptionError:
            if self.corrupt_policy != "quarantine":
                raise
            qpath = quarantine_file(path)
            with self._lock:  # reentrant: boot/replay callers hold it
                self.quarantined.append(
                    {"table": table, "segment_id": seg_id,
                     "part": part_idx, "path": qpath})

    def _replay(self, op: dict):
        # boot-time today, but WAL catch-up may replay on a live engine;
        # holding the (reentrant) engine lock makes either safe
        with self._lock:
            self._replay_locked(op)

    def _replay_locked(self, op: dict):
        kind = op["op"]
        if kind == "create_table":
            cols = [ColumnDef(n, SqlType(TypeKind(k), p, s), nl)
                    for n, k, p, s, nl in op["columns"]]
            part = op.get("partition")
            self._install_table(
                TableDef(op["name"], cols, primary_key=op["primary_key"],
                         partition=tuple(part) if part else None,
                         auto_increment_cols=op.get("auto_increment", [])),
                log=False)
        elif kind == "drop_table":
            self.tables.pop(op["name"], None)
        elif kind == "truncate":
            if op["table"] in self.tables:
                self.truncate_table(op["table"], log=False)
            self.truncate_barriers[op["table"]] = max(
                self.truncate_barriers.get(op["table"], 0),
                op.get("wal_lsn", 0))
        elif kind == "create_index":
            ts = self.tables.get(op["table"])
            if ts is not None and not any(ix.name == op["name"]
                                          for ix in ts.tdef.indexes):
                ts.tdef.indexes.append(IndexDef(
                    op["name"], op["table"], list(op["columns"]),
                    op["unique"],
                    self.index_storage_name(op["table"], op["name"])))
        elif kind == "drop_index":
            ts = self.tables.get(op["table"])
            if ts is not None:
                ts.tdef.indexes = [ix for ix in ts.tdef.indexes
                                   if ix.name != op["name"]]
        elif kind == "create_view":
            self.meta.setdefault("views", {})[op["name"]] = {
                "sql": op["sql"], "cols": op.get("cols", [])}
        elif kind == "drop_view":
            self.meta.get("views", {}).pop(op["name"], None)
        elif kind == "aux_index":
            ts = self.tables.get(op["table"])
            if ts is not None:
                ts.tdef.aux_indexes[op["name"]] = op["spec"]
        elif kind == "drop_aux_index":
            ts = self.tables.get(op["table"])
            if ts is not None:
                ts.tdef.aux_indexes.pop(op["name"], None)
        elif kind == "add_segment":
            ts = self.tables.get(op["table"])
            if ts is not None:
                path = self._segment_file(op["table"], op["segment_id"])
                if os.path.exists(path):
                    self._load_or_quarantine(op["table"],
                                             op["segment_id"],
                                             op.get("part"), path)
        elif kind == "replace_segments":
            ts = self.tables.get(op["table"])
            if ts is not None:
                ts.tablet.remove_segments(op["removed"])
                path = self._segment_file(op["table"], op["segment_id"])
                if os.path.exists(path):
                    self._load_or_quarantine(op["table"],
                                             op["segment_id"],
                                             op.get("part"), path)
        elif kind == "repair_segments":
            ts = self.tables.get(op["table"])
            if ts is not None:
                ts.tablet.remove_segments(op["removed"])
                for sid, _level, part in op["installed"]:
                    path = self._segment_file(op["table"], sid)
                    if os.path.exists(path):
                        self._load_or_quarantine(op["table"], sid, part,
                                                 path)
        elif kind == "sequence":
            seqs = self.meta.setdefault("sequences", {})
            if op["state"] is None:
                seqs.pop(op["name"], None)
            else:
                seqs[op["name"]] = op["state"]
        elif kind == "alter_add":
            n, k, p, s, nl = op["column"]
            if op["table"] in self.tables:
                self.alter_table(op["table"], "add_column",
                                 (n, SqlType(TypeKind(k), p, s), nl),
                                 log=False)
        elif kind == "alter_drop":
            if op["table"] in self.tables:
                try:
                    self.alter_table(op["table"], "drop_column",
                                     op["column"], log=False)
                except KeyError:
                    pass

    def _segment_file(self, table: str, seg_id: int) -> str:
        return os.path.join(self.root, "segments", f"{table}_{seg_id}.npz")

    def _save_segment(self, table: str, seg) -> str:
        """Persist one segment + consult the disk-fault plane (the one
        place segment bytes hit disk, so bitflip rules by kind cover
        every flush/compaction/load path)."""
        path = self._segment_file(table, seg.segment_id)
        try:
            if self.faults is not None:
                self.faults.check_write("segment", path)
            seg.save(path)
        except OSError as exc:
            # seg.save stages into path+".tmp" and publishes by rename:
            # on failure the current generation (if any) is untouched —
            # clean the partial tmp and surface the typed plane error
            try:
                os.remove(path + ".tmp")
            except OSError:
                pass
            raise wrap_disk_error(exc, f"segment flush {table}") from exc
        self._disk_fault("segment", path)
        return path

    # ------------------------------------------------------------------
    # DDL / load
    # ------------------------------------------------------------------
    def _install_table(self, tdef: TableDef, log=True):
        with self._lock:  # reentrant: callers may already hold it
            self._install_table_locked(tdef, log)

    def _install_table_locked(self, tdef: TableDef, log=True):
        types = {c.name: c.dtype for c in tdef.columns}
        columns = list(tdef.column_names)
        key_cols = list(tdef.primary_key)
        if not key_cols:
            # keyless tables get a hidden monotonically assigned rowid so
            # UPDATE/DELETE can address rows (≙ hidden pk in heap tables)
            columns.append("__rowid__")
            types["__rowid__"] = SqlType.int_()
            key_cols = ["__rowid__"]
        if tdef.partition is not None:
            part_col, bounds = tdef.partition
            tablet = PartitionedTablet(len(self.tables) + 1, columns,
                                       types, key_cols, part_col,
                                       list(bounds))
        else:
            tablet = Tablet(len(self.tables) + 1, columns, types, key_cols)
        self.tables[tdef.name] = TableStore(tdef, tablet)
        if log:
            try:
                self._log_meta({
                    "op": "create_table", "name": tdef.name,
                    "columns": [[c.name, c.dtype.kind.value,
                                 c.dtype.precision,
                                 c.dtype.scale, c.nullable]
                                for c in tdef.columns],
                    "primary_key": tdef.primary_key,
                    "partition": (list(tdef.partition)
                                  if tdef.partition else None),
                    "auto_increment": list(tdef.auto_increment_cols),
                })
            except Exception:
                # unwind the in-memory install: a table that never made
                # the slog must not exist (it would vanish on restart —
                # and block a retry of the same CREATE)
                self.tables.pop(tdef.name, None)
                raise

    def create_table(self, tdef: TableDef):
        with self._lock:
            if tdef.name in self.tables:
                raise ValueError(f"table {tdef.name} exists")
            if tdef.partition is not None and tdef.primary_key and \
                    tdef.partition[0] not in tdef.primary_key:
                # MySQL/OceanBase rule: every unique key (incl. the PK)
                # must contain all partitioning columns — otherwise
                # uniqueness could only be checked across partitions
                raise ValueError(
                    "a PRIMARY KEY must include all columns in the "
                    "table's partitioning function")
            self._install_table(tdef)

    def alter_table(self, name: str, action: str, column, log=True):
        """Online schema change: ADD COLUMN (old segments serve NULLs for
        it — no rewrite) / DROP COLUMN (segments holding the column are
        rewritten without it).  ≙ the instant-DDL subset of ObDDLService
        column changes."""
        with self._lock:
            ts = self.tables[name]
            tdef = ts.tdef
            tab = ts.tablet
            tablets = getattr(tab, "partitions", [tab])
            if action == "add_column":
                cname, dtype, nullable = column
                if any(c.name == cname for c in tdef.columns):
                    raise ValueError(f"column {cname!r} exists")
                tdef.columns.append(ColumnDef(cname, dtype, nullable))
                for t in tablets:
                    t.columns.append(cname)
                    t.types[cname] = dtype
                if hasattr(tab, "part_col"):
                    tab.columns.append(cname)
                    tab.types[cname] = dtype
                if log:
                    self._log_meta({
                        "op": "alter_add", "table": name, "column":
                        [cname, dtype.kind.value, dtype.precision,
                         dtype.scale, nullable]})
            elif action == "drop_column":
                cname = column
                if cname in tdef.primary_key:
                    raise ValueError("cannot drop a primary-key column")
                for ix in tdef.indexes:
                    if cname in ix.columns:
                        raise ValueError(
                            f"cannot drop column {cname!r}: used by "
                            f"index {ix.name} (drop the index first)")
                if getattr(tab, "part_col", None) == cname:
                    raise ValueError("cannot drop the partition column")
                if not any(c.name == cname for c in tdef.columns):
                    raise KeyError(f"unknown column {cname!r}")
                tdef.columns = [c for c in tdef.columns if c.name != cname]
                for t in tablets:
                    if cname in t.columns:
                        t.columns.remove(cname)
                    t.types.pop(cname, None)
                if hasattr(tab, "part_col"):
                    if cname in tab.columns:
                        tab.columns.remove(cname)
                    tab.types.pop(cname, None)
                # purge stored values so a later ADD COLUMN of the same
                # name cannot resurrect them (no column-identity ids yet)
                for t in tablets:
                    for mt in [t.active] + t.frozen:
                        with mt._lock:
                            for head in mt._rows.values():
                                v = head
                                while v is not None:
                                    v.values.pop(cname, None)
                                    v = v.prev
                    for i, seg in enumerate(list(t.segments)):
                        if cname not in seg.columns:
                            continue
                        a, vv = seg.decode()
                        a.pop(cname, None)
                        vv.pop(cname, None)
                        stypes = {k: v for k, v in seg.types.items()
                                  if k != cname}
                        new = Segment.build(
                            seg.segment_id, seg.level, a, stypes,
                            {k: x for k, x in vv.items() if x is not None},
                            min_version=seg.min_version,
                            max_version=seg.max_version)
                        t.segments[i] = new
                        if self.root is not None:
                            self._save_segment(name, new)
                if log:
                    self._log_meta({"op": "alter_drop", "table": name,
                                    "column": cname})
            else:
                raise ValueError(action)
            for t in tablets:
                t.data_version += 1

    # ------------------------------------------------------------------
    # secondary indexes (≙ index tables, src/share/schema index DDL +
    # src/storage/ddl index build tasks)
    # ------------------------------------------------------------------
    @staticmethod
    def index_storage_name(table: str, iname: str) -> str:
        return f"__idx__{table}__{iname}"

    def create_index(self, table: str, iname: str, columns: list[str],
                     unique: bool = False, backfill_version: int = 0,
                     drain=None):
        """CREATE INDEX: install the index table (key = index columns +
        primary key columns) and backfill it from the base table's
        current snapshot as one sorted baseline segment (≙ the DDL
        service's index build scanning the base and writing the index
        SSTable, src/storage/ddl/ob_ddl_redo_log_writer.h path).

        Ordering against concurrent DML (≙ the online-DDL write fence):
        1. install the store table + IndexDef — from here every NEW
           write runs index maintenance;
        2. ``drain()`` (supplied by the session layer) waits out
           transactions live before step 1 — their earlier writes were
           never maintained and must commit/abort first;
        3. backfill from a post-drain snapshot — covers everything those
           transactions committed; entries double-written by step-1
           maintenance dedup via newest-wins on the identical entry key.
        Any failure (unique violation, drain timeout) drops the index
        again, leaving no trace."""
        with self._lock:
            ts = self.tables[table]
            if any(ix.name == iname for ix in ts.tdef.indexes):
                raise ValueError(f"index {iname} exists on {table}")
            for c in columns:
                ts.tdef.column(c)  # validates existence
            store = self.index_storage_name(table, iname)
            if store in self.tables:
                raise ValueError(f"index table {store} exists")
            pk = list(ts.tdef.primary_key) or ["__rowid__"]
            key_cols = list(columns) + [k for k in pk if k not in columns]
            base_types = ts.tablet.types
            cols = [ColumnDef(c, base_types[c]) for c in key_cols]
            idx = IndexDef(iname, table, list(columns), unique, store)
            itdef = TableDef(store, cols, primary_key=key_cols)
            self._install_table(itdef)
            ts.tdef.indexes.append(idx)
            self._log_meta({"op": "create_index", "table": table,
                            "name": iname, "columns": list(columns),
                            "unique": unique})
        try:
            if drain is not None:
                drain()
            with self._lock:
                arrays, valids = ts.tablet.snapshot_arrays(
                    backfill_version or 2**62)
                entry = {c: arrays[c] for c in key_cols if c in arrays}
                ev = {c: valids[c] for c in key_cols
                      if valids.get(c) is not None}
                n = len(next(iter(entry.values()))) if entry else 0
                if unique and n:
                    self._check_unique_batch(idx, entry, ev, n)
                # the backfill is a free NDV sample for the indexed
                # columns (feeds access-path cardinality estimates)
                for c in columns:
                    if c in entry and n:
                        ts.tdef.ndv[c] = max(1, len(np.unique(
                            entry[c].astype("U")
                            if entry[c].dtype == object else entry[c])))
                if n:
                    self.bulk_load(store, entry, ev or None,
                                   version=max(1, backfill_version))
        except Exception:
            self.drop_index(table, iname)
            raise
        return idx

    @staticmethod
    def _check_unique_batch(idx, entry, ev, n):
        """Reject duplicate index keys among non-NULL entries (MySQL
        semantics: rows with any NULL index column never conflict)."""
        live = np.ones(n, dtype=bool)
        for c in idx.columns:
            if ev.get(c) is not None:
                live &= ev[c]
        keys = [np.asarray(entry[c])[live].astype("U")
                if entry[c].dtype == object else entry[c][live]
                for c in idx.columns]
        if not keys or not len(keys[0]):
            return
        order = np.lexsort(keys[::-1])
        dup = np.ones(len(order), dtype=bool)
        for k in keys:
            s = k[order]
            dup[1:] &= s[1:] == s[:-1]
        dup[0] = False
        if dup.any():
            i = int(np.nonzero(dup)[0][0])
            vals = tuple(k[order][i] for k in keys)
            raise DuplicateKey(
                f"duplicate entry {vals} for unique index {idx.name}")

    @staticmethod
    def _check_unique_existing(ix, itab, entry, ev, n):
        """Direct-load unique enforcement against COMMITTED index rows:
        existing live entries inside the batch's value envelope are
        compared tuple-wise; a match whose pk suffix differs from every
        batch row carrying that value is a duplicate.  (The tx write
        path does its own per-row check; this covers LOAD DATA/CTAS.)"""
        if itab.row_count_estimate() == 0:
            return
        live = np.ones(n, dtype=bool)
        for c in ix.columns:
            if ev.get(c) is not None:
                live &= ev[c]
        if not live.any():
            return
        env = {}
        for c in ix.columns:
            a = entry[c][live]
            s = a.astype("U") if a.dtype == object else a
            env[c] = (a[np.argmin(s)] if a.dtype == object else s.min(),
                      a[np.argmax(s)] if a.dtype == object else s.max())
        ikey_cols = itab.key_cols
        ex, exv = range_rows(itab, env, 2**62, 0, columns=list(ikey_cols))
        m = len(next(iter(ex.values()))) if ex else 0
        if m == 0:
            return
        n_ix = len(ix.columns)
        batch_pairs = set()
        idxs = np.nonzero(live)[0]
        for i in idxs:
            val = tuple(entry[c][i] for c in ix.columns)
            pkv = tuple(entry[c][i] for c in ikey_cols[n_ix:])
            batch_pairs.add((val, pkv))
        batch_vals = {v for v, _ in batch_pairs}
        for j in range(m):
            if any(exv.get(c) is not None and not exv[c][j]
                   for c in ix.columns):
                continue  # NULL entries never conflict
            val = tuple(ex[c][j].item() if hasattr(ex[c][j], "item")
                        else ex[c][j] for c in ix.columns)
            if val not in batch_vals:
                continue
            pkv = tuple(ex[c][j].item() if hasattr(ex[c][j], "item")
                        else ex[c][j] for c in ikey_cols[n_ix:])
            if (val, pkv) not in batch_pairs:
                raise DuplicateKey(
                    f"duplicate entry {val} for unique index {ix.name} "
                    f"(conflicts with existing row)")

    def drop_index(self, table: str, iname: str, log=True):
        with self._lock:
            ts = self.tables[table]
            keep = [ix for ix in ts.tdef.indexes if ix.name != iname]
            if len(keep) == len(ts.tdef.indexes):
                raise KeyError(f"no index {iname} on {table}")
            dropped = next(ix for ix in ts.tdef.indexes
                           if ix.name == iname)
            ts.tdef.indexes = keep
            if log:
                self._log_meta({"op": "drop_index", "table": table,
                                "name": iname})
            # drop the storage table THROUGH drop_table so the slog also
            # records it — replay must not resurrect an orphan index
            # table that would block re-creating the index
            if dropped.storage_table in self.tables:
                self.drop_table(dropped.storage_table)

    def truncate_table(self, name: str, log=True, wal_lsn: int = 0):
        """Drop all data, keep the schema: reinstall a fresh tablet
        (segments unlinked; ≙ TRUNCATE as fast DDL, not row deletes).

        ``wal_lsn`` is the LSN of the matching WAL truncate record; it is
        persisted in the slog record so recovery can fence WAL replay
        against engine state (the two logs share one order)."""
        with self._lock:
            ts = self.tables[name]
            tdef = ts.tdef
            del self.tables[name]
            self._install_table(tdef, log=False)
            self.tables[name].tdef.row_count = 0
            if wal_lsn:
                self.truncate_barriers[name] = max(
                    self.truncate_barriers.get(name, 0), wal_lsn)
            if log:
                self._log_meta({"op": "truncate", "table": name,
                                "wal_lsn": wal_lsn})
            # secondary indexes empty together with their base table
            for ix in tdef.indexes:
                if ix.storage_table in self.tables:
                    self.truncate_table(ix.storage_table, log=log,
                                        wal_lsn=wal_lsn)

    def reset_memtables(self, name: str):
        """Discard memtable state only, keeping segments — used by WAL
        replay when a TRUNCATE barrier was already applied via the slog
        (the slog-restored post-truncate segments must survive)."""
        with self._lock:
            ts = self.tables.get(name)
            if ts is None:
                return
            tab = ts.tablet
            for t in getattr(tab, "partitions", [tab]):
                t.active = MemTable(next(t._next_mt))
                t.frozen = []
                t.data_version += 1

    def drop_table(self, name: str):
        with self._lock:
            ts = self.tables.pop(name, None)
            self._log_meta({"op": "drop_table", "name": name})
            if ts is not None:
                for ix in ts.tdef.indexes:
                    if ix.storage_table in self.tables:
                        self.drop_table(ix.storage_table)

    def bulk_load(self, name: str, arrays: dict, valids: dict | None = None,
                  version: int = 1):
        """Direct load: host arrays -> L2 baseline segment, bypassing the
        memtable (≙ src/storage/direct_load)."""
        with self._lock:
            ts = self.tables[name]
            if "__rowid__" in ts.tablet.types and "__rowid__" not in arrays:
                n = len(next(iter(arrays.values()))) if arrays else 0
                base = ts.tablet.next_rowid(n)
                arrays = dict(arrays)
                arrays["__rowid__"] = np.arange(base, base + n,
                                                dtype=np.int64)
            if isinstance(ts.tablet, PartitionedTablet):
                parts = ts.tablet.split_arrays_by_partition(arrays)
                targets = [(i, pa,
                            {k: v[sel] for k, v in (valids or {}).items()
                             if v is not None})
                           for i, pa, sel in parts]
            else:
                targets = [(None, arrays, valids or {})]
            for part_idx, pa, pv in targets:
                tab = (ts.tablet.partitions[part_idx]
                       if part_idx is not None else ts.tablet)
                if tab.key_cols != ["__rowid__"]:
                    pa, pv = sort_rows_by_keys(pa, dict(pv or {}),
                                               tab.key_cols)
                seg = Segment.build(
                    next(tab._next_seg), 2, pa, ts.tablet.types,
                    pv or None, min_version=version, max_version=version)
                ts.tablet.add_segment(seg, part_idx)
                if self.root is not None:
                    op = {"op": "add_segment", "table": name,
                          "segment_id": seg.segment_id, "part": part_idx}
                    try:
                        self._save_segment(name, seg)
                        self._log_meta(op)
                    except Exception:
                        # memory serves the loaded seg; the persist
                        # re-attempts at the next flush/checkpoint
                        self._pending_segs.append((name, seg, op))
                        raise
            ts.tdef.row_count = ts.tablet.row_count_estimate()
            # maintain secondary indexes: the loaded rows' index entries
            # load the same way (sorted baseline segment per index).
            # Unique checks here are batch-local; the tx-plane write path
            # performs the full existing-row check.
            n = len(next(iter(arrays.values()))) if arrays else 0
            for ix in ts.tdef.indexes:
                istore = self.tables[ix.storage_table]
                ikey = istore.tablet.key_cols
                entry = {}
                ev = {}
                for c in ikey:
                    if c in arrays:
                        entry[c] = arrays[c]
                        if (valids or {}).get(c) is not None:
                            ev[c] = valids[c]
                        continue
                    # a load may omit a nullable indexed column: its
                    # entries are NULL (never silently dropped — that
                    # would collapse distinct rows in the index)
                    if c in (ts.tdef.primary_key or ["__rowid__"]):
                        raise ValueError(
                            f"bulk load is missing index key column "
                            f"{c!r} for index {ix.name}")
                    t = istore.tablet.types[c]
                    entry[c] = (np.array([""] * n, dtype=object)
                                if t.is_string
                                else np.zeros(n, dtype=t.np_dtype))
                    ev[c] = np.zeros(n, dtype=bool)
                if ix.unique and n:
                    self._check_unique_batch(ix, entry, ev, n)
                    self._check_unique_existing(ix, istore.tablet,
                                                entry, ev, n)
                if n:
                    self.bulk_load(ix.storage_table, entry, ev or None,
                                   version=version)

    # ------------------------------------------------------------------
    # compaction driving (≙ tenant tablet scheduler ticks)
    # ------------------------------------------------------------------
    @staticmethod
    def _new_segs(res):
        """Normalize compact results: Segment | [(part, Segment)] | None."""
        if res is None:
            return []
        if isinstance(res, Segment):
            return [(None, res)]
        return list(res)

    def freeze_and_flush(self, name: str, snapshot: int):
        ERRSIM.hit("storage.flush")
        with self._lock:
            self._flush_pending_locked()
            ts = self.tables[name]
            ts.tablet.freeze()
            segs = self._new_segs(ts.tablet.mini_compact(snapshot))
            if self.root is not None:
                self._persist_segs_locked(
                    name, segs,
                    lambda part, seg, _i: {
                        "op": "add_segment", "table": name,
                        "segment_id": seg.segment_id, "part": part})
            tab = ts.tablet
            remaining = sum(
                len(t.active) + sum(len(f) for f in t.frozen)
                for t in getattr(tab, "partitions", None) or [tab])
        listener = self.flush_listener
        if listener is not None:
            # outside the engine lock: the throttle takes its own lock
            listener(name, remaining)
        return segs[0][1] if segs else None

    def _compact(self, name: str, level_filter, method: str):
        with self._lock:
            self._flush_pending_locked()
            ts = self.tables[name]
            old_ids = [s.segment_id for s in ts.tablet.segments
                       if level_filter(s.level)]
            segs = self._new_segs(getattr(ts.tablet, method)())
            if segs and self.root is not None:
                # only segments ACTUALLY gone may be logged as removed — a
                # partition that declined to compact keeps its segments
                after = {s.segment_id for s in ts.tablet.segments}
                removed = [i for i in old_ids if i not in after]
                self._persist_segs_locked(
                    name, segs,
                    lambda part, seg, i: {
                        "op": "replace_segments", "table": name,
                        "segment_id": seg.segment_id, "part": part,
                        "removed": removed if i == 0 else []})
            return segs[0][1] if segs else None

    def minor_compact(self, name: str):
        return self._compact(name, lambda lv: lv == 0, "minor_compact")

    def major_compact(self, name: str):
        return self._compact(name, lambda lv: True, "major_compact")

    # ------------------------------------------------------------------
    # scrub plane hooks (storage/scrub.py drives these; ≙ the medium
    # checker re-reading macro blocks + replica checksum repair)
    # ------------------------------------------------------------------
    def scrub_verify_table(self, table: str) -> dict:
        """Re-read every persisted segment of ``table`` FROM DISK and
        verify it (the in-memory copy may be healthy while the disk
        bytes rot — exactly the failure scrub exists to catch).  A
        corrupt file is quarantined and recorded in ``quarantined``;
        the in-memory segment keeps serving until repair swaps the set,
        so no read ever sees a missing-row window.

        Cost shape: the FIRST verification of a file decodes and
        re-checks every chunk/footer crc, then caches the raw file's
        crc64; later rounds re-read the bytes (rot detection demands
        it) but only crc the raw stream — full coverage at raw-IO cost,
        which is what makes a continuous scrub cadence affordable.
        -> {"checked", "bytes", "corrupt": [segment_id, ...]}"""
        with self._lock:
            ts = self.tables.get(table)
            if ts is None or self.root is None:
                return {"checked": 0, "bytes": 0, "corrupt": []}
            locs = [(s.segment_id, part)
                    for s, part in ts.tablet.segment_locations()]
        checked, nbytes, corrupt = 0, 0, []
        for seg_id, part in locs:
            path = self._segment_file(table, seg_id)
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except OSError:
                continue  # never persisted / already quarantined
            checked += 1
            nbytes += len(raw)
            raw_crc = crc64(raw)
            with self._lock:
                known = self._verified_files.get(path)
            if known == raw_crc:
                continue  # bytes unchanged since full verification
            try:
                Segment.load(path)  # verify=True re-checks every crc
                with self._lock:
                    self._verified_files[path] = raw_crc
            except CorruptionError:
                with self._lock:
                    self._verified_files.pop(path, None)
                    if not os.path.exists(path):
                        continue  # repaired/quarantined concurrently
                    qpath = quarantine_file(path)
                    self.quarantined.append(
                        {"table": table, "segment_id": seg_id,
                         "part": part, "path": qpath})
                corrupt.append(seg_id)
        return {"checked": checked, "bytes": nbytes, "corrupt": corrupt}

    def rewrite_segment_from_memory(self, table: str, seg_id: int) -> bool:
        """Peer-less repair: if the in-memory copy of a quarantined
        segment is still resident (boot loaded it before the disk bytes
        rotted), re-persist it from the engine's host segment arrays.
        The cluster path prefers a peer refetch (storage/scrub.py) —
        this is the single-node fallback."""
        with self._lock:
            ts = self.tables.get(table)
            if ts is None or self.root is None:
                return False
            for seg, _part in ts.tablet.segment_locations():
                if seg.segment_id == seg_id:
                    self._save_segment(table, seg)
                    self.quarantined = [
                        q for q in self.quarantined
                        if not (q["table"] == table
                                and q["segment_id"] == seg_id)]
                    return True
            return False

    def repair_table_segments(self, table: str,
                              installed: list[dict]) -> dict:
        """Swap ``table``'s whole persisted+resident segment set for a
        peer baseline already staged and VERIFIED on local disk
        (storage/scrub.py downloads + checksums before calling).

        ``installed``: [{"segment_id", "level", "part", "src"}] where
        ``src`` is the staged file path.  Installed segments are
        re-minted under FRESH local ids — peer ids live in the peer's
        id space, and reusing them here could collide with local
        history, breaking the segment-files-are-write-once invariant
        incremental backups rely on.  Crash-safe order: files land
        under their new names first, then ONE slog record publishes
        the swap, then memory swaps and replaced files are deleted —
        a crash between any two steps boots to either the old set
        (fresh files orphaned) or the new set (replay applies the
        record)."""
        with self._lock:
            ts = self.tables[table]
            tab = ts.tablet
            old_ids = [s.segment_id for s, _ in tab.segment_locations()]
            segs = []
            for ent in installed:
                seg = Segment.load(ent["src"])
                parts = getattr(tab, "partitions", None)
                alloc = (parts[0] if parts else tab)._next_seg
                seg.segment_id = next(alloc)
                self._save_segment(table, seg)
                os.remove(ent["src"])
                segs.append((seg, ent.get("part")))
            self._log_meta({
                "op": "repair_segments", "table": table,
                "removed": old_ids,
                "installed": [[s.segment_id, s.level, p]
                              for s, p in segs]})
            tab.remove_segments(old_ids)
            for s, p in segs:
                tab.add_segment(s, p)
            for sid in old_ids:
                p = self._segment_file(table, sid)
                if os.path.exists(p):
                    os.remove(p)
                self._verified_files.pop(p, None)
            ts.tdef.row_count = tab.row_count_estimate()
            self.quarantined = [q for q in self.quarantined
                                if q["table"] != table]
            return {"removed": len(old_ids), "installed": len(segs)}


class StorageCatalog(Catalog):
    """Catalog backed by the storage engine: table_data() materializes a
    snapshot Relation from the tablet LSM on the catalog's device, with
    caching keyed on the tablet's data version."""

    def __init__(self, engine: StorageEngine, snapshot_fn=None,
                 config=None, device=None):
        super().__init__(device)
        self.engine = engine
        # snapshot provider (GTS reader); default: latest
        self.snapshot_fn = snapshot_fn or (lambda: 2**62)
        # bucket-policy knobs (enable_shape_buckets & co.) read live from
        # the tenant config when one is attached; defaults otherwise
        self.config = config
        # device-relation cache: decoded device-resident columns behind
        # a byte-bounded LRU (≙ ObKVGlobalCache block cache,
        # src/share/cache/ob_kv_storecache.h:91)
        self._cache = KvCache(limit_bytes=2 << 30, name="relation")
        # surface engine-persisted tables in the catalog
        for name, ts in engine.tables.items():
            self._defs[name] = ts.tdef
        self._load_externals()

    # -- external tables persist with the engine root -------------------
    def _externals_path(self):
        return (os.path.join(self.engine.root, "externals.json")
                if self.engine.root else None)

    def _load_externals(self):
        p = self._externals_path()
        if not p or not os.path.exists(p):
            return
        with open(p) as f:
            for name, e in json.load(f).items():
                cols = [ColumnDef(n, SqlType(TypeKind(k), pr, sc), nl)
                        for n, k, pr, sc, nl in e["columns"]]
                self._externals[name] = {
                    "tdef": TableDef(name, cols),
                    "location": e["location"], "format": e["format"],
                    "delimiter": e["delimiter"], "skip": e["skip"],
                    "cache": None}

    def _persist_externals(self):
        p = self._externals_path()
        if not p:
            return
        out = {}
        with self._lock:
            for name, e in self._externals.items():
                out[name] = {
                    "columns": [[c.name, c.dtype.kind.value,
                                 c.dtype.precision, c.dtype.scale,
                                 c.nullable]
                                for c in e["tdef"].columns],
                    "location": e["location"], "format": e["format"],
                    "delimiter": e["delimiter"], "skip": e["skip"]}
        tmp = p + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(out, f)
            os.replace(tmp, p)
        except OSError as exc:
            # typed like every durable writer (the reference raises the
            # bare OSError here; ROADMAP Queue 3 #21)
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise wrap_disk_error(exc, "externals.json") from exc

    def register_external(self, tdef, location, **kw):
        super().register_external(tdef, location, **kw)
        self._persist_externals()

    # -- views persist in engine meta (slog + manifest) -------------------
    def create_view(self, name, sql, cols=None, or_replace=False):
        with self._lock:
            if self.has_table(name) or name in self._externals:
                raise ValueError(f"table {name} already exists")
            views = self.engine.meta.setdefault("views", {})
            if name in views and not or_replace:
                raise ValueError(f"view {name} already exists")
            views[name] = {"sql": sql, "cols": list(cols or [])}
            self.schema_version += 1
        self.engine._log_meta({"op": "create_view", "name": name,
                               "sql": sql, "cols": list(cols or [])})

    def drop_view(self, name) -> bool:
        with self._lock:
            if self.engine.meta.get("views", {}).pop(name, None) is None:
                return False
            self.schema_version += 1
        self.engine._log_meta({"op": "drop_view", "name": name})
        return True

    def view_def(self, name):
        return self.engine.meta.get("views", {}).get(name)

    def view_names(self):
        return sorted(self.engine.meta.get("views", {}))

    def create_table(self, tdef: TableDef, if_not_exists: bool = False):
        with self._lock:
            # view-collision check inside the locked section (same
            # check-then-act closure as Catalog.create_table)
            if self.view_def(tdef.name) is not None:
                raise ValueError(f"view {tdef.name} already exists")
            if tdef.name in self._defs or tdef.name in self._externals:
                if if_not_exists:
                    return
                raise ValueError(f"table {tdef.name} already exists")
            self.engine.create_table(tdef)
            self._defs[tdef.name] = tdef
            self.schema_version += 1

    def drop_table(self, name: str, if_exists: bool = False):
        with self._lock:
            if name not in self._defs and name not in self.engine.tables:
                if if_exists:
                    return
                raise KeyError(name)
            self.engine.drop_table(name)
            self._defs.pop(name, None)
            self.invalidate(name)
            self.schema_version += 1

    def drop_external(self, name: str) -> bool:
        out = super().drop_external(name)
        if out:
            self._persist_externals()
        return out

    # -- the engine is the source of truth for definitions ---------------
    def table_def(self, name: str):
        with self._lock:
            t = self._transients.get(name)
            if t is not None:
                return t[0]
            e = self._externals.get(name)
            if e is not None:
                return e["tdef"]
            ts = self.engine.tables.get(name)
            if ts is not None:
                self._defs[name] = ts.tdef
                return ts.tdef
            self._defs.pop(name, None)
            raise KeyError(f"unknown table {name}")

    def has_table(self, name: str) -> bool:
        with self._lock:
            return name in self._transients or \
                name in self._externals or name in self.engine.tables

    def tables(self) -> list[str]:
        with self._lock:
            return sorted([n for n in self.engine.tables
                           if not n.startswith("__idx__")]
                          + list(self._externals))

    def load_numpy(self, name, arrays, types=None, primary_key=None,
                   valids=None):
        """Direct load: the arrays become one baseline segment (version
        1, as in the reference); the definition's types and NDVs come
        from the relation ``from_numpy`` builds of them on the catalog's
        device, as the catalog-only ``load_numpy`` computes them."""
        rel = from_numpy(arrays, types=types, valids=valids,
                         device=self.device)
        cols = [ColumnDef(c, rel.columns[c].dtype,
                          nullable=rel.columns[c].valid is not None)
                for c in arrays]
        tdef = TableDef(name, cols, primary_key=primary_key or [],
                        row_count=rel.capacity)
        with self._lock:
            if name not in self.engine.tables:
                self.engine.create_table(tdef)
            # store raw (pre-dict-encode) arrays; strings re-encode on read
            store_arrays = {}
            store_valids = {}
            for c in arrays:
                store_arrays[c] = np.asarray(arrays[c])
                if rel.columns[c].dtype.kind == TypeKind.DATE:
                    store_arrays[c] = store_arrays[c].astype(np.int32)
                elif rel.columns[c].dtype.kind == TypeKind.DECIMAL:
                    store_arrays[c] = store_arrays[c].astype(np.int64)
                if valids and c in valids and valids[c] is not None:
                    store_valids[c] = valids[c]
            self.engine.bulk_load(name, store_arrays, store_valids or None)
            self._defs[name] = self.engine.tables[name].tdef
            for c in cols:
                col = rel.columns[c.name]
                if col.sdict is not None:
                    nd = col.sdict.size
                elif col.dtype.kind == TypeKind.VECTOR:
                    nd = rel.capacity
                else:
                    nd = sampled_ndv(np.asarray(arrays[c.name]),
                                     rel.capacity)
                self._defs[name].ndv[c.name] = nd
            self.schema_version += 1
            self.invalidate(name)

    # -- capacity bucketing (the static-shape policy) --------------------
    def _bucket_policy(self):
        """-> (enabled, floor, growth), read live from the attached
        config so ALTER SYSTEM toggles apply to the next
        materialization."""
        cfg = self.config
        if cfg is None:
            return True, DEFAULT_BUCKET_FLOOR, DEFAULT_BUCKET_GROWTH
        return (bool(cfg["enable_shape_buckets"]),
                int(cfg["shape_bucket_floor"]),
                float(cfg["shape_bucket_growth"]))

    def _bucketed(self, rel):
        """Pad a freshly materialized relation to its capacity bucket
        (dead lanes masked) so every snapshot inside one bucket presents
        the same static shape."""
        enabled, floor, growth = self._bucket_policy()
        if not enabled:
            return rel
        return rel.pad_to(bucket_capacity(rel.capacity, floor, growth))

    def _from_snapshot(self, ts, arrays, valids):
        return self._bucketed(from_numpy(
            arrays, types={c.name: c.dtype for c in ts.tdef.columns},
            valids={k: v for k, v in valids.items() if v is not None},
            device=self.device))

    def table_data(self, name):
        if name in self._externals:
            return self._external_data(name)
        with self._lock:
            t = self._transients.get(name)
            if t is not None:
                return t[1]
            ts = self.engine.tables.get(name)
            if ts is None:
                raise KeyError(f"table {name} has no data")
            ver = ts.tablet.data_version
            hit = self._cache.get(name)
            if hit is not None and hit[0] == ver:
                return hit[1]
            snap = self.snapshot_fn()
            arrays, valids = ts.tablet.snapshot_arrays(snap)
            n = len(next(iter(arrays.values()))) if arrays else 0
            if n == 0:
                # static shapes need capacity >= 1: one all-dead row
                rel = self._empty_rel(ts)
            else:
                rel = self._from_snapshot(ts, arrays, valids)
            # only cache snapshots that cover every persisted segment —
            # a snapshot below a segment's max_version would pin a
            # partial view that later (larger) snapshots must not reuse.
            # The cached value is the bucket-padded relation, so every
            # snapshot read inside the bucket (table_data_at included)
            # reuses one device-resident copy.
            seg_max = max((s.max_version
                           for s, _ in ts.tablet.segment_locations()),
                          default=0)
            if snap >= seg_max:
                self._cache.put(name, (ver, rel),
                                nbytes=relation_bytes(rel))
            # record the LIVE row count, not the padded capacity: the
            # binder's est_rows drives join/groupby capacity budgets and
            # spill decisions, which must not drift with pad lanes
            ts.tdef.row_count = n
            return rel

    def table_data_at(self, name, snapshot: int, tx_id: int = 0):
        """Snapshot read at an explicit version (+ own-tx writes) — the
        read path active transactions use."""
        if name in self._externals:
            return self._external_data(name)
        t = self.transient(name)
        if t is not None:
            return t[1]  # virtual tables are snapshots of their own
        ts = self.engine.tables[name]
        if tx_id == 0 and snapshot >= ts.tablet.max_commit_version():
            # no committed version is newer than the snapshot, so the
            # latest-commit read (which caches its device relation) sees
            # identical data — reuse it instead of re-decoding.  Re-check
            # after materializing: a commit landing mid-read would make
            # the latest view newer than the snapshot.
            rel = self.table_data(name)
            if snapshot >= ts.tablet.max_commit_version():
                return rel
        arrays, valids = ts.tablet.snapshot_arrays(snapshot, tx_id)
        n = len(next(iter(arrays.values()))) if arrays else 0
        if n == 0:
            return self._empty_rel(ts)
        # snapshot reads pad to the SAME bucket ladder
        return self._from_snapshot(ts, arrays, valids)

    def _empty_rel(self, ts):
        arrays, valids = {}, {}
        for c in ts.tdef.columns:
            arrays[c.name] = c.dtype.host_zeros(1)
            valids[c.name] = np.array([False])
        rel = from_numpy(arrays,
                         types={c.name: c.dtype for c in ts.tdef.columns},
                         valids=valids, device=self.device)
        rel = Relation(columns=rel.columns,
                       mask=torch.zeros(1, dtype=torch.bool,
                                        device=self.device))
        # empty tables pad to the floor bucket too
        return self._bucketed(rel)

    def set_data(self, name, rel):
        raise NotImplementedError(
            "StorageCatalog data flows through the engine (DML/bulk_load)")

    def invalidate(self, name: str | None = None):
        """Drop the cached relation of ``name`` (of every table when
        None) and the index sidecars and vector search structures built
        from it."""
        with self._lock:
            self._cache.invalidate(name)
            if name is None:
                self._sidecars.clear()
            else:
                self.drop_sidecars(name)

    def device_bytes(self) -> int:
        """Bytes the cached relations hold."""
        return int(self._cache.stats()["bytes"])
