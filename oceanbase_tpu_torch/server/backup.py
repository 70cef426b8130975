"""Backup service: full + incremental physical backup, WAL archiving,
point-in-time restore.

Reference analog: data backup/restore (src/storage/backup,
src/rootserver/backup) + the log archive service
(src/logservice/archiveservice) feeding PITR
(src/storage/restore).  Model:

- FULL backup     = checkpoint + copy of the data tree + manifest
- INCREMENTAL     = copy of files NEW since the base backup's manifest
  (segment files are immutable once written, so name+size identity is
  sound; manifests/slog/config/WAL always re-copy — they're tiny or
  append-only)
- WAL archive     = copy of the append-only replica logs; re-archiving
  appends only the suffix (≙ archive progress per log stream)
- PITR            = restore chain -> rewrite the WAL keeping commit
  records with version <= the target timestamp (uncommitted/later txs
  never replay) -> boot

Restore = `Database(restored_root)` — recovery IS the restore path.

Port of ``oceanbase_tpu/server/backup.py`` over the port's
``palf/log.py`` (the same WAL layout, recycle base record included), so
a backup chain of either package restores the same way.  A restored or
point-in-time-cut database boots without optimizer statistics: run
ANALYZE on its tables before large in-memory queries.
"""

from __future__ import annotations

import json
import os
import shutil
import time

from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server.diskmgr import (
    DiskFull,
    DiskIOError,
    wrap_disk_error,
)
from oceanbase_tpu_torch.storage.integrity import CorruptionError

MANIFEST = "BACKUP_MANIFEST.json"


def _faults(db):
    """The node's fault plane (net/faults.FaultPlane) when armed —
    backup writes consult it per destination file (kind="backup")."""
    return getattr(db, "faults", None)


def _check_backup_write(faults, dst: str):
    if faults is not None:
        faults.check_write("backup", dst)


def _write_json_atomic(path: str, obj):
    """Manifest/state writes publish by rename: a failed write leaves
    the previous generation intact, never a torn current file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _walk(root: str) -> dict[str, int]:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = os.path.getsize(p)
    return out


def verify_wal_file(path: str):
    """Verify every entry crc64 of one replica WAL copy; raises
    CorruptionError on the first mismatch.  A torn TAIL (header/payload
    running past EOF) is a crash artifact the boot scan truncates, not
    corruption — but a bad crc on complete bytes means the archive
    would preserve rot forever, so the backup must fail loudly."""
    from oceanbase_tpu_torch.palf.log import _MAGIC, scan_wal

    with open(path, "rb") as fh:
        buf = fh.read()
    if not buf.startswith(_MAGIC):
        if buf:
            raise CorruptionError(f"backup WAL bad magic: {path}",
                                  kind="wal", path=path)
        return
    _entries, _valid_off, crc_failed_lsn = scan_wal(buf)
    if crc_failed_lsn:
        raise CorruptionError(
            f"backup WAL entry lsn={crc_failed_lsn} crc mismatch: "
            f"{path}", kind="wal", path=path)


def _verify_backup_wal(dest: str):
    """Backup-time gate: never archive corrupt WAL bytes — verify every
    replica log in the copied tree, removing the half-made backup on
    failure so a retry cannot resume from poison."""
    try:
        for dirpath, _dirs, files in os.walk(dest):
            for f in files:
                if f.startswith("replica_") and f.endswith(".log"):
                    verify_wal_file(os.path.join(dirpath, f))
    except CorruptionError:
        shutil.rmtree(dest, ignore_errors=True)
        raise


def full_backup(db, dest: str) -> str:
    """Checkpoint + full copy; returns the backup dir."""
    if db.root is None:
        raise ValueError("in-memory database cannot be backed up")
    db.checkpoint()
    faults = _faults(db)
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)

    def _copy(src, dst, *, follow_symlinks=True):
        # wrap to typed IMMEDIATELY: copytree folds bare OSErrors into
        # a shutil.Error that loses the errno (ENOSPC vs EIO)
        try:
            _check_backup_write(faults, dst)
            return shutil.copy2(src, dst,
                                follow_symlinks=follow_symlinks)
        except OSError as exc:
            raise wrap_disk_error(exc, f"backup copy {dst}") from exc

    try:
        shutil.copytree(db.root, dest, dirs_exist_ok=False,
                        copy_function=_copy)
        _verify_backup_wal(dest)
        files = _walk(dest)
        files.pop(MANIFEST, None)
        _check_backup_write(faults, os.path.join(dest, MANIFEST))
        _write_json_atomic(os.path.join(dest, MANIFEST),
                           {"kind": "full", "base": None,
                            "ts": time.time(), "files": files})
    except (OSError, DiskFull, DiskIOError) as exc:
        # a half-made backup must not survive to be resumed/restored
        shutil.rmtree(dest, ignore_errors=True)
        raise wrap_disk_error(exc, f"full backup to {dest}") from exc
    return dest


def incremental_backup(db, dest: str, base: str) -> str:
    """Copy only files new/changed since the ``base`` backup.

    Segment files are write-once (compaction writes NEW ids), so a file
    present in the base with the same size is skipped; everything else
    (manifest.json, slog, config, WAL logs, meta) re-copies."""
    if db.root is None:
        raise ValueError("in-memory database cannot be backed up")
    with open(os.path.join(base, MANIFEST)) as fh:
        base_m = json.load(fh)
    db.checkpoint()
    faults = _faults(db)
    os.makedirs(dest, exist_ok=False)
    copied, skipped = {}, 0
    try:
        for rel, size in _walk(db.root).items():
            qadmission.checkpoint()  # KILL/deadline between file copies
            if rel == MANIFEST:
                continue
            src = os.path.join(db.root, rel)
            immutable = "segments" + os.sep in rel or rel.endswith(".seg")
            if immutable and base_m["files"].get(rel) == size:
                skipped += 1
                continue
            dst = os.path.join(dest, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            _check_backup_write(faults, dst)
            shutil.copy2(src, dst)
            copied[rel] = size
        _verify_backup_wal(dest)
        _check_backup_write(faults, os.path.join(dest, MANIFEST))
        _write_json_atomic(os.path.join(dest, MANIFEST),
                           {"kind": "incremental",
                            "base": os.path.abspath(base),
                            "ts": time.time(), "files": copied,
                            "skipped": skipped})
    except OSError as exc:
        # a half-made increment must not survive as a chain link
        shutil.rmtree(dest, ignore_errors=True)
        raise wrap_disk_error(
            exc, f"incremental backup to {dest}") from exc
    return dest


def archive_wal(db, dest: str):
    """Append-only WAL archiving: copies each replica log's NEW suffix
    (byte offset recorded per file — ≙ archive progress points)."""
    os.makedirs(dest, exist_ok=True)
    faults = _faults(db)
    state_p = os.path.join(dest, "ARCHIVE_STATE.json")
    state = {}
    if os.path.exists(state_p):
        with open(state_p) as fh:
            state = json.load(fh)
    for dirpath, _dirs, files in os.walk(db.root):
        qadmission.checkpoint()  # KILL/deadline between directories
        for f in files:
            if not f.endswith(".log"):
                continue
            src = os.path.join(dirpath, f)
            rel = os.path.relpath(src, db.root)
            dst = os.path.join(dest, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            start = state.get(rel, 0)
            size = os.path.getsize(src)
            if size > start:
                try:
                    _check_backup_write(faults, dst)
                    with open(src, "rb") as s, open(dst, "ab") as d:
                        s.seek(start)
                        shutil.copyfileobj(s, d)
                        d.flush()
                        os.fsync(d.fileno())
                except OSError as exc:
                    # append-only discipline: truncate the archive copy
                    # back to the recorded progress point so the next
                    # round re-appends from a clean suffix boundary
                    try:
                        with open(dst, "ab") as d:
                            d.truncate(start)
                    except OSError:
                        pass
                    raise wrap_disk_error(
                        exc, f"wal archive {dst}") from exc
                state[rel] = size
    try:
        _check_backup_write(faults, state_p)
        _write_json_atomic(state_p, state)
    except OSError as exc:
        raise wrap_disk_error(exc, "wal archive state") from exc
    return dest


def restore_chain(backup: str, target: str) -> str:
    """Materialize a backup (full or incremental chain) at ``target``."""
    chain = []
    cur = backup
    while cur is not None:
        with open(os.path.join(cur, MANIFEST)) as fh:
            m = json.load(fh)
        chain.append(cur)
        cur = m["base"]
    base = chain[-1]
    shutil.copytree(base, target, dirs_exist_ok=False)
    for inc in reversed(chain[:-1]):
        qadmission.checkpoint()  # KILL/deadline between increments
        for dirpath, _dirs, files in os.walk(inc):
            for f in files:
                if f == MANIFEST:
                    continue
                src = os.path.join(dirpath, f)
                rel = os.path.relpath(src, inc)
                dst = os.path.join(target, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)
    os.remove(os.path.join(target, MANIFEST))
    return target


def overlay_archive(archive: str, target: str):
    """Lay archived WAL over a restored tree (archived logs are always
    at least as long as the backup's copies)."""
    for dirpath, _dirs, files in os.walk(archive):
        qadmission.checkpoint()  # KILL/deadline between directories
        for f in files:
            if f == "ARCHIVE_STATE.json":
                continue
            src = os.path.join(dirpath, f)
            rel = os.path.relpath(src, archive)
            dst = os.path.join(target, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(src, dst)


def pitr_cut(target: str, until_version: int):
    """Rewrite every WAL file under ``target`` dropping COMMIT records
    with version > until_version: transactions past the cut never
    replay, giving a consistent snapshot at the target point
    (≙ restoring to a timestamp, src/storage/restore).

    Every entry's stored crc64 is VERIFIED before the rewrite: the cut
    re-encodes entries, which would otherwise launder corrupt payloads
    into fresh valid checksums the restored node then trusts."""
    from oceanbase_tpu_torch.palf.log import _BASE_PAYLOAD, _MAGIC, LogEntry, \
        scan_wal

    for dirpath, _dirs, files in os.walk(target):
        for f in files:
            if not (f.startswith("replica_") and f.endswith(".log")):
                continue
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                buf = fh.read()
            if not buf.startswith(_MAGIC):
                continue
            entries, _valid_off, crc_failed_lsn = scan_wal(buf)
            if crc_failed_lsn:
                # a torn tail the boot scan would truncate is fine;
                # a complete entry failing its crc is rot
                raise CorruptionError(
                    f"PITR source WAL entry lsn={crc_failed_lsn} crc "
                    f"mismatch: {path}", kind="wal", path=path)
            # a recycled WAL leads with its base record — preserve it
            # verbatim and renumber the tail from base_lsn + 1 (recycled
            # entries are checkpointed history at/below the cut)
            base_rec = None
            if entries and entries[0].payload == _BASE_PAYLOAD:
                base_rec = entries[0]
                entries = entries[1:]
            kept: list[LogEntry] = []
            for e in entries:
                try:
                    rec = json.loads(e.payload.decode())
                except Exception:
                    rec = {}
                if rec.get("op") == "commit" and \
                        rec.get("version", 0) > until_version:
                    continue  # drop: this tx commits after the cut
                kept.append(e)
            # re-number LSNs densely (accept() requires a gapless log)
            first = (base_rec.lsn + 1) if base_rec is not None else 1
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(_MAGIC)
                if base_rec is not None:
                    fh.write(base_rec.encode())
                for i, e in enumerate(kept, first):
                    fh.write(LogEntry(e.term, i, e.payload).encode())
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
