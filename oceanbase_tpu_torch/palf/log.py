"""Replicated log replica: terms, append, group commit, persistence.

Port of ``oceanbase_tpu/palf/log.py``: the same on-disk format (magic,
crc64-stamped entries, recycle base record), torn-tail truncation and
recycle, the reference's ``palf.*`` metrics, the disk-fault plane's
write checks (``faults``) and the disk manager's typed errors: a failed
write unwinds exactly as in the reference and raises ``DiskFull`` or
``DiskIOError``, never a bare ``OSError``.

Reference analog: PalfHandleImpl + LogSlidingWindow + LogEngine/LogIOWorker
(src/logservice/palf/palf_handle_impl.cpp:406 submit_log, :3235
receive_log; log_sliding_window.cpp group buffers; log_engine.cpp disk IO).

Model (single log stream): entries are (term, lsn, payload bytes).  The
leader assigns LSNs, appends to its local log, and ships entries to
followers; an entry is committed once a majority has persisted it, after
which the apply callback fires in LSN order on every replica (leader
apply ≙ applyservice, follower ≙ replayservice).  Consistency follows the
standard term-match rule: a follower accepts entries only when the
previous entry's term matches (truncating divergent suffixes).
"""

from __future__ import annotations

import errno
import json
import logging
import os
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from oceanbase_tpu_torch.native import crc64
from oceanbase_tpu_torch.server import metrics as qmetrics

log = logging.getLogger(__name__)

# replication-plane accounting (host side; server/metrics.py registry)
qmetrics.declare("palf.appends", "counter",
                 "leader group-append batches")
qmetrics.declare("palf.entries_appended", "counter",
                 "log entries appended on the leader")
qmetrics.declare("palf.fsyncs", "counter",
                 "durable log fsyncs (append path)")
qmetrics.declare("palf.fsync_s", "histogram",
                 "append-path fsync latency", unit="s")
qmetrics.declare("palf.entries_applied", "counter",
                 "committed entries applied through the state machine")

_HDR = struct.Struct("<QQIQ")  # term, lsn(index), payload_len, crc64
_MAGIC = b"OBTPULG1"  # file magic + format version (bump on layout change)

# WAL-recycle base record: a recycled log file starts with one entry
# carrying this payload whose (term, lsn) name the last RECYCLED entry
# — everything at/below it was applied AND captured by a checkpoint, so
# recovery resumes from the manifest + the suffix (≙ palf base lsn /
# rebuild point advanced by the checkpoint service).  It rides the
# ordinary entry format, so scan_wal/crc verification cover it.
_BASE_PAYLOAD = b"\x00PALF_BASE\x00"

# quarantine retention (shared with the data-dir boundary):
# storage/integrity.py owns the pruner, re-exported here for callers
from oceanbase_tpu_torch.storage.integrity import (  # noqa: E402
    QUARANTINE_KEEP,
    QUARANTINE_MAX_AGE_S,
    prune_quarantine,
)


def scan_wal(buf: bytes) -> tuple[list[LogEntry], int, int]:
    """Shared WAL tail scan over a log file body (after the magic):
    -> (entries, valid_off, crc_failed_lsn).  ``valid_off`` is the end
    of the last fully-validated entry; ``crc_failed_lsn`` is non-zero
    when the scan stopped at a COMPLETE entry failing its crc64 (rot)
    rather than an incomplete torn append.  Every consumer of the
    on-disk entry format goes through here — recovery, backup
    verification, PITR — so a layout bump changes one scanner."""
    entries: list[LogEntry] = []
    off = len(_MAGIC)
    valid_off = off
    crc_failed_lsn = 0
    while off + _HDR.size <= len(buf):
        term, lsn, plen, crc = _HDR.unpack_from(buf, off)
        off += _HDR.size
        if off + plen > len(buf):
            break  # torn tail write: discard (≙ log tail scan)
        payload = buf[off:off + plen]
        if crc64(struct.pack("<QQ", term, lsn) + payload) != crc:
            crc_failed_lsn = lsn
            break
        entries.append(LogEntry(term, lsn, payload))
        off += plen
        valid_off = off
    return entries, valid_off, crc_failed_lsn


@dataclass
class LogEntry:
    term: int
    lsn: int          # 1-based dense index
    payload: bytes

    def encode(self) -> bytes:
        """Wire/disk format with a crc64 integrity checksum over
        (term, lsn, payload) — ≙ the reference's log-entry checksums
        (accumulated data checksums in the log group entries)."""
        crc = crc64(struct.pack("<QQ", self.term, self.lsn) + self.payload)
        return _HDR.pack(self.term, self.lsn, len(self.payload), crc) + \
            self.payload


class PalfReplica:
    """One replica of one log stream (host state machine + disk log)."""

    def __init__(self, replica_id: int, log_dir: str | None = None,
                 apply_cb: Optional[Callable] = None, recovery=None):
        self.replica_id = replica_id
        self.log_dir = log_dir
        self.apply_cb = apply_cb
        # recovery-event sink (storage/recovery.py RecoveryState or
        # None): quarantined/truncated WAL bytes surface in gv$recovery
        self.recovery = recovery
        # disk-fault plane hook (net/faults.py), armed by
        # Database.arm_disk_faults
        self.faults = None
        # WAL recycle point: entries at/below base_lsn were dropped
        # from memory AND disk (their effects live in the engine
        # checkpoint); entries[i].lsn == base_lsn + i + 1
        self.base_lsn = 0
        self.base_term = 0
        self.entries: list[LogEntry] = []   # suffix, lsn = base+idx+1
        self.committed_lsn = 0
        self.applied_lsn = 0
        self.current_term = 0
        self.voted_for: dict[int, int] = {}  # term -> candidate
        self.role = "follower"
        self._lock = threading.RLock()
        # serializes apply callbacks WITHOUT holding self._lock: the
        # callback reaches into engine/tx state whose own paths call
        # back into the log (commit -> append), so running it under a
        # log lock would order locks both ways (deadlock under churn)
        self._apply_mutex = threading.Lock()
        self._log_f = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._recover()

    # ------------------------------------------------------------------
    # persistence (≙ LogEngine block files; single append file here)
    # ------------------------------------------------------------------
    def _log_path(self):
        return os.path.join(self.log_dir, f"replica_{self.replica_id}.log")

    def _persist(self, entries: list[LogEntry]):
        """Durably append ``entries``.  A write failure — real ENOSPC/
        EIO or an armed errno fault — UNWINDS: the file is truncated
        back to the pre-write offset (no half entry left behind), the
        desynced buffered handle is dropped, and the failure surfaces
        as typed DiskFull/DiskIOError, never a bare OSError."""
        if self.log_dir is None:
            return
        path = self._log_path()
        buf = b"".join(e.encode() for e in entries)
        pre_off = None
        try:
            if self._log_f is None:
                fresh = not os.path.exists(path) or \
                    os.path.getsize(path) == 0
                self._log_f = open(path, "ab")
                if fresh:
                    self._log_f.write(_MAGIC)
            # flush the header/prior bytes so tell() is the real
            # pre-write file offset the unwind truncates back to
            self._log_f.flush()
            pre_off = self._log_f.tell()
            if self.faults is not None and entries:
                # errno injection INSIDE the writer: enospc/eio raise
                # with nothing written; partial persists a seeded
                # fraction of the batch then fails — the torn-write
                # case the unwind below must clean up
                cut = self.faults.check_write("wal", path,
                                              nbytes=len(buf))
                if cut is not None:
                    self._log_f.write(buf[:cut])
                    self._log_f.flush()
                    raise OSError(errno.ENOSPC,
                                  "fault: partial WAL write", path)
            self._log_f.write(buf)
            t0 = time.perf_counter()
            self._log_f.flush()
            os.fsync(self._log_f.fileno())
        except OSError as exc:
            self._unwind_append(pre_off)
            from oceanbase_tpu_torch.server.diskmgr import wrap_disk_error

            raise wrap_disk_error(
                exc, f"palf replica {self.replica_id} wal append"
            ) from exc
        qmetrics.inc("palf.fsyncs")
        qmetrics.observe("palf.fsync_s", time.perf_counter() - t0)
        if self.faults is not None:
            self.faults.act_disk("wal", path)

    def _unwind_append(self, pre_off: int | None):
        """Roll the append file back to the pre-write offset after a
        failed write: the buffered handle may hold half an entry (its
        view of the file offset desynced from disk), so it is dropped
        and the file physically truncated — the next append reopens
        clean, and a crash before this runs is covered by the recovery
        scan truncating the torn tail."""
        try:
            if self._log_f is not None:
                self._log_f.close()
        except OSError:
            pass  # close may flush the poisoned buffer and fail again
        self._log_f = None
        if pre_off is None:
            return
        try:
            with open(self._log_path(), "r+b") as f:
                f.truncate(pre_off)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            # best effort: recovery's tail scan handles what remains
            log.warning("palf replica %d: could not truncate back to "
                        "%d after failed append", self.replica_id,
                        pre_off)

    def _truncate_disk(self):
        """Rewrite the on-disk log after a suffix truncation (or a
        prefix recycle): tmp + fsync + atomic replace, with a base
        record leading a recycled file.  A failed rewrite leaves the
        OLD file intact; the caller resyncs memory from it."""
        if self.log_dir is None:
            return
        if self._log_f:
            self._log_f.close()
            self._log_f = None
        path = self._log_path()
        tmp = path + ".tmp"
        try:
            if self.faults is not None:
                self.faults.check_write("wal", path)
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                if self.base_lsn > 0:
                    f.write(LogEntry(self.base_term, self.base_lsn,
                                     _BASE_PAYLOAD).encode())
                for e in self.entries:
                    f.write(e.encode())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as exc:
            try:
                os.remove(tmp)
            except OSError:
                pass
            from oceanbase_tpu_torch.server.diskmgr import wrap_disk_error

            raise wrap_disk_error(
                exc, f"palf replica {self.replica_id} wal rewrite"
            ) from exc

    def _resync_from_disk(self):
        """Reload in-memory entries from the on-disk log (the recovery
        scan, minus quarantine) — used when a disk rewrite failed and
        the old file is authoritative again."""
        self._log_f = None
        self.entries = []
        self.base_lsn = self.base_term = 0
        path = self._log_path()
        if self.log_dir is None or not os.path.exists(path):
            return
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(_MAGIC):
            return
        entries, _valid_off, _crc_fail = scan_wal(buf)
        if entries and entries[0].payload == _BASE_PAYLOAD:
            self.base_lsn = entries[0].lsn
            self.base_term = entries[0].term
            entries = entries[1:]
        self.entries = entries
        self.committed_lsn = min(self.committed_lsn, self.last_lsn())
        self.applied_lsn = min(self.applied_lsn, self.last_lsn())

    def recycle(self, upto_lsn: int) -> int:
        """Physically reclaim log-disk space: drop entries at/below
        ``upto_lsn`` from memory and disk (clamped to the commit AND
        apply points — never an entry whose effects are not already in
        the engine; the caller additionally clamps to the persisted
        checkpoint replay point).  -> bytes reclaimed on disk."""
        with self._lock:
            upto = min(int(upto_lsn), self.committed_lsn,
                       self.applied_lsn)
            if upto <= self.base_lsn:
                return 0
            drop = upto - self.base_lsn
            self.base_term = self.entries[drop - 1].term
            del self.entries[:drop]
            self.base_lsn = upto
            if self.log_dir is None:
                return 0
            path = self._log_path()
            try:
                before = os.path.getsize(path)
            except OSError:
                before = 0
            try:
                self._truncate_disk()
            except Exception:
                # rewrite failed: the OLD file (full history) is still
                # authoritative — restore memory to match it
                self._resync_from_disk()
                raise
            try:
                after = os.path.getsize(path)
            except OSError:
                after = 0
            return max(0, before - after)

    def _recover(self):
        path = self._log_path()
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(_MAGIC):
            # unknown/older format: refuse to guess — quarantine the file
            # so a later append cannot land BEHIND unreadable bytes that
            # the next recovery would stop at (peer catch-up restores
            # state; a format migration tool would go here).  Quarantine
            # files get unique names, surface in gv$recovery
            # (phase=quarantine) and are retention-capped by count/age —
            # repeated corruption must never grow the dir unbounded or
            # vanish without an operator-visible trace.
            if buf:
                qpath = f"{path}.corrupt.{time.time_ns():x}"
                os.replace(path, qpath)
                log.warning("palf replica %d: quarantined %d unreadable "
                            "log bytes to %s", self.replica_id, len(buf),
                            qpath)
                if self.recovery is not None:
                    self.recovery.record(
                        "quarantine", nbytes=len(buf),
                        note=f"wal bad magic -> {os.path.basename(qpath)}")
                prune_quarantine(self.log_dir)
            return
        # crc_failed_lsn != 0: the scan stopped at a COMPLETE entry
        # failing its crc (rot — worth a gv$recovery quarantine row
        # below), vs 0 for an ordinary torn append
        self.entries, valid_off, crc_failed_lsn = scan_wal(buf)
        if self.entries and self.entries[0].payload == _BASE_PAYLOAD:
            # recycled log: the base record names the last dropped
            # entry — everything at/below it is applied AND in the
            # engine checkpoint, so the commit/apply points resume
            # there and the suffix replays on top
            base = self.entries[0]
            self.base_lsn = base.lsn
            self.base_term = base.term
            self.entries = self.entries[1:]
            self.committed_lsn = self.base_lsn
            self.applied_lsn = self.base_lsn
            self.current_term = self.base_term
        if valid_off < len(buf):
            # torn/corrupt tail bytes follow the last valid entry.  They
            # MUST be physically truncated before any append: _persist
            # reopens in append mode, and entries written after garbage
            # are unreachable to the next recovery (it stops scanning at
            # the garbage) — silently losing them.
            with open(path, "r+b") as f:
                f.truncate(valid_off)
                f.flush()
                os.fsync(f.fileno())
            log.warning(
                "palf replica %d: truncated %d torn/corrupt tail bytes "
                "(log keeps %d entries)", self.replica_id,
                len(buf) - valid_off, len(self.entries))
            if crc_failed_lsn and self.recovery is not None:
                # rot (vs an ordinary crash's torn append, which is
                # expected and stays a log line): surface it
                self.recovery.record(
                    "quarantine", nbytes=len(buf) - valid_off,
                    wal_start_lsn=crc_failed_lsn,
                    note=f"wal entry lsn={crc_failed_lsn} crc mismatch;"
                         " tail truncated (catch-up re-ships)")
        if self.entries:
            self.current_term = self.entries[-1].term

    # ------------------------------------------------------------------
    # leader path
    # ------------------------------------------------------------------
    def leader_append(self, payloads: list[bytes]) -> list[LogEntry]:
        """Group append (≙ submit_log into the sliding window's group
        buffer): assigns LSNs and persists locally in one fsync."""
        with self._lock:
            assert self.role == "leader"
            out = []
            for p in payloads:
                e = LogEntry(self.current_term, self.last_lsn() + 1, p)
                self.entries.append(e)
                out.append(e)
            try:
                self._persist(out)
            except Exception:
                # memory must not run ahead of a failed durable append:
                # a later append after the truncate-back would leave an
                # LSN gap on disk that recovery cannot scan across
                del self.entries[len(self.entries) - len(out):]
                raise
            qmetrics.inc("palf.appends")
            qmetrics.inc("palf.entries_appended", len(out))
            return out

    def last_lsn(self) -> int:
        with self._lock:
            return self.base_lsn + len(self.entries)

    def term_at(self, lsn: int) -> int:
        with self._lock:
            if lsn == 0:
                return 0
            if lsn == self.base_lsn:
                return self.base_term
            if lsn < self.base_lsn:
                return -1  # recycled away: unservable history
            if lsn <= self.base_lsn + len(self.entries):
                return self.entries[lsn - 1 - self.base_lsn].term
            return -1

    def entries_from(self, lsn: int) -> list[LogEntry] | None:
        """Entries with lsn > ``lsn`` (the catch-up batch after a
        matching prefix at ``lsn``); None when ``lsn`` predates the
        recycle point — that follower needs the rebuild plane, the
        recycled history cannot be served."""
        with self._lock:
            if lsn < self.base_lsn:
                return None
            return list(self.entries[lsn - self.base_lsn:])

    def entries_between(self, start_lsn: int, end_lsn: int
                        ) -> list[LogEntry]:
        """Entries with start < lsn <= end (the boot-replay slice).
        Entries recycled below base_lsn are by construction at/below
        the persisted checkpoint replay point, so a start clamped to
        that point never reaches them."""
        with self._lock:
            lo = max(0, start_lsn - self.base_lsn)
            hi = max(0, end_lsn - self.base_lsn)
            return list(self.entries[lo:hi])

    # ------------------------------------------------------------------
    # follower path (≙ receive_log)
    # ------------------------------------------------------------------
    def accept(self, prev_lsn: int, prev_term: int,
               entries: list[LogEntry]) -> bool:
        with self._lock:
            base = self.base_lsn
            if prev_lsn > self.last_lsn():
                return False  # gap
            if prev_lsn < base:
                return False  # prefix recycled: cannot verify the match
            if prev_lsn > base and \
                    self.entries[prev_lsn - 1 - base].term != prev_term:
                return False  # divergent history at prev
            truncated = False
            appended: list[LogEntry] = []
            for e in entries:
                if e.lsn <= base:
                    continue  # at/below the recycle point: applied long ago
                if e.lsn <= self.last_lsn():
                    if self.entries[e.lsn - 1 - base].term != e.term:
                        del self.entries[e.lsn - 1 - base:]
                        truncated = True
                    else:
                        continue  # duplicate
                if e.lsn != self.last_lsn() + 1:
                    return False  # non-contiguous batch: reject
                self.entries.append(e)
                appended.append(e)
            try:
                if truncated:
                    self._truncate_disk()  # rewrite incl. appended suffix
                else:
                    self._persist(appended)
            except Exception:
                if truncated:
                    # the OLD file survived the failed rewrite: make
                    # memory match it again (as if this accept never ran)
                    self._resync_from_disk()
                else:
                    del self.entries[len(self.entries) - len(appended):]
                raise
            return True

    # ------------------------------------------------------------------
    # commit + apply (≙ committed_end_lsn advance + apply/replay service)
    # ------------------------------------------------------------------
    def advance_commit(self, commit_lsn: int, drain: bool = True):
        """Advance the commit point; ``drain=False`` defers the apply
        callbacks to an explicit ``drain_applies()`` — for callers that
        hold locks the callback's downstream paths also take."""
        with self._lock:
            commit_lsn = min(commit_lsn, self.base_lsn + len(self.entries))
            if commit_lsn > self.committed_lsn:
                self.committed_lsn = commit_lsn
        if drain:
            self._apply_committed()

    def drain_applies(self):
        self._apply_committed()

    def _apply_committed(self):
        """Drain committed-but-unapplied entries through the callback in
        LSN order.  The apply mutex keeps the drain serial and ordered
        across concurrent advance_commit callers; the replica lock is
        NOT held across a callback (see _apply_mutex), and applied_lsn
        only advances AFTER the callback returns, so consumers gating on
        it (e.g. the DTL snapshot check) never run ahead of the engine.
        A non-blocking acquire avoids deadlock when the current drainer's
        callback is itself waiting on a lock this caller holds: the
        active drainer re-reads the commit point each iteration, and any
        entries it misses at the exit race drain at the next trigger."""
        if not self._apply_mutex.acquire(blocking=False):
            return  # an active drainer will observe the new commit point
        try:
            while True:
                with self._lock:
                    if self.applied_lsn >= self.committed_lsn:
                        return
                    # applied_lsn never trails base_lsn: recycle clamps
                    # to the apply point, and recovery of a recycled
                    # log resumes both points at the base
                    e = self.entries[self.applied_lsn - self.base_lsn]
                if self.apply_cb is not None:
                    self.apply_cb(e)
                qmetrics.inc("palf.entries_applied")
                with self._lock:
                    self.applied_lsn += 1
        finally:
            self._apply_mutex.release()

    def close(self):
        if self._log_f:
            self._log_f.close()
            self._log_f = None
