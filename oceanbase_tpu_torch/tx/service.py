"""Transaction service: MVCC transactions with WAL + two-phase commit.

Port of ``oceanbase_tpu/tx/service.py``, with the XA methods,
``restore_prepared`` and the table-lock hooks (the implicit IX lock in
``write``, the release at transaction end), the memstore-throttle and
disk-manager gates of ``write`` and the ERRSIM point of ``commit``.  The
WAL takes plain JSON: ``_jsonable`` turns numpy
scalars into Python values and refuses a torch tensor, which the
session must read back before it writes.

Reference analog: ObTransService (src/storage/tx/ob_trans_service.h:173)
with per-participant ObPartTransCtx (ob_trans_part_ctx.h:148) and the
optimized 2PC state machine ObTxState INIT -> REDO_COMPLETE -> PREPARE ->
PRE_COMMIT -> COMMIT -> CLEAR (ob_committer_define.h:61-73).

Model:
- participants are tablets (the LS analog at this scale); a transaction
  collects a write set per participant.
- redo for every write is appended to the PALF log before commit
  acknowledges (WAL); commit itself is a log record.  Recovery replays the
  committed log into fresh memtables (≙ replayservice).
- single-participant commits take the one-phase fast path; multi-
  participant commits run the explicit 2PC state machine: each participant
  logs PREPARE with its local max ts; commit version = max(prepare ts)
  (≙ GTS-free prepare-version negotiation), then COMMIT records fan out.
- conflicts fail fast with WriteConflict (lock-wait queues arrive with the
  lock manager); rollback restores version chains.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from oceanbase_tpu_torch.server.errsim import ERRSIM
from oceanbase_tpu_torch.storage.indexes import (
    IndexKeyLocks,
    maintain_indexes,
)
from oceanbase_tpu_torch.tx.errors import TxAborted
from oceanbase_tpu_torch.tx.gts import GTS


class TxState(Enum):
    ACTIVE = "active"
    REDO_COMPLETE = "redo_complete"
    PREPARE = "prepare"
    PRE_COMMIT = "pre_commit"
    COMMIT = "commit"
    ABORT = "abort"
    CLEAR = "clear"


@dataclass
class Participant:
    """Per-tablet transaction context (≙ ObPartTransCtx)."""

    table: str
    tablet: object
    keys: list = field(default_factory=list)
    prepare_version: int = 0
    state: TxState = TxState.ACTIVE


@dataclass
class Transaction:
    tx_id: int
    snapshot: int
    state: TxState = TxState.ACTIVE
    participants: dict = field(default_factory=dict)  # table -> Participant
    stmt_seq: int = 0  # statement counter (savepoint granularity)
    # XA: external branch id (set by the session on XA START) and, after
    # XA PREPARE, the WAL replay point that must stay BELOW any
    # checkpoint while this branch is pending (its redo lives only in
    # the WAL until commit)
    xid: str | None = None
    prepare_lsn: int = -1  # -1: no WAL presence to protect
    # crash recovery: marks a branch reconstructed from replayed
    # prepare records (sync_recovered re-creates its uncommitted
    # tablet versions, so commit/rollback take the ordinary paths)
    recovered: bool = False
    # WAL commit point when this tx began: commits at/below it are
    # strictly older than this tx's snapshot (commit serializes under
    # the service lock), so a checkpoint replay point clamped to the
    # oldest live begin_lsn only covers commits its clamped flush
    # snapshot captured
    begin_lsn: int = 0
    # group-commit buffer: redo lives here (and in the memtable) until the
    # commit ships everything in one replicated append.  Unbounded for
    # huge transactions — incremental pre-commit flush is an r2 item.
    pending_redo: list = field(default_factory=list)

    # parallel-DML workers write under one tx concurrently; participant
    # creation must not race (keys lists are append-only, GIL-atomic)
    plock: threading.Lock = field(default_factory=threading.Lock)

    def participant(self, table: str, tablet) -> Participant:
        p = self.participants.get(table)
        if p is None:
            with self.plock:
                p = self.participants.get(table)
                if p is None:
                    p = Participant(table, tablet)
                    self.participants[table] = p
        return p


class TransService:
    """Owns the GTS, live transactions, and the WAL (a PalfCluster)."""

    def __init__(self, wal=None):
        self.gts = GTS()
        self.wal = wal            # PalfCluster or None (no replication)
        # StorageEngine for secondary-index maintenance (set by the
        # tenant wiring); None disables maintenance (e.g. bare unit use)
        self.engine = None
        # unique-index rowkey locks held across duplicate checks
        # (≙ index rowkey locking; see storage/indexes.IndexKeyLocks)
        self.index_locks = IndexKeyLocks()
        self.lock_table = None    # tx/tablelock.LockTable when attached
        self.lock_wait_timeout_s = 5.0
        # memstore write backpressure (server/admission.py::
        # MemstoreThrottle, wired by the tenant): write() is the one
        # choke point every writer crosses — session DML, PDML workers,
        # OBKV — so accounting and the ramp/hard-limit gate live here;
        # None disables (bare unit use, WAL replay writes bypass write())
        self.throttle = None
        # disk-pressure plane (server/diskmgr.DiskManager, wired by the
        # tenant): the same choke point fails writes fast with typed
        # TenantReadOnly while a disk budget is exhausted; None disables
        self.diskmgr = None
        self._next_tx_id = 0
        self._live: dict[int, Transaction] = {}
        self._lock = threading.RLock()
        # XA branch registry: xid -> Transaction (live-prepared or
        # crash-recovered); the session's XA verbs drive it
        self.xa_transactions: dict[str, Transaction] = {}
        # WAL replay state, shared between boot replay and incremental
        # follower apply so a commit record arriving AFTER a restart
        # still finds the redo the boot replay buffered:
        #   replay_pending:  tx -> [redo records] not yet committed
        #   replay_prepared: tx -> {xid, version, lsn, tables} of
        #                    prepare records with no commit/abort yet
        self.replay_pending: dict[int, list] = {}
        self.replay_prepared: dict[int, dict] = {}

    # ------------------------------------------------------------------
    def advance_tx_id(self, past: int):
        """Never-go-back seeding on recovery: replayed transactions keep
        their ids; new ones must not collide with a reconstructed
        prepared branch's uncommitted id space."""
        with self._lock:
            self._next_tx_id = max(self._next_tx_id, int(past))

    def begin(self) -> Transaction:
        with self._lock:
            self._next_tx_id += 1
            tx = Transaction(self._next_tx_id, self.gts.get_ts())
            if self.wal is not None:
                tx.begin_lsn = self.wal.committed_lsn()
            self._live[tx.tx_id] = tx
            return tx

    def flush_horizon(self):
        """-> (snapshot, wal_lsn) safe for a memtable flush/checkpoint,
        clamped to the oldest ACTIVE transaction.

        First-committer-wins reads version CHAINS: a version committed
        after a live writer's snapshot must stay in the memtables
        (mini_compact carries post-snapshot versions back into the
        active memtable) or the conflict becomes invisible once flushed
        into a segment — a lost update.  The wal_lsn half keeps the
        checkpoint replay point consistent with the clamped snapshot:
        commits at/below the oldest live begin_lsn are strictly older
        than every live snapshot, hence covered by the flush."""
        with self._lock:
            active = [t for t in self._live.values()
                      if t.state == TxState.ACTIVE]
            snap = min([self.gts.current()]
                       + [t.snapshot for t in active])
            lsn = 0 if self.wal is None else \
                min([self.wal.committed_lsn()]
                    + [t.begin_lsn for t in active])
            return snap, lsn

    def flush_snapshot(self) -> int:
        return self.flush_horizon()[0]

    def write(self, tx: Transaction, table: str, tablet, key: tuple,
              op: str, values: dict):
        if tx.state != TxState.ACTIVE:
            raise TxAborted(f"tx {tx.tx_id} is {tx.state.value}")
        if self.diskmgr is not None and not table.startswith("__idx__"):
            # read-only degradation gate: fails fast (typed
            # TenantReadOnly) while a disk budget is exhausted — reads
            # never cross this point, so they keep serving
            self.diskmgr.admit_write()
        if self.throttle is not None and not table.startswith("__idx__"):
            # BEFORE the append: ramped sleep past the trigger, typed
            # MemstoreFull at the hard limit (index maintenance rides
            # its base write's admission — accounting would double)
            self.throttle.admit_write(table, values)
        if self.lock_table is not None:
            # implicit intent-exclusive table lock: honors LOCK TABLES
            # READ/WRITE held by other transactions (released at tx end)
            self.lock_table.acquire(table, "IX", tx.tx_id,
                                    timeout=self.lock_wait_timeout_s)
        if self.engine is not None:
            # secondary indexes update in the SAME transaction, before
            # the base write (pre-image must still be the old row);
            # recursive svc.write calls give index entries WAL redo,
            # statement rollback, and replay for free
            maintain_indexes(self, self.engine, tx, table, tablet, key,
                             op, values)
        tablet.write(key, op, values, tx.tx_id, stmt_seq=tx.stmt_seq,
                     snapshot=tx.snapshot)
        p = tx.participant(table, tablet)
        p.keys.append(key)
        # redo buffers in the tx and ships in ONE replicated group append
        # at commit (≙ the sliding window's group buffer batching —
        # N writes cost one majority fsync, not N)
        tx.pending_redo.append(
            {"op": "redo", "tx": tx.tx_id, "table": table,
             "key": list(key), "kind": op, "stmt": tx.stmt_seq,
             "values": _jsonable(values)})

    def rollback_statement(self, tx: Transaction, stmt_seq: int,
                           stmt_writes: dict):
        """Undo a failed statement's writes inside a live transaction
        (statement-level atomicity, ≙ savepoint rollback).
        stmt_writes: table -> list of keys written by the statement."""
        for table, keys in stmt_writes.items():
            p = tx.participants.get(table)
            if p is None:
                continue
            p.tablet.abort(tx.tx_id, keys, min_stmt_seq=stmt_seq)
            # p.keys keeps earlier-statement entries; commit() tolerates
            # keys whose uncommitted versions were statement-aborted
        # drop the statement's buffered redo (it never hit the WAL)
        tx.pending_redo = [r for r in tx.pending_redo
                           if r.get("stmt", 0) < stmt_seq]
        # index rowkey locks the statement introduced go with it — a
        # rolled-back INSERT must not wedge its unique value until tx end
        self.index_locks.release_stmt(tx.tx_id, stmt_seq)

    # ------------------------------------------------------------------
    def commit(self, tx: Transaction) -> int:
        """One-phase fast path or full 2PC; returns the commit version."""
        ERRSIM.hit("tx.commit")
        with self._lock:
            if tx.state != TxState.ACTIVE:
                raise TxAborted(f"tx {tx.tx_id} is {tx.state.value}")
            parts = list(tx.participants.values())
            if not parts:
                tx.state = TxState.CLEAR
                self._live.pop(tx.tx_id, None)
                self._release_locks(tx)
                return self.gts.get_ts()
            if len(parts) == 1:
                # single-LS fast path (≙ one-phase commit optimization):
                # buffered redo + commit ship as one group append
                version = self.gts.get_ts()
                self._log_batch(tx.pending_redo +
                                [{"op": "commit", "tx": tx.tx_id,
                                  "version": version}])
                tx.pending_redo = []
                parts[0].tablet.commit(tx.tx_id, version, parts[0].keys)
                tx.state = TxState.CLEAR
                self._live.pop(tx.tx_id, None)
                self._release_locks(tx)
                return version

            # ---- 2PC (≙ upstream/downstream committer state machine) ----
            tx.state = TxState.REDO_COMPLETE
            records = list(tx.pending_redo)
            for p in parts:
                p.state = TxState.PREPARE
                p.prepare_version = self.gts.get_ts()
                records.append({"op": "prepare", "tx": tx.tx_id,
                                "table": p.table,
                                "version": p.prepare_version})
            version = max(p.prepare_version for p in parts)
            tx.state = TxState.PRE_COMMIT
            records.append({"op": "commit", "tx": tx.tx_id,
                            "version": version})
            self._log_batch(records)
            tx.pending_redo = []
            tx.state = TxState.COMMIT
            for p in parts:
                p.tablet.commit(tx.tx_id, version, p.keys)
                p.state = TxState.COMMIT
            tx.state = TxState.CLEAR
            self._live.pop(tx.tx_id, None)
            self._release_locks(tx)
            return version

    # ------------------------------------------------------------------
    # XA: externally-coordinated two-phase commit (≙ ObXAService,
    # src/storage/tx/ob_xa_service.h — the prepare/commit phases split
    # across statements, possibly across sessions)
    # ------------------------------------------------------------------
    def xa_prepare(self, tx: Transaction):
        """Phase 1: make the tx's redo + prepare records durable; the tx
        stays in PREPARE until an explicit XA COMMIT/ROLLBACK.

        Durability: the prepare records carry the branch xid, so a crash
        between PREPARE and COMMIT reconstructs the branch at replay
        (``restore_prepared``) instead of implicitly rolling it back —
        ≙ ObXAService recovering into prepared state
        (src/storage/tx/ob_xa_service.h).  ``tx.prepare_lsn`` records
        the WAL replay point that checkpoints must not advance past
        while the branch is pending (its redo exists ONLY in the WAL)."""
        with self._lock:
            if tx.state != TxState.ACTIVE:
                raise TxAborted(f"tx {tx.tx_id} is {tx.state.value}")
            records = list(tx.pending_redo)
            for p in tx.participants.values():
                p.state = TxState.PREPARE
                p.prepare_version = self.gts.get_ts()
                records.append({"op": "prepare", "tx": tx.tx_id,
                                "table": p.table, "xid": tx.xid,
                                "version": p.prepare_version})
            end_lsn = self._log_batch(records)
            # the batch occupies [end-len+1, end]: a checkpoint replay
            # point at end-len still replays every record of the batch
            # (an empty or WAL-less branch has nothing to protect)
            if records and end_lsn:
                tx.prepare_lsn = max(end_lsn - len(records), 0)
            tx.pending_redo = []
            tx.state = TxState.PREPARE
            if tx.xid is not None:
                self.xa_transactions[tx.xid] = tx

    def xa_commit_prepared(self, tx: Transaction) -> int:
        """Phase 2 commit of a PREPARED tx (any session may drive it) —
        crash-recovered branches included (sync_recovered restored
        their uncommitted tablet versions, so this is one code path)."""
        with self._lock:
            if tx.state != TxState.PREPARE:
                raise TxAborted(
                    f"tx {tx.tx_id} is {tx.state.value}, not prepared")
            # a crash-recovered branch took the live shape at
            # sync_recovered (uncommitted tablet versions + participants),
            # so one path commits both — and the commit version is the
            # negotiated prepare version either way, keeping the WAL
            # record identical to what followers will stamp
            parts = list(tx.participants.values())
            version = max((p.prepare_version for p in parts),
                          default=self.gts.get_ts())
            self._log({"op": "commit", "tx": tx.tx_id,
                       "version": version})
            for p in parts:
                if p.tablet is not None:
                    p.tablet.commit(tx.tx_id, version, p.keys)
                p.state = TxState.COMMIT
            self.gts.advance_to(version)
            tx.state = TxState.CLEAR
            self._forget_xa_locked(tx)
            self._release_locks(tx)
            return version

    def xa_rollback_prepared(self, tx: Transaction):
        with self._lock:
            if tx.state != TxState.PREPARE:
                return self.rollback(tx)
            # redo already reached the WAL at prepare: log the abort so
            # replay drops the buffered records
            self._log({"op": "abort", "tx": tx.tx_id})
            for p in tx.participants.values():
                if p.tablet is not None:
                    p.tablet.abort(tx.tx_id, p.keys)
            tx.state = TxState.ABORT
            self._forget_xa_locked(tx)
            self._release_locks(tx)

    def _forget_xa_locked(self, tx: Transaction):
        """Drop every trace of a terminated XA branch: the live map, the
        xid registry, and the replay buffers (so an ended branch stops
        clamping checkpoints and cannot be re-registered by sync)."""
        self._live.pop(tx.tx_id, None)
        if tx.xid is not None:
            cur = self.xa_transactions.get(tx.xid)
            if cur is tx:
                self.xa_transactions.pop(tx.xid, None)
        self.replay_pending.pop(tx.tx_id, None)
        self.replay_prepared.pop(tx.tx_id, None)

    def recoverable_xids(self) -> list[str]:
        """XA RECOVER's data: xids of branches in PREPARE state (live or
        crash-reconstructed) this service can still commit or roll back."""
        with self._lock:
            return sorted(x for x, tx in self.xa_transactions.items()
                          if tx.state == TxState.PREPARE)

    def min_prepared_lsn(self):
        """Smallest WAL replay point still needed by a pending prepared
        branch (live or recovered), or None.  Checkpoints clamp their
        replay point to it: a prepared branch's redo lives ONLY in the
        WAL, so advancing past its prepare batch would lose the branch
        at the next restart."""
        with self._lock:
            lsns = [tx.prepare_lsn for tx in self._live.values()
                    if tx.state == TxState.PREPARE
                    and tx.xid is not None and tx.prepare_lsn >= 0]
            return min(lsns) if lsns else None

    def rollback(self, tx: Transaction):
        with self._lock:
            if tx.state == TxState.CLEAR:
                return
            for p in tx.participants.values():
                p.tablet.abort(tx.tx_id, p.keys)
            # redo never reached the WAL (group commit): nothing to log
            tx.pending_redo = []
            tx.state = TxState.ABORT
            self._live.pop(tx.tx_id, None)
            self._release_locks(tx)

    # ------------------------------------------------------------------
    def _release_locks(self, tx: Transaction):
        self.index_locks.release_all(tx.tx_id)
        if self.lock_table is not None:
            self.lock_table.release_all(tx.tx_id)

    def _log(self, record: dict) -> int:
        if self.wal is not None:
            return self.wal.append([json.dumps(record).encode()])
        return 0

    def _log_batch(self, records: list) -> int:
        """Group append: one majority-replicated fsync for the whole
        batch (≙ LogSlidingWindow group buffer)."""
        if self.wal is not None and records:
            return self.wal.append(
                [json.dumps(r).encode() for r in records])
        return 0

    # NOTE: with group commit, a live transaction has NO presence in the
    # WAL (redo ships atomically with its commit record), so checkpoints
    # no longer need a replay-point barrier at the oldest live tx — the
    # pre-group-commit min_active_wal_lsn clamp was removed with it.

    # ------------------------------------------------------------------
    # recovery (≙ replayservice applying committed log to memtables)
    # ------------------------------------------------------------------
    def apply_replay(self, entries, stats: dict | None = None) -> int:
        """Instance replay against this service's persistent replay
        buffers: boot replay and incremental follower apply share ONE
        pending/prepared state, so a commit record that arrives through
        catch-up AFTER a restart still finds the redo the boot replay
        buffered.  Keeps the xid registry in sync (prepared branches
        appear in XA RECOVER as soon as their prepare record applies;
        terminated ones disappear) and returns the max commit ts seen."""
        if stats is None:
            stats = {}
        max_ts = self.replay(entries, self.engine,
                             pending=self.replay_pending,
                             prepared=self.replay_prepared, stats=stats)
        self.sync_recovered()
        # seed the tx-id allocator past every replayed id: a follower
        # promoted to leader must not mint ids that collide with a
        # replayed (possibly still-prepared) transaction's id space
        self.advance_tx_id(stats.get("max_tx", 0))
        return max_ts

    def restore_prepared(self) -> list:
        """Boot-time hook (after the WAL tail replays): reconstruct every
        XA branch whose prepare records survived with no commit/abort —
        ≙ ObXAService crash recovery into prepared state.  Returns ALL
        currently-recovered branches (incremental replay may have
        registered them already), also reachable via XA RECOVER."""
        self.sync_recovered()
        with self._lock:
            return [tx for tx in self._live.values()
                    if tx.recovered and tx.state == TxState.PREPARE]

    def sync_recovered(self) -> list:
        """Reconcile the xid registry with the replay buffers: register
        newly-replayed prepared branches, drop branches a replayed
        commit/abort record terminated.

        A reconstructed branch takes the LIVE prepared shape: its redo
        is re-written into the tablets as UNCOMMITTED versions, so
        first-committer-wins checks see the branch exactly like before
        the crash (a concurrent write to its keys conflicts instead of
        silently racing the pending XA COMMIT), and the commit/rollback
        paths are the ordinary participant paths.  (Unique-index ROWKEY
        locks are not reacquired — narrower than the reference's
        recovered lock tables.)"""
        restored = []
        with self._lock:
            for tx_id, info in sorted(self.replay_prepared.items()):
                xid = info.get("xid")
                if xid is None or tx_id in self._live:
                    continue  # pre-durable-XA record or already known
                redo = list(self.replay_pending.get(tx_id, []))
                version = int(info.get("version", 0))
                tx = Transaction(tx_id, snapshot=version)
                tx.state = TxState.PREPARE
                tx.xid = xid
                tx.recovered = True
                # the replay point that still covers the whole batch is
                # one below its first record
                first = min([int(info.get("lsn", 1))]
                            + [int(r.get("_lsn", 1)) for r in redo])
                tx.prepare_lsn = max(first - 1, 0)
                for r in redo:
                    ts = (self.engine.tables.get(r["table"])
                          if self.engine is not None else None)
                    p = tx.participant(
                        r["table"], ts.tablet if ts is not None else None)
                    key = tuple(r["key"])
                    p.keys.append(key)
                    p.state = TxState.PREPARE
                    p.prepare_version = version
                    if ts is not None:
                        # no snapshot arg: recovery reapply, the check
                        # that would conflict is the one being restored
                        ts.tablet.write(key, r["kind"], r["values"],
                                        tx_id)
                self._live[tx_id] = tx
                self.xa_transactions[xid] = tx
                self.advance_tx_id(tx_id)
                self.gts.advance_to(version)
                restored.append(tx)
            # a commit/abort record replayed for a branch we had
            # reconstructed: replay already applied (or dropped) its
            # redo — retire the placeholder.  After a replayed COMMIT
            # the reconstructed versions were stamped alongside the
            # pending redo (same tx id), so the abort below is a no-op;
            # after a replayed ABORT it removes them.
            for tx_id in [t for t, tx in self._live.items()
                          if tx.recovered
                          and t not in self.replay_prepared]:
                tx = self._live.pop(tx_id)
                for p in tx.participants.values():
                    if p.tablet is not None:
                        p.tablet.abort(tx_id, p.keys)
                if tx.xid is not None and \
                        self.xa_transactions.get(tx.xid) is tx:
                    self.xa_transactions.pop(tx.xid, None)
        return restored

    @staticmethod
    def replay(entries, engine, pending: dict | None = None,
               prepared: dict | None = None, stats: dict | None = None):
        """Replay committed WAL records into a StorageEngine's memtables.
        Redo is buffered per tx and applied at its commit record, matching
        commit-version visibility.  ``pending`` carries the redo buffer
        across incremental calls (follower apply streams one entry at a
        time, ≙ replayservice applying as committed_lsn advances);
        ``prepared`` (optional) collects prepare records not yet
        terminated by a commit/abort — the durable-XA reconstruction
        input; ``stats`` (optional) accumulates replay progress counters
        for gv$recovery."""
        if pending is None:
            pending = {}
        if stats is None:
            stats = {}
        max_ts = 0
        for e in entries:
            stats["entries"] = stats.get("entries", 0) + 1
            try:
                rec = json.loads(e.payload.decode())
            except Exception:
                continue
            tx_id = rec.get("tx")
            if tx_id is not None:
                stats["max_tx"] = max(stats.get("max_tx", 0), tx_id)
            op = rec.get("op")
            if op == "ddl":
                # replicated logical DDL (multi-node log stream).  Apply
                # idempotently vs slog-applied state: the originator's
                # own slog may already hold the op (boot replays slog
                # first, then the WAL suffix).
                _replay_ddl(rec["slog"], engine)
            elif op == "redo":
                rec["_lsn"] = e.lsn  # prepared-branch replay-point bound
                pending.setdefault(rec["tx"], []).append(rec)
            elif op == "prepare":
                # XA phase 1 (durable): remember the branch until a
                # commit/abort terminates it; leftovers at the end of
                # replay are crash-recoverable prepared branches
                if prepared is not None:
                    info = prepared.setdefault(rec["tx"], {})
                    if rec.get("xid") is not None:
                        info["xid"] = rec["xid"]
                    info["version"] = max(int(info.get("version", 0)),
                                          int(rec.get("version", 0)))
                    info["lsn"] = min(int(info.get("lsn", e.lsn)), e.lsn)
                    stats["prepared"] = stats.get("prepared", 0) + 1
            elif op == "commit":
                version = rec["version"]
                max_ts = max(max_ts, version)
                stats["commits"] = stats.get("commits", 0) + 1
                for r in pending.pop(rec["tx"], []):
                    ts = engine.tables.get(r["table"])
                    if ts is None:
                        continue
                    key = tuple(r["key"])
                    ts.tablet.write(key, r["kind"], r["values"], rec["tx"])
                    ts.tablet.commit(rec["tx"], version, [key])
                if prepared is not None:
                    prepared.pop(rec["tx"], None)
            elif op == "abort":
                # XA phase-1 rollback (and pre-group-commit WALs)
                pending.pop(rec["tx"], None)
                if prepared is not None:
                    prepared.pop(rec["tx"], None)
            elif op == "truncate":
                # replayed in log order: discard everything replayed into
                # the table so far (≙ TRUNCATE barrier in the redo stream).
                # Secondary-index storage tables truncate with their base:
                # their redo replays alongside the base rows, so the
                # barrier must clear them identically or recovered index
                # entries would resurrect pre-truncate values.
                table = rec["table"]
                targets = [table]
                base = engine.tables.get(table)
                if base is not None:
                    targets += [ix.storage_table
                                for ix in base.tdef.indexes]
                for t in targets:
                    if e.lsn <= engine.truncate_barriers.get(t, 0):
                        # the slog already applied this truncate AND
                        # restored post-truncate direct-load segments;
                        # only clear what WAL replay put into memtables
                        engine.reset_memtables(t)
                    elif t in engine.tables:
                        engine.truncate_table(t, log=False)
                # drop buffered redo of the table (writers finish before
                # the barrier thanks to the X table lock; belt-and-braces)
                tset = set(targets)
                for recs in pending.values():
                    recs[:] = [r for r in recs if r["table"] not in tset]
        return max_ts


def _replay_ddl(op: dict, engine):
    """Apply one replicated DDL op, skipping anything the engine's own
    slog already applied (create/drop/alter become no-ops when the
    target state is already present — WAL DDL replay must never wipe
    slog-restored segments, e.g. a CTAS bulk load with no redo)."""
    kind = op.get("op")
    if kind in ("create_table", "drop_table"):
        exists = op.get("name") in engine.tables
        if (kind == "create_table" and exists) or \
                (kind == "drop_table" and not exists):
            return
    elif kind in ("alter_add", "alter_drop"):
        ts = engine.tables.get(op.get("table"))
        if ts is not None:
            cname = (op["column"][0] if kind == "alter_add"
                     else op.get("column"))
            has = any(c.name == cname for c in ts.tdef.columns)
            if (kind == "alter_add" and has) or \
                    (kind == "alter_drop" and not has):
                return
    # create_index/drop_index/truncate: engine._replay is idempotent
    engine._replay(op)


def _jsonable(values: dict) -> dict:
    out = {}
    for k, v in values.items():
        if type(v).__module__.startswith("torch"):
            # device values are read back once per statement, at the
            # write boundary, never per row here
            raise TypeError(f"column {k!r}: a torch value reached the "
                            f"WAL ({type(v).__name__})")
        if isinstance(v, np.ndarray):
            v = v.tolist()  # a VECTOR cell
        elif hasattr(v, "item"):
            v = v.item()
        out[k] = v
    return out
