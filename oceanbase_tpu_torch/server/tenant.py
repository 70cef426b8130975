"""Tenant: one module stack — storage engine, WAL, transactions, catalog.

Port of ``oceanbase_tpu/server/tenant.py`` (≙ the omt layer's per-tenant
module registry, src/observer/omt/ob_multi_tenant.h:71) for the single
node: each tenant (``sys`` and every one CREATE TENANT adds) owns its
directory ``<root>/tenants/<name>``, a config overlay over the cluster
config, its ``StorageEngine``, its WAL (an in-process ``PalfCluster``),
its ``TransService`` and its ``StorageCatalog`` on the database's
device, replays the WAL tail at boot and checkpoints; ``close()`` stops
its workers and its WAL.

It also wires the sequences (``share/sequence.py``), the table-lock
manager (``tx/tablelock.py``), the KV front end (``kv.py``) and the
worker pool parallel DML submits to, the PX admission semaphore
(``px_workers_per_tenant`` permits), the memstore write throttle
(``admission.MemstoreThrottle``) and the disk manager
(``diskmgr.DiskManager``: the log, data and spill budgets, read-only
degradation, the log surface's checkpoint-and-recycle reclaim).  A
cluster node hands it the networked ``NetPalf`` group (``wal=``) in
place of the in-process log, and its own ``RecoveryState``
(``recovery=``); ``cdc()`` opens a change-data-capture pump over the
WAL.  Its recovery steps carry the reference's trace spans
(``recovery.replay``, ``recovery.restore_prepared``,
``recovery.checkpoint``).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from oceanbase_tpu_torch.cdc import CdcPump
from oceanbase_tpu_torch.kv import KvTable
from oceanbase_tpu_torch.palf.cluster import PalfCluster
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.server.admission import MemstoreThrottle
from oceanbase_tpu_torch.server.diskmgr import DiskManager
from oceanbase_tpu_torch.server.config import Config
from oceanbase_tpu_torch.share.sequence import SequenceManager
from oceanbase_tpu_torch.storage.engine import StorageCatalog, StorageEngine
from oceanbase_tpu_torch.storage.recovery import RecoveryState
from oceanbase_tpu_torch.tx.service import TransService
from oceanbase_tpu_torch.tx.tablelock import LockTable


class Tenant:
    def __init__(self, name: str, root: str | None, cluster_config: Config,
                 wal_replicas: int = 3, wal=None, recovery=None,
                 device=None, corrupt_policy: str = "raise"):
        """``wal``: inject an external log handle (a NetPalf group whose
        replicas live in other OS processes, palf/netcluster.py) instead
        of the in-process PalfCluster — the multi-node path.
        ``recovery``: a shared RecoveryState (the node process passes its
        own so rebuild + boot events land in one gv$recovery log).
        ``corrupt_policy``: what boot does with a checksum-failing
        segment — "raise" (no repair source) or "quarantine" (move it
        aside and let the scrub plane repair it)."""
        self.name = name
        self.config = Config(parent=cluster_config)
        self.recovery = recovery if recovery is not None \
            else RecoveryState()
        # serializes checkpoint() across its callers (a node's periodic
        # loop, rebuild.fetch_meta handlers, admin sessions): interleaved
        # checkpoints could persist a REGRESSED replay point
        self._ckpt_lock = threading.Lock()
        data_dir = os.path.join(root, "data") if root else None
        wal_dir = os.path.join(root, "wal") if root else None
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)
        self.engine = StorageEngine(data_dir,
                                    corrupt_policy=corrupt_policy)
        if wal is not None:
            self.wal = wal
            local = wal.replica  # NetPalf: this process's replica
        else:
            self.wal = PalfCluster(wal_replicas, log_root=wal_dir)
            self.wal.elect()
            local = self.wal.replicas[self.wal.leader_id]
        self.tx = TransService(wal=self.wal)
        self.tx.engine = self.engine  # secondary-index maintenance

        # restart tier: replay the palf WAL tail from the persisted
        # replay point (the checkpoint keeps it O(tail), not
        # O(history)) through the service's persistent replay buffers
        start = self.engine.meta.get("wal_lsn", 0)
        m0 = time.monotonic()
        stats: dict = {}
        if local.committed_lsn > start:
            with qtrace.span("recovery.replay", tenant=name,
                             start_lsn=start, end_lsn=local.committed_lsn):
                max_ts = self.tx.apply_replay(
                    local.entries_between(start, local.committed_lsn),
                    stats=stats)
            self.tx.gts.advance_to(max_ts)
        #: WAL entries the last boot replayed
        self.replayed_entries = stats.get("entries", 0)
        if stats.get("entries") or start or local.last_lsn():
            # a networked replica restores its log but cannot know the
            # commit point without quorum: its apply happens through
            # catch-up (leader push / election noop) from ``start``
            deferred = local.last_lsn() - max(local.committed_lsn, start)
            self.recovery.record(
                "boot_replay", tenant=name, wal_start_lsn=start,
                wal_end_lsn=local.committed_lsn,
                entries=stats.get("entries", 0),
                prepared=stats.get("prepared", 0),
                elapsed_s=time.monotonic() - m0,
                note=f"commits={stats.get('commits', 0)}"
                     + (f" deferred_to_catchup={deferred}"
                        if deferred > 0 else ""))
        # durable XA: branches prepared before the crash reconstruct
        # into PREPARE state (XA RECOVER lists them)
        with qtrace.span("recovery.restore_prepared", tenant=name) as sp:
            restored = self.tx.restore_prepared()
            sp.tags["branches"] = len(restored)
        if restored:
            self.recovery.record(
                "restore_prepared", tenant=name, prepared=len(restored),
                xids=",".join(sorted(tx.xid for tx in restored
                                     if tx.xid)))
        local.applied_lsn = max(local.applied_lsn, start,
                                local.committed_lsn)
        self.tx.gts.advance_to(self.engine.meta.get("gts", 0))
        # bulk_load (CTAS / direct load) stamps segments with GTS values
        # that reach neither the WAL nor (pre-checkpoint) the persisted
        # meta — seed GTS past every persisted segment version so the
        # boot snapshot sees them
        self.tx.gts.advance_to(max(
            (s.max_version for ts in self.engine.tables.values()
             for s, _ in ts.tablet.segment_locations()), default=0))

        self.catalog = StorageCatalog(self.engine,
                                      snapshot_fn=self.tx.gts.current,
                                      config=self.config, device=device)
        self.catalog._cache.resize(int(self.config["kv_cache_limit_bytes"]))

        # satellites: sequences, table locks (the KV front end is kv())
        self.sequences = SequenceManager(self.engine)
        self.locks = LockTable()
        self.tx.lock_table = self.locks
        self.tx.lock_wait_timeout_s = float(
            self.config["lock_wait_timeout_s"])

        def _on_cfg(k, v):
            if k == "lock_wait_timeout_s":
                self.tx.lock_wait_timeout_s = float(v)
            elif k == "kv_cache_limit_bytes":
                self.catalog._cache.resize(int(v))
            elif k in ("enable_shape_buckets", "shape_bucket_growth",
                       "shape_bucket_floor"):
                # cached relations were padded under the old policy;
                # drop them so the next read re-materializes
                self.catalog.invalidate()

        # hot-reload from the tenant overlay AND the cluster config
        self.config.watch(_on_cfg)
        cluster_config.watch(_on_cfg)

        # CPU quota = bounded worker pool (≙ tenant unit min/max cpu)
        self._pool = ThreadPoolExecutor(
            max_workers=int(self.config["tenant_cpu_quota"]),
            thread_name_prefix=f"tnt-{name}")
        # PX admission quota (≙ px target monitor): a PX statement holds
        # one permit while it runs; a denied one runs serially
        self.px_admission = threading.BoundedSemaphore(
            int(self.config["px_workers_per_tenant"]))

        # memstore write backpressure (≙ writing throttling): byte
        # accounting + ramp/hard-limit at the TransService.write choke
        # point; pressure kicks a horizon-clamped freeze/flush of the
        # fattest table, and the engine's flush listener re-bases the
        # accounting when any flush (throttle-kicked, row-threshold or
        # checkpoint) clears memtable rows
        self.throttle = MemstoreThrottle(self.config,
                                         flush_cb=self._pressure_flush)
        self.tx.throttle = self.throttle
        self.engine.flush_listener = self.throttle.on_flush

        # disk-pressure plane: per-surface byte budgets (log/data/spill)
        # with read-only degradation; the log surface reclaims
        # (aggressive checkpoint + WAL recycle) before it degrades.  The
        # spill surface is accounted incrementally by TempFileStore, so
        # it needs no walk paths.
        self.diskmgr = DiskManager(
            self.config,
            paths={"log": [wal_dir] if wal_dir else [],
                   "data": [data_dir] if data_dir else []},
            reclaim_cb=self.reclaim_log_disk)
        self.tx.diskmgr = self.diskmgr

    def _pressure_flush(self, table: str):
        """Memstore-pressure flush: freeze + flush ``table`` at the
        flush horizon (never past a live writer's snapshot) so
        throttled writers unblock without losing conflict checks."""
        try:
            self.engine.freeze_and_flush(
                table, snapshot=self.tx.flush_snapshot())
            self.catalog.invalidate(table)
        except KeyError:
            self.throttle.drop_table(table)  # dropped mid-pressure

    def reclaim_log_disk(self):
        """Log-disk pressure reclaim: checkpoint aggressively, then
        recycle the WAL prefix below the persisted replay point — the
        checkpoint made those entries' effects durable in segments, so
        boot replay never needs them again."""
        self.checkpoint()
        if hasattr(self.wal, "recycle"):
            self.wal.recycle(int(self.engine.meta.get("wal_lsn", 0)))

    def kv(self, table: str) -> KvTable:
        """OBKV-style table API handle (≙ src/libtable client)."""
        return KvTable(self, table)

    def cdc(self) -> CdcPump:
        """Change-data-capture pump over this tenant's WAL (≙ libobcdc)."""
        return CdcPump(self)

    def submit(self, fn, *args, **kwargs):
        """Queue work onto this tenant's workers (≙ tenant request queue)."""
        return self._pool.submit(fn, *args, **kwargs)

    def checkpoint(self):
        with self._ckpt_lock:
            self._checkpoint_locked()

    def _checkpoint_locked(self):
        m0 = time.monotonic()
        # the flush horizon clamps BOTH halves to the oldest active
        # transaction: versions a live writer's conflict check still
        # needs stay in the memtables, and the replay point only covers
        # commits the clamped flush snapshot captured
        snap, wal_lsn = self.tx.flush_horizon()
        # a follower may have committed-but-not-yet-applied entries:
        # those are not in its memtables, so the flush below would not
        # cover them — the replay point must not skip them
        local = getattr(self.wal, "replica", None)
        if local is not None:
            wal_lsn = min(wal_lsn, local.applied_lsn)
        # a prepared XA branch's redo lives ONLY in the WAL until its
        # commit/abort — never advance past its prepare batch
        clamp = self.tx.min_prepared_lsn()
        if clamp is not None:
            wal_lsn = min(wal_lsn, clamp)
        # monotonic: a long-lived tx can clamp this checkpoint's horizon
        # BELOW a previous one; commits under the old replay point are
        # already durable in segments, so never regress it
        wal_lsn = max(wal_lsn, int(self.engine.meta.get("wal_lsn", 0)))
        with qtrace.span("recovery.checkpoint", tenant=self.name,
                         wal_lsn=wal_lsn):
            for name in list(self.engine.tables):
                self.engine.freeze_and_flush(name, snapshot=snap)
            self.engine.meta["wal_lsn"] = wal_lsn
            self.engine.meta["gts"] = self.tx.gts.current()
            self.engine.checkpoint()
        self.recovery.record(
            "checkpoint", tenant=self.name, wal_end_lsn=wal_lsn,
            elapsed_s=time.monotonic() - m0,
            note=f"clamped={clamp is not None}")

    def close(self):
        self._pool.shutdown(wait=False)
        self.wal.close()
