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
worker pool parallel DML submits to.  What the reference's tenant also
wires and the port's does not: the multi-node ``NetPalf`` log (ROADMAP
Queue 1 item 5b, sub-item 14), the memstore write throttle and the disk
manager (sub-item 10), the CDC pump and PX admission (item 10) and the
trace spans (item 9).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from oceanbase_tpu_torch.kv import KvTable
from oceanbase_tpu_torch.palf.cluster import PalfCluster
from oceanbase_tpu_torch.server.config import Config
from oceanbase_tpu_torch.share.sequence import SequenceManager
from oceanbase_tpu_torch.storage.engine import StorageCatalog, StorageEngine
from oceanbase_tpu_torch.storage.recovery import RecoveryState
from oceanbase_tpu_torch.tx.service import TransService
from oceanbase_tpu_torch.tx.tablelock import LockTable


class Tenant:
    def __init__(self, name: str, root: str | None, cluster_config: Config,
                 wal_replicas: int = 3, device=None):
        self.name = name
        self.config = Config(parent=cluster_config)
        self.recovery = RecoveryState()
        # serializes checkpoint(): interleaved checkpoints could persist
        # a REGRESSED replay point
        self._ckpt_lock = threading.Lock()
        data_dir = os.path.join(root, "data") if root else None
        wal_dir = os.path.join(root, "wal") if root else None
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)
        self.engine = StorageEngine(data_dir)
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
            max_ts = self.tx.apply_replay(
                local.entries_between(start, local.committed_lsn),
                stats=stats)
            self.tx.gts.advance_to(max_ts)
        #: WAL entries the last boot replayed
        self.replayed_entries = stats.get("entries", 0)
        if stats.get("entries") or start or local.last_lsn():
            self.recovery.record(
                "boot_replay", tenant=name, wal_start_lsn=start,
                wal_end_lsn=local.committed_lsn,
                entries=stats.get("entries", 0),
                prepared=stats.get("prepared", 0),
                elapsed_s=time.monotonic() - m0,
                note=f"commits={stats.get('commits', 0)}")
        # durable XA: branches prepared before the crash reconstruct
        # into PREPARE state (XA RECOVER lists them)
        restored = self.tx.restore_prepared()
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

    def kv(self, table: str) -> KvTable:
        """OBKV-style table API handle (≙ src/libtable client)."""
        return KvTable(self, table)

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
        # a prepared XA branch's redo lives ONLY in the WAL until its
        # commit/abort — never advance past its prepare batch
        clamp = self.tx.min_prepared_lsn()
        if clamp is not None:
            wal_lsn = min(wal_lsn, clamp)
        # monotonic: a long-lived tx can clamp this checkpoint's horizon
        # BELOW a previous one; commits under the old replay point are
        # already durable in segments, so never regress it
        wal_lsn = max(wal_lsn, int(self.engine.meta.get("wal_lsn", 0)))
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
