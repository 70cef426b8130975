"""NodeServer: one observer process of a multi-node cluster.

Reference analog: ObServer (src/observer/ob_server.cpp:228) hosting the
rpc frame, log service, storage, and SQL for one server — reduced to the
sys tenant.  The replication plane is a networked PALF group
(palf/netcluster.py, ≙ palf_handle_impl receive_log RPCs); DDL and DML
redo both ride it, so every node converges to the same engine state.
Writes execute on the PALF leader (statement routing on OB_NOT_MASTER,
≙ DML retry via the location cache); strong reads from a follower route
to the leader; weak reads (`consistency='weak'`) run on the local
replica (≙ weak-consistency replica reads).  ``das.scan`` serves
chunk-streamed snapshot column fetches for remote-relation access
(≙ ObDataAccessService, src/sql/das/ob_data_access_service.h:21).

CLI:  python -m oceanbase_tpu_torch.net.node --node-id 1 --port 7001 \
          --peers 2=127.0.0.1:7002,3=127.0.0.1:7003 --root /tmp/n1 \
          [--bootstrap] [--device cuda|cpu]

Port of ``oceanbase_tpu/net/node.py``: the same verbs, routing, DDL log
stream and background loops.  A node runs its tenant on one device,
``cuda`` unless it is started with ``--device cpu``: its
``StorageCatalog``, its sessions, the DTL fragments it executes and the
merges it coordinates all live there, and a node asked for ``cuda`` on a
machine without one exits nonzero.  Where the reference lets LOAD DATA
write a direct-load segment on the leader alone (the followers never see
the rows: ``add_segment`` is a physical op, not in ``_DDL_KINDS``), the
port's node refuses LOAD DATA INFILE when it has peers, with
``LoadDataOnCluster`` (ROADMAP Queue 3 #29).  A statement on the leader
waits until the apply reaches the commit point (Queue 3 #30), and the
heartbeat thread of a follower left without a leader campaigns (#31).
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.net.faults import FaultPlane
from oceanbase_tpu_torch.net.health import HealthMonitor
from oceanbase_tpu_torch.net.rpc import RpcClient, RpcError, RpcServer
from oceanbase_tpu_torch.palf.cluster import NoQuorum, NotLeader
from oceanbase_tpu_torch.palf.netcluster import NetPalf
from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.share.location import LocationCache
from oceanbase_tpu_torch.storage.integrity import CorruptionError, arrays_crc

_DDL_KINDS = {"create_view", "drop_view",
              "create_table", "drop_table", "truncate", "alter_add",
              "alter_drop", "create_index", "drop_index", "aux_index",
              "drop_aux_index"}
_WRITE_PREFIXES = ("insert", "update", "delete", "replace", "create",
                   "drop", "alter", "truncate", "load", "begin",
                   "commit", "rollback", "xa")
SCAN_CHUNK_ROWS = 65536


class LoadDataOnCluster(NotImplementedError):
    """LOAD DATA INFILE on a node with peers: its direct-load segment
    would land on this node alone (segment ops stay node-local and
    never ride the log stream), so the followers would miss the rows
    (ROADMAP Queue 3 #29).  INSERT replicates through the WAL."""


class NodeDatabase:
    """Database facade for one node process: the attribute surface
    sessions touch (config, tx/engine routing, observability), bound to
    the node's sys tenant over the networked WAL."""

    def __init__(self, node, root):
        import itertools

        from oceanbase_tpu_torch.px.dtl import DtlMetrics
        from oceanbase_tpu_torch.server.monitor import (
            AshSampler,
            PlanChoiceLedger,
            PlanFeedback,
            PlanHistory,
            PlanMonitor,
            SqlAudit,
            TimeCalibration,
            TimeModel,
            WaitEvents,
        )
        from oceanbase_tpu_torch.server.mysql_protocol import (
            mysql_native_hash,
        )
        from oceanbase_tpu_torch.server.profiler import DeviceProfileStore
        from oceanbase_tpu_torch.server.trace import TraceRegistry
        from oceanbase_tpu_torch.server.virtual_tables import VirtualTables

        self._node = node
        self.root = root
        self.device = node.device
        self.config = node.config
        self.node_id = node.node_id  # stamps trace spans / gv$trace
        self.tenants = {"sys": node.tenant}
        self.workarea_history: list = []
        # the stores the port's sessions write beside the reference's
        # (a node runs no calibration probe: its roofline stays
        # uncalibrated, as a Database booted with enable_calibration off)
        self.cost_units = None
        self.procedures: dict | None = None
        self.users: dict[str, bytes] = {"root": mysql_native_hash("")}
        self.plan_choice = PlanChoiceLedger(
            int(self.config["plan_history_entries"]))
        self.time_calibration = TimeCalibration()
        self.device_profiles = DeviceProfileStore()
        self.faults = None
        self.plan_monitor = PlanMonitor()
        self.plan_feedback = PlanFeedback(
            int(self.config["plan_feedback_entries"]))
        self.plan_history = PlanHistory(
            int(self.config["plan_history_entries"]))
        self.audit = SqlAudit(int(self.config["sql_audit_queue_size"]))
        self.wait_events = WaitEvents()
        self.time_model = TimeModel()  # gv$time_model (phase split)
        # ASH + full-link trace ring: NodeServer.start()/stop() drive
        # the sampler lifecycle; sessions register their state slots in
        # Session.__init__ like they do against a plain Database
        self.ash = AshSampler(
            interval_s=int(self.config["ash_sample_interval_ms"])
            / 1000.0)
        self.trace_registry = TraceRegistry(
            int(self.config["trace_ring_spans"]))
        self.dtl_metrics = DtlMetrics()
        self.dtl = None  # DtlExchange, installed by NodeServer
        self.health = None  # HealthMonitor, installed by NodeServer
        self.scrub = None  # ScrubState, installed by NodeServer
        # overload plane: statement admission + KILL for the sessions
        # this node's wire threads run (one sys tenant per node)
        from oceanbase_tpu_torch.server.admission import AdmissionController

        self.admission = AdmissionController(
            self.config,
            weight_of=lambda name: int(
                self.config["admission_tenant_weight"]))
        self.virtual_tables = VirtualTables(self)
        self._session_ids = itertools.count(1)
        # workload diagnostics repository: NodeServer installs the
        # fault plane on self.faults first, then start() launches the
        # snapshot thread beside scrub/hb/ckpt
        from oceanbase_tpu_torch.server.workload import WorkloadRepository

        self.workload = WorkloadRepository(self, root)

    @property
    def tx(self):
        return self._node.tx

    @property
    def engine(self):
        return self._node.engine

    @property
    def catalog(self):
        return self._node.catalog

    def tenant(self, name: str = "sys"):
        return self.tenants[name]

    def create_tenant(self, *a, **kw):
        raise NotImplementedError(
            "tenant DDL is a rootservice operation; run it on the "
            "cluster bootstrap node")

    drop_tenant = create_tenant


class NodeServer:
    def __init__(self, node_id: int, host: str, port: int,
                 peers: dict[int, tuple[str, int]],
                 root: str | None = None, bootstrap: bool = False,
                 lease_ms: int = 2000, device=None):
        import os

        from oceanbase_tpu_torch.server.config import Config
        from oceanbase_tpu_torch.server.tenant import Tenant

        self.node_id = node_id
        self.root = root
        # no CPU fallback: "cuda" (the default) raises without a card
        self.device = default_device(device)
        self.peer_addrs = dict(peers)
        self.config = Config(persist_path=(
            os.path.join(root, "config.json") if root else None))
        # metrics plane on/off rides the config (ALTER SYSTEM SET
        # enable_metrics — scripts/metrics_bench.py prices the toggle)
        from oceanbase_tpu_torch.server import metrics as _qmetrics

        _qmetrics.set_enabled(bool(self.config["enable_metrics"]))
        self.config.watch(
            lambda k, v: _qmetrics.set_enabled(bool(v))
            if k == "enable_metrics" else None)
        # per-process fault plane: every frame this node sends or
        # receives consults it (seeded — nemesis schedules replay)
        self.faults = FaultPlane(seed=int(self.config["fault_seed"]))
        pool = int(self.config["rpc_conn_pool_size"])
        max_conns = int(self.config["rpc_max_conns_per_peer"])
        self.peers = {pid: RpcClient(h, p, peer_id=pid,
                                     local_id=node_id,
                                     faults=self.faults, pool_size=pool,
                                     max_conns=max_conns)
                      for pid, (h, p) in peers.items()}
        self._apply_lock = threading.RLock()

        # rebuild tier: a WIPED node (no manifest, no slog, no WAL)
        # bootstraps from a peer's checkpoint + segments + WAL BEFORE
        # the engine opens, then boots through the ordinary restart
        # path (≙ ob_storage_ha_dag replica rebuild).  The whole boot
        # runs under one trace so gv$trace shows the recovery tree
        # (rebuild.fetch / recovery.replay / recovery.restore_prepared).
        import uuid

        from oceanbase_tpu_torch.net import rebuild as _rebuild
        from oceanbase_tpu_torch.server import trace as qtrace
        from oceanbase_tpu_torch.storage.recovery import RecoveryState

        self.recovery = RecoveryState(node_id)
        boot_trace = qtrace.TraceCtx(
            f"boot-{node_id}-{uuid.uuid4().hex[:8]}", node=node_id)
        with qtrace.activate(boot_trace):
            if root:
                # baseline integrity is NOT gated by the rebuild knob:
                # a digest-failing manifest/slog pair quarantines here
                # regardless, so boot falls back to WAL replay instead
                # of trusting (or crashing on) rot
                _rebuild.quarantine_corrupt_baseline(
                    root, recovery=self.recovery)
            if root and bool(self.config["enable_auto_rebuild"]):
                _rebuild.maybe_rebuild(
                    root, node_id, self.peers, recovery=self.recovery,
                    chunk_bytes=int(self.config["rebuild_chunk_bytes"]))

            wal_dir = os.path.join(root, "wal") if root else None
            self.palf = NetPalf(node_id, self.peers, log_dir=wal_dir,
                                apply_cb=self._apply_entry,
                                lease_ms=lease_ms,
                                recovery=self.recovery)
            # quarantine policy: a cluster node has peers to refetch a
            # checksum-failing segment from, so boot quarantines and
            # the scrub plane repairs instead of failing the boot
            self.tenant = Tenant("sys", root, self.config,
                                 wal=self.palf, recovery=self.recovery,
                                 device=self.device,
                                 corrupt_policy="quarantine")
        self.engine = self.tenant.engine
        # persistence boundaries consult the disk-fault plane (seeded
        # bitflip/truncate of just-written files; gated at arm time by
        # enable_disk_faults in _h_fault_inject)
        self.engine.faults = self.faults
        self.palf.replica.faults = self.faults
        # disk-pressure degradation hooks: entering read-only hands
        # PALF leadership to a peer with headroom (writes land there);
        # exiting needs no action — the location cache re-learns
        self.tenant.diskmgr.on_readonly = self._on_disk_readonly
        self.tx = self.tenant.tx
        self.catalog = self.tenant.catalog
        # replicate logical DDL through the log stream (followers apply
        # in _apply_entry; physical segment ops stay node-local)
        self.engine.ddl_wal_cb = self._on_local_ddl
        self.db = NodeDatabase(self, root)
        # backup/spill writers reach the fault plane through the db
        self.db.faults = self.faults
        if boot_trace.spans:
            self.db.trace_registry.add(boot_trace.snapshot())
        from oceanbase_tpu_torch.px.dtl import DtlExchange

        self.db.dtl = DtlExchange(self, self.db.dtl_metrics)
        self.location = LocationCache(node_id, self.peers,
                                      self.palf._on_state)
        # failure detector: heartbeats + per-call outcomes feed the
        # three-state breaker; a dead leader triggers re-election
        self.health = HealthMonitor(
            node_id, self.peers,
            interval_s=float(self.config["health_ping_interval_s"]),
            suspect_after=int(self.config["health_suspect_threshold"]),
            down_after=int(self.config["health_down_threshold"]),
            on_down=self._on_peer_down)
        for pid, cli in self.peers.items():
            cli.observer = self.health.observer(pid)
        self.db.health = self.health

        self.rebuild = _rebuild.RebuildServer(self)
        from oceanbase_tpu_torch.storage.scrub import Scrubber

        self.scrubber = Scrubber(self)
        self.db.scrub = self.scrubber.state
        from oceanbase_tpu_torch.px.dtl import CancelRegistry

        self.dtl_cancels = CancelRegistry()
        handlers = {
            "ping": lambda: "pong",
            "das.scan": self._h_scan,
            "das.pull": self._h_pull,
            "dtl.execute": self._h_dtl_execute,
            "dtl.cancel": self._h_dtl_cancel,
            "sql.execute": self._h_execute,
            "node.state": self._h_state,
            "cluster.health": self._h_health,
            "recovery.state": self._h_recovery,
            "metrics.scrape": self._h_metrics,
            "workload.snapshot": self._h_workload_snapshot,
            "fault.inject": self._h_fault_inject,
            "fault.clear": self._h_fault_clear,
            "config.set": self._h_config_set,
            "scrub.checksum": self.scrubber.checksum_handler,
            "scrub.run": self._h_scrub_run,
            "disk.takeover": self._h_disk_takeover,
            **self.rebuild.handlers(),
            **self.palf.handlers(),
        }
        self.server = RpcServer(host, port, handlers,
                                faults=self.faults, node_id=node_id)
        self._sessions: dict = {}
        self._stop = threading.Event()
        self._hb: threading.Thread | None = None
        self._ckpt: threading.Thread | None = None
        self._bootstrap = bootstrap

    # ------------------------------------------------------------------
    # WAL apply (follower replay; ≙ replayservice)
    # ------------------------------------------------------------------
    def _apply_entry(self, entry):
        with self._apply_lock:
            if entry.lsn in self.palf.local_lsns:
                # leader-originated: the write path already applied it
                self.palf.local_lsns.discard(entry.lsn)
                return
            # the tx service's PERSISTENT replay buffers: boot replay
            # leftovers (e.g. a prepared XA branch's redo) stay visible
            # to a commit record arriving later through catch-up, and a
            # replayed prepare record registers the branch for XA
            # RECOVER on this node too (durable XA across failover);
            # the record is parsed there, once
            stats: dict = {}
            max_ts = self.tx.apply_replay([entry], stats=stats)
            if stats.get("ddl"):
                self.catalog.schema_version += 1
            if max_ts:
                self.tx.gts.advance_to(max_ts)

    def _on_local_ddl(self, op: dict):
        """Engine slog hook: replicate logical DDL when leading (a
        follower reaching here is applying REMOTE ddl — don't re-ship)."""
        if op.get("op") not in _DDL_KINDS:
            return
        if not self.palf.is_leader:
            return
        self.palf.append([json.dumps({"op": "ddl", "slog": op}).encode()])

    # ------------------------------------------------------------------
    # RPC handlers
    # ------------------------------------------------------------------
    def _h_state(self):
        return {"node_id": self.node_id,
                "tables": sorted(t for t in self.engine.tables
                                 if not t.startswith("__idx__")),
                "gts": self.tx.gts.current(),
                # the port's addition: where this node runs its tenant
                "device": str(self.device),
                **self.palf._on_state()}

    def _h_health(self):
        """Failure-detector snapshot (the wire face of
        gv$cluster_health)."""
        return {"node_id": self.node_id,
                "peers": self.health.snapshot()}

    def _h_metrics(self, format: str = "wire"):
        """One node's metrics snapshot (the wire face of gv$sysstat /
        gv$sysstat_histogram).  ``format="prom"`` returns Prometheus
        text exposition instead of the mergeable wire body."""
        from oceanbase_tpu_torch.server import metrics as qmetrics

        if format == "prom":
            return {"node_id": self.node_id,
                    "text": qmetrics.prom_text()}
        return {"node_id": self.node_id,
                "wire": qmetrics.wire_snapshot()}

    def _h_workload_snapshot(self):
        """This node's LOCAL workload-diagnostics payload (the wire
        face of the snapshot merge): a pure read of monotonic counters
        plus point-in-time state, digest-stamped so the merging
        coordinator can verify the bulk body before folding it in."""
        from oceanbase_tpu_torch.server.workload import canonical_bytes
        from oceanbase_tpu_torch.storage.integrity import bytes_crc

        payload = self.db.workload.collect()
        return {"node_id": self.node_id,
                "payload": payload,
                "crc": bytes_crc(canonical_bytes(payload))}

    def _h_recovery(self):
        """Recovery progress (the wire face of gv$recovery): boot
        replay / rebuild / checkpoint events plus the live catch-up
        lag and the prepared XA branches this node can recover."""
        r = self.palf.replica
        xids = self.tx.recoverable_xids()
        return {"node_id": self.node_id,
                "applied_lsn": r.applied_lsn,
                "committed_lsn": r.committed_lsn,
                "replay_point": self.engine.meta.get("wal_lsn", 0),
                "prepared_xids": xids,
                "events": self.recovery.rows()}

    def _h_fault_inject(self, where: str, action: str, verb=None,
                        peer=None, prob: float = 1.0, nth=None,
                        count: int = -1, delay_ms: float = 0.0,
                        seed=None):
        """Admin verb arming one FaultPlane rule on THIS node (≙ ALTER
        SYSTEM SET ... errsim tracepoints; gated by config so a stray
        client cannot chaos a production cluster)."""
        if not bool(self.config["enable_fault_injection"]):
            raise PermissionError(
                "fault injection disabled: alter system set "
                "enable_fault_injection = true first")
        if where == "disk" and not bool(self.config["enable_disk_faults"]):
            raise PermissionError(
                "disk faults disabled: alter system set "
                "enable_disk_faults = true first")
        rid = self.faults.inject(where, action, verb=verb, peer=peer,
                                 prob=prob, nth=nth, count=count,
                                 delay_ms=delay_ms, seed=seed)
        return {"rule_id": rid, "node_id": self.node_id}

    def _h_fault_clear(self, rule_id=None):
        return {"removed": self.faults.clear(rule_id),
                "node_id": self.node_id}

    def _h_config_set(self, name: str, value):
        """Admin verb: set one config knob on THIS node (≙ ALTER
        SYSTEM SET ... SERVER 'ip:port', which scopes a change to a
        single observer).  SQL ALTER SYSTEM routes to the leader, so
        retuning a specific replica — e.g. lifting the log budget on
        a demoted, disk-pressured node — needs the node-scoped path.
        A disk-budget change polls the disk manager immediately:
        budget crossings (and read-only auto-exit) must not ride out
        the checkpoint-loop cadence."""
        self.config.set(str(name), value)
        if str(name).endswith("_disk_limit_bytes"):
            self.tenant.diskmgr.poll(force=True)
        return {"node_id": self.node_id, "name": str(name),
                "read_only": bool(self.tenant.diskmgr.read_only)}

    def _h_scrub_run(self):
        """Admin verb: run one scrub round NOW (detect → quarantine →
        repair → parity) and return its summary — the periodic loop's
        cadence is for production, benches/tests want determinism."""
        return self.scrubber.run_once()

    def _on_peer_down(self, pid: int):
        """Failure-detector down transition: stop routing at the dead
        peer, and if it was the leader, campaign NOW instead of letting
        writes ride out the remaining lease (≙ election priority takeover
        on server blacklist events)."""
        self.location.invalidate()
        if not self._stop.is_set():
            self.palf.on_peer_down(pid)

    def _on_disk_readonly(self, surface: str):
        """Read-only entry hook (server/diskmgr): if this node leads
        the PALF group, hand leadership to a peer with log-disk
        headroom so cluster writes keep landing somewhere — the
        relinquish runs OFF the write path (the hook fires inside a
        failing writer's poll)."""
        if not self.palf.is_leader or self._stop.is_set():
            return

        def _relinquish():
            for pid in sorted(self.peers):
                qadmission.checkpoint()  # KILL/deadline between peers
                try:
                    if self.peers[pid].call("disk.takeover",
                                            from_node=self.node_id):
                        self.location.invalidate()
                        return
                except OSError:
                    continue

        threading.Thread(target=_relinquish, daemon=True).start()

    def _h_disk_takeover(self, from_node=None):
        """A disk-pressured leader asks THIS node to campaign.  Refuse
        when our own log surface is degraded (shifting leadership onto
        another full disk helps nobody); otherwise run one election —
        winning demotes the pressured leader via the term bump."""
        dm = self.tenant.diskmgr
        dm.poll(force=True)
        if dm.read_only or dm.state("log") in ("pressure", "full"):
            return False
        try:
            self.palf.elect()
            return True
        except (NoQuorum, OSError):
            return False

    def _h_scan(self, table: str, snapshot: int | None = None,
                offset: int = 0, limit: int = SCAN_CHUNK_ROWS):
        """One chunk of a snapshot scan; the caller pages via
        offset/limit (streamed batches, ≙ the DAS scan iterator)."""
        ts = self.engine.tables.get(table)
        if ts is None:
            raise KeyError(f"table {table} not on node {self.node_id}")
        snap = int(snapshot) if snapshot else self.tx.gts.current()
        arrays, valids = ts.tablet.snapshot_arrays(snap)
        n = len(next(iter(arrays.values()))) if arrays else 0
        s, e = min(offset, n), min(offset + limit, n)
        out_arrays = {k: np.asarray(v)[s:e] for k, v in arrays.items()}
        out_valids = {k: np.asarray(v)[s:e]
                      for k, v in valids.items() if v is not None}
        return {
            "snapshot": snap, "total": n,
            "arrays": out_arrays,
            "valids": out_valids,
            # per-chunk digest over the bytes that actually ship; the
            # client verifies each page before concatenating
            "crc": arrays_crc(out_arrays, out_valids),
            "types": {c.name: [c.dtype.kind.value, c.dtype.precision or 0,
                               c.dtype.scale or 0]
                      for c in ts.tdef.columns},
        }

    def _h_pull(self, table: str, node_id: int | None = None):
        """Pull a table's full snapshot from a peer via the legacy
        das.scan paging (the path DTL pushdown replaces) and report its
        wire cost — the pushdown-vs-pull comparison surface used by
        scripts/dtl_bench.py; the pull is recorded as a mode='pull' row
        in gv$px_exchange by fetch_remote_table."""
        stats: dict = {}
        arrays, _valids, _types, snap = self.fetch_remote_table(
            table, node_id=node_id, stats=stats)
        n = len(next(iter(arrays.values()))) if arrays else 0
        return {"rows": n, "snapshot": snap,
                "bytes": stats.get("bytes", 0), "node": self.node_id}

    def _h_dtl_cancel(self, token: str):
        """Idempotent fragment cancellation (the remote half of KILL /
        query timeout): set — or tombstone — the cancel flag for
        ``token``; a running fragment observes it at its next host-side
        result-boundary checkpoint, a late-arriving one aborts before
        scanning anything."""
        return {"already": self.dtl_cancels.cancel(str(token)),
                "node_id": self.node_id}

    def _h_dtl_execute(self, plan: dict, table: str, snapshot: int,
                       part: int = 0, nparts: int = 1,
                       applied_lsn: int = 0, with_ops: bool = False,
                       monitor_lanes: bool = False,
                       cancel_token: str = ""):
        """Execute one DTL partial-plan slice against the local replica
        (≙ the SQC running its DFO over local tablets and streaming
        exchange rows back; px/dtl.py holds the plan wire codec).

        ``applied_lsn`` is the coordinator's WAL apply point when it
        chose the snapshot: a replica behind it may be missing rows
        visible at ``snapshot``, so it refuses and the coordinator runs
        the slice on its own replica instead; a replica AHEAD is fine —
        the MVCC snapshot filter hides any newer versions."""
        from oceanbase_tpu_torch.px import dtl

        ts = self.engine.tables.get(table)
        if ts is None:
            raise KeyError(f"table {table} not on node {self.node_id}")
        if self.palf.replica.applied_lsn < int(applied_lsn):
            raise dtl.DtlLagging(
                f"node {self.node_id} applied lsn "
                f"{self.palf.replica.applied_lsn} < {applied_lsn}")
        from oceanbase_tpu_torch.server import trace as qtrace

        # coordinator-propagated cancellation: the fragment runs under a
        # RemoteCtx observing the token's flag, so execute_plan's
        # result-boundary checkpoints stop remote work too (and a
        # tombstoned token aborts before scanning anything)
        from oceanbase_tpu_torch.server import admission as qadmission

        rctx = None
        pinned = ""
        if cancel_token:
            # pin for the fragment's whole execution: an LRU eviction
            # while RUNNING would hand dtl.cancel a fresh Event the
            # fragment's RemoteCtx never observes
            ev = self.dtl_cancels.pin(str(cancel_token))
            pinned = str(cancel_token)
            if ev.is_set():
                self.dtl_cancels.unpin(pinned)
                raise qadmission.QueryKilled(
                    f"fragment {cancel_token} cancelled before start")
            rctx = qadmission.RemoteCtx(ev, token=str(cancel_token))
        # monitor_lanes is the COORDINATOR's monitor-knob state (see
        # dtl.execute_fragment's monitor_lanes contract).  A local (coordinator-thread) call arrives WITHOUT a token and
        # must keep the statement's own ctx active — never mask it.
        import contextlib

        try:
            with (qadmission.activate(rctx) if rctx is not None
                  else contextlib.nullcontext()):
                with qtrace.span("dtl.fragment", table=table,
                                 part=int(part)) as sp:
                    out = dtl.execute_fragment(
                        ts, plan, int(snapshot), int(part), int(nparts),
                        with_ops=bool(with_ops),
                        monitor_lanes=bool(monitor_lanes),
                        device=self.device)
                    sp.tags.update(rows=out["rows"],
                                   scanned=out["scanned"])
                    return out
        finally:
            if pinned:
                self.dtl_cancels.unpin(pinned)

    def _h_execute(self, sql: str, consistency: str = "strong",
                   session_id: int = 0, forwarded: bool = False):
        return self.execute(sql, consistency=consistency,
                            session_id=session_id, _forwarded=forwarded)

    # ------------------------------------------------------------------
    # SQL surface
    # ------------------------------------------------------------------
    def _session(self, session_id: int = 0):
        from oceanbase_tpu_torch.sql.session import Session

        s = self._sessions.get(session_id)
        if s is None:
            # concurrent wire threads race the check-then-insert; the
            # apply lock makes one session per id authoritative
            with self._apply_lock:
                s = self._sessions.get(session_id)
                if s is None:
                    s = Session(self.catalog, tenant=self.tenant,
                                db=self.db)
                    self._sessions[session_id] = s
        return s

    @staticmethod
    def _is_write(sql: str) -> bool:
        return sql.lstrip().lower().startswith(_WRITE_PREFIXES)

    def execute(self, sql: str, consistency: str = "strong",
                session_id: int = 0, _forwarded: bool = False) -> dict:
        """-> {names, arrays, valids, rowcount, types, node}."""
        if self.peers and _is_load_infile(sql):
            raise LoadDataOnCluster(
                "LOAD DATA INFILE on a cluster node would write its rows "
                "on this node alone (direct-load segments do not ride "
                "the log stream); load with INSERT")
        if self.palf.is_leader:
            self._apply_to_commit_point()
            return self._run_local(sql, session_id)
        if not self._is_write(sql) and consistency != "strong":
            return self._run_local(sql, session_id)  # weak local read
        if _forwarded:
            # a peer believed we lead but we don't — make it retry
            raise NotLeader(f"node {self.node_id} is not the leader")
        return self._forward(sql, consistency, session_id)

    def _apply_to_commit_point(self):
        """Hold a statement on the leader until every entry this node
        knows committed is applied: a new leader commits the entries of
        earlier terms through its election's no-op and applies them
        outside the log lock, and a statement arriving in that window
        would read (and check keys against) older state than the log
        holds.  The reference serves it at once (ROADMAP Queue 3 #30).
        The wait takes no log lock: a heartbeat that holds it across its
        rpcs to a slow peer does not hold up the statement."""
        r = self.palf.replica
        end = time.monotonic() + 30.0
        target = self.palf.commit_point(0.0)
        while target is None:  # an election under way
            qadmission.checkpoint()
            if time.monotonic() >= end:
                raise NotLeader(f"node {self.node_id} is still electing")
            target = self.palf.commit_point(0.05)
        while r.applied_lsn < target:
            qadmission.checkpoint()  # KILL/deadline while the apply runs
            r.drain_applies()
            if r.applied_lsn >= target:
                return
            if time.monotonic() >= end:
                raise NotLeader(
                    f"node {self.node_id} has applied lsn {r.applied_lsn}"
                    f" of its commit point {target}")
            time.sleep(0.002)

    def _run_local(self, sql: str, session_id: int) -> dict:
        s = self._session(session_id)
        res = s.execute(sql)
        arrays, valids = {}, {}
        for name in res.names:
            arrays[name] = np.asarray(res.arrays[name])
            v = res.valids.get(name)
            if v is not None:
                valids[name] = np.asarray(v)
        return {"names": list(res.names), "arrays": arrays,
                "valids": valids, "rowcount": int(res.rowcount),
                # result digest: forwarded statements ride the wire
                # back, and the forwarding node verifies before handing
                # rows to the session (local callers just ignore it)
                "crc": arrays_crc(arrays, valids),
                "types": {n: [t.kind.value, t.precision or 0,
                              t.scale or 0]
                          for n, t in res.dtypes.items()
                          if t is not None},
                "node": self.node_id}

    def _forward(self, sql: str, consistency: str, session_id: int):
        """Route to the leader; campaign ourselves when none is
        reachable (≙ OB_NOT_MASTER retry + failover)."""
        last_err: Exception | None = None
        for _attempt in range(4):
            qadmission.checkpoint()  # KILL/deadline between route tries
            target = self.location.leader()
            if target is None or target == self.node_id:
                try:
                    self.palf.elect()
                except NoQuorum as e:
                    last_err = e
                    time.sleep(0.25)
                    continue
                return self._run_local(sql, session_id)
            try:
                # safe despite the retry loop: the request_sent guard
                # below refuses to re-route once the statement may have
                # reached the old leader's wire
                res = self.peers[target].call(  # obcheck: ok(rpc.nonidempotent-resend)
                    "sql.execute", sql=sql, consistency=consistency,
                    session_id=(self.node_id << 32) | session_id,
                    forwarded=True)
                self._verify_result(res, target)
                return res
            except (OSError, RpcError) as e:
                if isinstance(e, RpcError) and e.kind not in (
                        "NotLeader", "NoQuorum"):
                    raise
                if getattr(e, "request_sent", False):
                    # the statement hit the wire and the reply was lost:
                    # the DML may have applied on the old leader, so a
                    # blind re-route could double-apply — surface the
                    # transport error to the session layer instead
                    raise
                last_err = e
                self.location.invalidate()
                time.sleep(0.25)
        raise NotLeader(f"no reachable leader: {last_err}")

    def _verify_result(self, res: dict, peer: int):
        """Digest check of a forwarded-statement reply (the sql twin of
        dtl.verify_reply)."""
        crc = res.get("crc")
        if crc is None:
            return  # pre-integrity peer build
        got = arrays_crc(res.get("arrays", {}), res.get("valids", {}))
        if got != crc:
            raise CorruptionError(
                f"sql.execute reply digest mismatch (peer {peer})",
                kind="sql")

    # ------------------------------------------------------------------
    # remote-relation fetch (DAS client side)
    # ------------------------------------------------------------------
    def fetch_remote_table(self, table: str, node_id: int | None = None,
                           snapshot: int | None = None,
                           stats: dict | None = None):
        """Stream a table's snapshot from its home node in chunks
        -> (arrays, valids, types, snapshot).  ``stats`` (optional dict)
        receives the exact wire cost: {"bytes", "rows"}."""
        import time as _time

        if node_id is None:
            node_id = self.location.home_of(table)
        cli = self.peers.get(node_id)
        if cli is None:
            # the table's home is this node (or unknown): serve the
            # local snapshot through the same handler instead of a
            # KeyError masquerading as an RpcError
            return self._local_table_pages(table, snapshot, stats)
        chunks = []
        snap, off, nbytes = snapshot, 0, 0
        t0 = _time.time()       # record timestamp (wall)
        m0 = _time.monotonic()  # elapsed source (step-proof)
        while True:
            qadmission.checkpoint()  # KILL/deadline between pages
            r, sent, recv = cli.call_with_size(
                "das.scan", table=table, snapshot=snap,
                offset=off, limit=SCAN_CHUNK_ROWS)
            if r.get("crc") is not None and \
                    arrays_crc(r["arrays"], r.get("valids", {})) \
                    != r["crc"]:
                raise CorruptionError(
                    f"das.scan chunk digest mismatch (table {table}, "
                    f"peer {node_id}, offset {off})", kind="das")
            nbytes += sent + recv
            snap = r["snapshot"]
            chunks.append(r)
            off += SCAN_CHUNK_ROWS
            if off >= r["total"]:
                break
        arrays, valids = {}, {}
        for k in chunks[0]["arrays"]:
            arrays[k] = np.concatenate([c["arrays"][k] for c in chunks])
        for k in chunks[0].get("valids", {}):
            valids[k] = np.concatenate([c["valids"][k] for c in chunks])
        if stats is not None:
            stats["bytes"] = nbytes
            stats["rows"] = chunks[0]["total"]
        metrics = getattr(self.db, "dtl_metrics", None)
        if metrics is not None:
            from oceanbase_tpu_torch.px.dtl import DtlRecord

            metrics.record(DtlRecord(
                ts=t0, table=table, mode="pull", parts=1,
                pushdown_hit=False, bytes_shipped=nbytes,
                rows_shipped=chunks[0]["total"],
                elapsed_s=_time.monotonic() - m0))
        return arrays, valids, chunks[0]["types"], snap

    def _local_table_pages(self, table: str, snapshot: int | None,
                           stats: dict | None):
        """fetch_remote_table's local twin: page the snapshot through
        the same das.scan handler (zero wire bytes)."""
        chunks, snap, off = [], snapshot, 0
        while True:
            r = self._h_scan(table, snapshot=snap, offset=off,
                             limit=SCAN_CHUNK_ROWS)
            snap = r["snapshot"]
            chunks.append(r)
            off += SCAN_CHUNK_ROWS
            if off >= r["total"]:
                break
        arrays, valids = {}, {}
        for k in chunks[0]["arrays"]:
            arrays[k] = np.concatenate([c["arrays"][k] for c in chunks])
        for k in chunks[0].get("valids", {}):
            valids[k] = np.concatenate([c["valids"][k] for c in chunks])
        if stats is not None:
            stats["bytes"] = 0
            stats["rows"] = chunks[0]["total"]
        return arrays, valids, chunks[0]["types"], snap

    # ------------------------------------------------------------------
    def start(self):
        self.server.start()
        self._hb = threading.Thread(target=self._heartbeat, daemon=True)
        self._hb.start()
        self._ckpt = threading.Thread(target=self._checkpoint_loop,
                                      daemon=True)
        self._ckpt.start()
        self._scrub = threading.Thread(target=self._scrub_loop,
                                       daemon=True)
        self._scrub.start()
        self.health.start()
        if bool(self.config["enable_ash"]):
            self.db.ash.start()
        # workload snapshot thread: always launched (the loop gates on
        # enable_workload_repo every round, so ALTER SYSTEM turns it
        # on/off without a restart)
        self.db.workload.start()
        if self._bootstrap:
            threading.Thread(target=self._bootstrap_elect,
                             daemon=True).start()

    def _bootstrap_elect(self):
        """Campaign until a majority of peers is reachable (cluster
        bootstrap, ≙ rootservice bootstrap electing the first leader)."""
        while not self._stop.is_set():
            try:
                if self.location.leader() is not None:
                    return
                self.palf.elect()
                return
            except NoQuorum:
                time.sleep(0.3)

    def _heartbeat(self):
        period = self.palf.proposer.lease_ms / 4000.0
        while not self._stop.wait(period):
            try:
                if self.palf.replica.role == "leader":
                    self.palf.tick()
                else:
                    # a cluster left with no leader elects one without
                    # waiting for a write (ROADMAP Queue 3 #31)
                    self.palf.campaign_if_leaderless()
            except Exception:
                pass

    def _checkpoint_loop(self):
        """Periodic replay-point advance (≙ the tenant checkpoint slog
        recycler): restart replay cost stays O(WAL tail since the last
        checkpoint), not O(history).  Skips quiet intervals — a
        checkpoint only runs once the local APPLY point is at least
        ``checkpoint_lag_entries`` past the persisted replay point."""
        while not self._stop.wait(
                float(self.config["log_checkpoint_interval_s"])):
            try:
                lag = (self.palf.replica.applied_lsn
                       - int(self.engine.meta.get("wal_lsn", 0)))
                if lag >= int(self.config["checkpoint_lag_entries"]):
                    self.tenant.checkpoint()
            except Exception:
                pass  # transient flush failure: retry next interval
            try:
                # disk-pressure poll rides the same cadence: budget
                # crossings degrade (and read-only auto-exits) even on
                # a node receiving no writes
                self.tenant.diskmgr.poll()
            except Exception:
                pass

    def _scrub_loop(self):
        """Periodic scrub rounds (storage/scrub.py): local re-verify,
        cross-replica digest vote, auto-repair.  The knob pair is read
        live — the wait ticks at most 1 s at a time so ALTER SYSTEM SET
        scrub_interval_s retunes the cadence without riding out a long
        in-flight sleep."""
        last = time.monotonic()
        while not self._stop.wait(
                min(float(self.config["scrub_interval_s"]), 1.0)):
            try:
                if time.monotonic() - last < \
                        float(self.config["scrub_interval_s"]):
                    continue
                last = time.monotonic()
                if bool(self.config["enable_scrub"]):
                    self.scrubber.run_once()
            except Exception:
                pass  # transient (peer churn mid-round): next round

    def stop(self):
        self._stop.set()
        self.db.workload.stop()
        self.db.ash.stop()
        self.health.stop()
        self.server.stop()
        self.palf.close()

    @property
    def port(self) -> int:
        return self.server.port


def _is_load_infile(sql: str) -> bool:
    words = sql.split(None, 2)
    return (len(words) >= 2 and words[0].lower() == "load"
            and words[1].lower() == "data")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--node-id", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--peers", default="",
                    help="id=host:port,id=host:port")
    ap.add_argument("--root", default=None)
    ap.add_argument("--bootstrap", action="store_true")
    ap.add_argument("--lease-ms", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exits nonzero without a "
                         "card) or cpu")
    args = ap.parse_args(argv)
    peers = {}
    for part in filter(None, args.peers.split(",")):
        pid, addr = part.split("=")
        h, p = addr.rsplit(":", 1)
        peers[int(pid)] = (h, int(p))
    t0 = time.monotonic()
    node = NodeServer(args.node_id, args.host, args.port, peers,
                      root=args.root, bootstrap=args.bootstrap,
                      lease_ms=args.lease_ms, device=args.device)
    t1 = time.monotonic()
    node.start()
    print(f"node {args.node_id} listening on {args.host}:{node.port} "
          f"(NodeServer {t1 - t0:.3f} s: storage, WAL scan, device; "
          f"start {time.monotonic() - t1:.3f} s)", flush=True)
    try:
        # CLI foreground idle: KeyboardInterrupt IS the cancel path
        while True:  # obcheck: ok(cancel.loop-no-checkpoint)
            time.sleep(3600)
    except KeyboardInterrupt:
        node.stop()


if __name__ == "__main__":
    main()
