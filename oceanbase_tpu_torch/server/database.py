"""Database: the single-node instance of the port.

Port of ``oceanbase_tpu/server/database.py`` (≙ ObServer::init/start,
src/observer/ob_server.cpp:228, booting config, storage meta replay and
log replay): a persisted cluster ``Config``; the ``sys`` tenant and every
tenant persisted under ``<root>/tenants`` (each with its own storage
engine, PALF WAL, transaction service and a ``StorageCatalog`` on the
database's device); the users (``users.json``, mysql_native_password
hashes; ``root`` starts passwordless); statement admission
(``server/admission.py``); stored procedures (``procedures.json``,
loaded at first use by a session); the DBMS job scheduler
(``server/jobs.py``, whose thread starts only with ``enable_dbms_jobs``
or ``jobs.start()``); and the TLS credentials of the wire protocol
(``server/tls.py``).  ``Database(root).session(tenant).execute(sql)`` is
the in-process entry point and ``server/mysql_protocol.py::MySQLServer``
the wire one; both run on ``cuda`` unless the caller passes
``device="cpu"``, and raise without CUDA otherwise.

The measurement plane (ROADMAP Queue 1 item 9): the metrics flag
(``enable_metrics``) and the host/device time split
(``enable_profiling``), both process-global and hot-reloaded by config
watchers; roofline calibration at boot (``enable_calibration``: adopt
``cost_units.json`` or run the "boot" probe on the database's device,
cached per process; a probe failure leaves ``cost_units`` None and never
fails the boot); the SQL audit ring, the plan monitor, plan feedback and
history, the plan-choice ledger, per-operator time calibration, the
PROFILE capture store, the time model, the trace ring, wait events, the
spill work-area history, ASH (the live session registry SHOW
PROCESSLIST and KILL read; its sampling thread starts only with
``start_ash=True`` and ``enable_ash``) and ``virtual_tables``, which
serves the gv$/v$ views through SQL.

The durability and fault plane: each tenant's disk manager (log, data
and spill budgets, read-only degradation) and memstore throttle (on by
default, ``enable_rate_limit``); ``scrubber()`` and the gv$scrub event
log; ``faults``, the disk-fault plane the
backup and spill writers consult (``arm_disk_faults`` wires one plane
into every durable writer, with ``enable_disk_faults``); ``backup()``
(a checkpointed copy; ``server/backup.py`` holds the incremental,
archive and point-in-time chain); and the workload repository
(``server/workload.py``: persistent crc-checked snapshots behind
ANALYZE/SHOW WORKLOAD REPORT, whose snapshot thread starts only with
``enable_workload_repo``).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.exec import plan as qplan
from oceanbase_tpu_torch.server import calibrate as qcalibrate
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server.admission import AdmissionController
from oceanbase_tpu_torch.server.backend_info import backend_summary
from oceanbase_tpu_torch.server.config import Config
from oceanbase_tpu_torch.server.jobs import JobScheduler
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
from oceanbase_tpu_torch.server.mysql_protocol import mysql_native_hash
from oceanbase_tpu_torch.server.profiler import DeviceProfileStore
from oceanbase_tpu_torch.server.workload import WorkloadRepository
from oceanbase_tpu_torch.storage.scrub import ScrubState, Scrubber, local_node
from oceanbase_tpu_torch.server.tenant import Tenant
from oceanbase_tpu_torch.server.trace import TraceRegistry
from oceanbase_tpu_torch.server.virtual_tables import VirtualTables


class Database:
    def __init__(self, root: str | None = None, wal_replicas: int = 3,
                 device=None, start_ash: bool = False):
        self.root = root
        self.device = default_device(device)
        cfg_path = os.path.join(root, "config.json") if root else None
        if root:
            os.makedirs(root, exist_ok=True)
        self.config = Config(persist_path=cfg_path)
        self.tenants: dict[str, Tenant] = {}
        self._session_ids = itertools.count(1)
        self.node_id = 0  # single-process instance
        # disk-fault plane (net/faults.FaultPlane): durable writers
        # (backup, spill, workload snapshots) consult it; None = no
        # injection (arm_disk_faults wires one everywhere)
        self.faults = None
        #: the scrub event log gv$scrub serves (``scrubber()`` rounds
        #: record into it)
        self.scrub = ScrubState(self.node_id)

        # metrics plane and host/device time split ride the config,
        # process-global, hot-reloaded by ALTER SYSTEM SET
        qmetrics.set_enabled(bool(self.config["enable_metrics"]))
        qplan.set_time_split(bool(self.config["enable_profiling"]))
        self.config.watch(self._on_knob)

        # roofline calibration: adopt persisted machine constants or run
        # the first-boot probe (cached per process); a corrupt
        # cost_units.json is quarantined and re-probed, never served
        self.cost_units = None
        if bool(self.config["enable_calibration"]):
            try:
                self.cost_units = qcalibrate.ensure_units(
                    root, device=self.device)
            except Exception:  # noqa: BLE001 — calibration is
                # observability: a probe failure degrades predictions
                # to zeros, never boot
                self.cost_units = None

        # observability stores
        self.audit = SqlAudit(int(self.config["sql_audit_queue_size"]))
        self.plan_monitor = PlanMonitor()
        self.plan_feedback = PlanFeedback(
            int(self.config["plan_feedback_entries"]))
        self.plan_history = PlanHistory(
            int(self.config["plan_history_entries"]))
        self.plan_choice = PlanChoiceLedger(
            int(self.config["plan_history_entries"]))
        self.time_calibration = TimeCalibration()
        self.device_profiles = DeviceProfileStore()
        self.time_model = TimeModel()
        self.trace_registry = TraceRegistry(
            int(self.config["trace_ring_spans"]))
        #: live session states (SHOW PROCESSLIST, KILL) and ASH samples
        self.ash = AshSampler(
            interval_s=int(self.config["ash_sample_interval_ms"]) / 1000.0)
        self.wait_events = WaitEvents()
        #: per-query spill records (v$sql_workarea)
        self.workarea_history: list[dict] = []
        # statement admission + fair queuing + KILL; per-tenant WRR
        # weights read live from each tenant's config overlay
        self.admission = AdmissionController(
            self.config, weight_of=self._tenant_weight)
        #: {name: ProcedureStmt}, loaded by the first session that needs
        #: it (sql/session.py::_proc_store)
        self.procedures: dict | None = None
        # workload diagnostics repository (server/workload.py):
        # persistent snapshots + ANALYZE WORKLOAD REPORT.  The snapshot
        # thread starts with the knob (or later, when ALTER SYSTEM
        # turns it on — _on_workload_knob); the loop re-reads both
        # knobs every round, so turning it OFF needs no restart.
        self.workload = WorkloadRepository(self, root)
        self.config.watch(self._on_workload_knob)
        # DBMS job scheduler (≙ dbms_job/dbms_scheduler); built-ins
        # register at boot, the thread starts on demand or when enabled
        self.jobs = JobScheduler(self)
        self.jobs.register_builtins(
            stats_interval_s=float(
                self.config["stats_gather_interval_s"]),
            compact_interval_s=float(
                self.config["auto_compact_interval_s"]))

        # user store: mysql_native_password hashes (≙ __all_user); root
        # starts passwordless like a fresh deployment
        self.users: dict[str, bytes] = {"root": mysql_native_hash("")}
        self._users_path = (os.path.join(root, "users.json")
                            if root else None)
        if self._users_path and os.path.exists(self._users_path):
            with open(self._users_path) as fh:
                self.users = {u: bytes.fromhex(h)
                              for u, h in json.load(fh).items()}

        # boot tenants: 'sys' plus any persisted tenant directories
        self.create_tenant("sys", wal_replicas=wal_replicas, _boot=True)
        if root:
            tdir = os.path.join(root, "tenants")
            if os.path.isdir(tdir):
                for name in sorted(os.listdir(tdir)):
                    if name != "sys" and name not in self.tenants and \
                            os.path.isdir(os.path.join(tdir, name)):
                        self.create_tenant(name, wal_replicas=wal_replicas,
                                           _boot=True)
        if bool(self.config["enable_dbms_jobs"]):
            self.jobs.start()
        if bool(self.config["enable_workload_repo"]):
            self.workload.start()
        self.virtual_tables = VirtualTables(self)
        if start_ash and bool(self.config["enable_ash"]):
            self.ash.start()

        # one boot log line naming the resolved backend
        logging.getLogger("oceanbase_tpu_torch.server").info(
            "boot backend: %s", backend_summary(self.device,
                                                self.cost_units))

    def _on_workload_knob(self, name: str, value):
        if name == "enable_workload_repo" and bool(value):
            self.workload.start()

    @staticmethod
    def _on_knob(name: str, value):
        if name == "enable_metrics":
            qmetrics.set_enabled(bool(value))
        elif name == "enable_profiling":
            qplan.set_time_split(bool(value))

    def _tenant_weight(self, name: str) -> int:
        t = self.tenants.get(name)
        cfg = t.config if t is not None else self.config
        return int(cfg["admission_tenant_weight"])

    # ------------------------------------------------------------------
    def create_tenant(self, name: str, wal_replicas: int = 3,
                      _boot: bool = False) -> Tenant:
        if name in self.tenants:
            if _boot:
                return self.tenants[name]
            raise ValueError(f"tenant {name} exists")
        troot = (os.path.join(self.root, "tenants", name)
                 if self.root else None)
        if troot:
            os.makedirs(troot, exist_ok=True)
        t = Tenant(name, troot, self.config, wal_replicas=wal_replicas,
                   device=self.device)
        self.tenants[name] = t
        return t

    def drop_tenant(self, name: str):
        if name == "sys":
            raise ValueError("cannot drop sys tenant")
        t = self.tenants.pop(name, None)
        if t is not None:
            t.close()
        if self.root:
            troot = os.path.join(self.root, "tenants", name)
            if os.path.isdir(troot):
                shutil.rmtree(troot, ignore_errors=True)

    def tenant(self, name: str = "sys") -> Tenant:
        return self.tenants[name]

    @property
    def tls_context(self):
        """Lazily built server TLS context (self-signed credentials
        persisted under <root>/tls; None for in-memory databases)."""
        if self.root is None:
            return None
        ctx = getattr(self, "_tls_ctx", None)
        if ctx is None:
            from oceanbase_tpu_torch.server.tls import server_context

            ctx = self._tls_ctx = server_context(self.root)
        return ctx

    # -- users (mysql_native_password credentials) -----------------------
    def create_user(self, name: str, password: str):
        self.users[name] = mysql_native_hash(password)
        self._persist_users()

    def drop_user(self, name: str):
        if name == "root":
            raise ValueError("cannot drop root")
        self.users.pop(name, None)
        self._persist_users()

    def set_password(self, name: str, password: str):
        if name not in self.users:
            raise KeyError(f"unknown user {name}")
        self.create_user(name, password)

    def _persist_users(self):
        if not self._users_path:
            return
        tmp = self._users_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({u: h.hex() for u, h in self.users.items()}, fh)
        os.replace(tmp, self._users_path)

    # -- sys-tenant convenience ------------------------------------------
    @property
    def engine(self):
        return self.tenants["sys"].engine

    @property
    def wal(self):
        return self.tenants["sys"].wal

    @property
    def tx(self):
        return self.tenants["sys"].tx

    @property
    def catalog(self):
        return self.tenants["sys"].catalog

    # ------------------------------------------------------------------
    def session(self, tenant: str = "sys"):
        """A SQL session of ``tenant`` on the database's device."""
        from oceanbase_tpu_torch.sql.session import Session

        t = self.tenants[tenant]
        return Session(t.catalog, db=self, tenant=t)

    def checkpoint(self, tenant: str | None = None):
        for name, t in self.tenants.items():
            if tenant is None or name == tenant:
                t.checkpoint()

    def backup(self, dest_root: str):
        """Physical backup: checkpoint everything, then copy the data tree
        (≙ data backup, src/storage/backup).  Restore = Database(dest)."""
        if self.root is None:
            raise ValueError("in-memory database cannot be backed up")
        self.checkpoint()
        os.makedirs(os.path.dirname(dest_root) or ".", exist_ok=True)
        shutil.copytree(self.root, dest_root, dirs_exist_ok=False)

    def scrubber(self, tenant: str = "sys") -> Scrubber:
        """A single-node scrub runner over one tenant's engine
        (``run_once()``: re-read and verify every persisted segment,
        quarantine a corrupt one, rewrite it from the resident copy),
        recording into gv$scrub."""
        return Scrubber(local_node(self.tenants[tenant], self.node_id),
                        state=self.scrub)

    def arm_disk_faults(self, plane):
        """Wire a disk-fault plane (``net/faults.FaultPlane``) into every
        durable writer of this database — each tenant's slog, manifest
        and segment writers, its WAL replicas, and the backup, spill and
        workload writers that read ``self.faults`` — or disarm them all
        with None.  Arming needs ``enable_disk_faults``, as a node's
        ``fault.inject`` of a disk rule does."""
        if plane is not None and not bool(self.config["enable_disk_faults"]):
            raise PermissionError("disk faults are disabled; set "
                                  "enable_disk_faults = true first")
        self.faults = plane
        for t in self.tenants.values():
            t.engine.faults = plane
            for r in t.wal.replicas.values():
                r.faults = plane

    def close(self):
        self.jobs.stop()
        self.ash.stop()
        self.workload.stop()
        for t in self.tenants.values():
            t.close()


__all__ = ["Database"]
