"""Database: the single-node instance of the port.

Port of ``oceanbase_tpu/server/database.py`` (≙ ObServer::init/start,
src/observer/ob_server.cpp:228, booting config, storage meta replay and
log replay): a persisted cluster ``Config``; the ``sys`` tenant and every
tenant persisted under ``<root>/tenants`` (each with its own storage
engine, PALF WAL, transaction service and a ``StorageCatalog`` on the
database's device); the users (``users.json``, mysql_native_password
hashes; ``root`` starts passwordless); statement admission
(``server/admission.py``); the live session registry SHOW PROCESSLIST
and KILL read (``server/monitor.py``); stored procedures
(``procedures.json``, loaded at first use by a session); the DBMS job
scheduler (``server/jobs.py``, whose thread starts only with
``enable_dbms_jobs`` or ``jobs.start()``); and the TLS credentials of
the wire protocol (``server/tls.py``).  ``Database(root).session(tenant)
.execute(sql)`` is the in-process entry point and
``server/mysql_protocol.py::MySQLServer`` the wire one; both run on
``cuda`` unless the caller passes ``device="cpu"``, and raise without
CUDA otherwise.

The reference's instance also boots, and this one has no argument or
attribute for: roofline calibration (the port plans with the default
cost units of ``server/calibrate.py`` and runs no probe), the SQL audit
ring, the plan monitor, plan feedback and history, ASH sampling, wait
events, the trace ring, the metrics plane and the workload repository
(ROADMAP Queue 1 item 9, the measurement plane), and the virtual
tables (item 5b, sub-item 9).  ``backup()`` waits for sub-item 13.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.server.admission import AdmissionController
from oceanbase_tpu_torch.server.backend_info import backend_summary
from oceanbase_tpu_torch.server.config import Config
from oceanbase_tpu_torch.server.jobs import JobScheduler
from oceanbase_tpu_torch.server.monitor import AshSampler
from oceanbase_tpu_torch.server.mysql_protocol import mysql_native_hash
from oceanbase_tpu_torch.server.tenant import Tenant


class Database:
    def __init__(self, root: str | None = None, wal_replicas: int = 3,
                 device=None):
        self.root = root
        self.device = default_device(device)
        cfg_path = os.path.join(root, "config.json") if root else None
        if root:
            os.makedirs(root, exist_ok=True)
        self.config = Config(persist_path=cfg_path)
        self.tenants: dict[str, Tenant] = {}
        self._session_ids = itertools.count(1)
        #: live session states (SHOW PROCESSLIST, KILL)
        self.ash = AshSampler()
        # statement admission + fair queuing + KILL; per-tenant WRR
        # weights read live from each tenant's config overlay
        self.admission = AdmissionController(
            self.config, weight_of=self._tenant_weight)
        #: {name: ProcedureStmt}, loaded by the first session that needs
        #: it (sql/session.py::_proc_store)
        self.procedures: dict | None = None
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

        # one boot log line naming the resolved backend
        logging.getLogger("oceanbase_tpu_torch.server").info(
            "boot backend: %s", backend_summary(self.device))

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

    def close(self):
        self.jobs.stop()
        for t in self.tenants.values():
            t.close()


__all__ = ["Database"]
