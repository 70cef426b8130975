"""Database: the single-node instance of the port.

Port of ``oceanbase_tpu/server/database.py`` (≙ ObServer::init/start,
src/observer/ob_server.cpp:228, booting config, storage meta replay and
log replay): a persisted cluster ``Config`` and the ``sys`` tenant
(storage engine, PALF WAL, transaction service and a ``StorageCatalog``
on the database's device).  ``Database(root).session().execute(sql)``
is the entry point; it runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises without CUDA otherwise.

The reference's instance also boots, and this one has no argument or
attribute for: roofline calibration (the port plans with the default
cost units of ``server/calibrate.py`` and runs no probe), the SQL audit
ring, the plan monitor, plan feedback and history, ASH, wait events,
the trace ring, virtual tables and the workload repository (ROADMAP
Queue 1 item 9, the measurement plane); statement admission, the DBMS
job scheduler, users, TLS and tenants other than ``sys`` (item 7 and
item 5b).
"""

from __future__ import annotations

import os

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.server.config import Config
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
        troot = os.path.join(root, "tenants", "sys") if root else None
        if troot:
            os.makedirs(troot, exist_ok=True)
        self.tenants: dict[str, Tenant] = {
            "sys": Tenant("sys", troot, self.config,
                          wal_replicas=wal_replicas, device=self.device)}

    def tenant(self, name: str = "sys") -> Tenant:
        return self.tenants[name]

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
    def session(self):
        """A SQL session of the ``sys`` tenant on the database's device."""
        from oceanbase_tpu_torch.sql.session import Session

        return Session(self.catalog, db=self)

    def checkpoint(self):
        for t in self.tenants.values():
            t.checkpoint()

    def close(self):
        for t in self.tenants.values():
            t.close()


__all__ = ["Database"]
