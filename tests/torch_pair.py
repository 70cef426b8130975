"""The two packages side by side, for the durability-plane parity tests
(``tests/test_torch_{errsim,disk_faults,diskmgr,memstore_throttle,
scrub,backup,external_tables,workload}.py``).

``J`` and ``T`` expose the same names from the JAX package and from the
port, so one scenario function runs unchanged against either: a test
runs it once per package, each in its own directory, and holds the two
outcome records equal (``both``).  A ``Database`` of either package
boots with calibration off (both then plan with the default cost
units); the port's runs on the CPU.
"""

from __future__ import annotations

import importlib
import json
import os


class Pkg:
    def __init__(self, name: str):
        self.name = name
        self.is_port = name == "oceanbase_tpu_torch"

        def imp(mod):
            return importlib.import_module(f"{name}.{mod}")

        self.faults = imp("net.faults")
        self.FaultPlane = self.faults.FaultPlane
        self.bitflip_file = self.faults.bitflip_file
        self.diskmgr = imp("server.diskmgr")
        self.DiskManager = self.diskmgr.DiskManager
        self.palf_log = imp("palf.log")
        self.PalfReplica = self.palf_log.PalfReplica
        self.engine = imp("storage.engine")
        self.StorageEngine = self.engine.StorageEngine
        self.TempFileStore = imp("storage.tmpfile").TempFileStore
        cat = imp("catalog")
        self.ColumnDef, self.TableDef = cat.ColumnDef, cat.TableDef
        self.SqlType = imp("datatypes").SqlType
        self.Segment = imp("storage.segment").Segment
        self.integrity = imp("storage.integrity")
        self.backup = imp("server.backup")
        self.errsim = imp("server.errsim")
        self.admission = imp("server.admission")
        self.scrub = imp("storage.scrub")
        self.external = imp("share.external")
        self.workload = imp("server.workload")
        self.metrics = imp("server.metrics")
        self.Database = imp("server.database").Database

    def db(self, root, **cfg):
        """A Database at ``root``; ``cfg`` seeds its config.json on the
        first boot."""
        root = str(root)
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, "config.json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump({"enable_calibration": False, **cfg}, f)
        if self.is_port:
            return self.Database(root, device="cpu")
        return self.Database(root)

    def tdef(self, name="t"):
        return self.TableDef(name, [self.ColumnDef("k", self.SqlType.int_()),
                                    self.ColumnDef("v", self.SqlType.int_())],
                             primary_key=["k"])

    def __repr__(self):
        return self.name


J = Pkg("oceanbase_tpu")
T = Pkg("oceanbase_tpu_torch")
#: each package's node module, for the tests that boot a ``NodeCluster``
#: of each (``oceanbase_tpu_torch/bench/cluster.py``) and hold the two
NODE_PACKAGES = (("ref", "oceanbase_tpu.net.node"),
                 ("port", "oceanbase_tpu_torch.net.node"))


def outcome(fn, *args, **kw):
    """("ok", value) or ("error", exception class name)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__)


def both(scenario, tmp_path, *args, **kw):
    """Run ``scenario(P, root, ...)`` for the JAX package and the port,
    each under its own directory; -> the port's record, held equal to
    the reference's."""
    want = scenario(J, tmp_path / "jax", *args, **kw)
    got = scenario(T, tmp_path / "port", *args, **kw)
    assert got == want, (got, want)
    return got


def du(paths) -> int:
    total = 0
    for root in paths:
        if os.path.isfile(root):
            total += os.path.getsize(root)
            continue
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, f))
                except OSError:
                    pass
    return total
