"""The cluster half of the port's scrub plane, and the rebuild client,
run through the reference's own cases.

``tests/test_scrub.py`` is loaded with its imports pointed at the port
and its databases and nodes on the CPU (the substitutions are listed in
``_SUBS``); each of its cluster and rebuild cases is one case here:

- the rebuild client's chunk crc retry and its exhausted budget, and the
  pre-boot quarantine of a rotten manifest (``net/rebuild.py``);
- the DTL reply digest (``px/dtl.py::verify_reply``);
- the scrub verbs' policies;
- on a live 3-node cluster of in-process ``NodeServer``s: seeded rot of
  one replica's segment file found by its scrub round, quarantined,
  refetched from a healthy peer over the chunked rebuild verbs and
  re-verified to digest parity; a resident-memory rot out-voted by the
  majority and repaired; the lagging-replica guard of
  ``scrub.checksum``; a boot-time quarantine repaired by the first
  round.

Tolerance: exact.
"""

from __future__ import annotations

import inspect
import os
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

#: what makes the reference's module the port's: the package, its
#: Database's import path, and the CPU for every database and node
_SUBS = [
    ("from oceanbase_tpu.server import Database",
     "from oceanbase_tpu.server.database import Database"),
    ("oceanbase_tpu.", "oceanbase_tpu_torch."),
    ("Database(root)", "Database(root, device='cpu')"),
    ("Database(str(tmp_path / \"db\"))",
     "Database(str(tmp_path / \"db\"), device='cpu')"),
    ("lease_ms=1500)", "lease_ms=1500, device='cpu')"),
]


def _port_copy(name: str):
    with open(os.path.join(HERE, name + ".py")) as f:
        src = f.read()
    for a, b in _SUBS:
        assert a in src, a
        src = src.replace(a, b)
    mod = types.ModuleType(f"_port_{name}")
    mod.__file__ = os.path.join(HERE, name + ".py")
    exec(compile(src, f"<port copy of {name}.py>", "exec"), mod.__dict__)
    return mod


SCRUB = _port_copy("test_scrub")
assert SCRUB.Database.__module__ == "oceanbase_tpu_torch.server.database"

CASES = ["test_dtl_reply_digest_detects_tamper",
         "test_rebuild_chunk_crc_retry_then_ok",
         "test_rebuild_chunk_crc_exhausted_raises",
         "test_corrupt_baseline_quarantined_preboot",
         "test_scrub_policies_registered"]
TRIO_CASES = ["test_cluster_scrub_detect_quarantine_repair_parity",
              "test_scrub_checksum_lagging_guard",
              "test_boot_quarantine_then_scrub_repairs"]


@pytest.mark.parametrize("case", CASES)
def test_reference_case_over_the_port(case, tmp_path):
    fn = getattr(SCRUB, case)
    kw = {"tmp_path": tmp_path} \
        if "tmp_path" in inspect.signature(fn).parameters else {}
    fn(**kw)


@pytest.mark.parametrize("case", TRIO_CASES)
def test_reference_cluster_case_over_the_port(case, tmp_path):
    """A fresh in-process 3-node cluster per case (the reference's
    ``trio`` fixture), torn down after it."""
    gen = SCRUB.trio.__wrapped__(tmp_path)
    nodes = next(gen)
    try:
        getattr(SCRUB, case)(nodes)
    finally:
        next(gen, None)  # the fixture's teardown: every node stops

