"""The chaos plane over the port's cluster, held to the reference's
invariants and to the reference's own nodes.

The tier-1 cases drive ``oceanbase_tpu_torch/bench/chaos.py``'s five
scenarios, in ``scripts/chaos_bench.py``'s order, over one module-scoped
cluster of three ``python -m oceanbase_tpu_torch.net.node --device cpu``
processes holding the first 2,000 rows of ``gen_tpch(sf=0.01)``'s
lineitem (all 16 columns, ``dtl_min_rows`` 1 on every node, so Q6 and
Q1 push down as they do at 200,000 rows on the card); each record must
meet the reference's invariants (``chaos.failures``), every answer
equal to numpy.  The deterministic halves of the rot and disk-full
scenarios then run in process, once per package, over a single
``NodeServer`` with no peers (nothing re-ships what a restart drops),
on inputs made from a numpy seed, and the two records are held equal:
a complete WAL entry flipped (the restart keeps the same prefix), the
manifest flipped (quarantined, the whole WAL replayed to the same
rows), an ENOSPC or partial WAL append (typed ``DiskFull``, no torn
entry, the same rows after a restart).  The ``slow`` case runs the
whole chaos schedule (``chaos.run``) over reference nodes and over
port nodes and compares the records' fields that are not timings, as
the reference marks its own cluster failover cases ``slow``.
Tolerance: exact (sums and counts are integers), Q1's averages at 1e-12
relative.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np
import pytest
import torch

from oceanbase_tpu_torch.bench import chaos
from oceanbase_tpu_torch.bench.cluster import (
    NodeCluster,
    flip_wal_entry,
    rows,
    wait_for,
)
from oceanbase_tpu_torch.bench.tbl import create_table_sql, values_row
from oceanbase_tpu_torch.bench.tpch import gen_tpch
from torch_pair import both, outcome

torch.set_num_threads(2)

N_ROWS = 2000
BATCH = 500


def _slice(n=N_ROWS):
    tables, types = gen_tpch(sf=0.01)
    li = tables["lineitem"]
    arrays = {c: np.ascontiguousarray(a[:n]) for c, a in li.items()}
    return arrays, {c: types[c] for c in arrays if c in types}


def _loaded(root, module="oceanbase_tpu_torch.net.node"):
    """A fresh 3-node cluster with the slice loaded -> (cluster,
    workload)."""
    arrays, types = _slice()
    c = NodeCluster(str(root), n=3, device="cpu", module=module,
                    config={"dtl_min_rows": 1})
    try:
        c.execute(1, create_table_sql("lineitem", arrays, types,
                                      ["l_orderkey", "l_linenumber"]))
        for s in range(0, N_ROWS, BATCH):
            c.execute(1, "insert into lineitem values " + ", ".join(
                values_row(arrays, types, i)
                for i in range(s, min(s + BATCH, N_ROWS))))
        w = chaos.Workload(arrays, types)
        chaos.prepare(c)
    except BaseException:
        c.close()
        raise
    return c, w


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    c, w = _loaded(tmp_path_factory.mktemp("chaos"))
    yield c, w
    c.close()


def _scenario(loaded, name):
    c, w = loaded
    try:
        rec = getattr(chaos, name)(c, w)
    except BaseException:
        for i in (1, 2, 3):
            print(f"node {i} log tail:\n{c.log_tail(i)}")
        raise
    assert chaos.failures(name, rec) == [], rec
    assert rec["hung"] == 0 and rec["parity"] is True
    return rec


def test_partition_leader(loaded):
    rec = _scenario(loaded, "partition_leader")
    assert rec["queries"] == 6 and rec["detector_saw"] == "down"
    assert rec["leader_view"][str(rec["cut"])] == "down"
    assert rec["leader_view"][str(rec["via"])] == "up"


def test_nodekill_restart(loaded):
    rec = _scenario(loaded, "nodekill_restart")
    assert rec["marker_on_restarted_node"] and rec["xa_recoverable"]
    assert rec["detector_state"] == "up"
    assert "boot_replay" in rec["boot_phases"]
    # the restarted node takes its slice again
    assert (rec["avoided_parts"], rec["fallback_parts"]) == (0, 0)


def test_bitflip_scrub_repair(loaded):
    rec = _scenario(loaded, "bitflip_scrub_repair")
    assert rec["kinds_detected"] == ["manifest", "segment", "wal"]
    assert rec["quarantine_events"] == 2 and rec["scrub_repairs"] >= 1
    assert rec["oracle_match"]


def test_overload_shed(loaded):
    rec = _scenario(loaded, "overload_shed")
    assert rec["queries"] == chaos.STORM_CLIENTS * chaos.STORM_ROUNDS
    assert rec["admitted"] >= 1 and rec["untyped_errors"] == {}
    assert set(rec["kinds"]) - {"ok"} <= chaos.SHED_OK_KINDS


def test_disk_full_readonly(loaded):
    rec = _scenario(loaded, "disk_full_readonly")
    assert rec["readonly_state"] == "readonly"
    assert rec["takeover"] and rec["new_leader"] != rec["old_leader"]
    assert rec["auto_exit"] and rec["reclaims"] >= 1
    assert rec["enospc_kind"] == "DiskFull" and rec["count_held"]


def test_failures_names_each_broken_invariant():
    assert chaos.failures("overload_shed", {
        "parity": True, "hung": 0, "admitted": 0,
        "untyped_errors": {"OSError": 1}}) == [
        "untyped_errors {'OSError': 1}", "admitted 0"]
    assert chaos.failures("bitflip_scrub_repair", {
        "parity": False, "hung": 1, "kinds_detected": ["segment"],
        "oracle_match": True}) == [
        "parity", "hung 1", "kinds_detected ['segment']"]


# ---------------------------------------------------------------------------
# the deterministic halves, in process, once per package
# ---------------------------------------------------------------------------

def _boot(P, root, applied=True, slow_apply_s=0.0):
    """A single NodeServer of package ``P`` over ``root``, leading its
    one-replica log stream and (``applied``) done applying what its
    election committed; ``slow_apply_s`` delays each applied entry."""
    mod = importlib.import_module(f"{P.name}.net.node")
    kw = {"device": "cpu"} if P.is_port else {}
    node = mod.NodeServer(1, "127.0.0.1", 0, {}, root=str(root),
                          bootstrap=True, lease_ms=1500, **kw)
    r = node.palf.replica
    if slow_apply_s:
        apply = r.apply_cb

        def slow(entry):
            time.sleep(slow_apply_s)
            apply(entry)

        r.apply_cb = slow
    node.start()
    wait_for(lambda: node.palf.is_leader and (
        not applied or r.applied_lsn == r.committed_lsn == r.last_lsn()),
        60, "the single node to lead")
    return node


def _table(node):
    return rows(node.execute("select k, v from t order by k"))


def _seeded_rows(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(10 * n)[:n]
    return [(int(k), int(v)) for k, v in
            zip(keys, rng.integers(-1000, 1000, n))]


def _scn_wal_rot(P, root):
    node = _boot(P, root)
    node.execute("create table t (k int primary key, v int)")
    lsn_of = []
    for k, v in _seeded_rows(3, 16):
        node.execute(f"insert into t values ({k}, {v})")
        lsn_of.append(((k, v), node.palf.replica.last_lsn()))
    node.stop()
    bad = flip_wal_entry(os.path.join(root, "wal", "replica_1.log"))
    node = _boot(P, root)
    try:
        got = _table(node)
        quar = [(e["phase"], e.get("note", "").split(";")[0])
                for e in node.recovery.rows() if e["phase"] == "quarantine"]
    finally:
        node.stop()
    kept = sorted(kv for kv, lsn in lsn_of if lsn < bad)
    return [bad, got == kept, len(got), quar]


def test_wal_entry_rot_restarts_to_the_same_prefix(tmp_path):
    bad, same, n, quar = both(_scn_wal_rot, tmp_path)
    assert same and 0 < n < 16
    assert quar == [("quarantine", f"wal entry lsn={bad} crc mismatch")]


def _scn_new_leader_reads(P, root):
    node = _boot(P, root)
    node.execute("create table t (k int primary key, v int)")
    for k, v in _seeded_rows(7, 12):
        node.execute(f"insert into t values ({k}, {v})")
    node.stop()
    # the restart defers its replay to the commit point its election's
    # no-op sets; each applied entry then takes 50 ms
    node = _boot(P, root, applied=False, slow_apply_s=0.05)
    try:
        return len(_table(node))
    finally:
        node.stop()


def test_a_new_leader_applies_before_it_serves(tmp_path):
    """ROADMAP Queue 3 #30: the reference's new leader answers a SELECT
    from the state before the entries its election committed are
    applied (the apply runs outside the log lock, after ``is_leader``
    turns true); the port's node holds the statement until the apply
    reaches the commit point."""
    from torch_pair import J, T

    ref = _scn_new_leader_reads(J, tmp_path / "jax")
    port = _scn_new_leader_reads(T, tmp_path / "port")
    assert ref < 12
    assert port == 12


def _scn_manifest_rot(P, root):
    node = _boot(P, root)
    node.execute("create table t (k int primary key, v int)")
    data = _seeded_rows(5, 40)
    node.execute("insert into t values " + ", ".join(
        f"({k}, {v})" for k, v in data[:25]))
    node.tenant.checkpoint()
    node.execute("insert into t values " + ", ".join(
        f"({k}, {v})" for k, v in data[25:]))
    node.execute(f"update t set v = 7 where k = {data[0][0]}")
    node.stop()
    P.bitflip_file(os.path.join(root, "data", "manifest.json"),
                    seed=chaos.MANIFEST_FLIP_SEED)
    node = _boot(P, root)
    try:
        got = _table(node)
        quar = [(e["phase"], e.get("note", "").split(" -> ")[0])
                for e in node.recovery.rows() if e["phase"] == "quarantine"]
        leftover = sorted(f.split(".corrupt")[0] for f in os.listdir(
            os.path.join(root, "data")) if ".corrupt" in f)
    finally:
        node.stop()
    want = sorted([(data[0][0], 7)] + data[1:])
    return [got == want, len(got), quar, leftover]


def test_manifest_rot_quarantines_and_replays_the_wal(tmp_path):
    same, n, quar, leftover = both(_scn_manifest_rot, tmp_path)
    assert same and n == 40
    assert len(quar) == 1 and quar[0][1].startswith("manifest")
    assert leftover == ["manifest.json", "slog.jsonl"]


def _scn_enospc_append(P, root, action):
    node = _boot(P, root)
    node.execute("create table t (k int primary key, v int)")
    data = _seeded_rows(9, 12)
    for k, v in data[:6]:
        node.execute(f"insert into t values ({k}, {v})")
    node.config.set("enable_fault_injection", True)
    node.config.set("enable_disk_faults", True)
    node._h_fault_inject(where="disk", action=action, verb="wal", count=1)
    path = os.path.join(root, "wal", "replica_1.log")
    pre = os.path.getsize(path)
    k, v = data[6]
    failed = outcome(node.execute, f"insert into t values ({k}, {v})")
    held = [os.path.getsize(path) == pre, len(_table(node))]
    for k, v in data[7:]:
        node.execute(f"insert into t values ({k}, {v})")
    node.stop()
    with open(path, "rb") as f:
        buf = f.read()
    scan = P.palf_log.scan_wal(buf)
    node = _boot(P, root)
    try:
        got = _table(node)
    finally:
        node.stop()
    want = sorted(data[:6] + data[7:])
    return [failed, held, scan[1] == len(buf), scan[2], got == want]


@pytest.mark.parametrize("action", ["enospc", "partial"])
def test_failed_wal_append_leaves_no_torn_entry(tmp_path, action):
    failed, held, clean, crc_fail, same = both(
        _scn_enospc_append, tmp_path, action)
    assert failed == ("error", "DiskFull")
    assert held == [True, 6]
    assert clean and crc_fail == 0 and same


# ---------------------------------------------------------------------------
# the whole schedule: reference nodes beside port nodes
# ---------------------------------------------------------------------------

#: per scenario, the record fields that do not depend on timing
COMPARED = {
    "partition_leader": ("parity", "queries", "hung", "detector_saw"),
    "nodekill_restart": ("parity", "queries", "hung", "detector_state",
                         "marker_on_restarted_node", "xa_recoverable",
                         "xa_committed_row", "avoided_parts",
                         "fallback_parts", "boot_phases"),
    "bitflip_scrub_repair": ("parity", "queries", "hung", "kinds_detected",
                             "quarantine_events", "oracle_match",
                             "scrub_repairs"),
    "overload_shed": ("parity", "queries", "hung", "untyped_errors",
                      "admitted_oracle_parity", "parity_mismatches"),
    "disk_full_readonly": ("parity", "hung", "entered_readonly",
                           "readonly_state", "readonly_reads_parity",
                           "untyped_errors", "takeover", "peer_headroom",
                           "auto_exit", "enospc_kind", "count_held",
                           "served_by_restarted_node"),
}


@pytest.mark.slow
def test_chaos_run_port_nodes_beside_reference_nodes(tmp_path):
    records = {}
    for tag, module in (("ref", "oceanbase_tpu.net.node"),
                        ("port", "oceanbase_tpu_torch.net.node")):
        c, w = _loaded(tmp_path / tag, module=module)
        try:
            records[tag] = chaos.run(c, w)
        finally:
            c.close()
    for name, keys in COMPARED.items():
        ref = {k: records["ref"][name][k] for k in keys}
        port = {k: records["port"][name][k] for k in keys}
        assert port == ref, (name, port, ref)
