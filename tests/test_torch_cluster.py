"""The port's cluster over real node processes on the CPU.

Each test drives ``python -m oceanbase_tpu_torch.net.node --device cpu``
subprocesses through ``oceanbase_tpu_torch/bench/cluster.py``, whose
every wait polls a condition under its own deadline and names it when
it runs out.  The tier-1 cases share one module-scoped 3-node cluster:
replication and statement routing, the ``das.scan`` endpoint, DTL
pushdown parity (against the serial path and a numpy oracle) and its
wire bytes against ``das.pull``'s, ``metrics.scrape`` under gv$sysstat,
the merged workload snapshot, remote ``dtl.fragment`` spans under the
coordinator's statement, LOAD
DATA on a node with peers (ROADMAP Queue 3 #29, held beside the
reference's answer), the node-down fallback, and a node asked for
``cuda`` without a card.  The reference's failover cases
(``tests/test_failover.py``) follow, marked ``slow`` as the reference
marks them: kill and restart, wipe and rebuild, XA across a leader
failover, the detector's re-election, and suspect-slice avoidance.
Tolerance: exact (sums and counts are integers), float avgs at 1e-9
relative.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from oceanbase_tpu_torch.bench.cluster import (
    ClusterTimeout,
    NodeCluster,
    rows,
    wait_for,
)
from oceanbase_tpu_torch.net.rpc import RpcError

N_ROWS = 3000


def numpy_rows_equal(a, b) -> bool:
    """Row lists equal, floats compared at 1e-9 relative."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None or not np.isclose(
                        float(x), float(y), rtol=1e-9, atol=0.0):
                    return False
            elif x != y:
                return False
    return True


def _load_q6(c, n=N_ROWS, batch=750, table="q6", seed=11):
    c.execute(1, f"create table {table} (k int primary key, v int, d int)")
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 100, n)
    d = rng.integers(0, 1000, n)
    for s in range(0, n, batch):
        vals = ", ".join(f"({i}, {v[i]}, {d[i]})"
                         for i in range(s, min(s + batch, n)))
        c.execute(1, f"insert into {table} values {vals}")
    return v, d


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = NodeCluster(str(tmp_path_factory.mktemp("cluster")), n=3,
                    device="cpu")
    try:
        v, d = _load_q6(c)
        c.wait_count("q6", N_ROWS, nodes=(2, 3))
        c.execute(1, "alter system set dtl_min_rows = 1")
        c.q6 = (v, d)
        yield c
    finally:
        c.close()


def test_replication_and_routing(cluster):
    c = cluster
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values (1, 10), (2, 20), (3, 30)")
    # a write via a follower routes to the leader
    assert c.execute(2, "insert into t values (4, 40)")["node"] == 1
    # a strong read via a follower routes to the leader
    res = c.execute(3, "select k, v from t order by k")
    assert res["node"] == 1
    assert rows(res) == [(1, 10), (2, 20), (3, 30), (4, 40)]
    # replication: each follower's weak local read converges
    c.wait_count("t", 4, nodes=(2, 3), deadline_s=60)
    # the followers applied the leader's committed log
    lsn = c.wait_caught_up(deadline_s=60)
    assert lsn > 0


def test_das_remote_scan_endpoint(cluster):
    c = cluster
    c.execute(1, "create table r (k int primary key, s varchar(16))")
    c.execute(1, "insert into r values (1, 'aa'), (2, 'bb')")
    got = c.clients[1].call("das.scan", table="r")
    assert got["total"] == 2
    assert sorted(got["arrays"]["k"].tolist()) == [1, 2]
    assert sorted(got["arrays"]["s"].tolist()) == ["aa", "bb"]
    # the page carries its digest, as the reference's does
    from oceanbase_tpu_torch.storage.integrity import arrays_crc

    assert got["crc"] == arrays_crc(got["arrays"], got["valids"])
    # every node agrees on the home (the leader)
    st = wait_for(lambda: c.clients[2].call("node.state")
                  if c.clients[2].call("node.state")["leader_hint"] == 1
                  else None, 30, "node 2's leader hint")
    assert st["leader_hint"] == 1


def _newest_exchange(c, node=1):
    ex = c.execute(node, "select mode, pushdown_hit, bytes_shipped, "
                   "rows_shipped, parts, fallback_parts, avoided_parts "
                   "from gv$px_exchange where mode = 'pushdown' "
                   "order by ts desc limit 1")
    return rows(ex)[0]


def test_dtl_pushdown_parity_bytes_and_groupby(cluster):
    c = cluster
    v, d = c.q6
    q = "select sum(v), count(*) from q6 where d < 500"
    sel = d < 500
    oracle = [(int(v[sel].sum()), int(sel.sum()))]
    assert rows(c.execute(1, q)) == oracle
    mode, hit, nbytes, nrows, parts, fallbacks, avoided = \
        _newest_exchange(c)
    assert (mode, hit, parts, fallbacks) == ("pushdown", 1, 3, 0)
    assert nrows <= 4  # two partial-agg rows, not 3000 table rows
    pull = c.clients[1].call("das.pull", table="q6", node_id=2)
    assert pull["rows"] == N_ROWS
    assert nbytes < 0.05 * pull["bytes"], (nbytes, pull["bytes"])
    pl = c.execute(1, "select bytes_shipped from gv$px_exchange where "
                   "mode = 'pull' order by ts desc limit 1")
    assert rows(pl)[0][0] == pull["bytes"]
    # the same query from a follower is a strong read routed to the
    # leader, which pushes it down
    res = c.execute(2, q)
    assert res["node"] == 1 and rows(res) == oracle
    # group-by pushdown against the serial path and a numpy oracle
    gq = ("select d, sum(v), count(*), avg(v) from q6 "
          "where d < 200 group by d order by d")
    push_rows = rows(c.execute(1, gq))
    keys = np.unique(d[d < 200])
    expect = [(int(k), int(v[d == k].sum()), int((d == k).sum()),
               float(v[d == k].mean())) for k in keys]
    assert numpy_rows_equal(push_rows, expect)
    c.execute(1, "alter system set enable_dtl_pushdown = false")
    try:
        serial_rows = rows(c.execute(1, gq))
        assert numpy_rows_equal(push_rows, serial_rows)
        assert rows(c.execute(1, q)) == oracle
    finally:
        c.execute(1, "alter system set enable_dtl_pushdown = true")


def test_metrics_scrape_merges_every_node(cluster):
    c = cluster
    per_node = []
    for i in (1, 2, 3):
        w = c.clients[i].call("metrics.scrape")
        assert w["node_id"] == i
        per_node.append(w["wire"])
    # gv$sysstat on node 1 sums rpc.calls over the three nodes: at
    # least what each node's own scrape said a moment before
    each = [sum(v for n, _lbl, v in w["counters"] if n == "rpc.calls")
            for w in per_node]
    assert all(n > 0 for n in each), each
    got = rows(c.execute(1, "select sum(value) from gv$sysstat "
                         "where name = 'rpc.calls'"))[0][0]
    assert got >= sum(each), (got, each)
    # Prometheus text exposition of one node
    prom = c.clients[2].call("metrics.scrape", format="prom")
    assert "ob_rpc_calls" in prom["text"]


def test_workload_snapshot_merges_every_node(cluster):
    """ANALYZE WORKLOAD REPORT takes a cluster-merged snapshot: every
    peer's digest-checked ``workload.snapshot`` payload folded in."""
    c = cluster
    from oceanbase_tpu_torch.server.workload import canonical_bytes
    from oceanbase_tpu_torch.storage.integrity import bytes_crc

    for i in (1, 2, 3):
        r = c.clients[i].call("workload.snapshot")
        assert r["node_id"] == i
        assert r["crc"] == bytes_crc(canonical_bytes(r["payload"]))
    assert rows(c.execute(1, "analyze workload report"))
    assert rows(c.execute(
        1, "select node_count, nodes from gv$workload_snapshot "
        "order by snapshot_id desc limit 1")) == [(3, "1,2,3")]


def test_remote_trace_spans_under_the_statement(cluster):
    """The reference's ``test_trace.py::test_dtl_remote_spans_parented``
    over the port: the remote ``dtl.execute`` verb spans hang under the
    coordinator's ``rpc.dtl.execute`` spans, each tagged with the peer
    that ran it, and both peers' ``dtl.fragment`` spans are in the tree
    of the statement."""
    import json

    c = cluster
    q = "select v, sum(k) as s from q6 where k < 500 group by v"
    assert c.execute(1, q)["node"] == 1
    assert _newest_exchange(c)[1] == 1
    audit = rows(c.execute(1, "select sql, trace_id from gv$sql_audit"))
    tid = [t for s_, t in audit if s_.startswith(q) and t][-1]
    spans = [r for r in rows(c.execute(
        1, "select trace_id, span_id, parent_span_id, node, span_name, "
        "tags from gv$trace")) if r[0] == tid]
    ids = {r[1] for r in spans}
    remote = [r for r in spans if r[3] in (2, 3)]
    assert remote and all(r[2] in ids for r in remote), remote
    rpc = {r[1]: r for r in spans if r[4] == "rpc.dtl.execute"}
    verb = [r for r in remote if r[4] == "dtl.execute"]
    assert verb and all(r[2] in rpc for r in verb)
    for r in verb:
        assert json.loads(rpc[r[2]][5])["peer"] == r[3]
    frags = {r[3] for r in remote if r[4] == "dtl.fragment"}
    assert frags == {2, 3}
    names = {r[4] for r in spans if r[3] == 1}
    assert {"statement", "execute", "dtl.exchange", "dtl.slice",
            "dtl.merge"} <= names


def test_load_data_on_a_cluster_node(cluster, tmp_path):
    """ROADMAP Queue 3 #29: the reference's LOAD DATA writes a
    direct-load segment on the leader alone (``add_segment`` is not in
    ``net/node.py::_DDL_KINDS``), so followers count none of the rows
    and a pushed-down sum reads a third of them; the port's node refuses
    LOAD DATA INFILE when it has peers, with ``LoadDataOnCluster``."""
    n = 3000
    path = tmp_path / "ld.tbl"
    path.write_text("".join(f"{k}|{k * 2}\n" for k in range(n)))
    load = (f"load data infile '{path}' into table ld "
            f"fields terminated by '|'")

    def scenario(c):
        c.execute(1, "create table ld (k int primary key, v int)")
        try:
            loaded = c.execute(1, load)["rowcount"]
        except RpcError as e:
            loaded = e.kind
        c.wait_caught_up(deadline_s=60)
        # each node's weak count, once the node has applied the DDL
        counts = [wait_for(lambda i=i: (c.count(i, "ld"),), 60,
                           f"node {i} to know table ld")[0]
                  for i in (1, 2, 3)]
        c.execute(1, "alter system set dtl_min_rows = 1")
        total = rows(c.execute(1, "select sum(v) from ld where k >= 0"))
        return loaded, counts, total

    ref = NodeCluster(str(tmp_path / "ref"), n=3, device="cpu",
                      module="oceanbase_tpu.net.node")
    try:
        ref_loaded, ref_counts, ref_total = scenario(ref)
    finally:
        ref.close()
    loaded, counts, total = scenario(cluster)
    full = sum(k * 2 for k in range(n))
    # the reference: the leader alone holds the rows
    assert ref_loaded == n
    assert sorted(ref_counts) == [0, 0, n]
    assert ref_total[0][0] is not None and ref_total[0][0] < full
    # the port: refused, nothing written anywhere
    assert loaded == "LoadDataOnCluster"
    assert counts == [0, 0, 0]
    assert total == [(None,)]


def test_node_refuses_cuda_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the node would start")
    p = subprocess.run(
        [sys.executable, "-m", "oceanbase_tpu_torch.net.node",
         "--node-id", "1", "--port", "0", "--root", str(tmp_path / "n")],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode != 0
    assert "CUDA" in p.stderr


def test_dtl_node_down_falls_back(cluster):
    """Kill node 3: its slice re-runs on the coordinator; then the node
    restarts over its root and catches up.  Runs last in the module:
    it is the one case that takes a node down."""
    c = cluster
    v, d = c.q6
    c.kill(3)
    q = "select sum(v), count(*) from q6 where d >= 500"
    sel = d >= 500
    assert rows(c.execute(1, q)) == [(int(v[sel].sum()), int(sel.sum()))]
    _mode, hit, _b, _r, parts, fallbacks, avoided = _newest_exchange(c)
    assert hit == 1 and parts == 3
    assert fallbacks + avoided >= 1  # the dead node's slice ran locally
    c.restart(3)
    c.wait_count("q6", N_ROWS, nodes=(3,), deadline_s=90)


# ---------------------------------------------------------------------------
# the reference's multinode failover cases: reference nodes beside port
# nodes, each on a fresh cluster
# ---------------------------------------------------------------------------


def _side_by_side(tmp_path, scenario):
    """Run ``scenario(cluster)`` on a fresh cluster of the reference's
    nodes, then of the port's -> the port's record, held equal."""
    out = {}
    for tag, module in (("ref", "oceanbase_tpu.net.node"),
                        ("port", "oceanbase_tpu_torch.net.node")):
        c = NodeCluster(str(tmp_path / tag), n=3, device="cpu",
                        module=module)
        try:
            out[tag] = scenario(c)
        finally:
            c.close()
    assert out["port"] == out["ref"], out
    return out["port"]


def _scn_leader_kill(c):
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values " + ", ".join(
        f"({i}, {i * 7})" for i in range(50)))
    # committed on a majority; kill the leader process outright
    c.kill(1)
    # a write through a survivor forces the re-election (2 of 3)
    res = c.execute(2, "insert into t values (1000, 1)", deadline_s=40)
    return [res["node"] in (2, 3),
            rows(c.execute(2, "select count(*), sum(v) from t "
                              "where k < 1000")),
            rows(c.execute(3, "select count(*) from t"))]


def test_leader_kill_reelection_no_committed_loss(tmp_path):
    """``tests/test_multinode.py:165``."""
    moved, kept, total = _side_by_side(tmp_path, _scn_leader_kill)
    assert moved
    assert kept == [(50, sum(i * 7 for i in range(50)))]
    assert total == [(51,)]


def _scn_rejoin(c):
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values (1, 1), (2, 2)")
    # node 3 down; nodes 1 and 2 keep committing
    c.kill(3)
    c.execute(1, "insert into t values (3, 3), (4, 4)")
    c.restart(3)
    waited = c.wait_count("t", 4, nodes=(3,), deadline_s=60)
    return [waited < 60, rows(c.execute(3, "select sum(v) from t"))]


def test_killed_node_rejoins_and_catches_up(tmp_path):
    """``tests/test_multinode.py:193``: a crashed node restarts from
    its WAL, catches up on the writes it missed, and serves strong reads
    through the leader."""
    caught_up, total = _side_by_side(tmp_path, _scn_rejoin)
    assert caught_up and total == [(10,)]


LEADERLESS_BOUND_S = 15.0


def _scn_deposed_leader(c):
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values (1, 10)")
    c.wait_caught_up(deadline_s=60)
    ldr = c.leader()
    term = c.clients[ldr].call("palf.state")["term"]
    # a vote request for the next term from a candidate that never
    # campaigns (id 99): the leader grants it and steps down, alive
    vote = c.clients[ldr].call("palf.vote", term=term + 1, candidate=99,
                               last_lsn=1 << 40, last_term=1 << 40)
    try:
        c.leader(LEADERLESS_BOUND_S)
        healed = True
    except ClusterTimeout:
        healed = False
    # a write through a follower elects one in either package
    c.execute(1 + ldr % 3, "insert into t values (2, 20)", deadline_s=60)
    return [vote["granted"], healed,
            rows(c.execute(ldr, "select k, v from t order by k"))]


def test_a_deposed_leader_is_replaced_without_a_write(tmp_path):
    """ROADMAP Queue 3 #31: the reference's cluster stays leaderless
    when its leader is deposed by a higher-term vote request whose
    candidate never wins (no process is down, so the failure detector
    never campaigns) until a write arrives; the port's followers, which
    knew a leader, campaign after 3-6 leases of silence.  The detector's
    down threshold is set out of reach, so a ping slowed by a loaded
    host cannot start a campaign in either package."""
    out = {}
    for tag, module in (("ref", "oceanbase_tpu.net.node"),
                        ("port", "oceanbase_tpu_torch.net.node")):
        c = NodeCluster(str(tmp_path / tag), n=3, device="cpu",
                        module=module,
                        config={"health_down_threshold": 1000,
                                "health_suspect_threshold": 999})
        try:
            out[tag] = _scn_deposed_leader(c)
        finally:
            c.close()
    assert out["ref"] == [True, False, [(1, 10), (2, 20)]]
    assert out["port"] == [True, True, [(1, 10), (2, 20)]]


def _scn_unshippable_follower(c):
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values (1, 10)")
    c.wait_caught_up(deadline_s=60)
    ldr = c.leader()
    term = c.clients[ldr].call("palf.state")["term"]
    cut = 1 + ldr % 3
    # the leader's heartbeat reads the follower's state but every
    # palf.accept to it fails: the follower hears no leader message
    c.clients[ldr].call("fault.inject", where="send", action="drop",
                        verb="palf.accept", peer=cut)
    # past the longest silence timeout (6 leases) and two heartbeats
    time.sleep(6.5 * c.lease_ms / 1000.0)
    st = c.states()
    return [st[ldr]["role"], st[ldr]["term"] == term,
            st[cut]["term"] == term,
            rows(c.execute(ldr, "select k, v from t order by k"))]


def test_an_unshippable_follower_leaves_the_leader_in_place(tmp_path):
    """ROADMAP Queue 3 #31: a follower that hears no leader message
    because the leader cannot ship to it (here a dropped ``palf.accept``,
    as for a follower behind the leader's recycle base) does not depose
    the leader: before it campaigns it reads its peers' ``palf.state``,
    and a leader of its term stands.  The reference never campaigns from
    silence; both keep the leader and its term."""
    out = {}
    for tag, module in (("ref", "oceanbase_tpu.net.node"),
                        ("port", "oceanbase_tpu_torch.net.node")):
        c = NodeCluster(str(tmp_path / tag), n=3, device="cpu",
                        module=module, lease_ms=600,
                        config={"health_down_threshold": 1000,
                                "health_suspect_threshold": 999,
                                "enable_fault_injection": True})
        try:
            out[tag] = _scn_unshippable_follower(c)
        finally:
            c.close()
    assert out["ref"] == ["leader", True, True, [(1, 10)]]
    assert out["port"] == out["ref"]


#: the harness's deadlines for one election (``disk.takeover``) and one
#: state read (``recovery.state``) in the demoted-preparer scenario
TAKEOVER_DEADLINE_S = 60.0
STATE_DEADLINE_S = 30.0
#: its detectors declare no peer down: under a loaded test run a
#: reference node's missed pings made a peer "down" and its campaign
#: (``palf/netcluster.py::on_peer_down``) took the lead back to node 1
#: before the commit, which the scenario sends to node 2 as its leader
STEADY_DETECTOR = {"health_down_threshold": 1000,
                   "health_suspect_threshold": 999}
#: and its leases are long: under a loaded test run the port's commit
#: once ran on node 3, whose one way to the lead here is the campaign of
#: a follower that hears no leader for 3-6 leases
#: (``palf/netcluster.py::campaign_if_leaderless``; 1.5 s by default)
STEADY_LEASE_MS = 6000


def _scn_demoted_preparer(c):
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values (1, 10)")
    for sql in ("xa start 'dx1'", "insert into t values (2, 20)",
                "xa end 'dx1'", "xa prepare 'dx1'"):
        c.execute(1, sql, session_id=7)
    c.wait_caught_up(deadline_s=60)
    # node 2 campaigns and wins while node 1, the branch's preparer,
    # stays up as a follower; the verb's own 10 s deadline is the
    # election's budget on an idle host, and a reference node under a
    # loaded test run overran it once, so the harness waits longer
    assert c.clients[2].call("disk.takeover", from_node=1,
                             _deadline_s=TAKEOVER_DEADLINE_S) is True
    c.leader(30, exclude=(1,))
    # node 1 has seen the new term (a forwarded statement then cannot
    # run on it as a stale leader)
    wait_for(lambda: c.clients[1].call("node.state")["role"] == "follower",
             30, "node 1 to step down")
    recovered = "dx1" in c.clients[2].call(
        "recovery.state", _deadline_s=STATE_DEADLINE_S)["prepared_xids"]
    committed_on = c.execute(2, "xa commit 'dx1'", session_id=7)["node"]
    # every node has applied the commit record: then read each replica
    c.wait_caught_up(nodes=(1, 3), deadline_s=60)
    return [recovered, committed_on, [c.count(i, "t") for i in (1, 2, 3)],
            "dx1" in c.clients[1].call(
                "recovery.state", _deadline_s=STATE_DEADLINE_S)[
                    "prepared_xids"]]


def test_a_branch_committed_after_its_preparer_lost_the_lead(tmp_path):
    """ROADMAP Queue 3 #32: XA PREPARE on leader node 1, node 2 takes
    the lead (``disk.takeover``) and commits the branch; node 1 applies
    the commit record as a follower.  The reference's node 1 never
    shows the branch's row (it applied its own writes as leader and
    skipped its own log entries, so the record finds no redo to apply)
    and keeps listing the branch; the port's node 1 settles its live
    branch at the record."""
    out = {}
    for tag, module in (("ref", "oceanbase_tpu.net.node"),
                        ("port", "oceanbase_tpu_torch.net.node")):
        c = NodeCluster(str(tmp_path / tag), n=3, device="cpu",
                        module=module, lease_ms=STEADY_LEASE_MS,
                        config=STEADY_DETECTOR)
        try:
            out[tag] = _scn_demoted_preparer(c)
        finally:
            c.close()
    assert out["ref"] == [True, 2, [1, 2, 2], True]
    assert out["port"] == [True, 2, [2, 2, 2], False]


# ---------------------------------------------------------------------------
# failover, restart and rebuild: the reference's slow cases
# ---------------------------------------------------------------------------


@pytest.fixture()
def fresh(tmp_path):
    c = NodeCluster(str(tmp_path / "c"), n=3, device="cpu")
    yield c
    c.close()


@pytest.mark.slow
def test_health_triggered_reelection_bounded(fresh):
    c = fresh
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values (1, 1), (2, 2)")
    c.wait_caught_up(deadline_s=60)
    t_kill = time.monotonic()
    c.kill(1)
    new = c.leader(15.0, exclude=(1,))
    elapsed = time.monotonic() - t_kill
    assert new in (2, 3) and elapsed < 15.0
    c.execute(new, "insert into t values (3, 3)", deadline_s=30)
    assert rows(c.execute(5 - new, "select count(*) from t"))[0][0] == 3
    h = c.clients[new].call("cluster.health")
    st = {r["peer"]: r for r in h["peers"]}
    assert st[1]["state"] == "down"


@pytest.mark.slow
def test_suspect_node_slice_avoidance_parity(fresh):
    c = fresh
    v, d = _load_q6(c, n=1500, batch=500, table="q", seed=3)
    c.execute(1, "alter system set dtl_min_rows = 1")
    with pytest.raises(RpcError) as ei:
        c.clients[1].call("fault.inject", where="send", action="drop",
                          peer=3)
    assert ei.value.kind == "PermissionError"
    c.execute(1, "alter system set enable_fault_injection = true")
    c.clients[1].call("fault.inject", where="send", action="drop", peer=3)
    wait_for(lambda: {r["peer"]: r["state"] for r in c.clients[1].call(
        "cluster.health")["peers"]}[3] != "up", 15,
        "node 1's detector to suspect node 3")
    q = "select sum(v), count(*) from q where d < 500"
    sel = d < 500
    expect = [(int(v[sel].sum()), int(sel.sum()))]
    assert rows(c.execute(1, q)) == expect
    _m, hit, _b, _r, _p, fallbacks, avoided = _newest_exchange(c)
    assert hit == 1 and avoided >= 1 and fallbacks == 0
    c.execute(1, "alter system set enable_dtl_pushdown = false")
    assert rows(c.execute(1, q)) == expect
    hv = rows(c.execute(1, "select peer, state, failures from "
                        "gv$cluster_health order by peer"))
    assert [r[0] for r in hv] == [2, 3] and hv[1][1] in ("suspect", "down")
    c.clients[1].call("fault.clear")
    wait_for(lambda: {r["peer"]: r["state"] for r in c.clients[1].call(
        "cluster.health")["peers"]}[3] == "up", 15,
        "the breaker to close again")


@pytest.mark.slow
def test_nodekill_restart_rejoin(fresh):
    c = fresh
    c.execute(1, "create table t (k int primary key, v int)")
    for s in range(0, 1000, 250):
        c.execute(1, "insert into t values " + ", ".join(
            f"({i}, {i * 2})" for i in range(s, s + 250)))
    c.execute(1, "alter system set dtl_min_rows = 1")
    c.execute(1, "insert into t values (99999, 7)")
    c.wait_count("t", 1001, nodes=(3,))
    term = c.clients[1].call("palf.state")["term"]
    c.kill(3)
    c.execute(1, "insert into t values (99998, 8)")
    c.restart(3)
    c.wait_count("t", 1002, nodes=(3,))
    r = c.execute(3, "select v from t where k = 99999", consistency="weak")
    assert r["node"] == 3 and rows(r) == [(7,)]
    st = c.clients[1].call("palf.state")
    assert st["role"] == "leader" and st["term"] == term
    wait_for(lambda: {x["peer"]: x["state"] for x in c.clients[1].call(
        "cluster.health")["peers"]}[3] == "up", 20, "detector down->up")
    c.execute(1, "select sum(v), count(*) from t where k < 500")
    assert _newest_exchange(c)[5:] == (0, 0)
    rec = c.clients[3].call("recovery.state")
    assert "boot_replay" in [e["phase"] for e in rec["events"]]
    assert rec["applied_lsn"] == rec["committed_lsn"] > 0


@pytest.mark.slow
def test_wipe_rebuild_reaches_parity(fresh):
    c = fresh
    c.execute(1, "create table q (k int primary key, v int)")
    v = np.random.default_rng(11).integers(0, 1000, 1500)
    for s in range(0, 1500, 500):
        c.execute(1, "insert into q values " + ", ".join(
            f"({i}, {v[i]})" for i in range(s, s + 500)))
    c.wait_count("q", 1500, nodes=(3,))
    c.kill(3)
    c.wipe(3)
    c.execute(1, "insert into q values (50000, 1)")
    c.restart(3)
    c.wait_count("q", 1501, nodes=(3,))
    r = c.execute(3, "select sum(v) from q", consistency="weak")
    assert r["node"] == 3 and rows(r)[0][0] == int(v.sum()) + 1
    ev = {e["phase"]: e
          for e in c.clients[3].call("recovery.state")["events"]}
    assert ev["rebuild"]["bytes"] > 0 and ev["rebuild"]["peer"] in (1, 2)


@pytest.mark.slow
def test_xa_prepared_survives_leader_failover(fresh):
    c = fresh
    c.execute(1, "create table t (k int primary key, v int)")
    c.execute(1, "insert into t values (1, 10)")
    for sql in ("xa start 'fx1'", "insert into t values (2, 20)",
                "xa end 'fx1'", "xa prepare 'fx1'"):
        c.execute(1, sql)
    wait_for(lambda: "fx1" in c.clients[3].call(
        "recovery.state")["prepared_xids"], 20,
        "node 3 to register the prepared branch")
    c.kill(1)
    leader = c.leader(30, exclude=(1,))
    assert "fx1" in c.clients[leader].call(
        "recovery.state")["prepared_xids"]
    c.execute(leader, "xa commit 'fx1'", deadline_s=30)
    assert rows(c.execute(leader, "select k, v from t order by k")) == \
        [(1, 10), (2, 20)]
    c.restart(1)
    c.wait_count("t", 2, nodes=(1,))
    # retired once catch-up ships the commit
    wait_for(lambda: "fx1" not in c.clients[1].call(
        "recovery.state")["prepared_xids"], 30,
        "the restarted node to retire the branch")


def test_cluster_timeout_names_what_it_waited_for():
    with pytest.raises(ClusterTimeout, match="the answer"):
        wait_for(lambda: False, 0.2, "the answer")
