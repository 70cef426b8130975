"""The port's networked PALF (``palf/netcluster.py``) held against the
reference's.

- Handlers driven in process: the same seeded sequence of
  ``palf.vote``, ``palf.accept``, ``palf.commit`` and ``palf.state``
  requests (a leader's real batches, plus stale terms, divergent
  previous terms, gaps and duplicates) goes to one ``NetPalf`` follower
  of each package, on disk; every reply, the applied entries and the
  replica's log are equal, and so after a reopen of the log directory.
- Three ``NetPalf`` replicas per package behind real ``RpcServer``s:
  the election, a batch of appends, a heartbeat, a replica that missed
  writes catching up, and a deposed leader's append refused, with equal
  committed LSNs, terms and logs.
Tolerance: exact.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import oceanbase_tpu.net.rpc as jrpc
import oceanbase_tpu.palf.log as jlog
import oceanbase_tpu.palf.netcluster as jnet
import oceanbase_tpu_torch.net.rpc as trpc
import oceanbase_tpu_torch.palf.log as tlog
import oceanbase_tpu_torch.palf.netcluster as tnet
from oceanbase_tpu_torch.bench.cluster import free_ports

PKGS = {"j": (jnet, jlog, jrpc), "t": (tnet, tlog, trpc)}


def _requests(seed: int):
    """A follower's inbound protocol: batches a real leader replica
    appended over three terms, interleaved with hostile requests."""
    rng = np.random.default_rng(seed)
    ldr = jlog.PalfReplica(9)
    ldr.role = "leader"
    reqs = []
    for term in (1, 2, 3):
        ldr.current_term = term
        reqs.append(("vote", dict(term=term, candidate=9,
                                  last_lsn=ldr.last_lsn(),
                                  last_term=ldr.term_at(ldr.last_lsn()))))
        for _ in range(int(rng.integers(2, 5))):
            prev = ldr.last_lsn()
            es = ldr.leader_append([json.dumps(
                {"op": "noop", "i": int(rng.integers(0, 10**6))}).encode()
                for _ in range(int(rng.integers(1, 4)))])
            wire = [{"term": e.term, "lsn": e.lsn, "payload": e.payload}
                    for e in es]
            commit = max(prev - int(rng.integers(0, 2)), 0)
            reqs.append(("accept", dict(
                prev_lsn=prev, prev_term=ldr.term_at(prev), entries=wire,
                leader_id=9, commit=commit, term=term)))
            r = rng.random()
            if r < 0.25:  # a resend: duplicate entries
                reqs.append(reqs[-1])
            elif r < 0.45:  # divergent previous term
                reqs.append(("accept", dict(
                    prev_lsn=prev, prev_term=term + 7, entries=wire,
                    leader_id=9, commit=commit, term=term)))
            elif r < 0.6:  # a gap
                reqs.append(("accept", dict(
                    prev_lsn=prev + 5, prev_term=term, entries=[],
                    leader_id=9, commit=commit, term=term)))
            elif r < 0.75:  # a deposed leader's append and commit
                reqs.append(("accept", dict(
                    prev_lsn=prev, prev_term=ldr.term_at(prev),
                    entries=wire, leader_id=8, commit=prev + 1,
                    term=term - 1)))
                reqs.append(("commit", dict(commit_lsn=ldr.last_lsn(),
                                            leader_id=8, term=term - 1)))
            reqs.append(("commit", dict(commit_lsn=ldr.last_lsn() - int(
                rng.integers(0, 2)), leader_id=9, term=term)))
            reqs.append(("state", {}))
        # a rival candidate with a shorter log in the same term
        reqs.append(("vote", dict(term=term, candidate=7, last_lsn=0,
                                  last_term=0)))
    return reqs


def _drive(key: str, root, reqs):
    net, _log, _rpc = PKGS[key]
    applied = []
    p = net.NetPalf(2, {}, log_dir=str(root / key),
                    apply_cb=lambda e: applied.append((e.lsn, e.term,
                                                       e.payload)))
    h = p.handlers()
    replies = []
    for kind, kw in reqs:
        replies.append(h["palf." + kind](**kw))
    log = [(e.term, e.lsn, e.payload) for e in p.replica.entries]
    state = p._on_state()
    p.close()
    # a reopen reads the same log back
    q = net.NetPalf(2, {}, log_dir=str(root / key))
    relog = [(e.term, e.lsn, e.payload) for e in q.replica.entries]
    q.close()
    return replies, applied, log, state, relog


@pytest.mark.parametrize("seed", range(5))
def test_handlers_reply_as_the_reference(tmp_path, seed):
    reqs = _requests(seed)
    jout = _drive("j", tmp_path, reqs)
    tout = _drive("t", tmp_path, reqs)
    assert tout == jout
    replies, applied, log, _state, relog = tout
    assert True in replies and False in replies
    assert applied and log == relog


def _group(key: str, root, lease_ms=1500):
    net, _log, rpc = PKGS[key]
    ports = free_ports(3)
    clients = {i: {j: rpc.RpcClient("127.0.0.1", ports[j - 1],
                                    peer_id=j, local_id=i)
                   for j in (1, 2, 3) if j != i} for i in (1, 2, 3)}
    nodes, servers = {}, {}
    for i in (1, 2, 3):
        nodes[i] = net.NetPalf(i, clients[i], log_dir=str(root / key /
                                                          f"n{i}"),
                               lease_ms=lease_ms)
        servers[i] = rpc.RpcServer("127.0.0.1", ports[i - 1],
                                   nodes[i].handlers(), node_id=i)
        servers[i].start()
    return nodes, servers, clients


def _stop(nodes, servers, clients):
    for s in servers.values():
        s.stop()
    for cs in clients.values():
        for c in cs.values():
            c.close()
    for n in nodes.values():
        n.close()


def _scenario(key: str, root):
    nodes, servers, clients = _group(key, root)
    try:
        out = [nodes[1].elect()]
        out.append(nodes[1].append([b'{"op": "noop", "n": 1}',
                                    b'{"op": "noop", "n": 2}']))
        nodes[1].tick()
        out.append([nodes[i].committed_lsn() for i in (1, 2, 3)])
        # node 3 misses writes while its server is down
        servers[3].stop()
        out.append(nodes[1].append([b'{"op": "noop", "n": 3}']))
        servers[3] = type(servers[1])("127.0.0.1",
                                      clients[1][3].addr[1],
                                      nodes[3].handlers(), node_id=3)
        servers[3].start()
        nodes[1].tick()
        out.append([nodes[i].replica.last_lsn() for i in (1, 2, 3)])
        # node 2 takes over; node 1's lease lapses and its appends fail
        out.append(nodes[2].elect())
        nodes[1].proposer.lease_expire = 0.0
        try:
            nodes[1].append([b'{"op": "noop", "n": 4}'])
            out.append("appended")
        except Exception as e:  # noqa: BLE001 — the refusal is the point
            out.append(type(e).__name__)
        out.append(nodes[2].append([b'{"op": "noop", "n": 5}']))
        nodes[2].tick()
        out.append([(nodes[i].replica.current_term, nodes[i].replica.role,
                     [(e.term, e.lsn, e.payload)
                      for e in nodes[i].replica.entries])
                    for i in (1, 2, 3)])
        return out
    finally:
        _stop(nodes, servers, clients)


def test_three_replicas_over_rpc_match_the_reference(tmp_path):
    jout = _scenario("j", tmp_path)
    tout = _scenario("t", tmp_path)
    assert tout == jout
    assert tout[0] == 1 and tout[5] == 2
    assert tout[6] in ("NotLeader", "NoQuorum")
