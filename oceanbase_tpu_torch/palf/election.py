"""Lease-based leader election.

Port of ``oceanbase_tpu/palf/election.py``, with its ``palf.elections*``
metrics.

Reference analog: src/logservice/palf/election — ElectionImpl
(algorithm/election_impl.h:43), proposer/acceptor split
(election_proposer.cpp / election_acceptor.cpp), with leader leases and
priority comparison.

Model: candidates request votes for a term; an acceptor grants at most one
vote per term (persisted via the replica's voted_for) and only to
candidates whose log is at least as up-to-date (last term, last lsn).  A
leader holds a lease it must refresh by heartbeating a majority; an
expired lease triggers a new election with randomized timeouts
(priority = longer log wins, then lower id, ≙ election priority)."""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from oceanbase_tpu_torch.server import metrics as qmetrics

qmetrics.declare("palf.elections", "counter",
                 "election campaigns started on this node")
qmetrics.declare("palf.elections_won", "counter",
                 "campaigns that reached quorum")


@dataclass
class VoteRequest:
    term: int
    candidate: int
    last_lsn: int
    last_term: int


@dataclass
class VoteReply:
    term: int
    granted: bool
    voter: int


class ElectionAcceptor:
    """Vote-granting side, one per replica."""

    def __init__(self, replica):
        self.replica = replica
        self._lock = threading.Lock()

    def on_vote_request(self, req: VoteRequest) -> VoteReply:
        r = self.replica
        with self._lock:
            if req.term < r.current_term:
                return VoteReply(r.current_term, False, r.replica_id)
            if req.term > r.current_term:
                r.current_term = req.term
                r.role = "follower"
            already = r.voted_for.get(req.term)
            if already is not None and already != req.candidate:
                return VoteReply(r.current_term, False, r.replica_id)
            # up-to-date check (no committed-entry loss across leaders)
            my_last = r.last_lsn()
            my_last_term = r.term_at(my_last)
            ok = (req.last_term, req.last_lsn) >= (my_last_term, my_last)
            if ok:
                r.voted_for[req.term] = req.candidate
            return VoteReply(r.current_term, ok, r.replica_id)


class ElectionProposer:
    """Candidate side: runs one election round for its replica."""

    def __init__(self, replica, peers_rpc, lease_ms: int = 400):
        self.replica = replica
        self.peers_rpc = peers_rpc  # callable: (peer_id, VoteRequest) -> VoteReply | None
        self.lease_ms = lease_ms
        self.lease_expire = 0.0

    def randomized_timeout(self) -> float:
        return (self.lease_ms + random.randint(0, self.lease_ms)) / 1000.0

    def campaign(self, peer_ids) -> bool:
        qmetrics.inc("palf.elections")
        r = self.replica
        r.current_term += 1
        term = r.current_term
        r.voted_for[term] = r.replica_id
        r.role = "candidate"
        votes = 1
        req = VoteRequest(term, r.replica_id, r.last_lsn(),
                          r.term_at(r.last_lsn()))
        for pid in peer_ids:
            reply = self.peers_rpc(pid, req)
            if reply is None:
                continue
            if reply.term > r.current_term:
                r.current_term = reply.term
                r.role = "follower"
                return False
            if reply.granted:
                votes += 1
        quorum = (len(peer_ids) + 1) // 2 + 1
        if votes >= quorum and r.current_term == term:
            r.role = "leader"
            self.refresh_lease()
            qmetrics.inc("palf.elections_won")
            return True
        r.role = "follower"
        return False

    def refresh_lease(self):
        self.lease_expire = time.monotonic() + self.lease_ms / 1000.0

    def lease_valid(self) -> bool:
        return time.monotonic() < self.lease_expire
