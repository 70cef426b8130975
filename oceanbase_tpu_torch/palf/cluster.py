"""In-process PALF cluster: N replicas, message passing, failure injection.

Port of ``oceanbase_tpu/palf/cluster.py``, with the ERRSIM fault point
``palf.append`` on the append path.

Reference analog: the palf_cluster mittest harness
(mittest/palf_cluster/README.md) plus the runtime glue PalfEnv provides —
here the "RPC" is direct method calls guarded by a partition/down matrix
so tests can kill leaders and heal partitions (≙ errsim-driven failover
tests, SURVEY §4/§5.3).

Synchronous-replication model: ``append(payloads)`` on the leader ships to
every reachable follower and commits on majority persistence; commit
advances followers on the next append or an explicit ``tick()``
(heartbeat).  Election runs on demand via ``elect()`` or automatically
when an append finds no valid-lease leader.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from oceanbase_tpu_torch.palf.election import (
    ElectionAcceptor,
    ElectionProposer,
    VoteRequest,
)
from oceanbase_tpu_torch.palf.log import PalfReplica
from oceanbase_tpu_torch.server.errsim import ERRSIM


class NotLeader(RuntimeError):
    pass


class NoQuorum(RuntimeError):
    pass


class PalfCluster:
    def __init__(self, n_replicas: int = 3, log_root: str | None = None,
                 apply_cb_factory: Optional[Callable] = None):
        self.replicas: dict[int, PalfReplica] = {}
        self.acceptors: dict[int, ElectionAcceptor] = {}
        self.proposers: dict[int, ElectionProposer] = {}
        self.down: set[int] = set()
        self._lock = threading.RLock()
        for i in range(1, n_replicas + 1):
            cb = apply_cb_factory(i) if apply_cb_factory else None
            r = PalfReplica(i, log_root, apply_cb=cb)
            self.replicas[i] = r
            self.acceptors[i] = ElectionAcceptor(r)
            self.proposers[i] = ElectionProposer(r, self._vote_rpc)
        self.leader_id: int | None = None

    # ------------------------------------------------------------------
    # "network"
    # ------------------------------------------------------------------
    def _reachable(self, a: int, b: int) -> bool:
        return a not in self.down and b not in self.down

    def _vote_rpc(self, peer_id: int, req: VoteRequest):
        if not self._reachable(req.candidate, peer_id):
            return None
        return self.acceptors[peer_id].on_vote_request(req)

    # ------------------------------------------------------------------
    # election
    # ------------------------------------------------------------------
    def elect(self, candidate: int | None = None) -> int:
        """Run an election; returns the new leader id.
        ≙ election_proposer prepare/accept rounds."""
        with self._lock:
            alive = [i for i in self.replicas if i not in self.down]
            if not alive:
                raise NoQuorum("all replicas down")
            # candidate priority: longest log, then lowest id
            cands = [candidate] if candidate else sorted(
                alive, key=lambda i: (-self.replicas[i].last_lsn(), i))
            for cand in cands + alive:
                if cand in self.down:
                    continue
                peers = [i for i in self.replicas if i != cand]
                if self.proposers[cand].campaign(peers):
                    self.leader_id = cand
                    # demote others
                    for i, r in self.replicas.items():
                        if i != cand and r.role == "leader":
                            r.role = "follower"
                    self._reconcile_followers()
                    # Raft safety: prior-term entries commit only via a
                    # current-term entry — append a no-op (≙ reconfirm)
                    self._append_noop()
                    return cand
            raise NoQuorum("no candidate won")

    def _reconcile_followers(self):
        ldr = self.replicas[self.leader_id]
        for i, r in self.replicas.items():
            if i != ldr.replica_id and self._reachable(ldr.replica_id, i):
                self._ship(ldr, r)

    def _append_noop(self):
        ldr = self.replicas[self.leader_id]
        entries = ldr.leader_append([b'{"op": "noop"}'])
        acks = 1
        for i, r in self.replicas.items():
            if i == ldr.replica_id or not self._reachable(ldr.replica_id, i):
                continue
            if self._ship(ldr, r):
                acks += 1
        if acks >= len(self.replicas) // 2 + 1:
            ldr.advance_commit(entries[-1].lsn)
            self._broadcast_commit(ldr.committed_lsn)

    def leader(self) -> PalfReplica:
        if self.leader_id is None or self.leader_id in self.down or \
                self.replicas[self.leader_id].role != "leader" or \
                not self.proposers[self.leader_id].lease_valid():
            self.elect()
        return self.replicas[self.leader_id]

    # ------------------------------------------------------------------
    # append path (≙ submit_log -> replicate -> majority ack -> commit)
    # ------------------------------------------------------------------
    def append(self, payloads: list[bytes]) -> int:
        """Group-append on the leader; returns committed end LSN."""
        ERRSIM.hit("palf.append")
        with self._lock:
            ldr = self.leader()
            entries = ldr.leader_append(payloads)
            acks = 1
            for i, r in self.replicas.items():
                if i == ldr.replica_id:
                    continue
                if not self._reachable(ldr.replica_id, i):
                    continue
                if self._ship(ldr, r):
                    acks += 1
            quorum = len(self.replicas) // 2 + 1
            if acks < quorum:
                raise NoQuorum(
                    f"append replicated to {acks}/{len(self.replicas)}")
            # commit rule: majority-persisted entries of the current term
            commit = entries[-1].lsn if entries else ldr.last_lsn()
            ldr.advance_commit(commit)
            self.proposers[ldr.replica_id].refresh_lease()
            self._broadcast_commit(commit)
            return commit

    def _ship(self, ldr: PalfReplica, follower: PalfReplica) -> bool:
        """Bring a follower up to date from the leader's log
        (≙ fetch-log / push-log catch-up)."""
        # find the highest matching prefix, walking back on mismatch
        prev = min(ldr.last_lsn(), follower.last_lsn())
        while prev > 0 and follower.term_at(prev) != ldr.term_at(prev):
            prev -= 1
        batch = ldr.entries_from(prev)
        if batch is None:
            # the match point predates the leader's WAL-recycle base:
            # the history is physically gone — this follower needs the
            # rebuild plane, not catch-up
            return False
        return follower.accept(prev, ldr.term_at(prev), batch)

    def _broadcast_commit(self, commit_lsn: int):
        ldr_id = self.leader_id
        for i, r in self.replicas.items():
            if i == ldr_id or not self._reachable(ldr_id, i):
                continue
            r.advance_commit(min(commit_lsn, r.last_lsn()))

    def tick(self):
        """Heartbeat: refresh lease, catch followers up, advance commits."""
        with self._lock:
            if self.leader_id is None or self.leader_id in self.down:
                return
            ldr = self.replicas[self.leader_id]
            if ldr.role != "leader":
                return
            for i, r in self.replicas.items():
                if i != ldr.replica_id and self._reachable(ldr.replica_id, i):
                    self._ship(ldr, r)
            self.proposers[ldr.replica_id].refresh_lease()
            self._broadcast_commit(ldr.committed_lsn)

    # ------------------------------------------------------------------
    # failure injection (≙ errsim points)
    # ------------------------------------------------------------------
    def kill(self, replica_id: int):
        with self._lock:
            self.down.add(replica_id)
            if self.leader_id == replica_id:
                self.leader_id = None

    def revive(self, replica_id: int):
        with self._lock:
            self.down.discard(replica_id)

    def recycle(self, upto_lsn: int) -> int:
        """WAL recycle across every replica (each clamps to its own
        commit/apply point); -> bytes reclaimed on disk."""
        with self._lock:
            freed = 0
            for r in self.replicas.values():
                freed += r.recycle(upto_lsn)
            return freed

    def committed_lsn(self) -> int:
        if self.leader_id is not None and self.leader_id not in self.down:
            return self.replicas[self.leader_id].committed_lsn
        return max((r.committed_lsn for i, r in self.replicas.items()
                    if i not in self.down), default=0)

    def close(self):
        for r in self.replicas.values():
            r.close()
