"""Networked PALF group: one local replica per process, peers over RPC.

Reference analog: PalfHandleImpl's network path — submit_log on the
leader, receive_log on followers (src/logservice/palf/
palf_handle_impl.cpp:406, :3235), election RPCs (palf/election/), and
the log fetch/catch-up protocol.  The in-process `PalfCluster` keeps the
same protocol with direct calls; this class speaks it over
`oceanbase_tpu_torch.net.rpc` so each replica lives in its own OS process.

Interface-compatible with `PalfCluster` where the tenant/tx layers touch
it: ``append(payloads) -> committed_lsn``, ``committed_lsn()``,
``elect()``, ``leader()``/``is_leader``, ``close()``.  A non-leader
``append`` raises ``NotLeader`` with the current leader hint so the node
layer can forward the write (≙ location-cache-driven retry on
OB_NOT_MASTER).

RPC endpoints this class registers on its node's server:
    palf.vote(term, candidate, last_lsn, last_term) -> reply dict
    palf.accept(prev_lsn, prev_term, entries, leader_id, commit) -> bool
    palf.commit(commit_lsn, leader_id)
    palf.state() -> {last_lsn, committed_lsn, term, role}

Port of ``oceanbase_tpu/palf/netcluster.py``, line for line (host code):
the vote, accept and commit handlers answer as the reference's do.  Two
additions where the reference is wrong: ``commit_point`` (a new leader's
statements wait for its election's commit point to be applied, ROADMAP
Queue 3 #30) and ``campaign_if_leaderless`` (a cluster left with no
leader and no dead process elects one without a write, Queue 3 #31;
it asks its peers' ``palf.state`` first and leaves a leader of its term
in place, so a follower the leader cannot ship to deposes no one).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from oceanbase_tpu_torch.palf.cluster import NoQuorum, NotLeader
from oceanbase_tpu_torch.palf.election import (
    ElectionAcceptor,
    ElectionProposer,
    VoteReply,
    VoteRequest,
)
from oceanbase_tpu_torch.palf.log import LogEntry, PalfReplica


def _encode_entries(entries: list[LogEntry]) -> list[dict]:
    return [{"term": e.term, "lsn": e.lsn, "payload": e.payload}
            for e in entries]


def _decode_entries(raw: list[dict]) -> list[LogEntry]:
    return [LogEntry(int(d["term"]), int(d["lsn"]), bytes(d["payload"]))
            for d in raw]


class NetPalf:
    def __init__(self, node_id: int, peers: dict[int, "RpcClient"],
                 log_dir: str | None = None,
                 apply_cb: Optional[Callable] = None,
                 lease_ms: int = 2000, recovery=None):
        """peers: {node_id: RpcClient} for every OTHER node."""
        self.node_id = node_id
        self.peers = peers
        self.replica = PalfReplica(node_id, log_dir, apply_cb=apply_cb,
                                   recovery=recovery)
        self.acceptor = ElectionAcceptor(self.replica)
        self.proposer = ElectionProposer(self.replica, self._vote_rpc,
                                         lease_ms=lease_ms)
        self.leader_hint: int | None = None
        # LSNs this process originated as leader: their effects already
        # exist in the local engine via the write path, so the apply
        # callback must skip them (followers apply; ≙ applyservice
        # firing commit callbacks on the leader vs replayservice replay)
        self.local_lsns: set[int] = set()
        self._lock = threading.RLock()
        # the last message of a current leader (accept or commit); a
        # follower that knew a leader and hears none for its silence
        # timeout campaigns (``campaign_if_leaderless``)
        self._heard = time.monotonic()
        self._silence_s = self._silence_timeout()
        # an election's outcome for statements, published lock-free:
        # cleared while a campaign runs, set once its no-op committed
        # (or it lost); ``_elected_commit`` is that no-op's commit point
        self._elected = threading.Event()
        self._elected.set()
        self._elected_commit = 0

    # ------------------------------------------------------------------
    # outgoing RPC
    # ------------------------------------------------------------------
    def _vote_rpc(self, peer_id: int, req: VoteRequest):
        cli = self.peers.get(peer_id)
        if cli is None:
            return None
        try:
            r = cli.call("palf.vote", term=req.term,
                         candidate=req.candidate, last_lsn=req.last_lsn,
                         last_term=req.last_term)
        except OSError:
            return None
        return VoteReply(int(r["term"]), bool(r["granted"]),
                         int(r["voter"]))

    def _ship_to(self, peer_id: int, commit: int) -> bool:
        """Push the suffix a follower is missing (walk back on term
        mismatch — ≙ fetch-log catch-up)."""
        cli = self.peers.get(peer_id)
        if cli is None:
            return False
        r = self.replica
        try:
            st = cli.call("palf.state")
            if int(st.get("term", 0)) > r.current_term:
                # the cluster moved on to a newer term: we are a stale
                # leader — stop shipping (our lease lapses, we step down)
                return False
            prev = min(r.last_lsn(), int(st["last_lsn"]))
            while prev > 0:
                batch = r.entries_from(prev)
                if batch is None:
                    # prev predates our WAL-recycle base: the history
                    # is gone — this follower needs the rebuild plane
                    return False
                ok = cli.call(
                    "palf.accept", prev_lsn=prev,
                    prev_term=r.term_at(prev),
                    entries=_encode_entries(batch),
                    leader_id=self.node_id, commit=commit,
                    term=r.current_term)
                if ok:
                    return True
                prev -= 1
            batch = r.entries_from(0)
            if batch is None:
                return False  # recycled: cannot ship from lsn 0
            return bool(cli.call(
                "palf.accept", prev_lsn=0, prev_term=0,
                entries=_encode_entries(batch),
                leader_id=self.node_id, commit=commit,
                term=r.current_term))
        except OSError:
            return False

    # ------------------------------------------------------------------
    # incoming RPC handlers (registered by the node server)
    # ------------------------------------------------------------------
    def handlers(self) -> dict:
        return {
            "palf.vote": self._on_vote,
            "palf.accept": self._on_accept,
            "palf.commit": self._on_commit,
            "palf.state": self._on_state,
        }

    def _on_vote(self, term, candidate, last_lsn, last_term):
        rep = self.acceptor.on_vote_request(
            VoteRequest(int(term), int(candidate), int(last_lsn),
                        int(last_term)))
        if rep.granted:
            self._heard = time.monotonic()  # a campaign under way
        return {"term": rep.term, "granted": rep.granted,
                "voter": rep.voter}

    def _on_accept(self, prev_lsn, prev_term, entries, leader_id,
                   commit, term=None):
        with self._lock:
            r = self.replica
            es = _decode_entries(entries)
            # sender's leadership term; older wires omit it — fall back
            # to the shipped entries' last term as before
            sender_term = (int(term) if term is not None
                           else (es[-1].term if es else None))
            if sender_term is not None and sender_term < r.current_term:
                # Raft safety: a DEPOSED leader's append must not
                # truncate the new leader's entries (its conflicting
                # suffix would overwrite possibly-committed log) — and
                # must not count as an ack that refreshes its lease
                return False
            # a valid append refreshes follower state: the sender holds
            # a majority-granted lease for its term
            if sender_term is not None and sender_term >= r.current_term:
                r.current_term = sender_term
                if r.role == "leader" and leader_id != self.node_id:
                    r.role = "follower"
                self.leader_hint = int(leader_id)
            ok = r.accept(int(prev_lsn), int(prev_term), es)
            if ok:
                self.leader_hint = int(leader_id)
            if sender_term is not None:
                self._heard = time.monotonic()
        if ok:
            # apply OUTSIDE self._lock: the apply callback reaches into
            # tx/engine state whose write paths call back into this
            # class (commit -> append -> self._lock) from other threads —
            # holding the palf lock across it would order the two locks
            # both ways and deadlock under leadership churn
            r.advance_commit(min(int(commit), r.last_lsn()))
        return ok

    def _on_commit(self, commit_lsn, leader_id, term=None):
        with self._lock:
            if term is not None and int(term) < self.replica.current_term:
                return False  # stale leader's commit point: ignore
            self.leader_hint = int(leader_id)
            self._heard = time.monotonic()
        # apply outside self._lock (same rationale as _on_accept)
        self.replica.advance_commit(
            min(int(commit_lsn), self.replica.last_lsn()))
        return True

    def _on_state(self):
        r = self.replica
        return {"last_lsn": r.last_lsn(),
                "committed_lsn": r.committed_lsn,
                "term": r.current_term, "role": r.role,
                "leader_hint": self.leader_hint}

    # ------------------------------------------------------------------
    # leadership
    # ------------------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return (self.replica.role == "leader"
                and self.proposer.lease_valid())

    def _silence_timeout(self) -> float:
        """Randomized 3-6 leases: far past a live leader's heartbeat (a
        quarter lease) and the failure detector's down threshold, so it
        fires only where no leader is left to detect as down."""
        ms = self.proposer.lease_ms
        return random.uniform(3 * ms, 6 * ms) / 1000.0

    def campaign_if_leaderless(self) -> bool:
        """Campaign when this node knew a leader (``leader_hint`` set, so
        a booting or rejoining node waits to be contacted) and has heard
        from none for its silence timeout.  The failure detector
        campaigns only when the leader's process is down; a leader
        deposed by a rival's vote request for a higher term that the
        rival then loses leaves live nodes with no leader and nothing to
        detect, and the reference stays so until a write arrives
        (ROADMAP Queue 3 #31).  Before it campaigns it reads each peer's
        ``palf.state``, which bumps no term: a peer that leads in this
        node's term or a later one stands, since a leader that cannot
        ship to this node (a one-way link, a position before its recycle
        base) may still hold its majority.  -> True if this node won."""
        if self.replica.role == "leader" or self.leader_hint is None or \
                time.monotonic() - self._heard < self._silence_s:
            return False
        self._heard = time.monotonic()
        self._silence_s = self._silence_timeout()
        for cli in self.peers.values():
            try:
                st = cli.call("palf.state")
            except OSError:
                continue
            if st.get("role") == "leader" and \
                    int(st.get("term", 0)) >= self.replica.current_term:
                return False
        try:
            self.elect()
            return True
        except (NoQuorum, OSError):
            return False

    def commit_point(self, timeout_s: float) -> int | None:
        """The commit point of this node's last election: its no-op
        commits every earlier term's entry, and entries of its own term
        are this leader's own writes, applied by their statements.
        Waits, without the log lock, for an election under way to end;
        -> None if it is still running after ``timeout_s``."""
        if not self._elected.wait(timeout_s):
            return None
        return self._elected_commit

    def elect(self) -> int:
        """Campaign for leadership of this group."""
        with self._lock:
            self._elected.clear()
            try:
                if self.proposer.campaign(sorted(self.peers)):
                    self.leader_hint = self.node_id
                    # Raft safety: commit prior-term entries via a no-op
                    # in the new term
                    self._replicate([b'{"op": "noop"}'])
                    won = True
                else:
                    won = False
            finally:
                self._elected_commit = self.replica.committed_lsn
                self._elected.set()
        if won:
            # catch-up residue from follower days applies OUTSIDE the
            # palf lock (see _on_accept)
            self.replica.drain_applies()
            return self.node_id
        raise NoQuorum(f"node {self.node_id} lost the election")

    def on_peer_down(self, peer_id: int, attempts: int = 8) -> bool:
        """Failure-detector hook: the cluster health monitor declared
        ``peer_id`` down.  If that peer is the replica we believe leads,
        campaign IMMEDIATELY instead of waiting for the next write to
        pay out the remaining lease (≙ takeover election on a dead
        leader's lease, palf/election).  The survivors of a 3-node
        cluster detect the death near-simultaneously and would split the
        vote forever if symmetric, so campaigns are staggered by a
        node-id offset plus randomized, growing backoff (≙ election
        priority + randomized timeouts).  -> True if this node won."""
        if self.replica.role == "leader":
            return False
        if self.leader_hint is not None and self.leader_hint != peer_id:
            return False  # somebody else leads as far as we know
        stagger = 0.12 * ((self.node_id * 7) % 5)
        for attempt in range(max(attempts, 1)):
            time.sleep(stagger
                       + random.uniform(0.02, 0.15) * (attempt + 1))
            if self.replica.role == "leader":
                return True
            hint = self.leader_hint
            if hint is not None and hint not in (peer_id, self.node_id):
                return False  # a rival already won; follow it
            try:
                self.elect()
                return True
            except NoQuorum:
                continue
            except OSError:
                continue
        return False

    def ensure_leader(self, campaign: bool = False):
        if self.is_leader:
            return
        if campaign:
            self.elect()
            return
        raise NotLeader(f"node {self.node_id} is not the leader "
                        f"(hint: {self.leader_hint})")

    # ------------------------------------------------------------------
    # append path (PalfCluster-compatible surface)
    # ------------------------------------------------------------------
    def append(self, payloads: list[bytes]) -> int:
        with self._lock:
            self.ensure_leader()
            out = self._replicate(payloads)
        # deferred applies (drain=False in _replicate) run lock-free
        self.replica.drain_applies()
        return out

    def _replicate(self, payloads: list[bytes]) -> int:
        r = self.replica
        entries = r.leader_append(payloads)
        commit_target = entries[-1].lsn if entries else r.last_lsn()
        acks = 1
        for pid in sorted(self.peers):
            if self._ship_to(pid, r.committed_lsn):
                acks += 1
        quorum = (len(self.peers) + 1) // 2 + 1
        if acks < quorum:
            raise NoQuorum(
                f"append replicated to {acks}/{len(self.peers) + 1}")
        # mark leader-originated lsns only AFTER quorum: committed
        # entries are never replaced (Raft), so the skip in
        # _apply_entry is safe — whereas marking a NoQuorum'd batch
        # would make this node skip-apply whatever a later leader
        # commits at those lsns (its replacement entries, or even our
        # own, whose effects the failed write path never applied)
        self.local_lsns.update(e.lsn for e in entries)
        # caller holds self._lock: defer apply callbacks to the
        # drain_applies() after the lock releases (append/elect)
        r.advance_commit(commit_target, drain=False)
        self.proposer.refresh_lease()
        for pid, cli in self.peers.items():
            try:
                cli.call("palf.commit", commit_lsn=r.committed_lsn,
                         leader_id=self.node_id, term=r.current_term)
            except OSError:
                pass
        return r.committed_lsn

    def tick(self):
        """Leader heartbeat: catch followers up + refresh lease."""
        with self._lock:
            if self.replica.role != "leader":
                return
            # a leader hears itself: stepping down starts its silence
            # timeout afresh
            self._heard = time.monotonic()
            acks = 1
            for pid in sorted(self.peers):
                if self._ship_to(pid, self.replica.committed_lsn):
                    acks += 1
            if acks >= (len(self.peers) + 1) // 2 + 1:
                self.proposer.refresh_lease()

    # ------------------------------------------------------------------
    def committed_lsn(self) -> int:
        return self.replica.committed_lsn

    def recycle(self, upto_lsn: int) -> int:
        """WAL recycle of THIS process's replica (peers recycle on
        their own checkpoint cadence); -> bytes reclaimed on disk."""
        return self.replica.recycle(upto_lsn)

    def close(self):
        self.replica.close()
