"""Cluster failure detector: heartbeats + per-peer EWMA three-state breaker.

Reference analog: the failure detector feeding palf election leases
(src/logservice/palf/election) and the server blacklist
(ObServerBlacklist, share/ob_server_blacklist.cpp) that routing layers
consult to steer requests away from flaky servers BEFORE paying a
timeout.

One `HealthMonitor` per node process.  Signal comes from two sources:

- a heartbeat thread pinging every peer each ``interval_s`` with a
  deadline tied to the period (a hung peer cannot stall the loop);
- every ordinary RPC outcome, via the per-peer observer installed on the
  peer's `RpcClient` (`record_success`/`record_failure`/...): real
  traffic keeps the detector fresher than heartbeats alone.

Per peer, a breaker walks three states on consecutive failures:

    up ──(fails ≥ suspect_after)──> suspect ──(fails ≥ down_after)──> down
     ^                                                                 │
     └──────────────────── any success ────────────────────────────────┘

Consumers:
- the DTL exchange routes slices AWAY from suspect/down peers
  pre-emptively (px/dtl.py) instead of paying the timeout-then-fallback;
- `NetPalf.on_peer_down` campaigns immediately when the known leader
  dies instead of waiting for its lease to expire (palf/netcluster.py);
- `gv$cluster_health` (server/virtual_tables.py) serves the table.

Port of ``oceanbase_tpu/net/health.py``, line for line (host code): the
same thresholds walk a peer through the same states.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from oceanbase_tpu_torch.server import metrics as qmetrics

UP, SUSPECT, DOWN = "up", "suspect", "down"

qmetrics.declare("health.transitions", "counter",
                 "failure-detector state flips (label: to=<state>)")
qmetrics.declare("health.breaker_opens", "counter",
                 "peers leaving the 'up' state")


@dataclass
class PeerHealth:
    """Mutable per-peer record — only ever touched under the monitor's
    lock (the heartbeat thread and every rpc caller thread race here)."""

    peer: int
    state: str = UP
    rtt_ewma_ms: float = 0.0
    consecutive_failures: int = 0
    breaker_opens: int = 0       # transitions out of "up"
    successes: int = 0
    failures: int = 0
    retries: int = 0
    deadline_exceeded: int = 0
    last_change_ts: float = 0.0   # monotonic, 0 = never
    last_transition_ts: float = 0.0  # wall clock of the last state flip

    def row(self) -> dict:
        return {"peer": self.peer, "state": self.state,
                "rtt_ewma_ms": self.rtt_ewma_ms,
                "consecutive_failures": self.consecutive_failures,
                "breaker_opens": self.breaker_opens,
                "successes": self.successes, "failures": self.failures,
                "retries": self.retries,
                "deadline_exceeded": self.deadline_exceeded,
                "last_transition_ts": self.last_transition_ts}


class _PeerObserver:
    """RpcClient-facing adapter: one per peer, feeds the monitor."""

    def __init__(self, monitor: "HealthMonitor", peer: int):
        self._monitor = monitor
        self._peer = peer

    def record_success(self, rtt_s: float):
        self._monitor.record_success(self._peer, rtt_s)

    def record_failure(self):
        self._monitor.record_failure(self._peer)

    def record_retry(self):
        self._monitor.record_retry(self._peer)

    def record_deadline(self):
        self._monitor.record_deadline(self._peer)


class HealthMonitor:
    def __init__(self, node_id: int, peers: dict, interval_s: float = 0.5,
                 suspect_after: int = 2, down_after: int = 4,
                 rtt_alpha: float = 0.2, on_down=None):
        """peers: {node_id: RpcClient}.  ``on_down(peer_id)`` fires (from
        the reporting thread, outside the lock) on each transition INTO
        down — the re-election / routing-invalidation hook."""
        self.node_id = node_id
        self.peers = peers
        self.interval_s = float(interval_s)
        self.suspect_after = int(suspect_after)
        self.down_after = int(down_after)
        self.rtt_alpha = float(rtt_alpha)
        self.on_down = on_down
        self._stats: dict[int, PeerHealth] = {
            pid: PeerHealth(pid) for pid in peers}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def observer(self, peer: int) -> _PeerObserver:
        with self._lock:
            if peer not in self._stats:
                self._stats[peer] = PeerHealth(peer)
        return _PeerObserver(self, peer)

    # -- signal sinks (any thread) -------------------------------------
    def record_success(self, peer: int, rtt_s: float):
        with self._lock:
            st = self._stats.get(peer)
            if st is None:
                return
            st.successes += 1
            st.consecutive_failures = 0
            ms = rtt_s * 1000.0
            st.rtt_ewma_ms = ms if st.rtt_ewma_ms == 0.0 else (
                self.rtt_alpha * ms
                + (1.0 - self.rtt_alpha) * st.rtt_ewma_ms)
            if st.state != UP:
                # breaker resets on the FIRST success: a recovered peer
                # flips down→up within one heartbeat interval, so DTL
                # routing (and gv$px_exchange avoided_parts) stop
                # steering around it promptly
                st.state = UP
                st.last_change_ts = time.monotonic()
                st.last_transition_ts = time.time()
                qmetrics.inc("health.transitions", to=UP)

    def record_failure(self, peer: int):
        fire = None
        with self._lock:
            st = self._stats.get(peer)
            if st is None:
                return
            st.failures += 1
            st.consecutive_failures += 1
            new = st.state
            if st.consecutive_failures >= self.down_after:
                new = DOWN
            elif st.consecutive_failures >= self.suspect_after:
                new = SUSPECT
            if new != st.state:
                if st.state == UP:
                    st.breaker_opens += 1
                    qmetrics.inc("health.breaker_opens")
                went_down = new == DOWN
                st.state = new
                st.last_change_ts = time.monotonic()
                st.last_transition_ts = time.time()
                qmetrics.inc("health.transitions", to=new)
                if went_down and self.on_down is not None:
                    fire = self.on_down
        if fire is not None:
            # the reporting thread may be a user statement mid-rpc (or a
            # palf caller already holding NetPalf._lock); the down hook
            # runs a staggered multi-round ELECTION — never make the
            # reporter pay for it (or deadlock on lock re-entry)
            threading.Thread(target=fire, args=(peer,), daemon=True,
                             name=f"on-down-{peer}").start()

    def record_retry(self, peer: int):
        with self._lock:
            st = self._stats.get(peer)
            if st is not None:
                st.retries += 1

    def record_deadline(self, peer: int):
        with self._lock:
            st = self._stats.get(peer)
            if st is not None:
                st.deadline_exceeded += 1

    # -- consumers -----------------------------------------------------
    def state(self, peer: int) -> str:
        with self._lock:
            st = self._stats.get(peer)
            return UP if st is None else st.state

    def live_peers(self) -> list[int]:
        with self._lock:
            return [p for p, st in self._stats.items() if st.state == UP]

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [self._stats[p].row() for p in sorted(self._stats)]

    # -- heartbeat loop ------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"health-{self.node_id}")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.interval_s + 1.0)
            self._thread = None

    def _run(self):
        # the ping's own observer wiring records the outcome; bounding
        # the deadline to the period keeps one dead peer from delaying
        # the next round by more than ~one interval
        while not self._stop.wait(self.interval_s):
            for pid, cli in list(self.peers.items()):
                if self._stop.is_set():
                    return
                if getattr(cli, "observer", None) is not None:
                    cli.ping(_deadline_s=self.interval_s)
                else:
                    # unwired client (tests): account the probe here
                    t0 = time.monotonic()
                    if cli.ping(_deadline_s=self.interval_s):
                        self.record_success(pid,
                                            time.monotonic() - t0)
                    else:
                        self.record_failure(pid)
