"""Location cache: table/tablet -> serving node, refresh-on-miss.

Reference analog: ObLocationService
(src/share/location_cache/ob_location_service.h:27) — caches
tablet-to-LS-to-server mappings, refreshed when a routed request comes
back OB_NOT_MASTER / unreachable.

In this build every node replicates the sys log stream, so a table's
*home* (strong-read + write location) is the PALF leader; weak reads may
hit any replica.  The cache stores the last known home per table and
falls back to probing peers' ``palf.state`` on miss/invalidations.

Port of ``oceanbase_tpu/share/location.py``, line for line (host code).
"""

from __future__ import annotations

import threading
import time


class LocationCache:
    def __init__(self, node_id: int, peers: dict, local_state_fn,
                 ttl_s: float = 5.0):
        """peers: {node_id: RpcClient}; local_state_fn() -> palf.state
        dict of the local replica."""
        self.node_id = node_id
        self.peers = peers
        self.local_state_fn = local_state_fn
        self.ttl_s = ttl_s
        self._home: dict[str, tuple[int, float]] = {}  # table -> (node, ts)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def leader(self) -> int | None:
        """Current PALF leader (every table's home in the one-LS build)."""
        st = self.local_state_fn()
        if st.get("role") == "leader":
            return self.node_id
        hint = st.get("leader_hint")
        if hint is not None and self._confirm(hint):
            return int(hint)
        # probe peers (≙ location refresh by querying the meta service)
        for pid in sorted(self.peers):
            got = self._probe(pid)
            if got is not None:
                return got
        return None

    def _confirm(self, node_id: int) -> int | None:
        if node_id == self.node_id:
            st = self.local_state_fn()
            return node_id if st.get("role") == "leader" else None
        return self._probe(node_id, direct_only=True)

    def _probe(self, pid: int, direct_only: bool = False) -> int | None:
        cli = self.peers.get(pid)
        if cli is None:
            return None
        try:
            st = cli.call("palf.state")
        except OSError:
            return None
        if st.get("role") == "leader":
            return pid
        if direct_only:
            return None
        hint = st.get("leader_hint")
        if hint is not None and hint != self.node_id and \
                hint in self.peers:
            try:
                st2 = self.peers[hint].call("palf.state")
                if st2.get("role") == "leader":
                    return int(hint)
            except OSError:
                return None
        return None

    # ------------------------------------------------------------------
    def home_of(self, table: str) -> int | None:
        with self._lock:
            hit = self._home.get(table)
            if hit is not None and time.monotonic() - hit[1] < self.ttl_s:
                return hit[0]
        node = self.leader()
        if node is not None:
            with self._lock:
                self._home[table] = (node, time.monotonic())
        return node

    def invalidate(self, table: str | None = None):
        with self._lock:
            if table is None:
                self._home.clear()
            else:
                self._home.pop(table, None)
