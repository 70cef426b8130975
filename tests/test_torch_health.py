"""The port's failure detector (``net/health.py``) and location cache
(``share/location.py``) held against the reference's.

The same seeded sequences of call outcomes (success with its round-trip
time, failure, retry, deadline) drive one ``HealthMonitor`` of each
package: after every step the breaker states, the per-peer counters and
the rtt ewma are equal, and ``on_down`` fires at the same steps.  The
``LocationCache`` answers the same leaders over the same peer states,
and the detector's rows reach gv$cluster_health on a cluster node.
Tolerance: exact (the ewma is the same float arithmetic).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from oceanbase_tpu.net.health import HealthMonitor as JMon
from oceanbase_tpu.share.location import LocationCache as JLoc
from oceanbase_tpu_torch.net.health import HealthMonitor as TMon
from oceanbase_tpu_torch.share.location import LocationCache as TLoc


def _walk(Mon, seed: int, suspect: int, down: int):
    rng = np.random.default_rng(seed)
    fired: list = []
    lock = threading.Lock()

    def on_down(p):
        with lock:
            fired.append((step, p))

    mon = Mon(1, {}, suspect_after=suspect, down_after=down,
              on_down=on_down)
    for p in (2, 3, 4):
        mon.observer(p)
    trace = []
    for step in range(400):
        p = int(rng.integers(2, 5))
        op = rng.choice(["ok", "fail", "fail", "retry", "deadline"])
        if op == "ok":
            mon.record_success(p, float(rng.random()) * 0.05)
        elif op == "fail":
            mon.record_failure(p)
        elif op == "retry":
            mon.record_retry(p)
        else:
            mon.record_deadline(p)
        rows = [{k: v for k, v in r.items() if k != "last_transition_ts"}
                for r in mon.snapshot()]
        trace.append((rows, mon.live_peers(),
                      [mon.state(q) for q in (2, 3, 4, 9)]))
    # on_down runs on a thread of its own: let them land
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        time.sleep(0.05)
        with lock:
            n = len(fired)
        time.sleep(0.05)
        with lock:
            if len(fired) == n:
                break
    return trace, sorted(fired)


@pytest.mark.parametrize("seed,suspect,down", [(0, 2, 4), (1, 1, 2),
                                               (2, 3, 3), (3, 2, 6)])
def test_breaker_walks_the_same_states(seed, suspect, down):
    jt, jf = _walk(JMon, seed, suspect, down)
    tt, tf = _walk(TMon, seed, suspect, down)
    assert tt == jt
    assert tf == jf
    assert any(s == "down" for _r, _l, st in tt for s in st)


class _FakePeer:
    def __init__(self, state):
        self.state = state

    def call(self, method, **_kw):
        if self.state is None:
            raise ConnectionError("down")
        assert method == "palf.state"
        return dict(self.state)


@pytest.mark.parametrize("local,peer_states,want", [
    ({"role": "leader"}, {2: {"role": "follower"}}, 1),
    ({"role": "follower", "leader_hint": 3},
     {2: {"role": "follower"}, 3: {"role": "leader"}}, 3),
    ({"role": "follower", "leader_hint": 3},
     {2: {"role": "leader"}, 3: None}, 2),
    ({"role": "follower"}, {2: {"role": "follower", "leader_hint": 3},
                            3: {"role": "leader"}}, 3),
    ({"role": "follower"}, {2: None, 3: None}, None),
])
def test_location_cache_finds_the_same_leader(local, peer_states, want):
    got = []
    for Loc in (JLoc, TLoc):
        peers = {p: _FakePeer(s) for p, s in peer_states.items()}
        loc = Loc(1, peers, lambda: dict(local), ttl_s=60.0)
        first = loc.home_of("t")
        # cached until invalidated, even when the peers change
        for p in peers.values():
            p.state = None
        again = loc.home_of("t")
        loc.invalidate("t")
        after = loc.home_of("t")
        got.append((first, again, after))
    assert got[0] == got[1]
    assert got[1][0] == want


def test_gv_cluster_health_rows_on_a_node(tmp_path):
    """A node's detector reaches gv$cluster_health through SQL (an
    in-process node on the CPU whose peers never answer)."""
    from oceanbase_tpu_torch.bench.cluster import free_ports
    from oceanbase_tpu_torch.net.node import NodeServer

    p1, p2, p3 = free_ports(3)
    node = NodeServer(1, "127.0.0.1", p1, {2: ("127.0.0.1", p2),
                                           3: ("127.0.0.1", p3)},
                      root=str(tmp_path / "n1"), device="cpu")
    node.server.start()  # its rpc server only: no heartbeat, no loops
    try:
        for _ in range(4):
            node.health.record_failure(3)
        node.health.record_success(2, 0.002)
        s = node._session(0)
        r = s.execute("select peer, state, failures, successes from "
                      "gv$cluster_health order by peer").rows()
        assert r == [(2, "up", 0, 1), (3, "down", 4, 0)]
        assert node._h_health()["peers"][1]["state"] == "down"
    finally:
        node.stop()
