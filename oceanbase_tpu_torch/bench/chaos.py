"""The reference's nemesis schedule over a cluster of node processes.

Port of ``scripts/chaos_bench.py``'s scenarios that ``chip_smoke.py``'s
phase "cluster" does not already run (it runs the 30% ``dtl.execute``
drop, a node killed mid-query and a wiped node's rebuild):

  partition_leader      the PALF leader cut from one follower, ``send``
                        and ``recv`` on both sides; queries through the
                        third node; the leader's detector view; healed.
  nodekill_restart      a committed marker row and a prepared XA branch
                        staged, a follower SIGKILLed and restarted: the
                        marker reads from it, the branch is recoverable
                        there and commits.
  bitflip_scrub_repair  a follower's segment rotted and repaired live by
                        one ``scrub.run``; then a complete WAL entry and
                        the manifest rotted while it is down, repaired
                        at restart (crc64 truncation, digest quarantine,
                        full WAL replay and catch-up); its answers equal
                        the numpy oracle.
  overload_shed         12 clients, each with its own session, over 2
                        admission slots while a follower is SIGKILLed:
                        typed errors only, every admitted answer equal
                        to the oracle.
  disk_full_readonly    the leader's log budget set out of reach:
                        read-only with oracle-equal weak reads,
                        ``disk.takeover`` to a peer, auto-exit when the
                        budget lifts; then an ENOSPC-failed WAL append,
                        a SIGKILL and a clean restart.

Each scenario takes a running ``NodeCluster`` and a ``Workload`` (the
loaded lineitem rows, TPC-H Q6 and Q1, and their numpy answers), finds
the leader and followers from ``node.state``, retries statements over
``NotLeader``/``NoQuorum`` through ``ClusterClient.execute``, waits
through ``bench/cluster.py``'s waits (``wait_for``) under deadlines that
name what they await, and returns the reference's record: ``parity``, ``p99_s``,
``queries``, ``hung`` and its own fields.  Each one leaves every node up
and converged (the reference leaves overload_shed's victim down until
the next scenario restarts it).  ``run`` drives the five in order;
``failures`` lists where a record breaks the reference's invariants.
The module speaks rpc only, so it drives the reference's node processes
(``NodeCluster(module="oceanbase_tpu.net.node")``) as it drives the
port's.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from oceanbase_tpu_torch.bench.cluster import (
    flip_segment,
    flip_wal_entry,
    rows,
)
from oceanbase_tpu_torch.net.faults import bitflip_file

#: per-statement wall bound (``chaos_bench.py:86``): a statement slower
#: than this rode a hung socket instead of failing fast
QUERY_DEADLINE_S = 60.0
#: each wait for a node, a detector or a count
WAIT_S = 120.0
#: marker rows: an l_shipdate outside Q1's and Q6's windows, so the
#: numpy answers of the loaded rows stay the answers
MARK_SHIPDATE = "1998-11-30"
XA_SESSION = 4242
MANIFEST_FLIP_SEED = 5           # chaos_bench.py:590
STORM_CLIENTS = 12
STORM_ROUNDS = 3
STORM_KILL_AFTER_S = 0.3
#: the storm's admission knobs (``chaos_bench.py:633-637``) and the
#: values restored after it (the defaults of ``server/config.py``)
SHED_KNOBS = (("admission_slots", 2), ("admission_tenant_slots", 2),
              ("admission_queue_limit", 2),
              ("admission_queue_timeout_s", 1.0))
RESTORED_KNOBS = (("admission_slots", 32), ("admission_tenant_slots", 16),
                  ("admission_queue_limit", 64),
                  ("admission_queue_timeout_s", 10.0))
#: typed failures a storm client may see (``chaos_bench.py:638-646``)
SHED_OK_KINDS = frozenset({
    "ServerBusy", "QueryTimeout", "QueryKilled", "MemstoreFull",
    "NotLeader", "NoQuorum", "DeadlineExceeded", "ConnPoolExhausted",
    "DtlLagging", "ConnectionError", "ConnectionResetError",
    "BrokenPipeError", "TimeoutError"})
#: typed failures a write probe at a read-only leader may see
DISK_OK_KINDS = frozenset({"TenantReadOnly", "NotLeader", "NoQuorum",
                           "DeadlineExceeded", "ConnectionError",
                           "TimeoutError"})
#: a log budget below the WAL's floor after a recycle: the reclaim
#: round runs but cannot meet it, so the tenant degrades
UNREACHABLE_LOG_BYTES = 16
SCENARIOS = ("partition_leader", "nodekill_restart", "bitflip_scrub_repair",
             "overload_shed", "disk_full_readonly")


class Workload:
    """The loaded ``lineitem`` rows (generated TPC-H columns),
    Q6 and Q1 over them and their numpy answers, and marker rows."""

    def __init__(self, arrays: dict, types: dict):
        from oceanbase_tpu_torch.bench.oracle_np import numpy_q1, numpy_q6
        from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
        from oceanbase_tpu_torch.datatypes import date_to_days

        self.arrays, self.types = arrays, types
        self.sql = {"q6": QUERIES[6], "q1": QUERIES[1]}
        self.want = {"q6": numpy_q6(arrays), "q1": numpy_q1(arrays)}
        self._mark = {c: a[:1].copy() for c, a in arrays.items()}
        self._mark["l_shipdate"][0] = date_to_days(MARK_SHIPDATE)
        # above the markers phase cluster commits (max + 1, max + 2)
        self._keys = itertools.count(int(arrays["l_orderkey"].max()) + 1001)

    def matches(self, name: str, res: dict) -> bool:
        """A ``sql.execute`` reply equals the numpy answer (Q1's
        averages at 1e-12 relative)."""
        want = self.want[name]
        if name == "q6":
            return int(np.asarray(res["arrays"][res["names"][0]])[0]) == want
        if list(res["names"]) != list(want):
            return False
        for k, v in want.items():
            got = np.asarray(res["arrays"][k])
            if len(got) != len(v):
                return False
            if v.dtype.kind == "f":
                if not np.allclose(got.astype(np.float64), v, rtol=1e-12,
                                   atol=0.0):
                    return False
            elif [str(x) for x in got.tolist()] != \
                    [str(x) for x in v.tolist()]:
                return False
        return True

    def new_key(self) -> int:
        return next(self._keys)

    def marker_sql(self, key: int) -> str:
        from oceanbase_tpu_torch.bench.tbl import values_row

        m = {c: a.copy() for c, a in self._mark.items()}
        m["l_orderkey"][0] = key
        return f"insert into lineitem values {values_row(m, self.types, 0)}"

    def key_count_sql(self, key: int) -> str:
        return f"select count(*) from lineitem where l_orderkey = {key}"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def p99(lat) -> float:
    return float(np.percentile(np.asarray(lat), 99)) if lat else 0.0


def run_queries(w: Workload, execute, repeats: int):
    """``repeats`` rounds of Q6 then Q1 through ``execute(sql)`` ->
    (parity, latencies, hung)."""
    lat, parity, hung = [], True, 0
    for _ in range(repeats):
        for name in ("q6", "q1"):
            t0 = time.monotonic()
            res = execute(w.sql[name])
            dt = time.monotonic() - t0
            lat.append(dt)
            hung += dt > QUERY_DEADLINE_S
            parity = parity and w.matches(name, res)
    return parity, lat, hung


def roles(c) -> tuple[int, list[int]]:
    ldr = c.leader(WAIT_S)
    return ldr, sorted(i for i in c.clients if i != ldr)


def weak(c, i: int, sql: str) -> dict:
    res = c.execute(i, sql, consistency="weak", deadline_s=QUERY_DEADLINE_S)
    if res.get("node") != i:
        raise AssertionError(f"a weak read on node {i} ran on "
                             f"{res.get('node')}")
    return res


def total_rows(c) -> int:
    res = c.execute(c.leader(WAIT_S), "select count(*) from lineitem",
                    deadline_s=QUERY_DEADLINE_S)
    return int(rows(res)[0][0])


class Laps(dict):
    """Seconds of a scenario's parts, each since the previous lap."""

    def __init__(self):
        super().__init__()
        self._t = time.monotonic()

    def lap(self, name: str):
        now = time.monotonic()
        self[name] = self.get(name, 0.0) + now - self._t
        self._t = now


def rejoin(c, i: int, n: int, laps: Laps) -> float:
    """Restart killed node ``i``; wait for its ping (lap ``ping``), the
    other nodes' detector to see it up and its weak count to read ``n``
    (lap ``catch_up``) -> seconds in all."""
    t0 = time.monotonic()
    c.restart(i, WAIT_S)
    laps.lap("ping")
    watch = min(j for j in c.clients if j != i)
    c.wait_detector(watch, i, ("up",), WAIT_S)
    c.wait_count("lineitem", n, nodes=(i,), deadline_s=WAIT_S)
    laps.lap("catch_up")
    return time.monotonic() - t0


def counter_sum(c, i: int, prefix: str) -> int:
    """Node ``i``'s counters whose name starts with ``prefix``, summed
    over their label sets."""
    wire = c.clients[i].call("metrics.scrape")["wire"]
    return int(sum(v for name, _labels, v in wire["counters"]
                   if name.startswith(prefix)))


def prepare(c):
    """Arm the fault verbs on every node (node-scoped ``config.set``:
    ALTER SYSTEM would reach the leader only) and check that every node
    holds the loaded rows."""
    for i in c.clients:
        c.clients[i].call("config.set", name="enable_fault_injection",
                          value=True)
    n = total_rows(c)
    c.wait_count("lineitem", n, nodes=sorted(c.clients), deadline_s=WAIT_S)
    return n


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------

def partition_leader(c, w: Workload) -> dict:
    """The leader and one follower drop each other's frames, sent and
    received; Q6 and Q1 through the third node."""
    laps = Laps()
    ldr, (cut, via) = roles(c)
    for a, b in ((ldr, cut), (cut, ldr)):
        for where in ("send", "recv"):
            c.clients[a].call("fault.inject", where=where, action="drop",
                              peer=b)
    try:
        # down, not only suspect (the reference's record shows down): a
        # partition that outlasts the detector's threshold, so the cut
        # node may campaign and the queries follow whoever leads
        seen = c.wait_detector(ldr, cut, ("down",), WAIT_S)
        laps.lap("detect")
        parity, lat, hung = run_queries(
            w, lambda q: c.execute(via, q, deadline_s=QUERY_DEADLINE_S), 3)
        laps.lap("queries")
        view = c.health(ldr)
    finally:
        for a in (ldr, cut):
            c.clients[a].call("fault.clear")
    c.wait_detector(ldr, cut, ("up",), WAIT_S)
    c.wait_detector(cut, ldr, ("up",), WAIT_S)
    after = c.leader(WAIT_S)
    laps.lap("heal")
    return {"parity": parity, "p99_s": p99(lat), "queries": len(lat),
            "hung": hung, "leader": ldr, "cut": cut, "via": via,
            "detector_saw": seen,
            "leader_view": {str(p): s for p, s in sorted(view.items())},
            "leader_after": after, "split_s": laps}


def nodekill_restart(c, w: Workload) -> dict:
    """A committed marker and a prepared XA branch, then a follower's
    SIGKILL and restart: WAL replay, catch-up, rejoin, durable XA."""
    laps = Laps()
    n0 = total_rows(c)
    ldr, followers = roles(c)
    victim = followers[-1]
    marker_k, xa_k = w.new_key(), w.new_key()
    xid = f"chaos{marker_k}"
    c.execute(ldr, w.marker_sql(marker_k), deadline_s=QUERY_DEADLINE_S)
    for sql in (f"xa start '{xid}'", w.marker_sql(xa_k), f"xa end '{xid}'",
                f"xa prepare '{xid}'"):
        c.execute(ldr, sql, session_id=XA_SESSION,
                  deadline_s=QUERY_DEADLINE_S)
    # the victim holds the prepare record in its own WAL before it dies
    c.wait_caught_up(nodes=(victim,), deadline_s=WAIT_S)
    laps.lap("stage")
    c.kill(victim)
    # only the marker is committed: the branch's redo stays invisible
    restart_s = rejoin(c, victim, n0 + 1, laps)
    marker_ok = rows(weak(c, victim, w.key_count_sql(marker_k))) == [(1,)]
    rec = c.clients[victim].call("recovery.state")
    xa_recoverable = xid in rec.get("prepared_xids", [])
    c.execute(c.leader(WAIT_S), f"xa commit '{xid}'", session_id=XA_SESSION,
              deadline_s=QUERY_DEADLINE_S)
    c.wait_count("lineitem", n0 + 2, nodes=sorted(c.clients),
                 deadline_s=WAIT_S)
    xa_row = rows(weak(c, victim, w.key_count_sql(xa_k))) == [(1,)]
    laps.lap("xa")
    ldr = c.leader(WAIT_S)
    parity, lat, hung = run_queries(
        w, lambda q: c.execute(ldr, q, deadline_s=QUERY_DEADLINE_S), 3)
    laps.lap("queries")
    ex = c.last_exchange(ldr) or {}
    return {"parity": bool(parity and marker_ok and xa_recoverable
                           and xa_row),
            "p99_s": p99(lat), "queries": len(lat), "hung": hung,
            "victim": victim, "restart_s": restart_s,
            "detector_state": c.health(ldr).get(victim),
            "marker_on_restarted_node": marker_ok,
            "xa_recoverable": xa_recoverable, "xa_committed_row": xa_row,
            "avoided_parts": ex.get("avoided"),
            "fallback_parts": ex.get("fallback"),
            "boot_phases": sorted({e["phase"]
                                   for e in rec.get("events", [])}),
            "split_s": laps}


def bitflip_scrub_repair(c, w: Workload) -> dict:
    """Seeded rot of a follower's segment (one scrub round repairs it
    from a peer, live), then of a complete WAL entry and the manifest
    while it is down (its restart repairs them)."""
    from oceanbase_tpu_torch.storage.segment import Segment

    laps = Laps()
    n0 = total_rows(c)
    _ldr, followers = roles(c)
    victim = followers[-1]
    t0 = time.monotonic()
    # the victim's own checkpoint, through the verb a rebuilding peer
    # calls (it checkpoints first): segments and a manifest to rot
    c.clients[victim].call("rebuild.fetch_meta")
    laps.lap("checkpoint")
    segs = c.segments(victim, "lineitem")
    if not segs:
        raise AssertionError(f"node {victim} holds no lineitem segment "
                             "after its checkpoint")
    seed = flip_segment(segs[0])
    sres = c.clients[victim].call("scrub.run")
    laps.lap("scrub")
    seg_ok = bool(sres.get("corrupt")) and \
        "lineitem" in sres.get("repaired", []) and not sres.get("failed")
    gv = rows(weak(c, victim, "select phase, bytes, peer from gv$scrub "
                              "where phase = 'repair'"))
    seg_parity = all(w.matches(k, weak(c, victim, q))
                     for k, q in w.sql.items())
    for p in c.segments(victim, "lineitem"):
        Segment.load(p)  # mended files verify clean
    laps.lap("served")
    c.kill(victim)
    wal_lsn = flip_wal_entry(c.wal_path(victim))
    bitflip_file(c.manifest_path(victim), seed=MANIFEST_FLIP_SEED)
    laps.lap("rot")
    rejoin(c, victim, n0, laps)
    round_trip_s = time.monotonic() - t0
    rec = c.clients[victim].call("recovery.state")
    quar = [e for e in rec.get("events", []) if e["phase"] == "quarantine"]
    kinds = {"segment"} if seg_ok else set()
    for e in quar:
        kinds.add("wal" if "wal" in e.get("note", "") else "manifest")
    oracle_match = all(w.matches(k, weak(c, victim, q))
                       for k, q in w.sql.items())
    ldr = c.leader(WAIT_S)
    parity, lat, hung = run_queries(
        w, lambda q: c.execute(ldr, q, deadline_s=QUERY_DEADLINE_S), 3)
    laps.lap("queries")
    return {"parity": bool(seg_ok and seg_parity and parity and oracle_match
                           and kinds >= {"segment", "wal", "manifest"}),
            "p99_s": p99(lat), "queries": len(lat) + 4, "hung": hung,
            "victim": victim, "round_trip_s": round_trip_s,
            "segment_seed": seed, "wal_entry_lsn": wal_lsn,
            "kinds_detected": sorted(kinds), "scrub_repairs": len(gv),
            "scrub_repair_bytes": sum(int(b) for _p, b, _pe in gv),
            "scrub_repair_peer": int(gv[0][2]) if gv else -1,
            "oracle_match": oracle_match, "quarantine_events": len(quar),
            "split_s": laps}


def overload_shed(c, w: Workload) -> dict:
    """A statement storm over two admission slots on the leader while a
    follower dies mid-storm."""
    laps = Laps()
    n0 = total_rows(c)
    ldr, followers = roles(c)
    # the other follower than the rot scenario's victim: that one's
    # manifest quarantine reset its replay point to the log's start,
    # until its next checkpoint round
    victim = followers[0]
    for knob, val in SHED_KNOBS:
        c.execute(ldr, f"alter system set {knob} = {val}",
                  deadline_s=QUERY_DEADLINE_S)
    names = ["q6" if k % 2 == 0 else "q1" for k in range(STORM_CLIENTS)]
    join = c.storm(ldr, [w.sql[nm] for nm in names], STORM_ROUNDS,
                   deadline_s=2 * QUERY_DEADLINE_S)
    time.sleep(STORM_KILL_AFTER_S)  # the storm is in flight: kill
    c.kill(victim)
    results, alive = join()
    laps.lap("storm")
    hung = sum(dt > QUERY_DEADLINE_S for *_x, dt in results) + alive
    kinds: dict = {}
    for _k, kind, _r, _dt in results:
        kinds[kind] = kinds.get(kind, 0) + 1
    untyped = {k: v for k, v in kinds.items()
               if k != "ok" and k not in SHED_OK_KINDS}
    mismatches = sum(1 for k, kind, res, _dt in results
                     if kind == "ok" and not w.matches(names[k], res))
    admitted = kinds.get("ok", 0)
    ldr = c.leader(WAIT_S)
    for knob, val in RESTORED_KNOBS:
        c.execute(ldr, f"alter system set {knob} = {val}",
                  deadline_s=QUERY_DEADLINE_S)
    tr = rows(c.execute(ldr, "select tenant, admitted, rejected, queued "
                             "from gv$tenant_resource",
                        deadline_s=QUERY_DEADLINE_S))
    laps.lap("knobs")
    restart_s = rejoin(c, victim, n0, laps)
    return {"parity": bool(not mismatches and hung == 0 and not untyped
                           and admitted > 0),
            "p99_s": p99([r[-1] for r in results]),
            "queries": len(results), "hung": hung, "victim": victim,
            "admitted": admitted, "kinds": dict(sorted(kinds.items())),
            "untyped_errors": untyped,
            "admitted_oracle_parity": not mismatches,
            "parity_mismatches": mismatches,
            "tenant_resource": [list(r) for r in tr],
            "restart_s": restart_s, "split_s": laps}


def disk_full_readonly(c, w: Workload) -> dict:
    """The leader's log budget out of reach: read-only, takeover by a
    peer, auto-exit; then an ENOSPC-failed WAL append, a SIGKILL and a
    clean restart on the new leader."""
    t0 = time.monotonic()
    laps = Laps()
    n0 = total_rows(c)
    lead = c.leader(WAIT_S)

    def disk_state(i):
        r = rows(weak(c, i, "select surface, state from gv$disk "
                            "where surface = 'log'"))
        return r[0][1] if r else ""

    st = c.clients[lead].call("config.set", name="log_disk_limit_bytes",
                              value=UNREACHABLE_LOG_BYTES)
    entered_ro = bool(st.get("read_only"))
    ro_state = disk_state(lead)
    laps.lap("read_only")
    ro_parity = all(w.matches(k, weak(c, lead, q)) for k, q in w.sql.items())
    laps.lap("read_only_reads")
    # write probes at the degraded node: typed refusals until a peer
    # with headroom leads, then they land through forwarding
    probe_kinds: dict = {}
    probe_hung = landed = new_lead = 0
    end = time.monotonic() + QUERY_DEADLINE_S
    while time.monotonic() < end:
        t1 = time.monotonic()
        kind = "ok"
        try:
            c.clients[lead].call("sql.execute",
                                 sql=w.marker_sql(w.new_key()))
        except Exception as e:  # noqa: BLE001 — the probe's outcome
            kind = getattr(e, "kind", type(e).__name__)
        probe_hung += time.monotonic() - t1 > QUERY_DEADLINE_S
        probe_kinds[kind] = probe_kinds.get(kind, 0) + 1
        if kind == "ok":
            landed += 1
            new_lead = c.leader(WAIT_S)
            if new_lead != lead:
                break
        time.sleep(0.1)
    untyped = {k: v for k, v in probe_kinds.items()
               if k != "ok" and k not in DISK_OK_KINDS}
    laps.lap("takeover")
    took_over = bool(new_lead and new_lead != lead)
    headroom = took_over and disk_state(new_lead) == "ok"
    st2 = c.clients[lead].call("config.set", name="log_disk_limit_bytes",
                               value=0)
    auto_exit = not st2.get("read_only") and disk_state(lead) == "ok"
    reclaims = counter_sum(c, lead, "disk.reclaims")
    ro_exits = counter_sum(c, lead, "disk.readonly_exits")
    laps.lap("exit")

    # an ENOSPC-failed WAL append on the (new) leader, then SIGKILL
    m = new_lead if took_over else lead
    c.clients[m].call("config.set", name="enable_disk_faults", value=True)
    c.clients[m].call("fault.inject", where="disk", action="enospc",
                      verb="wal", count=1)
    pre = int(rows(weak(c, m, "select count(*) from lineitem"))[0][0])
    enospc_kind = "ok"
    try:
        c.clients[m].call("sql.execute", sql=w.marker_sql(w.new_key()))
    except Exception as e:  # noqa: BLE001 — the append's outcome
        enospc_kind = getattr(e, "kind", type(e).__name__)
    post = int(rows(weak(c, m, "select count(*) from lineitem"))[0][0])
    count_held = post == pre
    laps.lap("enospc")
    c.kill(m)
    # the leader died: as the reference's schedule does, a write through
    # a survivor resumes writes before the restarted node's catch-up is
    # awaited (a write is what elects a leader in the reference when its
    # election left none, ROADMAP Queue 3 #31)
    t1 = time.monotonic()
    c.restart(m, WAIT_S)
    laps.lap("ping")
    watch = min(j for j in c.clients if j != m)
    c.wait_detector(watch, m, ("up",), WAIT_S)
    c.execute(watch, w.marker_sql(w.new_key()), deadline_s=QUERY_DEADLINE_S)
    cnt = total_rows(c)
    c.wait_count("lineitem", cnt, nodes=sorted(c.clients), deadline_s=WAIT_S)
    laps.lap("catch_up")
    restart_s = time.monotonic() - t1
    c.clients[m].call("config.set", name="enable_disk_faults", value=False)
    served_m = w.matches("q6", weak(c, m, w.sql["q6"]))
    laps.lap("resume")
    ldr = c.leader(WAIT_S)
    parity, lat, hung = run_queries(
        w, lambda q: c.execute(ldr, q, deadline_s=QUERY_DEADLINE_S), 3)
    laps.lap("queries")
    return {"parity": bool(entered_ro and ro_state == "readonly"
                           and ro_parity and not untyped and landed > 0
                           and took_over and headroom and auto_exit
                           and reclaims >= 1 and ro_exits >= 1
                           and enospc_kind == "DiskFull" and count_held
                           and served_m and parity and probe_hung == 0),
            "p99_s": p99(lat),
            "queries": len(lat) + sum(probe_kinds.values()) + 3,
            "hung": hung + probe_hung, "rows_before": n0,
            "old_leader": lead, "new_leader": new_lead,
            "entered_readonly": entered_ro, "readonly_state": ro_state,
            "readonly_reads_parity": ro_parity,
            "probe_kinds": dict(sorted(probe_kinds.items())),
            "untyped_errors": untyped, "writes_landed_via_peer": landed,
            "takeover": took_over, "peer_headroom": headroom,
            "auto_exit": auto_exit, "reclaims": reclaims,
            "readonly_exits": ro_exits, "enospc_kind": enospc_kind,
            "count_held": count_held, "enospc_node": m,
            "restart_s": restart_s, "served_by_restarted_node": served_m,
            "round_trip_s": time.monotonic() - t0, "split_s": laps}


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def failures(name: str, rec: dict) -> list[str]:
    """Where ``rec`` breaks the reference's invariants for ``name``."""
    bad = []
    if not rec.get("parity"):
        bad.append("parity")
    if rec.get("hung"):
        bad.append(f"hung {rec['hung']}")
    if name == "nodekill_restart":
        bad += [k for k in ("marker_on_restarted_node", "xa_recoverable",
                            "xa_committed_row") if not rec.get(k)]
    elif name == "bitflip_scrub_repair":
        if not set(rec.get("kinds_detected", [])) >= {"segment", "wal",
                                                      "manifest"}:
            bad.append(f"kinds_detected {rec.get('kinds_detected')}")
        if not rec.get("oracle_match"):
            bad.append("oracle_match")
    elif name == "overload_shed":
        if rec.get("untyped_errors"):
            bad.append(f"untyped_errors {rec['untyped_errors']}")
        if rec.get("admitted", 0) < 1:
            bad.append("admitted 0")
    elif name == "disk_full_readonly":
        bad += [k for k in ("entered_readonly", "takeover", "auto_exit",
                            "count_held", "served_by_restarted_node")
                if not rec.get(k)]
        if rec.get("untyped_errors"):
            bad.append(f"untyped_errors {rec['untyped_errors']}")
        if rec.get("enospc_kind") != "DiskFull":
            bad.append(f"enospc_kind {rec.get('enospc_kind')}")
    return bad


def run(c, w: Workload, log=print) -> dict:
    """Drive ``SCENARIOS`` in order; print a ``[chaos] step`` line with
    each one's seconds and a ``[chaos] <scenario>`` line with its
    record; raise ``AssertionError`` at the first record that breaks
    the reference's invariants -> {scenario: record}."""
    import json

    t0 = time.monotonic()
    n = prepare(c)
    log(f"[chaos] step prepare: {time.monotonic() - t0:.3f} s "
        f"({n} rows on every node, fault verbs armed)")
    out = {}
    for name in SCENARIOS:
        t0 = time.monotonic()
        rec = globals()[name](c, w)
        out[name] = rec
        log(f"[chaos] step {name}: {time.monotonic() - t0:.3f} s")
        log(f"[chaos] {name} {json.dumps(rec, default=str)}")
        bad = failures(name, rec)
        if bad:
            raise AssertionError(f"chaos scenario {name} failed: "
                                 f"{', '.join(bad)}")
    return out
