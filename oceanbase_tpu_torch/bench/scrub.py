"""The data-integrity plane's standing contract on a 3-node cluster.

Port of ``scripts/scrub_bench.py`` (its constants, record fields and
gates, each cited by line), over any package's node processes
(``bench/cluster.py``), where the reference runs three in-process
``NodeServer``s:

  overhead  the slice's q6 and q1 on node 1 (the leader) in 8 blocks of
            alternating order with ``enable_scrub`` off and on on every
            node at ``scrub_interval_s = 2.0``, so rounds re-reading
            every segment and trading cross-replica digests overlap the
            timed queries (:196-227); the contract is ``overhead_pct <=
            2.0``;
  repair    a seeded bit flip in node 3's ``lineitem`` segment (the
            first seed of 1..63 whose probe copy ``Segment.load``
            refuses), then one ``scrub.run`` there must find it corrupt,
            repair ``lineitem`` alone from a peer and fail nothing; the
            repair's bytes and peer come from gv$scrub, the victim's
            weak q6 and q1 must equal an independent SQLite oracle, and
            every mended file must load clean (:229-272).  The
            periodic rounds stop for the flip and that round (the
            reference leaves them on; in node processes under load the
            loop's round held the verb's off or could mend the flip
            first), and start again after it.

Knobs go through the ``config.set`` verb, each node's checkpoint through
``rebuild.fetch_meta`` (a follower has no segment before one), rounds
through ``scrub.run``.  ``run`` returns the reference's line;
``failures`` names each broken gate.
"""

from __future__ import annotations

import sqlite3
import time

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.bench.cluster import (flip_segment, lead_from,
                                                wait_for)
from oceanbase_tpu_torch.bench.cluster import rows as rows_of
from oceanbase_tpu_torch.server import metrics as port_metrics

ROWS = 20_000           # ``scrub_bench.py:163`` (BENCH_ROWS)
REPEATS = 32            # ``scrub_bench.py:164`` (BENCH_REPEATS)
INTERVAL_S = 2.0        # ``scrub_bench.py:202``
BLOCKS = 8              # ``scrub_bench.py:204``
WARM = 3                # ``scrub_bench.py:196``
VICTIM = 3              # ``scrub_bench.py:234``
BOUND = 0.02            # ``scrub_bench.py:227``
QUERY_S = 60.0
STATE_S = 120.0         # a checkpoint, a knob, a scrape
COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate",
           "l_returnflag", "l_linestatus")


def _r9(rows: list) -> list:
    """Rows with floats rounded to 9 places (``scrub_bench.py:75-90``)."""
    return [tuple(round(x, 9) if isinstance(x, float) else x for x in r)
            for r in rows]


def sqlite_oracle(n_rows: int) -> dict:
    """The independent truth: the slice's ``n_rows`` rows and its q6 and
    q1 through SQLite (``scrub_bench.py:93-112``)."""
    cols = planes.gen(n_rows)
    conn = sqlite3.connect(":memory:")
    conn.execute(planes.CREATE_SQL.replace("l_id int primary key",
                                           "l_id integer primary key"))
    conn.executemany(
        "insert into lineitem values (?,?,?,?,?,?,?)",
        [(i,) + tuple(int(cols[c][i]) for c in COLUMNS)
         for i in range(n_rows)])
    out = {name: _r9(conn.execute(q).fetchall())
           for name, q in planes.QUERIES.items()}
    conn.close()
    return out


def checkpoint(c) -> None:
    """Every node's checkpoint, through the verb a rebuilding peer calls
    first (the reference's ``n.tenant.checkpoint()``, :189-190)."""
    for i in sorted(c.clients):
        c.clients[i].call("rebuild.fetch_meta", _deadline_s=STATE_S)


def set_all(c, name: str, value) -> None:
    for i in sorted(c.clients):
        c.clients[i].call("config.set", name=name, value=value,
                          _deadline_s=STATE_S)


def time_queries(c, node: int, repeats: int) -> float:
    """Seconds for ``repeats`` passes of q6 and q1 on ``node``
    (``scrub_bench.py:154-159``)."""
    t0 = time.monotonic()
    for _ in range(repeats):
        for q in planes.QUERIES.values():
            c.execute(node, q, deadline_s=QUERY_S)
    return time.monotonic() - t0


def overhead(c, repeats: int = REPEATS, node: int = 1) -> dict:
    """The overhead half on ``c``, its slice checkpointed on every node
    -> the reference's record."""
    set_all(c, "scrub_interval_s", INTERVAL_S)
    off_s = on_s = 0.0
    per_block = max(repeats // BLOCKS, 1)
    for b in range(BLOCKS):
        for mode in ((False, True) if b % 2 == 0 else (True, False)):
            set_all(c, "enable_scrub", mode)
            dt = time_queries(c, node, per_block)
            if mode:
                on_s += dt
            else:
                off_s += dt
    set_all(c, "enable_scrub", True)
    rounds = rows_of(c.execute(node, "select count(*) from gv$scrub"
                                  " where phase = 'verify'",
                            deadline_s=QUERY_S))[0][0]
    pct = (on_s - off_s) / off_s if off_s else 0.0
    return {"off_s": round(off_s, 3), "on_s": round(on_s, 3),
            "overhead_pct": round(pct * 100, 2),
            "scrub_rounds_leader": int(rounds),
            "queries": per_block * BLOCKS * 2 * len(planes.QUERIES),
            "pass": pct <= BOUND}


def repair(c, oracle: dict, victim: int = VICTIM) -> dict:
    """The repair half on ``c``: node ``victim``'s first ``lineitem``
    segment rotted and mended by one ``scrub.run`` -> the reference's
    record, with whether every mended file loads clean beside it."""
    from oceanbase_tpu_torch.storage.integrity import CorruptionError
    from oceanbase_tpu_torch.storage.segment import Segment

    segs = c.segments(victim, "lineitem")
    if not segs:
        raise AssertionError(f"node {victim} holds no lineitem segment "
                             "after its checkpoint")
    # the periodic rounds stop and the victim's round in flight ends
    # before the flip: a round of the loop would otherwise hold the
    # verb's round off ("skipped") or mend the flip before it
    set_all(c, "enable_scrub", False)
    wait_for(lambda: "skipped" not in c.clients[victim].call(
        "scrub.run", _deadline_s=STATE_S), STATE_S,
        f"node {victim}'s periodic scrub round to end")
    seed = flip_segment(segs[0])
    t0 = time.monotonic()
    s = c.clients[victim].call("scrub.run", _deadline_s=STATE_S)
    repair_s = time.monotonic() - t0
    set_all(c, "enable_scrub", True)

    def weak(sql):
        res = c.execute(victim, sql, consistency="weak", deadline_s=QUERY_S)
        if res.get("node") != victim:
            raise AssertionError(f"a weak read on node {victim} ran on "
                                 f"{res.get('node')}")
        return rows_of(res)

    repairs = weak("select bytes, peer from gv$scrub"
                   " where phase = 'repair'")
    served = {name: _r9(weak(q)) for name, q in planes.QUERIES.items()}
    clean = True
    for p in c.segments(victim, "lineitem"):
        try:
            Segment.load(p)
        except CorruptionError:
            clean = False
    oracle_match = served == oracle
    return {"seed": seed, "detected": bool(s["corrupt"]),
            "repaired": s["repaired"], "failed": s["failed"],
            "round_trip_s": round(repair_s, 3),
            "repair_bytes": sum(int(b) for b, _p in repairs),
            "repair_peer": int(repairs[-1][1]) if repairs else -1,
            "oracle_match": oracle_match, "mended_clean": clean,
            "pass": bool(s["corrupt"] and s["repaired"] == ["lineitem"]
                         and not s["failed"] and oracle_match and clean)}


def run(c, n_rows: int = ROWS, repeats: int = REPEATS, load_s=None,
        node: int = 1, victim: int = VICTIM) -> dict:
    """The reference's line on ``c`` (a ``ClusterClient`` whose
    ``lineitem`` holds ``n_rows`` rows of the slice, loaded in
    ``load_s``): every node checkpointed, the leader's answers held to
    SQLite and warmed, then the overhead and repair halves, and the
    merged scrape's ``scrub.*`` series."""
    oracle = sqlite_oracle(n_rows)
    lead_from(c, node)
    checkpoint(c)
    before = {name: _r9(rows_of(c.execute(node, q, deadline_s=QUERY_S)))
              for name, q in planes.QUERIES.items()}
    time_queries(c, node, WARM)
    out = {"metric": "scrub_bench", "rows": n_rows, "load_s": load_s,
           "oracle_match_before": before == oracle}
    out["overhead"] = overhead(c, repeats, node)
    out["repair"] = repair(c, oracle, victim)
    out["pass"] = bool(out["oracle_match_before"]
                       and out["overhead"]["pass"]
                       and out["repair"]["pass"])
    merged: dict = {"counters": [], "gauges": [], "hists": []}
    for i in sorted(c.clients):
        merged = port_metrics.merge_wire(merged, c.clients[i].call(
            "metrics.scrape", _deadline_s=STATE_S)["wire"])
    out["sysstat"] = {k: v for k, v in
                      sorted(port_metrics.wire_to_flat(merged).items())
                      if k.startswith("scrub.")}
    return out


def failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the line ``rec`` breaks, by name; with ``timing`` False
    the 2% overhead bound is left to the caller to report."""
    bad = []
    if not rec.get("oracle_match_before"):
        bad.append("oracle_match_before: the leader's answers differ "
                   "from SQLite")
    r = rec.get("repair", {})
    if not r.get("detected"):
        bad.append("detected: the round found no corrupt segment")
    if r.get("repaired") != ["lineitem"] or r.get("failed"):
        bad.append(f"repaired {r.get('repaired')}, failed "
                   f"{r.get('failed')}")
    if not r.get("oracle_match"):
        bad.append("oracle_match: the mended replica's answers differ "
                   "from SQLite")
    if not r.get("mended_clean", True):
        bad.append("mended_clean: a mended file fails its checksums")
    o = rec.get("overhead", {})
    if timing and not o.get("pass"):
        bad.append(f"overhead_pct {o.get('overhead_pct')} > {BOUND * 100}")
    return bad
