"""The disk plane's standing contract, on one in-process Database.

Port of ``scripts/disk_bench.py`` (its constants, record fields and
gates, each cited by line), over any package's ``Database``: the caller
passes a function that opens the database at a root, and the fault
plane's class, ``full_backup`` and the metrics module of the same package
(the port's by default).  Exceptions are triaged by class name, as
``except DiskFull`` would match them.

  overhead    a write workload timed in alternating blocks with the disk
              budgets off (all limits 0) and on (1 GiB), compared by
              medians: the contract is <= 2% (``disk_bench.py:78-100``);
  surfaces    one-shot seeded ENOSPC on wal, slog, segment, manifest,
              spill and backup, in that order, each through its real
              entry point: the failure is typed ``DiskFull`` and the
              retry succeeds (``disk_bench.py:103-174``); the spill
              trial's answer is held to numpy and it leaves no file;
  degrade     an unreachable log budget: the reclaim round, read-only,
              writes refused typed, reads served, and the tenant leaves
              read-only by itself when the budget is lifted
              (``disk_bench.py:177-219``);
  accounting  gv$disk's log and data bytes within 5% of ``du``
              (``disk_bench.py:244-258``);
  restart     ``count(*), sum(v)`` equal after a reopen
              (``disk_bench.py:260-267``).

The table is ``t (k int primary key, v int)`` with ``v = k % 997``,
direct-loaded (the reference INSERTs 1,000-row statements of the same
rows), with the reference's INSERT workload on top.
"""

from __future__ import annotations

import os
import shutil
import statistics
import time

import numpy as np

from oceanbase_tpu_torch.net.faults import FaultPlane
from oceanbase_tpu_torch.server import metrics as port_metrics
from oceanbase_tpu_torch.server.backup import full_backup as port_backup

V_MOD = 997                          # ``v = k % 997`` (disk_bench.py:236)
BLOCK_WRITES = 40                    # rows per timed INSERT (:60)
BLOCK_STATEMENTS = 4                 # INSERTs per timed block (:89)
OVERHEAD_BLOCKS = 24                 # off/on block pairs (:78)
OVERHEAD_LIMIT = 0.02                # the 2% contract (:100)
ON_LIMIT_BYTES = 1 << 30             # "on": 1 GiB budgets (:87)
SURFACES = ("wal", "slog", "segment", "manifest", "spill", "backup")
SURFACE_SEED = 1000                  # FaultPlane(seed=1000 + i) (:115)
#: the spill trial's sorted runs: the reference's 4,000 rows over a
#: 100-row work area (:161).  ``t`` is direct-loaded as this many
#: segments, the spill tier streams at least one granule per segment
#: whatever the granule's capacity (2^21 rows), and the work area of
#: rows / SPILL_RUNS holds one of them
SPILL_RUNS = 40
SPILL_QUERY = "select k, v from t order by v, k"
UNREACHABLE_LOG_BYTES = 10           # (:185)
READONLY_PROBE_KEY = 99999991        # (:191)
ACCOUNTING_PCT = 5.0                 # gv$disk against du (:218, :256)
LIMIT_KNOBS = ("log_disk_limit_bytes", "data_disk_limit_bytes",
               "spill_disk_limit_bytes")


def du(paths) -> int:
    """Bytes under ``paths`` by ``os.path.getsize``, as gv$disk counts
    them (``disk_bench.py:41-53``)."""
    total = 0
    for root in paths:
        if os.path.isfile(root):
            total += os.path.getsize(root)
            continue
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, f))
                except OSError:
                    pass
    return total


def _files(root: str) -> list:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, f), root)
                for f in files]
    return sorted(out)


def _is(exc, name: str) -> bool:
    return any(c.__name__ == name for c in type(exc).__mro__)


def count(s) -> tuple:
    return tuple(s.execute("select count(*), sum(v) from t").rows()[0])


def load(db, rows: int, segments: int = SPILL_RUNS) -> list:
    """``t`` with ``rows`` rows direct-loaded as ``segments`` segments
    -> the next free key."""
    k = np.arange(rows, dtype=np.int32)
    v = (k % V_MOD).astype(np.int32)
    cat = db.tenant("sys").catalog
    cuts = np.linspace(0, rows, segments + 1).astype(np.int64)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi > lo:
            cat.load_numpy("t", {"k": k[lo:hi], "v": v[lo:hi]},
                           primary_key=["k"])
    return [rows]


def workload_block(s, keys, n_writes: int = BLOCK_WRITES):
    """One INSERT of ``n_writes`` new rows through the admitted write
    path (``disk_bench.py:60-72``)."""
    base = keys[0]
    vals = ", ".join(f"({base + i}, {(base + i) % V_MOD})"
                     for i in range(n_writes))
    s.execute(f"insert into t values {vals}")
    keys[0] = base + n_writes


def set_limits(s, lim: int):
    for knob in LIMIT_KNOBS:
        s.execute(f"alter system set {knob} = {lim}")


def overhead(s, keys, blocks: int = OVERHEAD_BLOCKS) -> dict:
    """Alternating off/on blocks compared by their medians
    (``disk_bench.py:78-100``), with each side's spread."""
    off, on = [], []
    for b in range(blocks):
        order = (False, True) if b % 2 == 0 else (True, False)
        for mode in order:
            set_limits(s, ON_LIMIT_BYTES if mode else 0)
            t0 = time.monotonic()
            for _ in range(BLOCK_STATEMENTS):
                workload_block(s, keys)
            (on if mode else off).append(time.monotonic() - t0)
    set_limits(s, 0)
    med_off = statistics.median(off)
    med_on = statistics.median(on)
    over = (med_on - med_off) / med_off if med_off else 0.0
    return {"off_s": round(sum(off), 3), "on_s": round(sum(on), 3),
            "median_off_s": round(med_off, 4),
            "median_on_s": round(med_on, 4),
            "min_max_off_s": [round(min(off), 4), round(max(off), 4)],
            "min_max_on_s": [round(min(on), 4), round(max(on), 4)],
            "overhead_pct": round(over * 100, 2),
            "blocks": blocks,
            "pass": over <= OVERHEAD_LIMIT}


def expected_sorted(keys, lost=()) -> tuple[np.ndarray, np.ndarray]:
    """numpy's ``order by v, k`` over keys ``0 .. keys[0] - 1`` but the
    ``lost`` ones (INSERTs that failed)."""
    k = np.setdiff1d(np.arange(keys[0], dtype=np.int64),
                     np.asarray(lost, dtype=np.int64))
    v = k % V_MOD
    order = np.lexsort((k, v))
    return k[order], v[order]


def surfaces(db, s, keys, tmp: str, work_area_rows: int,
             fault_plane=FaultPlane, full_backup=port_backup) -> dict:
    """One-shot seeded ENOSPC per durable surface through its real entry
    point (``disk_bench.py:103-174``).  Each trial arms exactly one
    writer directly, as the reference does, with ``enable_disk_faults``
    set."""
    tenant = db.tenant("sys")
    local = tenant.wal.replicas[tenant.wal.leader_id]
    results = []
    lost = []
    db.config.set("enable_disk_faults", True)

    def trial(surface, arm, fire, recover, check=None):
        plane = fault_plane(seed=SURFACE_SEED + len(results))
        plane.disk("enospc", kind=surface)
        arm(plane)
        t0 = time.monotonic()
        typed = retried = False
        err = ""
        got = None
        try:
            fire()
        except Exception as exc:  # noqa: BLE001 — triaged by name
            if _is(exc, "DiskFull"):
                typed = True
            else:
                err = f"{type(exc).__name__}: {exc}"
        if typed:
            try:
                got = recover()
                retried = True
            except Exception as exc:  # noqa: BLE001 — the record says
                err = f"retry failed: {type(exc).__name__}: {exc}"
        arm(None)
        rec = {"surface": surface, "typed_error": typed,
               "recovered": retried, "error": err,
               "round_trip_s": round(time.monotonic() - t0, 3),
               "pass": typed and retried}
        if check is not None and retried:
            rec.update(check(got))
            rec["pass"] = rec["pass"] and rec["answer_ok"] \
                and not rec["residue"]
        results.append(rec)

    def ins():
        k = keys[0]
        keys[0] += 1
        try:
            s.execute(f"insert into t values ({k}, {k % V_MOD})")
        except Exception:
            lost.append(k)
            raise

    def arm_wal(p):
        local.faults = p

    def arm_engine(p):
        tenant.engine.faults = p

    def arm_db(p):
        db.faults = p

    def ddl():
        s.execute("create table slog_probe (k int primary key)")

    trial("wal", arm_wal, ins, ins)
    trial("slog", arm_engine, ddl, ddl)
    ins()  # memtable rows, so the next checkpoint flushes a segment
    trial("segment", arm_engine, db.checkpoint, db.checkpoint)
    trial("manifest", arm_engine, db.checkpoint, db.checkpoint)
    area = int(db.config["sql_work_area_rows"])
    s.execute(f"alter system set sql_work_area_rows = {work_area_rows}")
    spill_root = os.path.join(db.root, "tmpfile")

    def spill():
        return s.execute(SPILL_QUERY)

    def spill_check(res):
        want_k, want_v = expected_sorted(keys, lost)
        got_k = np.asarray(res.arrays[res.names[0]], dtype=np.int64)
        got_v = np.asarray(res.arrays[res.names[1]], dtype=np.int64)
        spilled = db.workarea_history[-1] if db.workarea_history else {}
        return {"answer_ok": bool(np.array_equal(got_k, want_k)
                                  and np.array_equal(got_v, want_v)),
                "rows": int(len(got_k)),
                "runs": int(spilled.get("runs", 0)),
                "residue": _files(spill_root)}

    trial("spill", arm_db, spill, spill, spill_check)
    s.execute(f"alter system set sql_work_area_rows = {area}")
    bdir = os.path.join(tmp, "backup")

    def backup():
        shutil.rmtree(bdir, ignore_errors=True)
        full_backup(db, bdir)

    trial("backup", arm_db, backup, backup)
    db.config.set("enable_disk_faults", False)
    shutil.rmtree(bdir, ignore_errors=True)
    return {"surfaces": results, "pass": all(r["pass"] for r in results)}


def degrade(db, s) -> dict:
    """Inject (an unreachable log budget), degrade (read-only, reads
    serve), recover (auto-exit) (``disk_bench.py:177-219``)."""
    dm = db.tenant("sys").diskmgr
    out = {}
    t0 = time.monotonic()
    s.execute(f"alter system set log_disk_limit_bytes = "
              f"{UNREACHABLE_LOG_BYTES}")
    dm.poll(force=True)
    out["reclaims"] = dm.reclaims
    out["entered_readonly"] = bool(dm.read_only)
    rejected = False
    try:
        s.execute(f"insert into t values ({READONLY_PROBE_KEY}, 1)")
    except Exception as exc:  # noqa: BLE001 — triaged by name
        rejected = _is(exc, "TenantReadOnly")
    out["write_rejected_typed"] = rejected
    pre = count(s)
    out["reads_serve_in_readonly"] = pre[0] > 0
    rows = s.execute("select surface, used_bytes, state from gv$disk"
                     " where surface = 'log'").rows()
    used = du(dm.paths["log"])
    out["gv_disk_state"] = rows[0][2] if rows else ""
    out["gv_vs_du_pct"] = round(
        abs(rows[0][1] - used) / max(1, used) * 100, 2) if rows else 100.0
    s.execute("alter system set log_disk_limit_bytes = 0")
    dm.poll(force=True)
    out["exited_readonly"] = not dm.read_only
    resumed = False
    try:
        s.execute(f"insert into t values ({READONLY_PROBE_KEY}, 1)")
        resumed = True
    except Exception:  # noqa: BLE001 — the record says
        pass
    out["writes_resume"] = resumed
    out["round_trip_s"] = round(time.monotonic() - t0, 3)
    out["pass"] = bool(
        out["entered_readonly"] and out["write_rejected_typed"]
        and out["reads_serve_in_readonly"] and out["exited_readonly"]
        and out["writes_resume"] and out["gv_disk_state"] == "readonly"
        and out["gv_vs_du_pct"] <= ACCOUNTING_PCT and out["reclaims"] >= 1)
    return out


def accounting(db, s) -> dict:
    """gv$disk against ``du`` for log and data, budgets armed
    (``disk_bench.py:244-258``)."""
    s.execute(f"alter system set log_disk_limit_bytes = {ON_LIMIT_BYTES}")
    s.execute(f"alter system set data_disk_limit_bytes = {ON_LIMIT_BYTES}")
    dm = db.tenant("sys").diskmgr
    by = {r[0]: r[1] for r in
          s.execute("select surface, used_bytes from gv$disk").rows()}
    acct = {}
    for surface in ("log", "data"):
        used = du(dm.paths[surface])
        pct = abs(by[surface] - used) / max(1, used) * 100
        acct[surface] = {"gv_bytes": int(by[surface]), "du_bytes": used,
                         "delta_pct": round(pct, 2)}
    acct["pass"] = all(a["delta_pct"] <= ACCOUNTING_PCT
                       for a in acct.values() if isinstance(a, dict))
    return acct


def restart(db, s, open_db, path):
    """Close and reopen: ``count(*), sum(v)`` must be equal
    (``disk_bench.py:260-267``) -> (the record, the reopened db)."""
    expect = count(s)
    db.close()
    db = open_db(path)
    got = count(db.session())
    return {"expect": list(expect), "got": list(got),
            "pass": got == expect}, db


def run(open_db, tmp: str, rows: int, blocks: int = OVERHEAD_BLOCKS,
        fault_plane=FaultPlane, full_backup=port_backup,
        metrics=port_metrics) -> dict:
    """The reference's halves on a fresh Database at ``tmp/db`` (opened
    by ``open_db(path)``, twice) -> its record: ``overhead``,
    ``surfaces``, ``degrade``, ``accounting``, ``restart``, ``pass``,
    ``sysstat``, and ``seconds`` by half."""
    out = {"metric": "disk_bench", "rows": rows}
    secs = {}
    path = os.path.join(tmp, "db")
    db = open_db(path)
    try:
        t0 = time.monotonic()
        s = db.session()
        keys = load(db, rows)
        workload_block(s, keys)  # warm-up (plan cache, first execution)
        secs["load"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["overhead"] = overhead(s, keys, blocks)
        secs["overhead"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["surfaces"] = surfaces(db, s, keys, tmp,
                                   max(rows // SPILL_RUNS, 1),
                                   fault_plane, full_backup)
        secs["surfaces"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["degrade"] = degrade(db, s)
        secs["degrade"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["accounting"] = accounting(db, s)
        secs["accounting"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["restart"], db = restart(db, s, open_db, path)
        secs["restart"] = time.monotonic() - t0
    finally:
        db.close()
    out["pass"] = bool(out["overhead"]["pass"] and out["surfaces"]["pass"]
                       and out["degrade"]["pass"]
                       and out["accounting"]["pass"]
                       and out["restart"]["pass"])
    out["sysstat"] = {k: v for k, v in sorted(metrics.sysstat_dict().items())
                      if k.startswith("disk.")}
    out["seconds"] = {k: round(v, 3) for k, v in secs.items()}
    return out


def failures(rec: dict, overhead_gated: bool = True) -> list[str]:
    """Each invariant ``rec`` breaks, by name; the 2% overhead contract
    only with ``overhead_gated``."""
    bad = []
    if overhead_gated and not rec.get("overhead", {}).get("pass"):
        bad.append(f"overhead_pct {rec.get('overhead', {}).get('overhead_pct')}")
    surf = rec.get("surfaces", {}).get("surfaces", [])
    if [r.get("surface") for r in surf] != list(SURFACES):
        bad.append(f"surfaces {[r.get('surface') for r in surf]}")
    for r in surf:
        for key in ("typed_error", "recovered"):
            if not r.get(key):
                bad.append(f"{r.get('surface')} {key} ({r.get('error')})")
        if "answer_ok" in r and not r["answer_ok"]:
            bad.append(f"{r['surface']} answer_ok")
        if r.get("residue"):
            bad.append(f"{r['surface']} residue {r['residue']}")
        if "runs" in r and not r["runs"] > 1:
            bad.append(f"{r['surface']} runs {r['runs']}")
    deg = rec.get("degrade", {})
    for key in ("entered_readonly", "write_rejected_typed",
                "reads_serve_in_readonly", "exited_readonly",
                "writes_resume"):
        if not deg.get(key):
            bad.append(f"degrade {key}")
    if deg.get("gv_disk_state") != "readonly":
        bad.append(f"degrade gv_disk_state {deg.get('gv_disk_state')!r}")
    if not deg.get("gv_vs_du_pct", 100.0) <= ACCOUNTING_PCT:
        bad.append(f"degrade gv_vs_du_pct {deg.get('gv_vs_du_pct')}")
    if not deg.get("reclaims", 0) >= 1:
        bad.append("degrade reclaims 0")
    acct = rec.get("accounting", {})
    for surface in ("log", "data"):
        pct = acct.get(surface, {}).get("delta_pct", 100.0)
        if not pct <= ACCOUNTING_PCT:
            bad.append(f"accounting {surface} delta_pct {pct}")
    rs = rec.get("restart", {})
    if not rs.get("pass") or rs.get("expect") != rs.get("got"):
        bad.append(f"restart {rs.get('expect')} -> {rs.get('got')}")
    return bad
