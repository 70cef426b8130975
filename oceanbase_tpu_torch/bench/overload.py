"""The serving plane under 4x offered load, on one in-process Database.

Port of ``scripts/overload_bench.py`` (its constants, record fields and
gates, each cited by line), over any package's ``Database``: the caller
passes the database and, where the module reads counters, the metrics
module of the same package (the port's by default).  Exceptions are
triaged by class name, as the reference does.

  saturation   two tenants, ``loud`` with 8 closed-loop clients and
               ``quiet`` with 2, over 2 admission slots, a queue of 3
               and a 4 s queue timeout, for a fixed window: every
               statement finishes or fails typed inside the 30 s
               deadline, and every admitted answer equals numpy's
               ``sum(b), count(*)`` for its predicate;
  fairness     quiet keeps >= 20% of the completions (40% of its fair
               half) while loud offers 4x its clients;
  kill         a spilled scan of ``SEGMENTS`` granules KILLed mid-flight
               returns ``QueryKilled`` before its last checkpoint and
               within ``max(2 x base_runtime / checkpoints, 0.5 s)``; the
               same session then runs it again to numpy's answer, and
               SHOW PROCESSLIST holds no leftover statement;
  write_flood  4 writers x 250 INSERTs of 200-byte strings against a
               200,000-byte memstore budget while an open transaction
               pins the flush: the peak stays at or under the budget,
               ramp sleeps and typed ``MemstoreFull`` absorb the flood,
               and writes are admitted again once the pin commits.

``run`` drives the four in order and returns the reference's record;
``failures`` names each broken invariant.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from oceanbase_tpu_torch.server import metrics as port_metrics

#: per-statement wall bound: a statement that neither finishes nor
#: fails typed inside this is a hang (``overload_bench.py:54``)
STMT_DEADLINE_S = 30.0
#: the typed failures a statement may see (``overload_bench.py:55``)
TYPED = ("ServerBusy", "QueryTimeout", "QueryKilled", "MemstoreFull")
#: the storm's admission knobs (``overload_bench.py:96-99``)
STORM_KNOBS = (("admission_slots", 2), ("admission_tenant_slots", 2),
               ("admission_queue_limit", 3),
               ("admission_queue_timeout_s", 4.0))
#: closed-loop clients per tenant (``overload_bench.py:127``)
CLIENTS = (("loud", 8), ("quiet", 2))
TENANTS = ("loud", "quiet")
QUERY = "select sum(b), count(*) from big where b < {}"
LONG_QUERY = "select sum(b), count(*) from big where b < 90"
B_SEED = 7                      # ``overload_bench.py:101``
B_VALUES = 97                   # ``b`` in [0, 97)
FAIR_SHARE = 0.5
QUIET_FLOOR = 0.20              # ``overload_bench.py:162``
KILL_FLOOR_S = 0.5              # ``overload_bench.py:218``
#: entry, close and at least one granule between: a KILL can land mid-scan
MIN_CHECKPOINTS = 3
#: the KILL's work area: 512 rows at the reference's 20,000
#: (``overload_bench.py:187``), kept in proportion to the table.  It
#: only routes the scan to the spill tier; the chunks come from SEGMENTS
KILL_AREA_PER_ROWS = (512, 20_000)
#: ``big`` is direct-loaded as this many segments, and the spill tier
#: streams at least one granule per segment, so the KILL's victim passes
#: about the reference's 20,000 / 512 checkpoints (``overload_bench.py:
#: 187``) whatever the granule's capacity (2^21 rows) and the table's size
SEGMENTS = 40
#: the write flood (``overload_bench.py:231-316``)
FLOOD_WRITERS = 4
FLOOD_INSERTS = 250
FLOOD_LIMIT_BYTES = 200_000
FLOOD_TRIGGER_PCT = 50
FLOOD_MAX_SLEEP_S = 0.002
FLOOD_PAYLOAD = "z" * 200
FLOOD_WATCH_S = 120.0
RECOVERED_LIMIT_BYTES = 256 << 20
SYSSTAT_KEYS = ("admission.admitted", "admission.queued",
                "admission.rejected", "admission.timeouts",
                "admission.kills", "admission.demotions",
                "admission.throttle_sleeps", "admission.memstore_full",
                "admission.px_downgrades")


def b_column(n_rows: int) -> np.ndarray:
    """The ``b`` column both tenants hold (``overload_bench.py:101-102``)."""
    return np.random.default_rng(B_SEED).integers(0, B_VALUES, n_rows)


def kill_work_area(n_rows: int) -> int:
    num, den = KILL_AREA_PER_ROWS
    return max(n_rows * num // den, 1)


class Answers:
    """numpy's ``sum(b), count(*)`` for every ``b < t``: one bincount."""

    def __init__(self, b: np.ndarray):
        counts = np.bincount(b, minlength=B_VALUES).astype(np.int64)
        self._count = np.concatenate([[0], np.cumsum(counts)])
        self._sum = np.concatenate(
            [[0], np.cumsum(counts * np.arange(B_VALUES))])

    def below(self, t: int) -> tuple[int, int]:
        t = min(max(int(t), 0), B_VALUES)
        return int(self._sum[t]), int(self._count[t])

    def matches(self, t: int, rows) -> bool:
        return (len(rows) == 1
                and tuple(int(x) for x in rows[0]) == self.below(t))


def load(db, n_rows: int, segments: int = SEGMENTS) -> np.ndarray:
    """Both tenants with ``big (a int primary key, b int)`` direct-loaded
    as ``segments`` segments (the reference INSERTs 2,000-row statements;
    the rows are the same), and a warm statement each, so the storm
    measures serving and not a first execution -> ``b``."""
    b = b_column(n_rows)
    a, b32 = np.arange(n_rows, dtype=np.int32), b.astype(np.int32)
    cuts = np.linspace(0, n_rows, segments + 1).astype(np.int64)
    for t in TENANTS:
        cat = db.tenant(t).catalog
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            if hi > lo:
                cat.load_numpy("big", {"a": a[lo:hi], "b": b32[lo:hi]},
                               primary_key=["a"])
        s = db.session(t)
        s.execute(QUERY.format(50))
        s.close()
    return b


def closed_loop(tenant, session, threshold, results, lock, stop,
                deadline_s=STMT_DEADLINE_S):
    """One serving client (``overload_bench.py:58-76``): issue
    statements back to back until the window closes and record every
    outcome with the statement's predicate and rows; a rejected
    statement is a shed outcome, not a retry loop."""
    k = 0
    while not stop.is_set():
        t = threshold(k)
        t0 = time.monotonic()
        kind, rows = "ok", None
        try:
            rows = session.execute(QUERY.format(t)).rows()
        except Exception as e:  # noqa: BLE001 — triaged by name
            kind = type(e).__name__
        dt = time.monotonic() - t0
        with lock:
            results.append((tenant, kind, dt, dt > deadline_s, t, rows))
        k += 1
        if kind != "ok":
            time.sleep(0.01)  # shed: tiny client backoff, keep offering


def saturation(db, answers: Answers, window_s: float,
               deadline_s: float = STMT_DEADLINE_S) -> tuple[dict, dict]:
    """Phases 1 and 2 (``overload_bench.py:117-181``) -> (the saturation
    record, the fairness record)."""
    for name, value in STORM_KNOBS:
        db.config.set(name, value)
    results: list = []
    lock = threading.Lock()
    stop = threading.Event()
    clients = []
    for tname, count in CLIENTS:
        for k in range(count):
            s = db.session(tname)
            th = threading.Thread(
                target=closed_loop,
                args=(tname, s, (lambda k0: lambda j: 20 + ((k0 * 7 + j)
                                                           % 60))(k),
                      results, lock, stop, deadline_s))
            clients.append((tname, s, th))
    t0 = time.monotonic()
    for _t, _s, th in clients:
        th.start()
    time.sleep(window_s)
    stop.set()
    for _t, _s, th in clients:
        th.join(deadline_s * 2)
    storm_s = time.monotonic() - t0
    for _t, s, _th in clients:
        s.close()
    hung_threads = sum(1 for _t, _s, th in clients if th.is_alive())
    kinds: dict = {}
    per_tenant_ok = {t: 0 for t in TENANTS}
    wrong = 0
    for tn, kind, _dt, _h, t, rows in results:
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "ok":
            per_tenant_ok[tn] += 1
            wrong += not answers.matches(t, rows)
    hung = sum(1 for r in results if r[3]) + hung_threads
    untyped = {k: v for k, v in kinds.items()
               if k != "ok" and k not in TYPED}
    total_ok = max(sum(per_tenant_ok.values()), 1)
    quiet_share = per_tenant_ok["quiet"] / total_ok
    adm = {r["tenant"]: r for r in db.admission.stats()}
    sat = {
        "clients": dict(CLIENTS), "window_s": window_s,
        "offered": len(results), "storm_s": round(storm_s, 2),
        "completed": total_ok, "kinds": kinds, "hung": hung,
        "untyped_errors": untyped,
        "rejected": {t: adm.get(t, {}).get("rejected", 0) for t in TENANTS},
        "queued": {t: adm.get(t, {}).get("queued", 0) for t in TENANTS},
        "wrong_answers": wrong,
        "completed_by_tenant": dict(per_tenant_ok),
    }
    fair = {
        "loud_completed": per_tenant_ok["loud"],
        "quiet_completed": per_tenant_ok["quiet"],
        "quiet_share": round(quiet_share, 3),
        "fair_share": FAIR_SHARE, "floor": QUIET_FLOOR,
        "ok": quiet_share >= QUIET_FLOOR,
    }
    return sat, fair


def _leftover(session) -> list:
    """SHOW PROCESSLIST rows of other sessions that are not idle."""
    rows = session.execute("show processlist").rows()
    return [r for r in rows if r[0] != session.session_id and r[1] != "IDLE"]


def _long(session, out: dict):
    """Run the long scan on ``session``; its kind and rows into ``out``."""
    try:
        out["rows"] = session.execute(LONG_QUERY).rows()
        out["kind"] = "ok"
    except Exception as e:  # noqa: BLE001 — triaged by name
        out["kind"] = type(e).__name__


def kill(db, answers: Answers, work_area_rows: int, metrics=port_metrics,
         tenant: str = "quiet", deadline_s: float = STMT_DEADLINE_S) -> dict:
    """Phase 3 (``overload_bench.py:183-229``): KILL a spilled scan; the
    bound is two of its checkpoint intervals, read from an uninterrupted
    run's ``admission.checkpoints``.  That run goes through a thread of
    its own, as the victim's does: on a loaded CPU a statement on the
    main thread ran 3x the victim's time, and the KILL, sent at 30% of
    it, came after the victim had finished.  Then the killed session
    runs the scan again, and SHOW PROCESSLIST must hold no statement but
    the caller's."""
    db.config.set("admission_slots", 32)
    db.config.set("sql_work_area_rows", work_area_rows)
    s = db.session(tenant)
    cp0 = metrics.counter_value("admission.checkpoints")
    first: dict = {}
    th = threading.Thread(target=_long, args=(s, first))
    t0 = time.monotonic()
    th.start()
    th.join(deadline_s)
    base_runtime = time.monotonic() - t0
    checkpoints = max(
        metrics.counter_value("admission.checkpoints") - cp0, 1)
    interval = base_runtime / checkpoints
    killer = db.session(tenant)
    res: dict = {}
    th = threading.Thread(target=_long, args=(s, res))
    cp0 = metrics.counter_value("admission.checkpoints")
    th.start()
    time.sleep(min(base_runtime * 0.3, 1.0))
    k0 = time.monotonic()
    killer.execute(f"kill query {s.session_id}")
    th.join(deadline_s)
    kill_latency = time.monotonic() - k0
    victim_checkpoints = metrics.counter_value("admission.checkpoints") - cp0
    killed_ok = not th.is_alive() and res.get("kind") == "QueryKilled"
    bound = max(2.0 * interval, KILL_FLOOR_S)
    leftover = _leftover(killer) if not th.is_alive() else ["victim alive"]
    t0 = time.monotonic()
    again = s.execute(LONG_QUERY).rows()
    rerun_s = time.monotonic() - t0
    out = {
        "base_runtime_s": round(base_runtime, 3),
        "checkpoints": int(checkpoints),
        "checkpoint_interval_s": round(interval, 4),
        "victim_checkpoints": int(victim_checkpoints),
        "kill_latency_s": round(kill_latency, 3),
        "bound_s": round(bound, 3),
        "typed": res.get("kind"),
        "ok": bool(killed_ok and kill_latency <= bound),
        "answer_ok": (first.get("kind") == "ok"
                      and answers.matches(90, first["rows"])),
        "rerun_ok": answers.matches(90, again),
        "rerun_s": round(rerun_s, 3),
        "leftover": [list(r) for r in leftover],
    }
    s.close()
    killer.close()
    return out


def write_flood(db, tenant: str = "quiet") -> dict:
    """Phase 4 (``overload_bench.py:231-316``): an open transaction pins
    the flush horizon, so the ramp and the hard limit must bound the
    flood; then the pin commits and writes are admitted again."""
    t = db.tenant(tenant)
    wsess = [db.session(tenant) for _ in range(FLOOD_WRITERS)]
    wsess[0].execute("create table flood (a int primary key, p string)")
    pin = db.session(tenant)
    pin.execute("begin")
    pin.execute("insert into flood values (-1, 'pin')")
    db.checkpoint(tenant)  # drain the earlier phases' accounting
    t.throttle.reset_peak()
    sleeps0 = t.throttle.throttle_sleeps
    full0 = t.throttle.full_rejections
    db.config.set("memstore_limit_bytes", FLOOD_LIMIT_BYTES)
    db.config.set("writing_throttle_trigger_pct", FLOOD_TRIGGER_PCT)
    db.config.set("writing_throttle_max_sleep_s", FLOOD_MAX_SLEEP_S)
    wres: list = []

    def writer(sess, base):
        full = okc = 0
        for i in range(FLOOD_INSERTS):
            try:
                sess.execute(f"insert into flood values "
                             f"({base + i}, '{FLOOD_PAYLOAD}')")
                okc += 1
            except Exception as e:  # noqa: BLE001 — triaged by name
                if type(e).__name__ != "MemstoreFull":
                    wres.append(("untyped", type(e).__name__))
                    return
                full += 1
                time.sleep(0.002)
        wres.append(("done", okc, full))

    threads = [threading.Thread(target=writer, args=(wsess[i], i * 10000))
               for i in range(FLOOD_WRITERS)]
    f0 = time.monotonic()
    for th in threads:
        th.start()
    peak_seen = 0
    while any(th.is_alive() for th in threads):
        peak_seen = max(peak_seen, t.throttle.used_bytes())
        time.sleep(0.01)
        if time.monotonic() - f0 > FLOOD_WATCH_S:
            break
    for th in threads:
        th.join(10)
    flood_s = time.monotonic() - f0
    thr = t.throttle.stats()
    untyped = [r[1] for r in wres if r[0] == "untyped"]
    peak = int(max(peak_seen, thr["memstore_peak_bytes"]))
    sleeps = thr["throttle_sleeps"] - sleeps0
    fulls = thr["memstore_full_rejections"] - full0
    pin.execute("commit")
    db.config.set("memstore_limit_bytes", RECOVERED_LIMIT_BYTES)
    recovered = False
    for _ in range(50):
        try:
            wsess[0].execute("insert into flood values (999999, 'ok')")
            recovered = True
            break
        except Exception:  # noqa: BLE001 — MemstoreFull mid-drain
            time.sleep(0.05)
    live = sum(th.is_alive() for th in threads)
    for w in wsess:
        w.close()
    pin.close()
    return {
        "writers": FLOOD_WRITERS, "flood_s": round(flood_s, 2),
        "peak_bytes": peak, "limit_bytes": FLOOD_LIMIT_BYTES,
        "throttle_sleeps": int(sleeps),
        "memstore_full_rejections": int(fulls),
        "untyped_errors": untyped,
        "recovered_after_flush": recovered,
        "live_writers": live,
        "ok": bool(peak <= FLOOD_LIMIT_BYTES and fulls > 0 and sleeps > 0
                   and not untyped and recovered and live == 0),
    }


def run(db, rows: int, window_s: float, work_area_rows: int,
        metrics=port_metrics) -> dict:
    """The reference's four phases on ``db`` (a fresh Database of either
    package; two tenants are created on it) -> its record: ``saturation``,
    ``fairness``, ``kill``, ``write_flood``, ``ok``, ``sysstat``, and
    ``seconds`` by half."""
    out = {"metric": "overload_bench", "rows": rows,
           "stmt_deadline_s": STMT_DEADLINE_S}
    secs = {}
    t0 = time.monotonic()
    for t in TENANTS:
        db.create_tenant(t)
    for name, value in STORM_KNOBS:
        db.config.set(name, value)
    answers = Answers(load(db, rows))
    secs["load"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["saturation"], out["fairness"] = saturation(db, answers, window_s)
    secs["saturation"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["kill"] = kill(db, answers, work_area_rows, metrics)
    secs["kill"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["write_flood"] = write_flood(db)
    secs["write_flood"] = time.monotonic() - t0
    sat = out["saturation"]
    out["ok"] = bool(sat["hung"] == 0 and not sat["untyped_errors"]
                     and out["fairness"]["ok"] and out["kill"]["ok"]
                     and out["write_flood"]["ok"])
    out["sysstat"] = {k: metrics.counter_value(k) for k in SYSSTAT_KEYS}
    out["seconds"] = {k: round(v, 3) for k, v in secs.items()}
    return out


def failures(rec: dict) -> list[str]:
    """Each invariant ``rec`` breaks, by name."""
    bad = []
    sat = rec.get("saturation", {})
    if sat.get("hung", 1) != 0:
        bad.append(f"hung {sat.get('hung')}")
    if sat.get("untyped_errors"):
        bad.append(f"untyped_errors {sat['untyped_errors']}")
    if sat.get("wrong_answers", 0):
        bad.append(f"wrong_answers {sat['wrong_answers']}")
    fair = rec.get("fairness", {})
    if not fair.get("quiet_share", 0.0) >= QUIET_FLOOR:
        bad.append(f"quiet_share {fair.get('quiet_share')}")
    k = rec.get("kill", {})
    if k.get("typed") != "QueryKilled":
        bad.append(f"kill typed {k.get('typed')}")
    # a cancel that acts only at the statement's close would pass the
    # latency bound of a scan with one interval; this one must stop
    # before its last checkpoint
    if not k.get("checkpoints", 0) >= MIN_CHECKPOINTS:
        bad.append(f"kill checkpoints {k.get('checkpoints')} < "
                   f"{MIN_CHECKPOINTS}")
    if not k.get("victim_checkpoints", float("inf")) < k.get("checkpoints",
                                                             0):
        bad.append(f"kill victim_checkpoints {k.get('victim_checkpoints')} "
                   f"not under the uninterrupted run's "
                   f"{k.get('checkpoints')}")
    if not k.get("kill_latency_s", float("inf")) <= k.get("bound_s", 0.0):
        bad.append(f"kill_latency_s {k.get('kill_latency_s')} > bound_s "
                   f"{k.get('bound_s')}")
    for key in ("answer_ok", "rerun_ok"):
        if not k.get(key):
            bad.append(f"kill {key}")
    if k.get("leftover"):
        bad.append(f"kill leftover {k['leftover']}")
    f = rec.get("write_flood", {})
    if not f.get("peak_bytes", float("inf")) <= f.get("limit_bytes", 0):
        bad.append(f"flood peak_bytes {f.get('peak_bytes')} > limit_bytes "
                   f"{f.get('limit_bytes')}")
    if not f.get("memstore_full_rejections", 0) > 0:
        bad.append("flood memstore_full_rejections 0")
    if not f.get("throttle_sleeps", 0) > 0:
        bad.append("flood throttle_sleeps 0")
    if f.get("untyped_errors"):
        bad.append(f"flood untyped_errors {f['untyped_errors']}")
    if not f.get("recovered_after_flush"):
        bad.append("flood recovered_after_flush")
    if f.get("live_writers", 1):
        bad.append(f"flood live_writers {f.get('live_writers')}")
    return bad
