"""The port's workload repository against the JAX package's: the merge
and delta math (on hand-built counters, equal to the last digit), the
report rows and text tree built from the same hand-built snapshots,
snapshot persistence with its crc, quarantine of a rotten snapshot and
a write fault, restart survival, retention by count and age, the
background loop's knobs, and the SQL faces — ANALYZE / SHOW WORKLOAD
REPORT and ``gv$workload_snapshot`` / ``gv$workload_report`` — with a
Database and without one.  The cases mirror ``tests/test_workload.py``;
each runs once per package and holds the records equal (timings and the
counters each package keeps of its own are left out)."""

from __future__ import annotations

import glob
import os
import time

import pytest
import torch

from torch_pair import J, T, both, outcome

torch.set_num_threads(2)


def _warm(s, rows=200):
    s.execute("create table t (k int primary key, v int)")
    vals = ", ".join(f"({i}, {i % 13})" for i in range(rows))
    s.execute(f"insert into t values {vals}")
    for _ in range(3):
        s.execute("select v, count(*) from t where v < 11 group by v")
        s.execute("select sum(v) from t")


# ---------------------------------------------------------------------------
# the math, on hand-built counters
# ---------------------------------------------------------------------------


def test_merge_and_delta_value_semantics():
    a = {"n": 2, "f": 1.5, "sub": {"x": 1}, "lst": [1], "s": "a",
         "flag": False}
    b = {"n": 3, "f": 0.5, "sub": {"x": 2, "y": 7}, "lst": [2],
         "flag": True, "only_b": 9}
    frm = {"n": 10, "sub": {"x": 4}, "gone": 3}
    to = {"n": 25, "sub": {"x": 9, "new": 2}, "txt": "z", "flag": True}
    outs = [[P.workload._merge_value(a, b), P.workload._delta_value(frm, to),
             P.workload._merge_value(3, 4.5), P.workload._delta_value(
                 None, {"q": 1.25}), P.workload._merge_value("", "x")]
            for P in (J, T)]
    assert outs[0] == outs[1]
    assert outs[1][1] == {"n": 15, "sub": {"x": 5, "new": 2}, "txt": "z",
                          "flag": True}


def _payload(scale):
    return {
        "sysstat": {"sql.statements{kind=select}": 10 * scale,
                    "sql.rows_returned": 1000 * scale, "zero": 0},
        "sysstat_hist": {},
        "time_model": {"sys": {"statements": 4 * scale,
                               "bind_s": 0.25 * scale,
                               "dispatch_s": 0.5 * scale,
                               "elapsed_s": 2.0 * scale}},
        "plan_cache": {"entries": 3, "executions": 9 * scale,
                       "xla_traces": 3, "sidecar_builds": scale,
                       "sidecar_build_s": 0.01 * scale,
                       "compile_s": 0.0,
                       "top": [{"plan_hash": "ab" * 20, "executions": 5,
                                "xla_traces": 2, "sidecar_builds": 1}]},
        "plan_history": {"plans": 2, "regress_count": scale,
                         "regressed": ["h1"] if scale > 1 else []},
        "wait_events": {"io": {"count": 2 * scale, "sum": 0.125 * scale}},
        "ash": {"ACTIVE": scale},
        "top_sql": [{"sql": "select sum(v) from t", "calls": 3 * scale,
                     "elapsed_s": 0.3, "device_s": 0.1, "bind_s": 0.01,
                     "sidecar_build_s": 0.0, "lower_s": 0.0,
                     "compile_s": 0.0, "dispatch_s": 0.05,
                     "merge_s": 0.0}],
        "disk": [{"tenant": "sys", "surface": "log", "used_bytes": 100,
                  "limit_bytes": 0, "state": "ok"}],
        "health": [],
    }


def test_report_from_hand_built_snapshots():
    outs = []
    for P in (J, T):
        db = type("Db", (), {"config": {"workload_retention_keep": 64,
                                        "workload_retention_max_age_s":
                                            1e9},
                             "node_id": 0})()
        repo = P.workload.WorkloadRepository(db, root=None)
        for sid, scale in ((1, 1), (2, 3)):
            payload = _payload(scale)
            repo._persist({"id": sid, "ts": 100.0 * sid, "node_id": 0,
                           "nodes": [0],
                           "crc": P.integrity.bytes_crc(
                               P.workload.canonical_bytes(payload)),
                           "payload": payload})
        d = repo.delta(1, 2)
        rep = repo.build_report(1, 2)
        first = repo.build_report(0, 1)
        outs.append([d, rep["rows"], rep["text"], first["rows"],
                     P.workload.canonical_bytes(_payload(2))])
    assert outs[0] == outs[1]
    d = outs[1][0]
    assert d["payload"]["time_model"]["sys"]["statements"] == 8
    assert d["payload"]["sysstat"]["sql.rows_returned"] == 2000
    assert d["payload"]["disk"] == _payload(3)["disk"]
    assert d["span_s"] == 100.0


# ---------------------------------------------------------------------------
# snapshots: persistence, crc, quarantine, restart, retention
# ---------------------------------------------------------------------------

_SECTIONS = ("sysstat", "sysstat_hist", "time_model", "plan_cache",
             "plan_history", "wait_events", "ash", "top_sql", "disk",
             "health")


def _scn_snapshot_roundtrip(P, root):
    db = P.db(root / "db")
    s = db.session()
    _warm(s)
    snap = db.workload.snapshot(cluster=False)
    loaded = db.workload.load(snap["id"])
    assert loaded["payload"] == snap["payload"]
    assert P.integrity.bytes_crc(
        P.workload.canonical_bytes(loaded["payload"])) == loaded["crc"]
    p = snap["payload"]
    out = [snap["id"], db.workload.snapshot_ids(), sorted(p),
           p["disk"] and sorted(r["surface"] for r in p["disk"]),
           sorted(p["time_model"]), p["health"],
           sorted(p["plan_cache"]),
           sorted((r["sql"], r["calls"]) for r in p["top_sql"])]
    db.close()
    return out


def test_snapshot_persist_and_crc_roundtrip(tmp_path):
    out = both(_scn_snapshot_roundtrip, tmp_path)
    assert tuple(sorted(_SECTIONS)) == tuple(out[2])


def _scn_corrupt_snapshot(P, root):
    db = P.db(root / "db")
    s = db.session()
    _warm(s)
    fp = P.FaultPlane(seed=3)
    fp.disk("bitflip", kind="workload", count=1)
    db.faults = fp
    before = P.metrics.counter_value("workload.snapshot_corrupt")
    snap = db.workload.snapshot(cluster=False)
    err = outcome(db.workload.load, snap["id"])
    quarantined = len(glob.glob(os.path.join(str(root / "db"), "workload",
                                             "*.corrupt")))
    gone = snap["id"] not in db.workload.snapshot_ids()
    counted = P.metrics.counter_value("workload.snapshot_corrupt") - before
    snap2 = db.workload.snapshot(cluster=False)
    ok = db.workload.load(snap2["id"])["id"] == snap2["id"]
    db.close()
    return [err, quarantined, gone, counted, ok]


def test_corrupt_snapshot_quarantined_then_resnapshot(tmp_path):
    assert both(_scn_corrupt_snapshot, tmp_path) == \
        [("error", "CorruptionError"), 1, True, 1, True]


def _scn_snapshot_enospc(P, root):
    db = P.db(root / "db")
    _warm(db.session())
    fp = P.FaultPlane(seed=5)
    fp.disk("enospc", kind="workload", count=1)
    db.faults = fp
    err = outcome(db.workload.snapshot, cluster=False)
    tmps = glob.glob(os.path.join(db.workload.dir, "*.tmp"))
    snap = db.workload.snapshot(cluster=False)
    ok = bool(db.workload.load(snap["id"]))
    db.close()
    return [err, tmps, ok]


def test_snapshot_write_errno_fault_surfaces(tmp_path):
    """The reference raises the bare OSError out of its snapshot writer;
    the port raises the disk manager's typed DiskFull, as every other
    durable writer does (ROADMAP Queue 3 #21).  Otherwise equal."""
    want = _scn_snapshot_enospc(J, tmp_path / "jax")
    got = _scn_snapshot_enospc(T, tmp_path / "port")
    assert want == [("error", "OSError"), [], True]
    assert got == [("error", "DiskFull"), [], True]


def _scn_delta_sql(P, root):
    db = P.db(root / "db")
    s = db.session()
    _warm(s)
    a = db.workload.snapshot(cluster=False)
    for _ in range(4):
        s.execute("select sum(v) from t")
    b = db.workload.snapshot(cluster=False)
    d = db.workload.delta(a["id"], b["id"])
    name = "sql.statements{ok=1,tenant=sys}"
    sys_d = d["payload"]["sysstat"][name]
    assert sys_d == b["payload"]["sysstat"][name] - \
        a["payload"]["sysstat"].get(name, 0)
    stmts = d["payload"]["time_model"]["sys"]["statements"]
    out = [name, sys_d, stmts, d["payload"]["disk"] == b["payload"]["disk"],
           d["payload"]["top_sql"] == b["payload"]["top_sql"],
           d["span_s"] >= 0.0]
    db.close()
    return out


def test_delta_math_over_a_real_workload(tmp_path):
    out = both(_scn_delta_sql, tmp_path)
    assert out[2] == 4 and out[3:] == [True, True, True]


def _scn_restart(P, root):
    db = P.db(root / "db")
    _warm(db.session())
    pre = db.workload.snapshot(cluster=False)["id"]
    db.close()
    db2 = P.db(root / "db")
    s2 = db2.session()
    s2.execute("select sum(v) from t")
    ids = db2.workload.snapshot_ids()
    loaded = db2.workload.load(pre)["id"]
    rep = db2.workload.build_report(from_id=pre, to_id=-1)
    out = [ids, loaded, rep["from_id"], rep["to_id"],
           sorted({r["section"] for r in rep["rows"]})]
    db2.close()
    return out


def test_restart_survival_and_cross_restart_report(tmp_path):
    ids, loaded, frm, to, sections = both(_scn_restart, tmp_path)
    assert ids == [1] and loaded == 1 and (frm, to) == (1, 2)
    assert {"report", "time_model", "plan_cache"} <= set(sections)


def _scn_retention(P, root):
    db = P.db(root / "db")
    s = db.session()
    _warm(s, rows=50)
    s.execute("alter system set workload_retention_keep = 3")
    for _ in range(7):
        db.workload.snapshot(cluster=False)
    by_count = db.workload.snapshot_ids()
    s.execute("alter system set workload_retention_keep = 64")
    s.execute("alter system set workload_retention_max_age_s = 60")
    stale = time.time() - 3600
    os.utime(db.workload._path(by_count[0]), (stale, stale))
    db.workload.prune()
    by_age = db.workload.snapshot_ids()
    files = sorted(os.listdir(db.workload.dir))
    db.close()
    return [by_count, by_age, files]


def test_retention_prunes_by_count_and_age(tmp_path):
    by_count, by_age, files = both(_scn_retention, tmp_path)
    assert by_count == [5, 6, 7] and by_age == [6, 7] and len(files) == 2


def _scn_background_loop(P, root):
    db = P.db(root / "db")
    s = db.session()
    _warm(s, rows=50)
    s.execute("alter system set workload_retention_keep = 2")
    s.execute("alter system set workload_snapshot_interval_s = 0.05")
    s.execute("alter system set enable_workload_repo = true")
    deadline = time.monotonic() + 10.0
    while not db.workload.snapshot_ids() and time.monotonic() < deadline:
        time.sleep(0.05)
    took = bool(db.workload.snapshot_ids())
    bounded = len(db.workload.snapshot_ids()) <= 2
    s.execute("alter system set enable_workload_repo = false")
    time.sleep(0.4)
    frozen = db.workload.snapshot_ids()
    time.sleep(0.4)
    still = db.workload.snapshot_ids() == frozen
    db.close()
    return [took, bounded, still, db.workload._thread is None]


def test_background_loop_bounded_and_knob_off(tmp_path):
    assert both(_scn_background_loop, tmp_path) == [True, True, True, True]


def test_loop_starts_only_with_the_knob(tmp_path):
    db = T.db(tmp_path / "db")
    assert db.workload._thread is None            # off by default
    db.close()
    db2 = T.db(tmp_path / "db2", enable_workload_repo=True,
               workload_snapshot_interval_s=3600.0)
    assert db2.workload._thread is not None
    db2.close()
    assert db2.workload._thread is None


# ---------------------------------------------------------------------------
# SQL faces
# ---------------------------------------------------------------------------


def _scn_sql_faces(P, root):
    db = P.db(root / "db")
    s = db.session()
    _warm(s)
    r = s.execute("analyze workload report")
    sections = sorted({row[0] for row in r.rows()})
    items = sorted({row[1] for row in r.rows() if row[0] == "time_model"})
    s.execute("select sum(v) from t")
    b = db.workload.snapshot(cluster=False)
    a_id = db.workload.snapshot_ids()[0]
    r2 = s.execute(f"analyze workload report from {a_id} to {b['id']}")
    hdr = next(row for row in r2.rows() if row[0] == "report")
    tree = s.execute("show workload report").rows()
    gv = s.execute("select section, item from gv$workload_report")
    snaps = s.execute(
        "select snapshot_id, crc64 from gv$workload_snapshot").rows()
    out = [r.names, sections, items, hdr[3], tree[0][0].split()[:4],
           any(line[0].strip() == "time_model" for line in tree),
           gv.rowcount == r2.rowcount,
           sorted(x[0] for x in snaps) == db.workload.snapshot_ids()]
    db.close()
    return out


def test_analyze_workload_report_end_to_end(tmp_path):
    out = both(_scn_sql_faces, tmp_path)
    assert out[0] == ["section", "item", "value", "detail"]
    assert {"report", "time_model", "plan_cache", "sysstat"} <= set(out[1])
    assert "sys.dispatch_s" in out[2] and "sys.elapsed_s" in out[2]
    assert out[3].startswith("from=1 to=2") and out[5:] == [True, True, True]


# the statements a Database refused before the plane was ported (the
# nine of the database-level refusal test that belong to this plane or
# its neighbours, and the five workload spellings of the catalog-level
# one), now answered as the reference answers them
_STATEMENTS = [
    "describe gv$workload_snapshot", "analyze workload report",
    "show workload report", "select count(*) from gv$workload_report",
    "analyze workload report from 1 to 2",
    "ANALYZE WORKLOAD REPORT FROM 3 TO 4",
    "profile analyze workload report",
    "select count(*) from gv$workload_snapshot",
]


@pytest.mark.parametrize("sql", _STATEMENTS)
def test_workload_statements_with_a_database(tmp_path, sql):
    def scn(P, root):
        db = P.db(root / "db")
        s = db.session()
        s.execute("create table t (k int primary key, v int)")
        s.execute("insert into t values (1, 1)")
        if "from 1 to 2" in sql:
            db.workload.snapshot(cluster=False)
            db.workload.snapshot(cluster=False)
        try:
            r = s.execute(sql)
            got = ("ok", r.names if not r.names[0].startswith("expr")
                   else None, sorted({row[0] for row in r.rows()})
                   if "analyze" in sql.lower() else r.rowcount)
        except Exception as e:  # noqa: BLE001 — the error is the outcome
            got = ("error", type(e).__name__)
        db.close()
        return got

    got = both(scn, tmp_path)
    if "3 to 4" in sql.lower():
        assert got == ("error", "KeyError")     # no such snapshots
    else:
        assert got[0] == "ok"


def test_in_memory_repo_without_root():
    for P in (J, T):
        db = type("Db", (), {"config": {"workload_retention_keep": 64,
                                        "workload_retention_max_age_s":
                                            1e9}})()
        repo = P.workload.WorkloadRepository(db, root=None)
        a = repo.snapshot(cluster=False)
        b = repo.snapshot(cluster=False)
        assert repo.snapshot_ids() == [a["id"], b["id"]]
        rep = repo.build_report(a["id"], b["id"])
        assert (rep["from_id"], rep["to_id"]) == (a["id"], b["id"])


def test_every_virtual_table_listed_and_describable(tmp_path):
    db = T.db(tmp_path / "db")
    s = db.session()
    registry = sorted(db.virtual_tables.names())
    assert {"gv$workload_snapshot", "gv$workload_report", "gv$scrub",
            "v$errsim", "gv$disk"} <= set(registry)
    shown = {r[0] for r in s.execute("show tables").rows()}
    assert not [n for n in registry if n not in shown]
    for name in registry:
        assert s.execute(f"describe {name}").rowcount >= 1, name
    db.close()
