"""The port's disk manager against the JAX package's: per-surface
budgets, the log surface's reclaim (checkpoint + WAL recycle), read-only
entry and automatic exit, the data surface, the spill budget at the
temp-file store and through SQL, backup and archive under disk faults,
``gv$disk`` against ``du``, and the WAL recycle's restart identity.
Each scenario mirrors a case of ``tests/test_disk.py`` (297-560), runs
once per package, asserts the reference's expectations on each and
holds the two outcome records equal."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from torch_pair import T, both, du, outcome

torch.set_num_threads(2)


def _cfg(**kw):
    cfg = {"log_disk_limit_bytes": 0, "data_disk_limit_bytes": 0,
           "spill_disk_limit_bytes": 0,
           "log_disk_utilization_threshold": 80}
    cfg.update(kw)
    return cfg


# ---------------------------------------------------------------------------
# the temp-file store's spill budget
# ---------------------------------------------------------------------------


def _scn_spill_budget_kills(P, root):
    dm = P.DiskManager(_cfg(spill_disk_limit_bytes=1), paths={},
                       poll_interval_s=0.0)
    big = {"x": np.random.default_rng(0).integers(0, 1 << 30, 4096)}
    with P.TempFileStore(str(root / "spill"), budget=dm,
                         label="stmt-1") as store:
        rid = store.new_run()
        err = outcome(store.append_chunk, rid, big)
        left = os.listdir(store._chunk_dir(rid))
        out = [err, left, dm.usage("spill"), dm.spill_rejections]
    dm.admit_write()
    return out + [dm.read_only]


def test_spill_budget_kills_statement_only(tmp_path):
    assert both(_scn_spill_budget_kills, tmp_path) == \
        [("error", "SpillBudgetExceeded"), [], 0, 1, False]


def _scn_spill_accounting(P, root):
    dm = P.DiskManager(_cfg(spill_disk_limit_bytes=1 << 20), paths={})
    arrays = {"x": np.arange(256, dtype=np.int64)}
    with P.TempFileStore(str(root / "s"), budget=dm,
                         label="select heavy") as store:
        rid = store.new_run()
        store.append_chunk(rid, arrays)
        used = dm.usage("spill")
        stmt = [r for r in dm.stats(tenant="sys")
                if r["surface"] == "spill_stmt"]
        assert used > 0 and stmt[0]["used_bytes"] == used
        detail = stmt[0]["detail"]
        store.close_run(rid)
        after_close = dm.usage("spill")
        rid2 = store.new_run()
        store.append_chunk(rid2, arrays)
    # leaving the store sweeps what an unclosed run still held
    return [detail, after_close, dm.usage("spill")]


def test_spill_accounting_admit_release_and_stats(tmp_path):
    assert both(_scn_spill_accounting, tmp_path) == ["select heavy", 0, 0]


# ---------------------------------------------------------------------------
# backup and archive under disk faults
# ---------------------------------------------------------------------------


def _scn_backup_enospc(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i * 3})" for i in range(500)))
    fp = P.FaultPlane(seed=8)
    fp.disk("enospc", kind="backup")
    db.faults = fp
    dest = str(root / "b0")
    err = outcome(P.backup.full_backup, db, dest)
    half = os.path.exists(dest)
    full = P.backup.full_backup(db, dest)
    db.close()
    target = str(root / "restored")
    P.backup.restore_chain(full, target)
    db2 = P.db(target)
    got = db2.session().execute("select count(*), sum(v) from t").rows()
    db2.close()
    return [err, half, got]


def test_backup_enospc_typed_and_retry_restores(tmp_path):
    assert both(_scn_backup_enospc, tmp_path) == \
        [("error", "DiskFull"), False,
         [(500, sum(i * 3 for i in range(500)))]]


def _scn_archive_eio(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key)")
    s.execute("insert into t values (1), (2)")
    fp = P.FaultPlane(seed=9)
    fp.disk("eio", kind="backup")
    db.faults = fp
    err = outcome(P.backup.archive_wal, db, str(root / "arch"))
    P.backup.archive_wal(db, str(root / "arch"))
    files = sorted(os.path.relpath(os.path.join(d, f), str(root / "arch"))
                   for d, _s, fs in os.walk(str(root / "arch"))
                   for f in fs)
    db.close()
    return [err, files]


def test_wal_archive_eio_typed(tmp_path):
    assert both(_scn_archive_eio, tmp_path)[0] == ("error", "DiskIOError")


# ---------------------------------------------------------------------------
# DiskManager: budgets, reclaim, read-only enter and auto-exit
# ---------------------------------------------------------------------------


def _scn_readonly_enter_exit(P, root):
    d = str(root / "log")
    os.makedirs(d)
    f = os.path.join(d, "wal.log")
    with open(f, "wb") as fh:
        fh.write(b"x" * 1000)
    events = []
    dm = P.DiskManager(_cfg(log_disk_limit_bytes=500), paths={"log": [d]},
                       reclaim_cb=lambda: events.append("reclaim"),
                       on_readonly=lambda s: events.append(f"ro:{s}"),
                       on_exit_readonly=lambda: events.append("exit"),
                       poll_interval_s=0.0, reclaim_backoff_s=0.0)
    dm.poll(force=True)
    state = [dm.read_only, dm.state("log")]
    err = outcome(dm.admit_write)
    with open(f, "wb") as fh:
        fh.write(b"x" * 100)
    dm.poll(force=True)
    dm.admit_write()
    return [list(events), state, err, dm.write_rejections, dm.read_only]


def test_readonly_enter_and_autoexit(tmp_path):
    assert both(_scn_readonly_enter_exit, tmp_path) == \
        [["reclaim", "ro:log", "reclaim", "exit"], [True, "readonly"],
         ("error", "TenantReadOnly"), 1, False]


def _scn_reclaim_avoids_readonly(P, root):
    d = str(root / "log")
    os.makedirs(d)
    f = os.path.join(d, "wal.log")
    with open(f, "wb") as fh:
        fh.write(b"x" * 900)

    def reclaim():
        with open(f, "wb") as fh:
            fh.write(b"x" * 100)

    dm = P.DiskManager(_cfg(log_disk_limit_bytes=1000),
                       paths={"log": [d]}, reclaim_cb=reclaim,
                       poll_interval_s=0.0, reclaim_backoff_s=0.0)
    dm.poll(force=True)
    dm.admit_write()
    return [dm.reclaims, dm.read_only]


def test_reclaim_avoids_readonly(tmp_path):
    assert both(_scn_reclaim_avoids_readonly, tmp_path)[:2] == [1, False]


def _scn_data_surface(P, root):
    d = str(root / "data")
    os.makedirs(d)
    with open(os.path.join(d, "seg.npz"), "wb") as fh:
        fh.write(b"x" * 400)
    cfg = _cfg(data_disk_limit_bytes=300)
    dm = P.DiskManager(cfg, paths={"data": [d]}, poll_interval_s=0.0)
    dm.poll(force=True)
    entered = [dm.read_only, dm.readonly_surface]
    cfg["data_disk_limit_bytes"] = 10_000
    dm.poll(force=True)
    return [entered, dm.read_only]


def test_data_surface_readonly(tmp_path):
    assert both(_scn_data_surface, tmp_path) == [[True, "data"], False]


# ---------------------------------------------------------------------------
# the tenant's wiring: read-only through SQL, gv$disk, the spill budget
# ---------------------------------------------------------------------------


def _scn_tenant_readonly(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i})" for i in range(200)))
    dm = db.tenant("sys").diskmgr
    wal_before = du(dm.paths["log"])
    s.execute("alter system set log_disk_limit_bytes = 10")
    dm.poll(force=True)
    entered = [dm.reclaims >= 1, dm.read_only]
    err = outcome(s.execute, "insert into t values (9001, 1)")
    reads = s.execute("select count(*) from t").rows()
    view = s.execute("select surface, state from gv$disk"
                     " where surface = 'log'").rows()
    shrunk = du(dm.paths["log"]) < wal_before
    s.execute("alter system set log_disk_limit_bytes = 0")
    dm.poll(force=True)
    exited = [dm.read_only, dm.readonly_exits]
    s.execute("insert into t values (9001, 1)")
    after = s.execute("select count(*) from t").rows()
    db.close()
    db2 = P.db(root / "db")
    reopened = db2.session().execute("select count(*) from t").rows()
    db2.close()
    return [entered, err, reads, view, shrunk, exited, after, reopened]


def test_tenant_log_budget_readonly_reads_serve_then_autoexit(tmp_path):
    assert both(_scn_tenant_readonly, tmp_path) == \
        [[True, True], ("error", "TenantReadOnly"), [(200,)],
         [("log", "readonly")], True, [False, 1], [(201,)], [(201,)]]


def test_readonly_read_path_writes_nothing(tmp_path):
    """Under TenantReadOnly the read path keeps serving and writes
    nothing durable: ANALYZE's statistics, the plan cache, the monitor
    stores and a catalog re-upload after a data_version bump all stay
    in memory."""
    db = T.db(tmp_path / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 7})" for i in range(300)))
    t = db.tenant("sys")
    dm = t.diskmgr
    s.execute("alter system set log_disk_limit_bytes = 10")
    dm.poll(force=True)
    assert dm.read_only
    walked = {surface: du(dm.paths[surface]) for surface in ("log", "data")}
    t.catalog.invalidate("t")          # as after a data_version bump
    assert s.execute("analyze table t").rowcount is not None
    for _ in range(3):
        assert s.execute("select v, count(*) from t group by v"
                         " order by v").rows()[0] == (0, 43)
    s.execute("explain analyze select sum(v) from t where k > 5")
    s.execute("select count(*) from gv$sql_audit")
    with pytest.raises(T.diskmgr.TenantReadOnly):
        s.execute("update t set v = 1 where k = 3")
    assert {surface: du(dm.paths[surface])
            for surface in ("log", "data")} == walked
    db.close()


def _scn_gv_disk_du(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i})" for i in range(500)))
    db.checkpoint()
    s.execute("alter system set log_disk_limit_bytes = 1073741824")
    s.execute("alter system set data_disk_limit_bytes = 1073741824")
    dm = db.tenant("sys").diskmgr
    rows = s.execute("select surface, used_bytes, limit_bytes, state"
                     " from gv$disk order by surface").rows()
    by_surface = {r[0]: r for r in rows}
    for surface in ("log", "data"):
        d = du(dm.paths[surface])
        used = by_surface[surface][1]
        assert abs(used - d) <= max(1, d) * 0.05, (surface, used, d)
    db.close()
    return [(r[0], r[2], r[3]) for r in rows]


def test_gv_disk_matches_du_within_5pct(tmp_path):
    out = both(_scn_gv_disk_du, tmp_path)
    assert ("log", 1 << 30, "ok") in out and ("data", 1 << 30, "ok") in out


def _scn_spill_budget_sql(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {(i * 7919) % 100000})" for i in range(3000)))
    s.execute("alter system set sql_work_area_rows = 100")
    s.execute("alter system set spill_disk_limit_bytes = 1")
    err = outcome(s.execute, "select k, v from t order by v, k")
    dm = db.tenant("sys").diskmgr
    tmp = os.path.join(str(root / "db"), "tmpfile")
    residue = [f for _d, _s, fs in os.walk(tmp) for f in fs] \
        if os.path.isdir(tmp) else []
    state = [dm.read_only, dm.usage("spill"), residue]
    s.execute("insert into t values (9001, 1)")
    n = s.execute("select count(*) from t").rows()
    s.execute("alter system set spill_disk_limit_bytes = 1073741824")
    got = s.execute("select k, v from t order by v, k").rows()
    db.close()
    return [err, state, n, got]


def test_statement_spill_budget_via_sql(tmp_path):
    err, state, n, got = both(_scn_spill_budget_sql, tmp_path)
    assert err == ("error", "SpillBudgetExceeded")
    assert state == [False, 0, []] and n == [(3001,)]
    assert len(got) == 3001 and got == sorted(got, key=lambda r: (r[1], r[0]))


# ---------------------------------------------------------------------------
# the WAL recycle the log reclaim runs
# ---------------------------------------------------------------------------


def _scn_wal_recycle(P, root, upto):
    r = P.PalfReplica(0, log_dir=str(root / "wal"))
    r.role, r.current_term = "leader", 1
    r.leader_append([f"p{i}".encode() for i in range(40)])
    r.advance_commit(40)
    before = os.path.getsize(r._log_path())
    freed = r.recycle(upto)
    after = os.path.getsize(r._log_path())
    oracle = [(e.term, e.lsn, e.payload) for e in r.entries]
    r.close()
    r2 = P.PalfReplica(0, log_dir=str(root / "wal"))
    assert [(e.term, e.lsn, e.payload) for e in r2.entries] == oracle
    got = r2.entries_from(upto)
    out = [freed > 0, after < before, (r2.base_lsn, r2.base_term),
           r2.committed_lsn, r2.applied_lsn, r2.entries_from(upto - 15),
           [e.lsn for e in got], after,
           open(r._log_path(), "rb").read()]
    r2.close()
    return out


@pytest.mark.parametrize("upto", [25, 39])
def test_wal_recycle_restart_identical_and_smaller(tmp_path, upto):
    out = both(_scn_wal_recycle, tmp_path, upto)
    assert out[:6] == [True, True, (upto, 1), upto, upto, None]
    assert out[6] == list(range(upto + 1, 41))
