"""Statement admission, deadlines and KILL in the port, against the JAX
package's ``server/admission.py`` on the CPU.

The cases of ``tests/test_admission.py`` that do not touch the memstore
throttle, RPC, DTL or ``gv$`` tables: the controller cases run on both
packages' controllers, the SQL cases on the port's ``Database``.  Then
one scripted schedule of acquires, releases and kills over three
weighted tenants and one slot runs on both controllers, and the grants
come in the same order.  Statements that must still be running when a
KILL or a deadline lands run a stored procedure's loop, whose every
iteration passes ``execute_plan``'s checkpoints, so no case depends on
how fast the host is.
"""

from __future__ import annotations

import os
import threading
import time
import traceback

import pytest
import torch

from oceanbase_tpu.server import admission as jadm
from oceanbase_tpu.server.config import Config as JConfig
from oceanbase_tpu_torch.server import admission as tadm
from oceanbase_tpu_torch.server.config import Config as TConfig
from oceanbase_tpu_torch.server.database import Database

torch.set_num_threads(2)

PKGS = {"reference": (jadm, JConfig), "port": (tadm, TConfig)}


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """(admission module, Config class) of one package."""
    return PKGS[request.param]


def _cfg(cfg_cls, **over):
    c = cfg_cls()
    for k, v in over.items():
        c.set(k, v)
    return c


def _ctx(m, sid=1, tenant="sys", timeout_s=None, controller=None):
    return m.StmtCtx(session_id=sid, tenant=tenant, timeout_s=timeout_s,
                     controller=controller)


def _wait(cond, timeout_s=10.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError("timed out waiting")
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# controller cases (both packages)
# ---------------------------------------------------------------------------


def test_slot_checkout_release_and_stats(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=2,
                                     admission_tenant_slots=2))
    a, b = _ctx(m, 1), _ctx(m, 2)
    adm.acquire(a)
    adm.acquire(b)
    assert adm.active_slots() == 2
    adm.release(a)
    adm.release(b)
    assert adm.active_slots() == 0
    row = adm.stats()[0]
    assert row["tenant"] == "sys" and row["admitted"] == 2


def test_full_queue_rejects_serverbusy_fast(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=1,
                                     admission_tenant_slots=1,
                                     admission_queue_limit=0))
    adm.acquire(_ctx(m, 1))
    t0 = time.monotonic()
    with pytest.raises(m.ServerBusy):
        adm.acquire(_ctx(m, 2))
    assert time.monotonic() - t0 < 1.0
    assert adm.stats()[0]["rejected"] == 1


def test_queue_wait_budget_rejects_typed(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=1,
                                     admission_tenant_slots=1,
                                     admission_queue_limit=4,
                                     admission_queue_timeout_s=0.15))
    adm.acquire(_ctx(m, 1))
    t0 = time.monotonic()
    with pytest.raises(m.ServerBusy):
        adm.acquire(_ctx(m, 2))
    assert 0.1 <= time.monotonic() - t0 < 2.0


def test_queued_statement_grants_on_release(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=1,
                                     admission_tenant_slots=1))
    a = _ctx(m, 1)
    adm.acquire(a)
    got = []

    def waiter():
        c = _ctx(m, 2)
        adm.acquire(c)
        got.append(c)
        adm.release(c)

    th = threading.Thread(target=waiter)
    th.start()
    _wait(lambda: adm.queue_depth("sys") == 1)
    assert not got
    adm.release(a)
    th.join(5)
    assert got and got[0].queue_s > 0


def _grant_order(m, C, weights, waiters, kills=()):
    """One slot held; ``waiters`` [(sid, tenant)] queue one after the
    other; ``kills`` are sids killed while queued.  The slot is then
    passed on grant by grant -> [sid in grant order], [killed sids]."""
    cfg = _cfg(C, admission_slots=1, admission_tenant_slots=1,
               admission_queue_limit=16, admission_queue_timeout_s=30.0)
    adm = m.AdmissionController(cfg, weight_of=lambda t: weights.get(t, 1))
    hold = _ctx(m, 0)
    adm.acquire(hold)
    granted, killed, ctxs = [], [], {}
    lock = threading.Lock()

    def waiter(sid, tenant):
        c = _ctx(m, sid, tenant)
        ctxs[sid] = c
        try:
            adm.acquire(c)
        except m.QueryKilled:
            with lock:
                killed.append(sid)
            return
        with lock:
            granted.append(sid)

    threads = []
    depth = 0
    for sid, tenant in waiters:
        th = threading.Thread(target=waiter, args=(sid, tenant))
        th.start()
        threads.append(th)
        depth += 1
        _wait(lambda: sum(r["queue_depth"] for r in adm.stats()) == depth)
    for sid in kills:
        ctxs[sid].kill()
        _wait(lambda: sid in killed)
    holder = hold
    for n in range(len(waiters) - len(kills)):
        adm.release(holder)
        _wait(lambda: len(granted) == n + 1)
        holder = ctxs[granted[-1]]
    adm.release(holder)
    for th in threads:
        th.join(5)
    assert adm.active_slots() == 0
    return granted, killed


def test_wrr_fairness_across_tenants(pkg):
    """One slot, a loud tenant with 8 waiters and a quiet one with 2:
    round-robin interleaves grants."""
    m, C = pkg
    order, _ = _grant_order(
        m, C, {}, [(10 + i, "loud") for i in range(8)] +
        [(50 + i, "quiet") for i in range(2)])
    tenants = ["quiet" if s >= 50 else "loud" for s in order]
    assert tenants[:6].count("quiet") == 2, tenants


def test_wrr_weight_biases_grants(pkg):
    m, C = pkg
    order, _ = _grant_order(
        m, C, {"heavy": 2, "light": 1},
        [(10 + i, "heavy") for i in range(4)] +
        [(50 + i, "light") for i in range(4)])
    tenants = ["light" if s >= 50 else "heavy" for s in order]
    assert tenants.count("heavy") == 4 and tenants[:3].count("heavy") >= 2


def test_scripted_schedule_grants_in_the_same_order():
    """Three tenants with weights 3, 1 and 2 queue 12 statements behind
    one slot, two of them are killed while queued, and the slot passes
    on grant by grant: both controllers grant in the same order."""
    weights = {"a": 3, "b": 1, "c": 2}
    waiters = [(sid, "abc"[(sid * 7) % 3]) for sid in range(1, 13)]
    out = {name: _grant_order(m, C, weights, waiters, kills=(5, 9))
           for name, (m, C) in PKGS.items()}
    assert out["port"] == out["reference"]
    granted, killed = out["port"]
    assert sorted(killed) == [5, 9] and len(granted) == 10


def test_kill_while_queued_raises_querykilled(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=1,
                                     admission_tenant_slots=1,
                                     admission_queue_timeout_s=30.0))
    adm.acquire(_ctx(m, 1))
    victim = _ctx(m, 2)
    err = []

    def waiter():
        try:
            adm.acquire(victim)
        except BaseException as e:  # noqa: BLE001 — captured for assert
            err.append(e)

    th = threading.Thread(target=waiter)
    th.start()
    _wait(lambda: adm.queue_depth("sys") == 1)
    victim.kill()
    th.join(5)
    assert err and isinstance(err[0], m.QueryKilled)


def test_checkpoint_timeout_and_kill(pkg):
    m, _C = pkg
    ctx = _ctx(m, timeout_s=0.05)
    with m.activate(ctx):
        m.checkpoint()
        time.sleep(0.08)
        with pytest.raises(m.QueryTimeout):
            m.checkpoint()
    ctx2 = _ctx(m)
    with m.activate(ctx2):
        ctx2.kill()
        with pytest.raises(m.QueryKilled):
            m.checkpoint()
    m.checkpoint()  # no active ctx: no-op


def test_large_query_demotion_frees_slot(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=1,
                                     admission_tenant_slots=1,
                                     large_query_threshold_s=0.01,
                                     admission_large_slots=2,
                                     admission_queue_timeout_s=30.0))
    big = _ctx(m, 1, controller=adm)
    adm.acquire(big)
    got = []

    def pointq():
        c = _ctx(m, 2)
        adm.acquire(c)
        got.append(c)
        adm.release(c)

    th = threading.Thread(target=pointq)
    th.start()
    _wait(lambda: adm.queue_depth("sys") == 1)
    time.sleep(0.02)
    assert not got
    with m.activate(big):
        m.checkpoint()  # past the threshold: demotes to the large lane
    th.join(5)
    assert got
    assert big.lane == "large" and big.demoted
    adm.release(big)
    assert adm.active_slots() == 0


def test_release_after_rejection_does_not_over_admit(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=1,
                                     admission_tenant_slots=1,
                                     admission_queue_limit=0))
    holder = _ctx(m, 1)
    adm.acquire(holder)
    loser = _ctx(m, 2)
    with pytest.raises(m.ServerBusy):
        adm.acquire(loser)
    adm.release(loser)
    assert adm.active_slots() == 1
    with pytest.raises(m.ServerBusy):
        adm.acquire(_ctx(m, 3))
    adm.release(holder)
    assert adm.active_slots() == 0


def test_release_survives_knob_toggle_mid_statement(pkg):
    m, C = pkg
    cfg = _cfg(C, admission_slots=2, admission_tenant_slots=2)
    adm = m.AdmissionController(cfg)
    a = _ctx(m, 1)
    adm.acquire(a)
    cfg.set("enable_admission", False)
    adm.release(a)
    cfg.set("enable_admission", True)
    assert adm.active_slots() == 0
    cfg.set("enable_admission", False)
    b = _ctx(m, 2)
    adm.acquire(b)
    cfg.set("enable_admission", True)
    adm.release(b)
    assert adm.active_slots() == 0


def test_demotion_denied_then_killed_frees_exactly_once(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=2,
                                     admission_tenant_slots=2,
                                     admission_large_slots=1,
                                     large_query_threshold_s=0.01))
    occupier = _ctx(m, 1, controller=adm)
    adm.acquire(occupier)
    with m.activate(occupier):
        time.sleep(0.02)
        m.checkpoint()
    assert occupier.lane == "large"
    victim = _ctx(m, 2, controller=adm)
    adm.acquire(victim)
    err = []

    def run():
        with m.activate(victim):
            try:
                time.sleep(0.02)
                m.checkpoint()  # demotes; large lane full -> parks
            except BaseException as e:  # noqa: BLE001 — captured
                err.append(e)

    th = threading.Thread(target=run)
    th.start()
    time.sleep(0.15)
    victim.kill()
    th.join(5)
    assert err and isinstance(err[0], m.QueryKilled)
    adm.release(victim)
    assert adm.active_slots() == 1
    adm.release(occupier)
    assert adm.active_slots() == 0


def test_large_lane_is_per_tenant(pkg):
    m, C = pkg
    adm = m.AdmissionController(_cfg(C, admission_slots=4,
                                     admission_tenant_slots=4,
                                     admission_large_slots=2,
                                     large_query_threshold_s=0.01))
    a = m.StmtCtx(session_id=1, tenant="t1", controller=adm)
    adm.acquire(a)
    with m.activate(a):
        time.sleep(0.02)
        m.checkpoint()
    b = m.StmtCtx(session_id=2, tenant="t2", controller=adm)
    adm.acquire(b)
    rows = {r["tenant"]: r for r in adm.stats()}
    assert rows["t1"]["large_in_use"] == 1 and rows["t2"]["large_in_use"] == 0
    adm.release(a)
    adm.release(b)
    assert {r["tenant"]: r for r in adm.stats()}["t1"]["large_in_use"] == 0


# ---------------------------------------------------------------------------
# SQL cases (the port's Database)
# ---------------------------------------------------------------------------


@pytest.fixture()
def db(tmp_path):
    d = Database(str(tmp_path / "db"), device="cpu")
    yield d
    d.close()


SPIN = ("create procedure spin(in n int) begin declare i int default 0; "
        "while i < n do select sum(b), count(*) from big where b < 70; "
        "set i = i + 1; end while; end")


def _load_big(s, n=4000):
    s.execute("create table big (a int primary key, b int)")
    vals = ", ".join(f"({i}, {i % 97})" for i in range(n))
    s.execute(f"insert into big values {vals}")


def _in_thread(s, sql):
    res: dict = {}

    def run():
        try:
            res["r"] = s.execute(sql)
        except BaseException as e:  # noqa: BLE001 — captured
            res["e"] = e

    th = threading.Thread(target=run)
    th.start()
    return th, res


def _state(db, sid):
    return db.ash.sessions().get(sid, {}).get("state")


def test_query_timeout_typed_sql(db):
    """SET query_timeout_s bounds a statement; over the spill tier the
    deadline lands at a host batch (the first checkpoint there)."""
    s = db.session()
    _load_big(s)
    db.config.set("sql_work_area_rows", 512)  # the spill route
    s.execute("set query_timeout_s = 0.001")
    with pytest.raises(tadm.QueryTimeout) as ei:
        s.execute("select sum(b), count(*) from big where b < 90")
    frames = [f.name for f in traceback.extract_tb(ei.value.__traceback__)]
    assert "_host_batch" in frames
    db.config.set("sql_work_area_rows", 1 << 22)
    s.execute(SPIN)
    s.execute("set query_timeout_s = 0.3")
    t0 = time.monotonic()
    with pytest.raises(tadm.QueryTimeout):
        s.execute("call spin(1000000)")
    assert time.monotonic() - t0 < 10
    # the deadline is per statement, not sticky damage
    s.execute("set query_timeout_s = 3600")
    assert s.execute("select count(*) from big").rows() == [(4000,)]
    assert db.admission.active_slots() == 0


def test_kill_query_mid_statement_and_hygiene(db):
    """KILL unwinds a statement whose loop spills at every iteration; no
    spill directory is left, no admission slot leaks, the session stays
    usable."""
    s = db.session()
    _load_big(s)
    s.execute(SPIN)
    db.config.set("sql_work_area_rows", 512)
    killer = db.session()
    th, res = _in_thread(s, "call spin(1000000)")
    _wait(lambda: _state(db, s.session_id) == "executing" and
          s.last_spill is not None)
    assert killer.execute(f"kill query {s.session_id}").rowcount == 1
    th.join(15)
    assert not th.is_alive(), "killed statement hung"
    assert isinstance(res.get("e"), tadm.QueryKilled)
    tmpdir = os.path.join(db.root, "tmpfile")
    assert (os.listdir(tmpdir) if os.path.isdir(tmpdir) else []) == []
    assert db.admission.active_slots() == 0
    assert s.execute("select 1").rows() == [(1,)]
    assert _state(db, s.session_id) == "idle"


def test_kill_reaches_queued_statement(db):
    db.config.set("admission_slots", 1)
    db.config.set("admission_tenant_slots", 1)
    db.config.set("admission_queue_timeout_s", 30.0)
    hold = tadm.StmtCtx(session_id=998, tenant="sys")
    db.admission.acquire(hold)
    s, killer = db.session(), db.session()
    th, res = _in_thread(s, "select 1")
    _wait(lambda: _state(db, s.session_id) == "queued")
    rows = killer.execute("show processlist").rows()
    assert (s.session_id, "QUEUED", "select 1") in rows
    assert killer.execute(f"kill {s.session_id}").rowcount == 1
    th.join(10)
    assert isinstance(res.get("e"), tadm.QueryKilled)
    db.admission.release(hold)
    assert db.admission.active_slots() == 0


def test_kill_unknown_session_and_idle_session(db):
    s = db.session()
    with pytest.raises(KeyError):
        s.execute("kill query 987654")
    with pytest.raises(KeyError):
        s.execute("kill 987654")
    s2 = db.session()
    assert s.execute(f"kill query {s2.session_id}").rowcount == 0
    assert s2.execute("select 1").rows() == [(1,)]
    assert s.execute(f"kill {s2.session_id}").rowcount == 1
    with pytest.raises(tadm.QueryKilled):
        s2.execute("select 1")
    s2.close()
    s3 = db.session()  # a fresh session (reconnect) works
    assert s3.execute("select 1").rows() == [(1,)]


def test_serverbusy_typed_under_saturation(db):
    """One slot and no queue: while one statement runs, a second
    rejects typed at once; the first finishes correctly."""
    db.config.set("admission_slots", 1)
    db.config.set("admission_tenant_slots", 1)
    db.config.set("admission_queue_limit", 0)
    s1, s2 = db.session(), db.session()
    _load_big(s1, n=400)
    s1.execute(SPIN)
    th, res = _in_thread(s1, "call spin(200)")
    _wait(lambda: _state(db, s1.session_id) == "executing")
    t0 = time.monotonic()
    with pytest.raises(tadm.ServerBusy):
        s2.execute("select count(*) from big")
    assert time.monotonic() - t0 < 1.0
    th.join(60)
    assert "e" not in res, res
    assert s1.execute("select count(*) from big").rows() == [(400,)]


def test_show_processlist_states(db):
    s = db.session()
    s.execute("create table t (a int primary key)")
    r = s.execute("show processlist")
    i = r.names.index("state")
    states = {row[i] for row in r.rows()}
    assert states <= {"RUNNING", "QUEUED", "KILLED", "IDLE"}
    assert "RUNNING" in states  # this statement itself
    s2 = db.session()
    assert (s2.session_id, "IDLE", "") in s.execute(
        "show processlist").rows()
    s2.close()
    assert s2.session_id not in {
        row[0] for row in s.execute("show processlist").rows()}


def test_session_close_rolls_back_and_forgets(db):
    """A client that goes away mid-transaction leaves no table lock and
    no eviction flag behind."""
    s, s2 = db.session(), db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("set global lock_wait_timeout_s = 0.2")
    s.execute("lock tables t write")
    s.execute("insert into t values (1, 1)")
    s2.execute(f"kill {s.session_id}")
    s.close()
    s2.execute("insert into t values (2, 2)")  # the lock went with it
    assert s2.execute("select k from t order by k").rows() == [(2,)]
    assert s.session_id not in db.ash.sessions()
    assert db.admission.active_slots() == 0


def test_concurrent_acquire_release_keeps_the_slot_bound():
    """More threads than cores acquire and release across three tenants
    with a short switch interval: no more than ``admission_slots`` are
    ever admitted at once, every statement is admitted once, and every
    slot comes back."""
    import sys

    adm = tadm.AdmissionController(
        _cfg(TConfig, admission_slots=3, admission_tenant_slots=2,
             admission_queue_limit=64, admission_queue_timeout_s=30.0))
    lock = threading.Lock()
    live, peak, done = [0], [0], []
    n_threads, per_thread = 16, 40

    def worker(i):
        for j in range(per_thread):
            c = _ctx(tadm, sid=i * 1000 + j, tenant="abc"[(i + j) % 3])
            adm.acquire(c)
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            with lock:
                live[0] -= 1
            adm.release(c)
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert sorted(done) == list(range(n_threads))
    assert 1 <= peak[0] <= 3
    assert adm.active_slots() == 0
    assert sum(r["admitted"] for r in adm.stats()) == n_threads * per_thread
    assert all(r["queue_depth"] == 0 for r in adm.stats())
