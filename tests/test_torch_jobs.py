"""The DBMS job scheduler (``server/jobs.py``) on both packages' Database
on the CPU: the three cases of ``tests/test_dbms_jobs.py`` (stats
auto-gather, a custom SQL job, a failing job recorded), reading the
scheduler's own records where the reference reads ``v$dbms_jobs``;
and the thread's life: not started at boot unless ``enable_dbms_jobs``,
stopped by ``Database.close()``."""

import time

import pytest
import torch

from oceanbase_tpu_torch.server.database import Database
from test_torch_database import _jdb

torch.set_num_threads(2)


@pytest.fixture(params=["reference", "port"])
def db(request, tmp_path):
    d = (_jdb(tmp_path / "db") if request.param == "reference"
         else Database(str(tmp_path / "db"), device="cpu"))
    yield d
    d.close()


def _until(cond, what, timeout_s=10.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(what)


def test_stats_auto_gather(db):
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 7})" for i in range(500)))
    db.jobs.tick_s = 0.05
    db.jobs.schedule_fn("stats_gather", 0.1, db.jobs._stats_gather)
    db.jobs.start()
    # exact NDV only comes from ANALYZE
    _until(lambda: s.catalog.table_def("t").ndv.get("v") == 7,
           "stats job never gathered exact NDV")
    _until(lambda: db.jobs.jobs["stats_gather"]["runs"] >= 1,
           "stats job run not recorded")


def test_custom_sql_job(db):
    s = db.session()
    s.execute("create table log (k int primary key auto_increment, "
              "v int)")
    db.jobs.tick_s = 0.05
    db.jobs.schedule("writer", 0.1, "insert into log (v) values (1)")
    db.jobs.start()
    _until(lambda: s.execute("select count(*) from log").rows()[0][0] >= 2,
           "custom job never ran twice")
    db.jobs.cancel("writer")


def test_job_failure_recorded(db):
    db.jobs.tick_s = 0.05
    db.jobs.schedule("bad", 0.1, "select * from missing_table")
    db.jobs.start()
    _until(lambda: db.jobs.jobs.get("bad", {}).get("failures", 0) >= 1,
           "failure never recorded")
    assert any(h["job"] == "bad" and not h["ok"]
               for h in db.jobs.history)


def test_job_thread_starts_with_the_knob_and_stops_on_close(tmp_path):
    db = Database(str(tmp_path / "a"), device="cpu")
    assert db.jobs._thread is None
    assert set(db.jobs.jobs) == {"stats_gather", "auto_compact"}
    db.close()
    db = Database(str(tmp_path / "b"), device="cpu")
    db.session().execute("alter system set enable_dbms_jobs = true")
    db.close()
    db = Database(str(tmp_path / "b"), device="cpu")   # persisted knob
    th = db.jobs._thread
    assert th is not None and th.is_alive()
    db.close()
    assert not th.is_alive() and db.jobs._thread is None
