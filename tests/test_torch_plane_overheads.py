"""The overhead and time-model halves of ``oceanbase_tpu_torch/bench/
{trace,metrics,profile,workload,planqual}.py`` (the ports of the
reference's ``scripts/*_bench.py``) over each package's ``Database`` on
the CPU: 2,000 rows of the TPC-H slice INSERTed into one database per
package, each plane toggled in turn; every non-timing field equal across
the packages (the on/off answers, the passes counted, the time model's
phase names), and every knob a half flips put back as it was."""

from __future__ import annotations

import math

import pytest
import torch

from oceanbase_tpu_torch.bench import (metrics, planes, planqual, profile,
                                       trace, workload)
from torch_pair import J, T

torch.set_num_threads(2)

ROWS = 2000
REPEATS = 8


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    out = {}
    for P in (J, T):
        db = P.db(tmp_path_factory.mktemp(P.name))
        s = db.session()
        planes.load_inserts(s, ROWS)
        s.close()
        out[P.name] = (P, db)
    yield out
    for _P, db in out.values():
        db.close()


HALVES = {
    "trace": (lambda P, db: trace.overhead(db, REPEATS), trace.KNOBS),
    "metrics": (lambda P, db: metrics.overhead(db, REPEATS, P.metrics),
                metrics.KNOBS),
    "profile": (lambda P, db: profile.overhead(db, REPEATS),
                profile.OVERHEAD_KNOBS),
    "planqual": (lambda P, db: planqual.overhead(db, REPEATS),
                 planqual.OVERHEAD_KNOBS),
    "workload": (lambda P, db: workload.overhead_and_phases(db, REPEATS),
                 workload.KNOBS),
}
#: the fields of each record that hold no time
SAME = ("repeats", "rows_equal", "time_model_names", "statements")


def _answers_close(a: dict, b: dict) -> bool:
    """Equal rows, floats (the slice's avg) at rtol 1e-12."""
    if a.keys() != b.keys():
        return False
    for k in a:
        if len(a[k]) != len(b[k]):
            return False
        for ra, rb in zip(a[k], b[k]):
            if len(ra) != len(rb) or not all(
                    math.isclose(x, y, rel_tol=1e-12)
                    if isinstance(x, float) else x == y
                    for x, y in zip(ra, rb)):
                return False
    return True


@pytest.mark.parametrize("plane", sorted(HALVES))
def test_overhead_half_equal_across_packages(dbs, plane):
    fn, knobs = HALVES[plane]
    recs = {}
    for name, (P, db) in dbs.items():
        before = {k: db.config[k] for k in knobs}
        recs[name] = fn(P, db)
        assert {k: db.config[k] for k in knobs} == before, (plane, name)
        assert P.metrics.enabled()
    got, want = recs[T.name], recs[J.name]
    assert got["rows_equal"] is True and want["rows_equal"] is True
    assert _answers_close(got["answers"], want["answers"])
    assert {k: got[k] for k in SAME if k in want} == \
        {k: want[k] for k in SAME if k in want}
    assert {k for k in got if k != "answers"} >= \
        {k for k in want if k != "answers"}
    for k in ("overhead_pct", "off_s", "on_s"):
        assert math.isfinite(got[k]) and got["off_s"] > 0.0


def test_time_model_phases_are_the_reference_s(dbs):
    recs = {name: workload.overhead_and_phases(db, REPEATS)
            for name, (_P, db) in dbs.items()}
    got, want = recs[T.name], recs[J.name]
    assert sorted(got["phases"]) == sorted(want["phases"]) == \
        sorted(workload.PHASES)
    assert got["time_model_names"] == want["time_model_names"]
    # the loop's statements, each charged once
    assert got["statements"] == want["statements"] == \
        2 * max(REPEATS // 2, workload.MIN_LOOP)
    # on the CPU the port's device half is 0 by definition (no event
    # pair) and its dispatch phase is the execution's wall
    assert got["phases"]["device_s"] == 0.0 and \
        got["phases"]["dispatch_s"] > 0.0
    assert 0.0 < got["phase_sum_s"] <= got["elapsed_s"]
    assert got["phases_reconcile"] == (
        90.0 <= got["phase_coverage_pct"] <= 110.0)


def test_the_slice_is_the_reference_s():
    cols = planes.gen(1000)
    assert sorted(cols) == ["l_discount", "l_extendedprice",
                            "l_linestatus", "l_quantity", "l_returnflag",
                            "l_shipdate"]
    assert int(cols["l_quantity"].min()) >= 1 and \
        int(cols["l_quantity"].max()) < 50
    assert (planes.gen(1000)["l_shipdate"] == cols["l_shipdate"]).all()
    assert planes.median([3, 1, 2]) == 2 and planes.median([4, 1]) == 2.5
    assert planes.median([]) is None
    assert planes.trimmed_mean([100.0, 1.0, 2.0, 3.0]) == 2.5


class _Event:
    """A stand-in CUDA event pair: 30 ms between the two."""

    def elapsed_time(self, other):
        return 30.0

    def query(self):
        return True


def test_time_model_device_phase_is_the_wait_past_dispatch(dbs, monkeypatch):
    """ROADMAP Queue 3 #33: the reference's device phase is the host's
    ``block_until_ready`` after dispatch, so its phases are disjoint
    slices of the wall; the port's ``device_s`` is a stream span that
    overlaps its dispatch, and gv$time_model charges only the part past
    each execution's host window (``device_wait_s``)."""
    from oceanbase_tpu_torch.exec import plan as tplan

    # the reference: dispatch, then the wait, one after the other
    for name, (_P, db) in dbs.items():
        tm0 = db.time_model.snapshot()["sys"]
        planes.time_queries(db.session(), 3)
        tm1 = db.time_model.snapshot()["sys"]
        d = {k: tm1[k] - tm0[k] for k in tm1}
        assert d["dispatch_s"] + d["device_s"] <= d["elapsed_s"], (name, d)
    # the port: a 30 ms span over a 20 ms host window waits 10 ms
    tplan.reset_exec_times()
    ex = tplan._Execution()
    ex.ev0 = ex.ev1 = ex.done = _Event()
    ex.stats, ex.host_s = None, 0.020
    tplan._finish(ex)
    times = tplan.exec_times()
    assert math.isclose(times.device_s, 0.030)
    assert math.isclose(times.device_wait_s, 0.010)
    tplan.reset_exec_times()
    # and the session charges that wait, not the span
    _T, db = dbs[T.name]
    monkeypatch.setattr(tplan, "exec_times", lambda: tplan.ExecTimes(
        device_s=0.5, device_wait_s=0.1, dispatch_s=0.2))
    tm0 = db.time_model.snapshot()["sys"]
    db.session().execute("select 1")
    tm1 = db.time_model.snapshot()["sys"]
    assert math.isclose(tm1["device_s"] - tm0["device_s"], 0.1)
    assert math.isclose(tm1["dispatch_s"] - tm0["dispatch_s"], 0.2)
