"""``oceanbase_tpu_torch/bench/overload.py`` (the port of
``scripts/overload_bench.py``) on the CPU: the whole record over a port
``Database`` held to ``failures``; the KILL and write-flood halves once
over each package's ``Database`` with their non-timing fields equal;
``failures`` naming each broken invariant of a synthetic record; and,
``slow``, the whole run over both packages at the reference script's
default size."""

from __future__ import annotations

import copy

import pytest
import torch

from oceanbase_tpu_torch.bench import overload
from torch_pair import J, T
from torch_script import run_script

torch.set_num_threads(2)


ROWS = 2000
WINDOW_S = 2.0
#: segments of ``big`` in the two-package case: the reference compiles
#: one program per 2^21-lane granule on the CPU, so 40 would take ~50 s
SEGMENTS = 4


def _run(P, root, rows=ROWS, window_s=WINDOW_S):
    db = P.db(root)
    try:
        return overload.run(db, rows, window_s,
                            overload.kill_work_area(rows), P.metrics)
    finally:
        db.close()


def test_port_run_holds_every_invariant(tmp_path):
    rec = _run(T, tmp_path)
    assert overload.failures(rec) == [], rec
    assert rec["ok"] is True
    sat = rec["saturation"]
    assert sat["offered"] == sum(sat["kinds"].values())
    assert sat["completed"] == sum(sat["completed_by_tenant"].values())
    assert sat["completed_by_tenant"]["quiet"] > 0
    assert set(rec) >= {"saturation", "fairness", "kill", "write_flood",
                        "ok", "sysstat"}
    assert rec["sysstat"]["admission.kills"] >= 1


def test_answers_match_numpy():
    b = overload.b_column(5000)
    a = overload.Answers(b)
    for t in (0, 1, 20, 50, 79, 90, 97, 200):
        m = b < t
        assert a.below(t) == (int(b[m].sum()), int(m.sum()))
    assert a.matches(50, [(int(b[b < 50].sum()), int((b < 50).sum()))])
    assert not a.matches(50, [(0, 0)])
    assert not a.matches(50, [])


def _kill_and_flood(P, root):
    db = P.db(root)
    try:
        for t in overload.TENANTS:
            db.create_tenant(t)
        answers = overload.Answers(overload.load(db, ROWS, SEGMENTS))
        k = overload.kill(db, answers, overload.kill_work_area(ROWS),
                          P.metrics)
        f = overload.write_flood(db)
    finally:
        db.close()
    return {
        "kill_typed": k["typed"], "kill_ok": k["ok"],
        "within_bound": k["kill_latency_s"] <= k["bound_s"],
        "checkpoints": k["checkpoints"],
        "mid_scan": k["victim_checkpoints"] < k["checkpoints"],
        "answer_ok": k["answer_ok"],
        "rerun_ok": k["rerun_ok"], "leftover": k["leftover"],
        "flood_ok": f["ok"],
        "peak_under_limit": f["peak_bytes"] <= f["limit_bytes"],
        "limit": f["limit_bytes"], "fulls": f["memstore_full_rejections"] > 0,
        "sleeps": f["throttle_sleeps"] > 0,
        "recovered": f["recovered_after_flush"],
        "untyped": f["untyped_errors"], "live": f["live_writers"],
    }


def test_kill_and_flood_equal_across_packages(tmp_path):
    want = _kill_and_flood(J, tmp_path / "jax")
    got = _kill_and_flood(T, tmp_path / "port")
    assert got == want, (got, want)
    assert got["kill_typed"] == "QueryKilled" and got["kill_ok"]
    assert got["checkpoints"] >= overload.MIN_CHECKPOINTS and got["mid_scan"]
    assert got["flood_ok"] and got["recovered"]


def _good_record() -> dict:
    return {
        "saturation": {"hung": 0, "untyped_errors": {}, "wrong_answers": 0},
        "fairness": {"quiet_share": 0.45},
        "kill": {"typed": "QueryKilled", "kill_latency_s": 0.1,
                 "bound_s": 0.5, "checkpoints": 80,
                 "victim_checkpoints": 1, "answer_ok": True,
                 "rerun_ok": True, "leftover": []},
        "write_flood": {"peak_bytes": 199_000, "limit_bytes": 200_000,
                        "memstore_full_rejections": 3, "throttle_sleeps": 4,
                        "untyped_errors": [], "recovered_after_flush": True,
                        "live_writers": 0},
    }


BROKEN = {
    "hung": ("saturation", "hung", 1),
    "untyped_errors": ("saturation", "untyped_errors", {"RuntimeError": 1}),
    "wrong_answers": ("saturation", "wrong_answers", 2),
    "quiet_share": ("fairness", "quiet_share", 0.1),
    "kill typed": ("kill", "typed", "ok"),
    "kill_latency_s": ("kill", "kill_latency_s", 0.9),
    "kill checkpoints": ("kill", "checkpoints", 2),
    "kill victim_checkpoints": ("kill", "victim_checkpoints", 80),
    "kill answer_ok": ("kill", "answer_ok", False),
    "kill rerun_ok": ("kill", "rerun_ok", False),
    "kill leftover": ("kill", "leftover", [[3, "KILLED", "select"]]),
    "flood peak_bytes": ("write_flood", "peak_bytes", 200_001),
    "flood memstore_full_rejections": ("write_flood",
                                       "memstore_full_rejections", 0),
    "flood throttle_sleeps": ("write_flood", "throttle_sleeps", 0),
    "flood untyped_errors": ("write_flood", "untyped_errors", ["EIO"]),
    "flood recovered_after_flush": ("write_flood", "recovered_after_flush",
                                    False),
    "flood live_writers": ("write_flood", "live_writers", 1),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_failures_names_each_broken_invariant(name):
    assert overload.failures(_good_record()) == []
    rec = copy.deepcopy(_good_record())
    half, key, value = BROKEN[name]
    rec[half][key] = value
    bad = overload.failures(rec)
    assert len(bad) == 1 and bad[0].startswith(name), bad


def test_script_prints_the_reference_line_on_the_cpu():
    rc, rec, before, after = run_script(
        "torch_overload_bench.py", {"BENCH_ROWS": "2000",
                                    "BENCH_WINDOW_S": "1"})
    assert rc == 0 and rec["ok"] is True and before == after
    assert {"metric", "rows", "stmt_deadline_s", "saturation", "fairness",
            "kill", "write_flood", "ok", "sysstat"} <= set(rec)
    assert rec["metric"] == "overload_bench" and rec["rows"] == 2000


#: the fields of the whole record that hold no timing or scheduling count
SAME = (("fairness", "fair_share"), ("fairness", "floor"),
        ("fairness", "ok"), ("saturation", "hung"),
        ("saturation", "untyped_errors"), ("saturation", "wrong_answers"),
        ("saturation", "clients"), ("kill", "typed"), ("kill", "ok"),
        ("kill", "checkpoints"), ("kill", "rerun_ok"),
        ("write_flood", "ok"), ("write_flood", "limit_bytes"),
        ("write_flood", "recovered_after_flush"))


@pytest.mark.slow
def test_whole_run_at_the_reference_default_both_packages(tmp_path):
    recs = {P.name: _run(P, tmp_path / P.name, 20_000, 8.0) for P in (J, T)}
    for P in (J, T):
        assert overload.failures(recs[P.name]) == [], (P, recs[P.name])
    got = {f"{h}.{k}": recs[T.name][h][k] for h, k in SAME}
    want = {f"{h}.{k}": recs[J.name][h][k] for h, k in SAME}
    assert got == want and recs[T.name]["ok"] == recs[J.name]["ok"]
