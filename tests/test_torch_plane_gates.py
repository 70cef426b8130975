"""The gates of ``oceanbase_tpu_torch/bench/{trace,metrics,profile,
workload,planqual}.py``: ``failures`` naming each broken gate of a
crafted record (the timing gates only when asked), and each
``scripts/torch_<plane>_bench.py`` twin run on the CPU at a small size:
one JSON line with the reference's fields, the exit code its gates give,
the gates that read device time failing on the CPU by definition, and no
file written into the repo (``--out`` writes where it is told)."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from oceanbase_tpu_torch.bench import (metrics, planqual, profile, trace,
                                       workload)
from torch_script import run_script

torch.set_num_threads(2)


def _overhead(**kw):
    return {"rows": 10, "repeats": 8, "off_s": 1.0, "on_s": 1.01,
            "overhead_pct": 1.0, "rows_equal": True, **kw}


def _profile_line():
    return {"overhead": _overhead(),
            "checks": {k: True for k in (
                "overhead_le_2pct", "all_queries_priced",
                "median_time_q_le_4x", "achieved_gflops_nonzero",
                "profile_rows_joined")}}


def _workload_line():
    return {"overhead": _overhead(phases_reconcile=True,
                                  phase_coverage_pct=99.0),
            "restart": {"crc_verified_after_restart": True,
                        "delta_reportable": True}}


def _planqual_line():
    return {"overhead": _overhead(),
            "feedback": {"on": {"answers_ok": True},
                         "off": {"answers_ok": True}},
            "checks": {k: True for k in (
                "qerror_all_operators", "cost_model_choices_recorded",
                "cost_model_ranking", "overhead_le_2pct",
                "feedback_one_retry", "ladder_without_feedback")}}


def _set(rec, path, value):
    rec = copy.deepcopy(rec)
    d = rec
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value
    return rec


#: (module, good record, path broken, value, the gate's name, timing)
BROKEN = {
    "trace rows_equal": (trace, _overhead(), ("rows_equal",), False,
                         "rows_equal", False),
    "trace overhead_pct": (trace, _overhead(), ("overhead_pct",), 2.5,
                           "overhead_pct", True),
    "metrics rows_equal": (metrics, _overhead(), ("rows_equal",), False,
                           "rows_equal", False),
    "metrics overhead_pct": (metrics, _overhead(), ("overhead_pct",), 3.0,
                             "overhead_pct", True),
    "profile rows_equal": (profile, _profile_line(),
                           ("overhead", "rows_equal"), False, "rows_equal",
                           False),
    "workload rows_equal": (workload, _workload_line(),
                            ("overhead", "rows_equal"), False, "rows_equal",
                            False),
    "workload crc": (workload, _workload_line(),
                     ("restart", "crc_verified_after_restart"), False,
                     "crc_verified_after_restart", False),
    "workload delta": (workload, _workload_line(),
                       ("restart", "delta_reportable"), False,
                       "delta_reportable", False),
    "workload overhead_pct": (workload, _workload_line(),
                              ("overhead", "overhead_pct"), 2.01,
                              "overhead_pct", True),
    "workload phases": (workload, _workload_line(),
                        ("overhead", "phases_reconcile"), False,
                        "phases_reconcile", True),
    "planqual rows_equal": (planqual, _planqual_line(),
                            ("overhead", "rows_equal"), False,
                            "rows_equal", False),
    "planqual feedback on": (planqual, _planqual_line(),
                             ("feedback", "on", "answers_ok"), False,
                             "feedback on answers_ok", False),
    "planqual feedback off": (planqual, _planqual_line(),
                              ("feedback", "off", "answers_ok"), False,
                              "feedback off answers_ok", False),
}
for _name in _profile_line()["checks"]:
    BROKEN[f"profile {_name}"] = (profile, _profile_line(),
                                  ("checks", _name), False, _name,
                                  _name in profile.TIMING)
for _name in _planqual_line()["checks"]:
    BROKEN[f"planqual {_name}"] = (planqual, _planqual_line(),
                                   ("checks", _name), False, _name,
                                   _name in planqual.TIMING)


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_failures_names_each_broken_gate(case):
    mod, good, path, value, name, timing = BROKEN[case]
    assert mod.failures(good) == [] and mod.failures(good, timing=False) == []
    bad = mod.failures(_set(good, path, value))
    assert len(bad) == 1 and bad[0].startswith(name), bad
    assert mod.failures(_set(good, path, value), timing=False) == \
        ([] if timing else bad)


#: (env at a small size, the gates that read device time and fail on the
#: CPU by definition, the record's top-level keys)
SCRIPTS = {
    "trace": ({"BENCH_ROWS": "2000", "BENCH_REPEATS": "8"}, [],
              {"metric", "overhead", "attribution", "ok"}),
    "metrics": ({"BENCH_ROWS": "2000", "BENCH_REPEATS": "8"}, [],
                {"metric", "overhead", "scrape", "ok"}),
    "workload": ({"BENCH_ROWS": "2000", "BENCH_REPEATS": "8"}, [],
                 {"metric", "overhead", "restart", "cluster", "ok"}),
    "profile": ({"PROFILE_SF": "0.01", "PROFILE_REPEATS": "16"},
                ["all_queries_priced", "achieved_gflops_nonzero"],
                {"metric", "sf", "backend", "roofline", "overhead",
                 "checks", "ok", "sysstat"}),
    "planqual": ({"PLANQUAL_SF": "0.01", "PLANQUAL_REPEATS": "16"},
                 ["cost_model_choices_recorded"],
                 {"metric", "sf", "coverage", "overhead", "feedback",
                  "skew", "checks", "ok", "sysstat"}),
}
MODULES = {"trace": trace, "metrics": metrics, "workload": workload,
           "profile": profile, "planqual": planqual}


@pytest.mark.parametrize("plane", sorted(SCRIPTS))
def test_script_prints_the_reference_line_on_the_cpu(plane, tmp_path):
    env, cpu_failing, keys = SCRIPTS[plane]
    out = tmp_path / "line.json"
    rc, rec, before, after = run_script(f"torch_{plane}_bench.py", env,
                                        ("--out", str(out)))
    assert before == after
    assert json.loads(out.read_text()) == rec
    assert set(rec) == keys and rec["metric"] == f"{plane}_bench"
    mod = MODULES[plane]
    part = rec["overhead"] if plane in ("trace", "metrics") else rec
    assert mod.failures(part, timing=False) == cpu_failing
    assert rc == (0 if rec["ok"] and not mod.failures(part) else 1)
