"""The gates of ``oceanbase_tpu_torch/bench/{trace,metrics,profile,
workload,planqual,scrub}.py``: each ``failures`` naming each broken gate
of a crafted record (the timing gates only when asked), the cluster
halves' records included, and each ``scripts/torch_<plane>_bench.py``
twin run on the CPU at a small size with its cluster half skipped, as
the reference's ``*_SKIP_CLUSTER`` knobs skip it: one JSON line with the
reference's skipped shape, the exit code its gates give, the gates that
read device time failing on the CPU by definition, and no file written
into the repo (``--out`` writes where it is told).  The twins' cluster
halves run in ``tests/test_torch_plane_cluster.py`` (slow here), the
scrub twin in ``tests/test_torch_scrub_bench.py``."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from oceanbase_tpu_torch.bench import (metrics, planqual, profile, scrub,
                                       trace, workload)
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


def _skew():
    table = {"max_slice_rows": 10, "mean_slice_rows": 10.0, "parts": 3,
             "answer_rows": 10, "pushdown_hit": 1}
    return {"rows": 30, "matching": 10,
            "skewed": {**table, "slice_skew": 3.0},
            "uniform": {**table, "slice_skew": 1.0}}


def _planqual_line():
    return {"overhead": _overhead(),
            "feedback": {"on": {"answers_ok": True},
                         "off": {"answers_ok": True}},
            "skew": _skew(),
            "checks": {k: True for k in (
                "qerror_all_operators", "cost_model_choices_recorded",
                "cost_model_ranking", "overhead_le_2pct",
                "feedback_one_retry", "ladder_without_feedback",
                "skew_visible")}}


def _attribution():
    return {"slowest_span": "rpc.dtl.execute", "slowest_span_tags":
            {"peer": 2}, "slowest_elapsed_s": 0.41, "attribution_ok": True,
            "parity": True}


def _reconciled():
    return {"nodes_merged": 3, "rpc_dtl_bytes": 100,
            "px_exchange_bytes": 100, "drift_pct": 0.0, "reconciled": True}


def _scrub_line():
    return {"oracle_match_before": True,
            "overhead": {"overhead_pct": 1.0, "pass": True},
            "repair": {"detected": True, "repaired": ["lineitem"],
                       "failed": [], "oracle_match": True,
                       "mended_clean": True, "pass": True},
            "pass": True}


def _set(rec, path, value):
    rec = copy.deepcopy(rec)
    d = rec
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value
    return rec


#: (the failures function, good record, path broken, value, the gate's
#: name, timing)
BROKEN = {
    "trace rows_equal": (trace.failures, _overhead(), ("rows_equal",),
                         False, "rows_equal", False),
    "trace overhead_pct": (trace.failures, _overhead(), ("overhead_pct",),
                           2.5, "overhead_pct", True),
    "trace attribution parity": (trace.attribution_failures,
                                 _attribution(), ("parity",), False,
                                 "parity", False),
    "trace attribution_ok": (trace.attribution_failures, _attribution(),
                             ("attribution_ok",), False, "attribution_ok",
                             False),
    "metrics rows_equal": (metrics.failures, _overhead(), ("rows_equal",),
                           False, "rows_equal", False),
    "metrics overhead_pct": (metrics.failures, _overhead(),
                             ("overhead_pct",), 3.0, "overhead_pct", True),
    "metrics scrape reconciled": (metrics.scrape_failures, _reconciled(),
                                  ("reconciled",), False, "reconciled",
                                  False),
    "profile rows_equal": (profile.failures, _profile_line(),
                           ("overhead", "rows_equal"), False, "rows_equal",
                           False),
    "workload rows_equal": (workload.failures, _workload_line(),
                            ("overhead", "rows_equal"), False, "rows_equal",
                            False),
    "workload crc": (workload.failures, _workload_line(),
                     ("restart", "crc_verified_after_restart"), False,
                     "crc_verified_after_restart", False),
    "workload delta": (workload.failures, _workload_line(),
                       ("restart", "delta_reportable"), False,
                       "delta_reportable", False),
    "workload overhead_pct": (workload.failures, _workload_line(),
                              ("overhead", "overhead_pct"), 2.01,
                              "overhead_pct", True),
    "workload phases": (workload.failures, _workload_line(),
                        ("overhead", "phases_reconcile"), False,
                        "phases_reconcile", True),
    "workload cluster reconciled": (
        workload.failures, {**_workload_line(), "cluster": _reconciled()},
        ("cluster", "reconciled"), False, "reconciled", False),
    "planqual rows_equal": (planqual.failures, _planqual_line(),
                            ("overhead", "rows_equal"), False,
                            "rows_equal", False),
    "planqual feedback on": (planqual.failures, _planqual_line(),
                             ("feedback", "on", "answers_ok"), False,
                             "feedback on answers_ok", False),
    "planqual feedback off": (planqual.failures, _planqual_line(),
                              ("feedback", "off", "answers_ok"), False,
                              "feedback off answers_ok", False),
    "planqual skew answer": (planqual.failures, _planqual_line(),
                             ("skew", "uniform", "answer_rows"), 9,
                             "uniform", False),
    "planqual skew pushdown": (planqual.failures, _planqual_line(),
                               ("skew", "skewed", "pushdown_hit"), 0,
                               "skewed", False),
    "planqual skew_visible skewed": (planqual.skew_failures, _skew(),
                                     ("skewed", "slice_skew"), 2.9,
                                     "skew_visible", False),
    "planqual skew_visible uniform": (planqual.skew_failures, _skew(),
                                      ("uniform", "slice_skew"), 1.5,
                                      "skew_visible", False),
    "scrub oracle_match_before": (scrub.failures, _scrub_line(),
                                  ("oracle_match_before",), False,
                                  "oracle_match_before", False),
    "scrub detected": (scrub.failures, _scrub_line(),
                       ("repair", "detected"), False, "detected", False),
    "scrub repaired": (scrub.failures, _scrub_line(),
                       ("repair", "repaired"), [], "repaired", False),
    "scrub failed": (scrub.failures, _scrub_line(), ("repair", "failed"),
                     ["lineitem"], "repaired", False),
    "scrub oracle_match": (scrub.failures, _scrub_line(),
                           ("repair", "oracle_match"), False,
                           "oracle_match", False),
    "scrub mended_clean": (scrub.failures, _scrub_line(),
                           ("repair", "mended_clean"), False,
                           "mended_clean", False),
    "scrub overhead_pct": (scrub.failures, _scrub_line(),
                           ("overhead", "pass"), False, "overhead_pct",
                           True),
}
for _name in _profile_line()["checks"]:
    BROKEN[f"profile {_name}"] = (profile.failures, _profile_line(),
                                  ("checks", _name), False, _name,
                                  _name in profile.TIMING)
for _name in _planqual_line()["checks"]:
    BROKEN[f"planqual {_name}"] = (planqual.failures, _planqual_line(),
                                   ("checks", _name), False, _name,
                                   _name in planqual.TIMING)


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_failures_names_each_broken_gate(case):
    failures, good, path, value, name, timing = BROKEN[case]
    assert failures(good) == [] and failures(good, timing=False) == []
    bad = failures(_set(good, path, value))
    assert len(bad) == 1 and bad[0].startswith(name), bad
    assert failures(_set(good, path, value), timing=False) == \
        ([] if timing else bad)


#: (env at a small size, the cluster half skipped as the reference's knob
#: skips it; the gates that read device time and fail on the CPU by
#: definition; the record's top-level keys, the reference's skipped shape)
SCRIPTS = {
    "trace": ({"BENCH_ROWS": "2000", "BENCH_REPEATS": "8",
               "TRACE_BENCH_SKIP_CLUSTER": "1"}, [],
              {"metric", "overhead", "ok"}),
    "metrics": ({"BENCH_ROWS": "2000", "BENCH_REPEATS": "8",
                 "METRICS_BENCH_SKIP_CLUSTER": "1"}, [],
                {"metric", "overhead", "ok"}),
    "workload": ({"BENCH_ROWS": "2000", "BENCH_REPEATS": "8",
                  "WORKLOAD_BENCH_SKIP_CLUSTER": "1"}, [],
                 {"metric", "overhead", "restart", "ok"}),
    "profile": ({"PROFILE_SF": "0.01", "PROFILE_REPEATS": "16"},
                ["all_queries_priced", "achieved_gflops_nonzero"],
                {"metric", "sf", "backend", "roofline", "overhead",
                 "checks", "ok", "sysstat"}),
    "planqual": ({"PLANQUAL_SF": "0.01", "PLANQUAL_REPEATS": "16",
                  "PLANQUAL_SKIP_CLUSTER": "1"},
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
    if plane == "planqual":
        assert rec["skew"] == {"skipped": True}
        assert "skew_visible" not in rec["checks"]
    mod = MODULES[plane]
    part = rec["overhead"] if plane in ("trace", "metrics") else rec
    assert mod.failures(part, timing=False) == cpu_failing
    assert rc == (0 if rec["ok"] and not mod.failures(part) else 1)
