"""``oceanbase_tpu_torch/bench/recompile.py`` (the port of
``scripts/recompile_bench.py``) on the CPU: the INSERT/SELECT loop with
shape buckets off and on once over each package's ``Database``: the
results equal across packages and across modes, the port's first
executions per capacity signature equal to the reference's XLA trace
counts, and gv$plan_cache equal to the plan-cache counters in each
package; ``failures`` naming each broken invariant; and, ``slow``, the
whole run over both packages at the reference's 100 x 50 loop."""

from __future__ import annotations

import importlib

import pytest
import torch

from oceanbase_tpu_torch.bench import recompile
from torch_pair import J, T
from torch_script import run_script

torch.set_num_threads(2)


STEPS = 12
ROWS_PER_STEP = 20


def _plan(P):
    return importlib.import_module(f"{P.name}.exec.plan")


def _loop(P, root, buckets, steps=STEPS, per_step=ROWS_PER_STEP):
    return recompile.run_loop(str(root), steps, per_step, buckets,
                              device="cpu", open_db=P.db, plan=_plan(P))


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "bucketed"])
def test_loop_equal_across_packages(tmp_path, buckets):
    want = _loop(J, tmp_path / "jax", buckets)
    got = _loop(T, tmp_path / "port", buckets)
    for rec in (want, got):
        assert rec["vt_traces"] == rec["traces"]
        assert rec["vt_executions"] == rec["executions"] == STEPS
    assert got["results"] == want["results"]
    assert got["traces"] == want["traces"]
    assert got["traces"] == (STEPS if not buckets else 3)


def test_port_run_results_equal_across_modes(tmp_path):
    rec = recompile.run(str(tmp_path), STEPS, ROWS_PER_STEP, device="cpu",
                        open_db=T.db)
    assert recompile.failures(rec) == [], rec
    assert rec["results_match"] is True
    assert rec["compiles_exact"] == STEPS
    assert rec["compiles_bucketed"] < rec["compiles_exact"]
    assert rec["final_rows"] == STEPS * ROWS_PER_STEP
    assert {"compiles_exact", "compiles_bucketed", "compile_ratio",
            "executions_exact", "executions_bucketed", "loop_s_exact",
            "loop_s_bucketed", "results_match", "sysstat"} <= set(rec)


def _good_record() -> dict:
    return {"steps": 100, "results_match": True, "compiles_exact": 100,
            "compiles_bucketed": 8, "executions_exact": 100,
            "executions_bucketed": 100, "plan_cache_exact": [100, 100],
            "plan_cache_bucketed": [8, 100]}


BROKEN = {
    "results_match": {"results_match": False},
    "gv$plan_cache exact": {"plan_cache_exact": [99, 100]},
    "gv$plan_cache bucketed": {"plan_cache_bucketed": [8, 99]},
    "compile amortization": {"compiles_bucketed": 11,
                             "plan_cache_bucketed": [11, 100]},
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_failures_names_each_broken_invariant(name):
    assert recompile.failures(_good_record()) == []
    rec = {**_good_record(), **BROKEN[name]}
    bad = recompile.failures(rec)
    assert len(bad) == 1 and bad[0].startswith(name), bad
    # the 10x gate is defined for the 100-step loop only
    assert "compile amortization" not in " ".join(
        recompile.failures({**rec, "steps": 99}))


def test_script_prints_the_reference_line_on_the_cpu():
    rc, rec, before, after = run_script(
        "torch_recompile_bench.py", {"BENCH_STEPS": "12",
                                     "BENCH_ROWS_PER_STEP": "20"})
    assert rc == 0 and before == after
    assert {"metric", "steps", "rows_per_step", "final_rows",
            "compiles_exact", "compiles_bucketed", "compile_ratio",
            "executions_exact", "executions_bucketed", "loop_s_exact",
            "loop_s_bucketed", "results_match", "sysstat"} <= set(rec)
    assert rec["metric"] == "recompile_amortization"
    assert (rec["compiles_exact"], rec["compiles_bucketed"]) == (12, 3)


@pytest.mark.slow
def test_whole_run_at_the_reference_default_both_packages(tmp_path):
    recs = {}
    for P in (J, T):
        rec = recompile.run(str(tmp_path / P.name), device="cpu",
                            open_db=P.db, plan=_plan(P), metrics=P.metrics)
        assert recompile.failures(rec) == [], (P, rec)
        recs[P.name] = {k: rec[k] for k in (
            "steps", "rows_per_step", "final_rows", "compiles_exact",
            "compiles_bucketed", "compile_ratio", "executions_exact",
            "executions_bucketed", "results_match", "plan_cache_exact",
            "plan_cache_bucketed")}
    assert recs[T.name] == recs[J.name]
