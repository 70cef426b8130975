"""The coverage half of ``oceanbase_tpu_torch/bench/planqual.py`` (the
port of ``scripts/planqual_bench.py:73-196``) over each package's
``Database`` on the CPU: TPC-H at SF0.01, ANALYZEd, with the ``*key``
indexes, the first 11 queries (``tests/test_torch_plane_coverage_b.py``
runs the other 11, so ``--dist loadfile`` spreads them over two
workers).  Per query the operators, those with an estimate, the largest
q-error, the retries and the path are equal, every operator is
estimated, and gv$plan_choice's enumerated plans and runner-ups are
equal (counted at bind time: on the CPU the port measures no device
seconds, so no execution of its counts)."""

from __future__ import annotations

import importlib

import pytest
import torch

import oceanbase_tpu.server.calibrate as jcalibrate
import oceanbase_tpu_torch.server.calibrate as tcalibrate
from oceanbase_tpu_torch.bench import planes, planqual
from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
from torch_pair import J, T

torch.set_num_threads(2)

SF = 0.01
FIRST_HALF = [q for q in sorted(QUERIES) if q <= 11]


def tpch_db(P, root):
    """A Database of ``P`` at ``root`` with TPC-H at SF0.01 loaded,
    ANALYZEd and indexed as the reference's coverage half does."""
    tables, types = importlib.import_module(
        f"{P.name}.bench.tpch").gen_tpch(sf=SF)
    db = P.db(root)
    s = db.session()
    planes.load_tpch(s, tables, types, TPCH_PRIMARY_KEYS)
    for ix, name, c in planqual.key_indexes(tables):
        s.execute(f"create index {ix} on {name} ({c})")
    s.close()
    return db


def _bind_time_choices(db) -> dict:
    """gv$plan_choice's counts without ``cost_model_validation``'s
    filter on executions (which count only measured device seconds)."""
    rows = db.plan_choice.rows()
    cbo = [r for r in rows if r["enumerated"] > 1 and r["pred_s"] > 0]
    return {"plans_recorded": len(rows), "plans_enumerated": len(cbo),
            "plans_with_runner_up": sum(r["runner_up_s"] > 0 for r in cbo),
            "index_probe_plans": sum(r["index_probes"] > 0 for r in rows)}


def coverage_both(tmp_path, monkeypatch, qnums):
    """-> (the reference's record, the port's) over ``qnums``, both
    pricing with the uncalibrated units."""
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)
    monkeypatch.setattr(tcalibrate, "_PROC_UNITS", None)
    recs = []
    for P in (J, T):
        db = tpch_db(P, tmp_path / P.name)
        rec = planqual.coverage(db, {q: QUERIES[q] for q in qnums})
        rec["bind_time"] = _bind_time_choices(db)
        db.close()
        recs.append(rec)
    return recs


def check_coverage(want, got, qnums):
    assert got["queries"] == want["queries"] == len(qnums)
    assert got["per_query"] == want["per_query"]
    assert got["all_operators_covered"] is True
    assert want["all_operators_covered"] is True
    assert got["worst_misestimate"] == want["worst_misestimate"]
    keys = ("plans_recorded", "plans_enumerated", "plans_with_runner_up",
            "index_probe_plans")
    assert {k: got["bind_time"][k] for k in keys} == \
        {k: want["bind_time"][k] for k in keys}
    # the reference measures device seconds on the CPU, the port does not
    assert want["cost_model"]["plans_recorded"] == len(qnums)
    assert got["cost_model"]["plans_recorded"] == 0


def test_coverage_first_half_equal_across_packages(tmp_path, monkeypatch):
    want, got = coverage_both(tmp_path, monkeypatch, FIRST_HALF)
    check_coverage(want, got, FIRST_HALF)
