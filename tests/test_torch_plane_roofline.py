"""The roofline, rate and deep-profile halves of
``oceanbase_tpu_torch/bench/profile.py`` (the port of
``scripts/profile_bench.py:153-233``) over each package's ``Database`` on
the CPU, at SF0.01 after one ``ALTER SYSTEM CALIBRATE``: each query's
path equal, the units calibrated, and PROFILE of Q6 joined to at least
one gv$device_profile row by the audit's trace_id in both.  The reference
times its device half on the CPU and prices every query; the port's
``device_s`` is 0 there by definition (a CUDA event pair only on the
card), so it prices none and its two rate checks fail on the CPU, as
``chip_smoke.py`` phase planes holds them on the card."""

from __future__ import annotations

import importlib

import torch

import oceanbase_tpu.server.calibrate as jcalibrate
import oceanbase_tpu_torch.server.calibrate as tcalibrate
from oceanbase_tpu_torch.bench import planes, profile
from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
from torch_pair import J, T

torch.set_num_threads(2)

SF = 0.01
#: a scan, a join, the profiled query and a correlated subquery: the
#: reference compiles each on the CPU, so the 22 would take ~40 s here
ROOF_QUERIES = (1, 3, 6, 17)


def _roofline(P, root):
    tables, types = importlib.import_module(
        f"{P.name}.bench.tpch").gen_tpch(sf=SF)
    db = P.db(root, enable_calibration=True)
    s = db.session()
    planes.load_tpch(s, tables, types, TPCH_PRIMARY_KEYS)
    s.close()
    sample_every = db.config["plan_monitor_sample_every"]
    rec = profile.roofline(db, queries={q: QUERIES[q] for q in ROOF_QUERIES})
    assert db.config["plan_monitor_sample_every"] == sample_every
    db.close()
    return rec


def test_roofline_halves_across_packages(tmp_path, monkeypatch):
    # the calibration is process-wide in both packages: leave it unset
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)
    monkeypatch.setattr(tcalibrate, "_PROC_UNITS", None)
    want = _roofline(J, tmp_path / "jax")
    got = _roofline(T, tmp_path / "port")
    assert got["queries"] == want["queries"] == len(ROOF_QUERIES)
    assert {q: r["path"] for q, r in got["per_query"].items()} == \
        {q: r["path"] for q, r in want["per_query"].items()}
    assert sorted(got) == sorted(want)
    for rec in (got, want):
        assert rec["calibration"]["preset"] == "full"
        assert rec["profile"]["rows"] >= 1 and rec["profile"]["trace_id"]
    # the reference prices every query; the port's CPU prices none
    assert want["with_time_q"] == len(ROOF_QUERIES)
    assert want["max_achieved_gflops"] > 0.0
    assert got["with_time_q"] == 0 and got["max_achieved_gflops"] == 0.0
    assert all(r["device_ms"] == 0.0 and r["host_ms"] > 0.0
               for r in got["per_query"].values())
    assert {k for k, ok in profile.roofline_checks(got).items()
            if not ok} == {"all_queries_priced", "median_time_q_le_4x",
                           "achieved_gflops_nonzero"}
    assert all(profile.roofline_checks(want)[k] for k in
               ("all_queries_priced", "achieved_gflops_nonzero",
                "profile_rows_joined"))
