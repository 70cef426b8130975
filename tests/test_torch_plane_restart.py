"""The restart lane of ``oceanbase_tpu_torch/bench/workload.py`` and the
feedback half of ``bench/planqual.py`` (ports of the reference's
``scripts/workload_bench.py:170-203`` and ``planqual_bench.py:274-307``)
over each package's ``Database`` on the CPU, with their records equal:
the snapshot ids across a restart, the crc-verified load, the delta
report's rows; one retry with feedback on and none in a fresh session,
>= 2 on the blind ladder with it off."""

from __future__ import annotations

import torch

from oceanbase_tpu_torch.bench import planqual, workload
from torch_pair import J, T

torch.set_num_threads(2)

ROWS = 2000


def _restart(P, root):
    # the report's sysstat section lists the process's series: start
    # each package's registry empty so the two reports list the same
    P.metrics.reset()
    return workload.restart(P.db, str(root), ROWS)


def test_restart_lane_equal_across_packages(tmp_path):
    want = _restart(J, tmp_path / "jax")
    got = _restart(T, tmp_path / "port")
    assert got == want, (got, want)
    assert got["delta_reportable"] and got["crc_verified_after_restart"]
    assert got["post_restart_to_id"] > got["pre_restart_id"]
    assert workload.failures({"overhead": {"rows_equal": True},
                              "restart": got}, timing=False) == []


def test_feedback_half_equal_across_packages(tmp_path):
    want = planqual.feedback(J.db, str(tmp_path / "jax"), J.metrics)
    got = planqual.feedback(T.db, str(tmp_path / "port"), T.metrics)
    assert got == want, (got, want)
    assert got["on"] == {"first_run_retries": 1, "fresh_session_retries": 0,
                         "answers_ok": True}
    assert got["off"]["first_run_retries"] >= 2 and got["off"]["answers_ok"]
