"""The second half of ``tests/test_torch_plane_coverage.py``: TPC-H
queries 12-22 through ``bench/planqual.py``'s coverage half over each
package's ``Database`` on the CPU, their records equal."""

from __future__ import annotations

import torch

from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
from test_torch_plane_coverage import check_coverage, coverage_both

torch.set_num_threads(2)

SECOND_HALF = [q for q in sorted(QUERIES) if q > 11]


def test_coverage_second_half_equal_across_packages(tmp_path, monkeypatch):
    want, got = coverage_both(tmp_path, monkeypatch, SECOND_HALF)
    check_coverage(want, got, SECOND_HALF)
