"""The cluster halves of the measurement planes' benches, over both
packages' node processes on the CPU.

One module-scoped 3-node cluster per package (``bench/cluster.py::boot``,
the reference's ``oceanbase_tpu.net.node`` beside the port's), each
loaded with 2,000 rows of the slice in 1,000-row INSERTs on node 1; each
half of ``oceanbase_tpu_torch/bench/{trace,metrics,workload,planqual}.py``
runs once on each cluster and the non-timing records are held equal:

- trace attribution: ``attribution_ok``, the slowest span, its peer tag
  and the answer's parity under the delay;
- metrics scrape and workload report: reconciled, the drift <= 1%, the
  nodes merged;
- DTL slice skew at 600 + 600 rows: ``max_slice_rows``,
  ``mean_slice_rows`` and ``parts`` exactly equal, and the port's
  ``slice_mask`` equal to the reference's on the same ids;
- ``take_lead``: node 1 takes the lead back from node 2.

Every wait is ``bench/cluster.py``'s, under a deadline that names what
it awaits.  The twins ``scripts/torch_{trace,metrics,workload,
planqual}_bench.py`` with their cluster halves run are marked slow (each
boots a cluster of its own after its single-node half).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oceanbase_tpu.px.dtl import slice_mask as jslice_mask
from oceanbase_tpu_torch.bench import cluster as bc
from oceanbase_tpu_torch.bench import metrics, planqual, trace, workload
from oceanbase_tpu_torch.px.dtl import slice_mask
from torch_pair import NODE_PACKAGES
from torch_script import run_script

torch.set_num_threads(2)

ROWS = 2000
SKEW_ROWS = 600


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    cs = {}
    try:
        for tag, module in NODE_PACKAGES:  # both boot at once
            cs[tag] = bc.boot(str(tmp_path_factory.mktemp(tag)), "cpu",
                              module, wait=False)
        for c in cs.values():
            c.wait_ready()
            bc.load_slice(c, ROWS)
        yield cs
    finally:
        for c in cs.values():
            c.close()


def _both(clusters, half) -> dict:
    return {tag: half(c) for tag, c in clusters.items()}


def test_attribution_names_the_delayed_peer(clusters):
    recs = _both(clusters, lambda c: trace.attribution(c, ROWS))
    keys = ("attribution_ok", "slowest_span", "parity")
    for tag, rec in recs.items():
        assert trace.attribution_failures(rec) == [], (tag, rec)
        assert rec["slowest_span_tags"]["peer"] == trace.DELAY_PEER
        assert rec["slowest_elapsed_s"] >= trace.DELAY_MS / 1000.0
    assert {k: recs["port"][k] for k in keys} == \
        {k: recs["ref"][k] for k in keys}


def test_scrape_reconciles_with_the_exchange(clusters):
    recs = _both(clusters, lambda c: metrics.scrape(c, ROWS))
    for tag, rec in recs.items():
        assert metrics.scrape_failures(rec) == [], (tag, rec)
        assert rec["drift_pct"] <= metrics.DRIFT_PCT
        assert rec["px_exchange_bytes"] > 0 and rec["prom_lines"] > 0
    assert recs["port"]["nodes"] == recs["ref"]["nodes"] == 3


def test_workload_report_merges_three_nodes(clusters):
    recs = _both(clusters, lambda c: workload.cluster(c, ROWS))
    for tag, rec in recs.items():
        assert workload.cluster_failures(rec) == [], (tag, rec)
        assert rec["drift_pct"] <= workload.DRIFT_PCT
        assert rec["report_rows"] > 0 and rec["tree_lines"] > 0
    assert recs["port"]["nodes_merged"] == recs["ref"]["nodes_merged"] == 3


def test_slice_skew_is_visible_and_exact(clusters):
    recs = _both(clusters, lambda c: planqual.skew(c, SKEW_ROWS))
    for tag, rec in recs.items():
        assert planqual.skew_failures(rec) == [], (tag, rec)
    keys = ("max_slice_rows", "mean_slice_rows", "parts", "answer_rows",
            "pushdown_hit")
    for table in ("skewed", "uniform"):
        assert {k: recs["port"][table][k] for k in keys} == \
            {k: recs["ref"][table][k] for k in keys}
    assert recs["port"]["skewed"]["slice_skew"] == \
        recs["ref"]["skewed"]["slice_skew"] == 3.0


def test_node_1_takes_the_lead_back(clusters):
    """After the halves: node 2 takes the lead, and ``take_lead`` hands
    it back to node 1 on both packages' clusters (the load does so when
    an election under load moved it off the bootstrap node)."""
    for tag, c in clusters.items():
        assert c.clients[2].call("disk.takeover", from_node=1,
                                 _deadline_s=60.0) is True, tag
        assert c.leader(30.0) == 2, tag
        assert bc.take_lead(c, 1) == 1
        assert c.leader(30.0) == 1, tag
        assert bc.lead_from(c, 1) == 1


@pytest.mark.parametrize("nparts", [1, 2, 3, 8])
def test_slice_mask_equals_the_reference(nparts):
    ids = np.arange(SKEW_ROWS * 4, dtype=np.int64)
    for part in range(nparts):
        np.testing.assert_array_equal(
            slice_mask({"k": ids}, ["k"], part, nparts),
            jslice_mask({"k": ids}, ["k"], part, nparts))
    got = planqual.skew_tables(SKEW_ROWS)
    in0 = jslice_mask({"k": ids}, ["k"], 0, planqual.SKEW_PARTS)
    assert np.array_equal(got["skewed"][0], ids[in0][:SKEW_ROWS // 3])


#: the cluster half's key in the twin's line, and its gate
TWINS = {
    "trace": ("attribution", trace.attribution_failures),
    "metrics": ("scrape", metrics.scrape_failures),
    "workload": ("cluster", workload.cluster_failures),
    "planqual": ("skew", planqual.skew_failures),
}


@pytest.mark.slow
@pytest.mark.parametrize("plane", sorted(TWINS))
def test_twin_runs_its_cluster_half(plane):
    key, gate = TWINS[plane]
    env = {"BENCH_ROWS": "2000", "BENCH_REPEATS": "8",
           "BENCH_CLUSTER_ROWS": "2000", "PLANQUAL_SF": "0.01",
           "PLANQUAL_REPEATS": "16"}
    rc, rec, before, after = run_script(f"torch_{plane}_bench.py", env)
    assert before == after
    assert gate(rec[key]) == [], rec[key]
    if plane == "planqual":
        assert rec["checks"]["skew_visible"]
    assert rc == (0 if rec["ok"] else 1)
