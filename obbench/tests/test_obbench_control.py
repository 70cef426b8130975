"""The control, the reference in the precision below the one the
configuration states, comes out not correct; the sound reference comes
out correct.  On the CPU at a tiny size; ``chip`` tests at a larger
size on the card."""

import numpy as np
import pytest

from obbench.datasets import tpch, vectors
from obbench.reference import vectors as vref
from obbench.reference.tpch import Ref


def _tpch_readings(sf, seed):
    data = tpch.make({"scale_factor": sf}, seed, "cpu")
    sound, control = Ref(data["tables"]), Ref(data["tables"],
                                              money=np.float32)
    samples_ok, samples_ctl = [], []
    for q in range(1, 23):
        e = sound.run(q)
        samples_ok.append((q, e.rows[: e.limit or len(e.rows)]))
        c = control.run(q)
        samples_ctl.append((q, c.rows[: c.limit or len(c.rows)]))
    return (tpch.judge({}, data, samples_ok, "cpu"),
            tpch.judge({}, data, samples_ctl, "cpu"))


def test_tpch_control_is_refused():
    ok, ctl = _tpch_readings(0.01, 5)
    assert ok == {"wrong_rows": 0, "float_gap": 0.0}
    limits = {"wrong_rows": 0, "float_gap": 1e-9}
    assert any(ctl[n] > limits[n] for n in limits), ctl


def _knn_readings(cfg, seed, device, n_queries):
    data = vectors.make(cfg, seed, device)
    keys = list(range(n_queries))
    rows = vref.control_rows(data["base"], data["queries"], cfg["k"], keys,
                             device)
    return vectors.judge(cfg, data, list(zip(keys, rows)), device)


def test_knn_control_is_refused():
    cfg = {"rows": 20_000, "dim": 128, "queries": 50, "k": 10,
           "centres": 1000, "spread": 12.0}
    ctl = _knn_readings(cfg, 7, "cpu", 50)
    assert ctl["wrong_rows"] > 0


@pytest.mark.chip
def test_knn_control_is_refused_on_the_card(card):
    cfg = {"rows": 2_000_000, "dim": 128, "queries": 100, "k": 10,
           "centres": 1000, "spread": 12.0}
    for seed in (1, 2, 3):
        assert _knn_readings(cfg, seed, card, 100)["wrong_rows"] > 0
