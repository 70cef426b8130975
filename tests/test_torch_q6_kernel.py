"""The port's Q6 kernel wrapper and plain version against the JAX Pallas
kernel (interpret mode on the CPU).  Exact int64 equality.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held against it on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from oceanbase_tpu.datatypes import date_to_days
from oceanbase_tpu.ops import q6_filter_sum as jax_q6
from oceanbase_tpu_torch.ops import q6_filter_sum, q6_filter_sum_reference
from oceanbase_tpu_torch.ops import _build

BOUNDS = dict(ship_lo=date_to_days("1994-01-01"),
              ship_hi=date_to_days("1995-01-01"),
              disc_lo=5, disc_hi=7, qty_hi=2400)


def _random_columns(n, seed=7):
    rng = np.random.default_rng(seed)
    ship = rng.integers(date_to_days("1992-01-01"),
                        date_to_days("1998-12-01"), n).astype(np.int32)
    disc = rng.integers(0, 11, n).astype(np.int32)
    qty = (rng.integers(1, 51, n) * 100).astype(np.int32)
    price = rng.integers(90_000, 10_000_000, n).astype(np.int32)
    live = np.ones(n, dtype=np.int32)
    live[::17] = 0  # some dead lanes
    return ship, disc, qty, price, live


def _both(cols, bounds):
    want = int(jax_q6(*cols, **bounds, interpret=True))
    tcols = [torch.from_numpy(c) for c in cols]
    plain = q6_filter_sum_reference(*tcols, **bounds)
    wrapped = q6_filter_sum(*tcols, **bounds)
    assert plain.dtype == torch.int64 and plain.dim() == 0
    return want, int(plain), int(wrapped)


@pytest.mark.parametrize("n", [1, 100, 8192, 8193, 100_000])
def test_q6_plain_matches_pallas_random(n):
    want, plain, wrapped = _both(_random_columns(n), BOUNDS)
    assert plain == want
    assert wrapped == want


@pytest.mark.parametrize("n", [1, 100, 8192, 8193])
def test_q6_plain_matches_pallas_ragged(n):
    cols = (np.full(n, date_to_days("1994-06-01"), dtype=np.int32),
            np.full(n, 6, dtype=np.int32),
            np.full(n, 100, dtype=np.int32),
            np.full(n, 1_000_000, dtype=np.int32),
            np.ones(n, dtype=np.int32))
    want, plain, wrapped = _both(cols, BOUNDS)
    assert want == n * 6_000_000
    assert plain == want and wrapped == want


def test_q6_plain_matches_pallas_all_filtered():
    cols = _random_columns(8193)
    bounds = dict(BOUNDS, ship_lo=0, ship_hi=1)
    want, plain, wrapped = _both(cols, bounds)
    assert want == 0 and plain == 0 and wrapped == 0


def test_q6_wrapper_on_cpu_does_not_count_launches():
    _build.reset_launch_counts()
    cols = [torch.from_numpy(c) for c in _random_columns(100)]
    q6_filter_sum(*cols, **BOUNDS)
    assert _build.launch_counts().get("q6_filter_sum", 0) == 0


def _bad_inputs(kind):
    cols = [torch.from_numpy(c) for c in _random_columns(64)]
    if kind == "int64":
        cols[3] = cols[3].to(torch.int64)
        return cols, TypeError
    if kind == "length":
        cols[1] = cols[1][:63].contiguous()
        return cols, ValueError
    if kind == "noncontiguous":
        cols = [torch.from_numpy(np.repeat(c.numpy(), 2))[::2]
                for c in cols]
        return cols, ValueError
    if kind == "2d":
        cols[0] = cols[0].reshape(8, 8)
        return cols, ValueError
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["int64", "length", "noncontiguous", "2d"])
def test_q6_wrapper_rejects(kind):
    cols, exc = _bad_inputs(kind)
    with pytest.raises(exc):
        q6_filter_sum(*cols, **BOUNDS)
