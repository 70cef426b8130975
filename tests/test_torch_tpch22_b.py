"""The second half of the 22 TPC-H queries through the port's ``Session``
against the JAX package's and the SQLite oracle (see
``tests/test_torch_tpch22.py``)."""

import pytest
import torch

from test_torch_tpch22 import SECOND_HALF, check_query, load_sessions

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def env():
    return load_sessions()


@pytest.mark.parametrize("qnum", SECOND_HALF)
def test_tpch_query_matches(env, qnum, monkeypatch):
    check_query(env, qnum, monkeypatch)
