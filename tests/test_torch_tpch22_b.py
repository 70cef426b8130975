"""The second half of the 22 TPC-H queries through the port's ``Session``
against the JAX package's and the SQLite oracle (see
``tests/test_torch_tpch22.py``)."""

import pytest

from test_torch_tpch22 import SECOND_HALF, check_query, load_sessions


@pytest.fixture(scope="module")
def env():
    return load_sessions()


@pytest.mark.parametrize("qnum", SECOND_HALF)
def test_tpch_query_matches(env, qnum, monkeypatch):
    check_query(env, qnum, monkeypatch)
