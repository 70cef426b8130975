"""All 22 TPC-H queries through the port's ``Session`` on the CPU, at
SF0.01: each answer equals the JAX package's ``Session`` row for row (the
same plan, so the same order; floats at rtol 1e-12) and the SQLite
oracle's (under the ordering rule of ``tests/test_sql_tpch.py``), and the
port re-plans after ``CapacityOverflow`` exactly as often as the
reference does.  Both optimizers price with the uncalibrated cost units.

``tests/test_torch_tpch22_b.py`` runs the second half of the queries, so
``--dist loadfile`` spreads the two halves over two workers."""

import pytest
import torch

import oceanbase_tpu.server.calibrate as jcalibrate
import oceanbase_tpu.sql.session as jsession
from oceanbase_tpu.bench.oracle import load_sqlite, rows_match, run_oracle
from oceanbase_tpu.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
from oceanbase_tpu.bench.tpch_queries import QUERIES
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen_tpch
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.sql import Session as TSession

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)

SF = 0.01
FIRST_HALF = [q for q in sorted(QUERIES) if q <= 11]
SECOND_HALF = [q for q in sorted(QUERIES) if q > 11]


def load_sessions(sf=SF):
    """(JAX Session, port Session on the CPU, SQLite connection) over the
    same generated tables."""
    tables, jtypes = gen_tpch(sf=sf)
    _t, ttypes = tgen_tpch(sf=sf)
    js, ts = jsession.Session(), TSession(device="cpu")
    for name, arrays in tables.items():
        pk = TPCH_PRIMARY_KEYS[name]
        js.catalog.load_numpy(
            name, arrays, primary_key=pk,
            types={k: v for k, v in jtypes.items() if k in arrays})
        ts.catalog.load_numpy(
            name, arrays, primary_key=pk,
            types={k: v for k, v in ttypes.items() if k in arrays})
    return js, ts, load_sqlite(tables, jtypes)


def check_query(env, qnum, monkeypatch):
    js, ts, conn = env
    sql = QUERIES[qnum]
    runs = []
    jexec = jsession.execute_plan

    def counted(*a, **k):
        runs.append(1)
        return jexec(*a, **k)

    monkeypatch.setattr(jsession, "execute_plan", counted)
    # process-wide cost units another test in this worker may have
    # calibrated would give the JAX optimizer other plans; the port has
    # no calibration yet and always prices with the uncalibrated units
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)
    want_j = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert ts.last_retries == len(runs) - 1
    ok, why = rows_match(got, want_j, ordered=True, rtol=1e-12)
    assert ok, f"Q{qnum} port vs JAX: {why}"
    want = run_oracle(conn, sql)
    ordered = "order by" in sql.lower() and qnum not in (2, 18, 21)
    ok, why = rows_match(got, want, ordered=ordered)
    assert ok, f"Q{qnum} port vs SQLite: {why}"


@pytest.fixture(scope="module")
def env():
    return load_sessions()


@pytest.mark.parametrize("qnum", FIRST_HALF)
def test_tpch_query_matches(env, qnum, monkeypatch):
    check_query(env, qnum, monkeypatch)


def test_exhausted_retry_ladder_raises(env):
    """Q21 needs three re-plans at SF0.01; with none allowed the port
    raises the overflow, as the reference does without a spill tier."""
    _js, ts, _conn = env
    ts.variables["max_capacity_retry"] = 0
    try:
        with pytest.raises(CapacityOverflow, match="rows dropped"):
            ts.execute(QUERIES[21])
    finally:
        ts.variables["max_capacity_retry"] = ts.MAX_CAPACITY_RETRIES
