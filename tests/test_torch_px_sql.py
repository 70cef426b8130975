"""PX through the port's ``Session``: ``SET px_dop = 8`` runs each
distributable plan as 8 shard programs on the CPU mesh.

- At SF0.01, the six queries of ``tests/test_px_sql.py`` and its
  fallback case (Q16's count(distinct) repartitions raw rows): the port's
  PX answer equals the JAX package's PX answer (8 host devices,
  ``tests/conftest.py``) row for row in order (floats at 1e-9 relative),
  both took the same path (``_last_px``), and both equal the port's
  serial answer.
- At SF0.002, all 22 TPC-H queries: port serial equals port px(8), and
  22 of 22 run distributed (the reference's ``__graft_entry__.py``
  dryrun gate).
- A tenant whose ``px_admission`` permits are taken runs a PX statement
  serially, counts it in ``admission.px_downgrades``, tags its trace and
  says so in EXPLAIN ANALYZE, as the reference does.
- A plan PX refuses is tried once per statement, not once per capacity
  re-plan, and shards no table.

Both optimizers price with the uncalibrated cost units."""

import numpy as np
import pytest
import torch

import oceanbase_tpu.server.calibrate as jcalibrate
import oceanbase_tpu.sql.session as jsession
import oceanbase_tpu_torch.exec.ops as tops
import oceanbase_tpu_torch.exec.plan as tplan
import oceanbase_tpu_torch.expr.ir as tir
import oceanbase_tpu_torch.px.exchange as tx
import oceanbase_tpu_torch.px.planner as tpx
import oceanbase_tpu_torch.server.calibrate as tcalibrate
import oceanbase_tpu_torch.sql.session as tsession
from oceanbase_tpu.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
from oceanbase_tpu.bench.tpch_queries import QUERIES
from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu_torch.bench.oracle import rows_match
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen_tpch
from oceanbase_tpu_torch.server import metrics as tmetrics
from oceanbase_tpu_torch.server.database import Database as TDatabase
from oceanbase_tpu_torch.sql import Session as TSession
from oceanbase_tpu_torch.vector import column as tcol

torch.set_num_threads(2)

PX_QUERIES = [6, 1, 14, 3, 5, 12, 16]  # tests/test_px_sql.py, in order


@pytest.fixture(autouse=True)
def _mesh8(monkeypatch):
    tx.set_mesh_size(8)
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)
    monkeypatch.setattr(tcalibrate, "_PROC_UNITS", None)
    yield
    tx.set_mesh_size(None)


def _load(sf, jax_side=True):
    tables, jtypes = gen_tpch(sf=sf)
    _t, ttypes = tgen_tpch(sf=sf)
    js = jsession.Session() if jax_side else None
    ts = TSession(device="cpu")
    for name, arrays in tables.items():
        pk = TPCH_PRIMARY_KEYS[name]
        if js is not None:
            js.catalog.load_numpy(
                name, arrays, primary_key=pk,
                types={k: v for k, v in jtypes.items() if k in arrays})
        ts.catalog.load_numpy(
            name, arrays, primary_key=pk,
            types={k: v for k, v in ttypes.items() if k in arrays})
    return js, ts


@pytest.fixture(scope="module")
def sf01():
    return _load(0.01)


@pytest.fixture(scope="module")
def sf002():
    return _load(0.002, jax_side=False)[1]


def _run(sess, sql, dop):
    sess.variables["px_dop"] = dop
    try:
        return sess.execute(sql).rows(), bool(sess._last_px)
    finally:
        sess.variables["px_dop"] = 0


@pytest.mark.parametrize("qnum", PX_QUERIES)
def test_px_matches_the_reference_px(sf01, qnum):
    js, ts = sf01
    sql = QUERIES[qnum]
    want, jpx = _run(js, sql, 8)
    got, tpx = _run(ts, sql, 8)
    assert tpx == jpx, (tpx, jpx)
    ok, why = rows_match(got, want, ordered=True, rtol=1e-9)
    assert ok, f"Q{qnum} port px vs JAX px: {why}"
    serial, spx = _run(ts, sql, 0)
    assert not spx
    ordered = "order by" in sql.lower() and qnum not in (2, 18, 21)
    ok, why = rows_match(got, serial, ordered=ordered, rtol=1e-9)
    assert ok, f"Q{qnum} port px vs port serial: {why}"


def test_px_all_22_distributed_and_equal_serial(sf002):
    ts = sf002
    distributed = []
    for qnum in sorted(QUERIES):
        sql = QUERIES[qnum]
        serial, _ = _run(ts, sql, 0)
        got, used = _run(ts, sql, 8)
        ordered = "order by" in sql.lower() and qnum not in (2, 18, 21)
        ok, why = rows_match(got, serial, ordered=ordered, rtol=1e-9)
        assert ok, f"Q{qnum} serial vs px(8): {why}"
        if used:
            distributed.append(qnum)
    assert distributed == sorted(QUERIES)


def test_dop_capped_at_the_mesh(sf002):
    ts = sf002
    tx.set_mesh_size(None)  # one CPU device: px_dop 8 runs serially
    _rows, used = _run(ts, QUERIES[6], 8)
    assert not used
    tx.set_mesh_size(4)
    ts.variables["px_dop"] = 8
    assert ts._px_dop() == 4
    ts.variables["px_dop"] = 1
    assert ts._px_dop() == 1


def test_px_downgrade_counted_and_visible(tmp_path):
    """Drained px_admission, in both packages: the downgrade is counted,
    the statement runs serially with the right answer, and EXPLAIN
    ANALYZE says so."""
    from oceanbase_tpu.server import metrics as jmetrics

    want = [(sum(i % 7 for i in range(500)),)]
    out = []
    for db, metrics in ((JDatabase(str(tmp_path / "j")), jmetrics),
                        (TDatabase(str(tmp_path / "t"), device="cpu"),
                         tmetrics)):
        s = db.session()
        s.execute("create table big (a int primary key, b int)")
        s.execute("insert into big values " + ", ".join(
            f"({i}, {i % 7})" for i in range(500)))
        s.execute("set px_dop = 8")
        assert s.execute("select sum(b) from big").rows() == want
        assert s._last_px
        t = db.tenant("sys")
        grabbed = 0
        while t.px_admission.acquire(blocking=False):
            grabbed += 1
        try:
            before = metrics.counter_value("admission.px_downgrades")
            rows = s.execute("select sum(b) from big").rows()
            after = metrics.counter_value("admission.px_downgrades")
            txt = s.execute("explain analyze select sum(b) from big"
                            ).plan_text
            out.append((rows, after - before, s._last_px,
                        s._last_px_downgrade,
                        "px: admission denied" in txt, grabbed))
        finally:
            for _ in range(grabbed):
                t.px_admission.release()
        db.close()
    assert out[0] == out[1]
    assert out[1] == (want, 1, False, True, True, 64)


def test_refused_plan_tries_px_once_across_retries(monkeypatch):
    """A plan PX refuses by its shape (a window without PARTITION BY)
    whose serial run overflows a 16-row group-by: the session's capacity
    ladder re-plans it, PX is tried on the first attempt only and shards
    nothing, and the answer equals the serial one."""
    rng = np.random.default_rng(5)
    ts = TSession(device="cpu")
    ts.catalog.load_numpy("t", {"k": rng.integers(0, 200, 2_000),
                                "v": rng.integers(0, 9, 2_000)})
    plan = tplan.Window(
        tplan.GroupBy(tplan.TableScan("t"), {"k": tir.col("k")},
                      [tops.AggSpec("c", "count_star")], out_capacity=16),
        [("r", tir.WindowCall("rank", order_by=[(tir.col("k"), True)]))])
    outputs = [("k", "k"), ("c", "c"), ("r", "r")]
    serial, _ = ts._run_plan(plan, outputs)
    want = tcol.to_numpy(serial)
    assert ts.last_retries >= 2

    calls, sharded = [], []
    run = tsession.execute_plan_distributed
    monkeypatch.setattr(tsession, "execute_plan_distributed",
                        lambda *a, **k: calls.append(1) or run(*a, **k))
    monkeypatch.setattr(tpx, "shard_relation",
                        lambda *a, **k: sharded.append(1))
    ts.variables["px_dop"] = 8
    try:
        rel, _ = ts._run_plan(plan, outputs)
    finally:
        ts.variables["px_dop"] = 0
    assert calls == [1] and not sharded and not ts._last_px
    assert ts.last_retries >= 2
    got = tcol.to_numpy(rel)
    for name in ("k", "c", "r"):
        assert got[name].tolist() == want[name].tolist()
