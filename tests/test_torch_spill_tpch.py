"""TPC-H plans through the spill tier of both packages on the CPU at
SF0.01, lineitem streamed in 8,192-row granules under a 4,096-row work
area: Q9 and the S1 external sort here, the refused shapes, and the
helpers ``tests/test_torch_spill.py`` (Q3) and
``tests/test_torch_granule.py`` (Q1, Q6, Q14) run their queries with, so
``--dist loadfile`` spreads the reference's slow eager runs over three
workers.  Ints, decimals, dates and strings must match exactly, float64
at 1e-12 relative, by output position."""

import numpy as np
import pytest
import torch

import oceanbase_tpu.server.calibrate as jcalibrate
import oceanbase_tpu_torch.server.calibrate as tcalibrate
from oceanbase_tpu.bench.oracle import rows_match, run_oracle
from oceanbase_tpu.bench.tpch_queries import QUERIES
from oceanbase_tpu.exec import granule as jg
from oceanbase_tpu.exec import spill_exec as jse
from oceanbase_tpu.px.planner import NotDistributable as JNotDistributable
from oceanbase_tpu.sql.parser import parse_sql as jparse
from oceanbase_tpu_torch.bench.harness import spill_inputs, spilled_result
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.exec import spill_exec as tse
from oceanbase_tpu_torch.px.planner import NotDistributable
from oceanbase_tpu_torch.sql.parser import parse_sql as tparse
from test_torch_tpch22 import load_sessions

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)

BUDGET = 4096
GRANULE = 8192

#: output positions where the reference's spilled avg divides a raw
#: scaled DECIMAL sum (typed INT, ROADMAP Queue 3 #10): 100x the answer
REF_AVG_UNDESCALED = {1: (6, 7, 8)}


# ---------------------------------------------------------------------------
# execute_spilled over TPC-H plans
# ---------------------------------------------------------------------------


def tpch_env():
    """(JAX Session, port Session on the CPU, SQLite, {"lineitem": host
    arrays}) over TPC-H SF0.01, every table ANALYZEd in both."""
    js, ts, conn = load_sessions()
    for name in ts.catalog.tables():
        js.execute(f"analyze table {name}")
        ts.execute(f"analyze table {name}")
    from oceanbase_tpu.bench.tpch import gen_tpch

    tables, _types = gen_tpch(sf=0.01)
    return js, ts, conn, {"lineitem": tables["lineitem"]}


def _jax_spilled(js, plan, host, spill_dir):
    providers, device_tables, types_by_table = {}, {}, {}
    for t in sorted(js.catalog.tables()):
        if t in host:
            providers[t] = jg.numpy_chunk_provider(host[t])
            types_by_table[t] = {c.name: c.dtype
                                 for c in js.catalog.table_def(t).columns}
        else:
            device_tables[t] = js.catalog.table_data(t)
    return jse.execute_spilled(plan, providers, spill_dir, BUDGET,
                               device_tables, types_by_table, set(host),
                               chunk_rows=GRANULE)


def _port_spilled(ts, plan, host, spill_dir):
    providers, device_tables, types_by_table = spill_inputs(
        ts.catalog, plan, host)
    return tse.execute_spilled(plan, providers, spill_dir, BUDGET,
                               device_tables, types_by_table, set(host),
                               chunk_rows=GRANULE, device="cpu")


@pytest.fixture(scope="module")
def tpch():
    return tpch_env()


def check_spilled_query(tpch, tmp_path, qnum, monkeypatch):
    """One TPC-H query through both packages' ``execute_spilled`` with
    lineitem streamed: the port equals the reference, the in-memory
    session and SQLite."""
    js, ts, conn, host = tpch
    monkeypatch.setattr(jcalibrate, "_PROC_UNITS", None)
    monkeypatch.setattr(tcalibrate, "_PROC_UNITS", None)
    sql = QUERIES[qnum]
    jplan, jout, _ = js._plan_select(jparse(sql), None)
    tplan, tout, _ = ts._plan_select(tparse(sql), None)
    ja, jv, jd, jst = _jax_spilled(js, jplan, host, str(tmp_path / "j"))
    ta, tv, td, tst = _port_spilled(ts, tplan, host, str(tmp_path / "t"))
    assert not (tmp_path / "t").exists()  # the spill directory is swept
    assert (tst.kind, tst.runs, tst.batches, tst.spilled_rows) == \
        (jst.kind, jst.runs, jst.batches, jst.spilled_rows)
    assert tst.host_reads >= tst.batches
    assert ("groupby" in tst.kind) == (qnum not in (6, 14))
    # by output position: the two binders number columns differently
    for i, ((jc, _), (tc, _)) in enumerate(zip(jout, tout)):
        a, b = np.asarray(ja[jc]), np.asarray(ta[tc])
        if i in REF_AVG_UNDESCALED.get(qnum, ()):
            np.testing.assert_allclose(b * 100, a, rtol=1e-12, err_msg=tc)
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-12, err_msg=tc)
        else:
            assert a.dtype == b.dtype and a.tolist() == b.tolist(), tc
        assert (tv.get(tc) is None) == (jv.get(jc) is None)
        if jv.get(jc) is not None:
            np.testing.assert_array_equal(tv[tc], jv[jc])
    # typed like the in-memory result (the reference types its host-
    # merged aggregates INT: ROADMAP Queue 3 #10), descaled through the
    # session's Result, the rows equal SQLite's
    mem = ts.execute(sql)
    # one reference bind for the port's: the binders' colid counters are
    # process-wide, and later tests in this worker compare colids
    js._plan_select(jparse(sql), None)
    assert [(td[c].kind, td[c].scale) for c, _n in tout] == \
        [(mem.dtypes[n].kind, mem.dtypes[n].scale) for n in mem.names]
    got = spilled_result(ta, tv, td, tout).rows()
    ok, why = rows_match(got, run_oracle(conn, sql), ordered=True)
    assert ok, why
    # and the in-memory session's, avg included (split avg = sum/count)
    ok, why = rows_match(got, mem.rows(), ordered=True, rtol=1e-12)
    assert ok, why


@pytest.mark.parametrize("qnum", [9])
def test_execute_spilled_tpch_matches_jax(tpch, tmp_path, qnum,
                                          monkeypatch):
    check_spilled_query(tpch, tmp_path, qnum, monkeypatch)


@pytest.mark.parametrize("qnum", [4, 13, 21])
def test_execute_spilled_refuses_like_jax(tpch, tmp_path, qnum):
    js, ts, _conn, host = tpch
    sql = QUERIES[qnum]
    jplan, _jout, _ = js._plan_select(jparse(sql), None)
    tplan, _tout, _ = ts._plan_select(tparse(sql), None)
    with pytest.raises(JNotDistributable) as jerr:
        _jax_spilled(js, jplan, host, str(tmp_path / "j"))
    with pytest.raises(NotDistributable) as terr:
        _port_spilled(ts, tplan, host, str(tmp_path / "t"))
    assert str(terr.value) == str(jerr.value)
    assert not (tmp_path / "t").exists()


def test_spilled_sort_limit_matches_jax(tpch, tmp_path):
    """A streamed external sort over every lineitem row (the chip run's
    S1, at SF0.01), past its budget."""
    from oceanbase_tpu_torch.bench.surface_queries import S1

    js, ts, conn, host = tpch
    jplan, jout, _ = js._plan_select(jparse(S1), None)
    tplan, tout, _ = ts._plan_select(tparse(S1), None)
    ja, jv, jd, jst = _jax_spilled(js, jplan, host, str(tmp_path / "j"))
    ta, tv, td, tst = _port_spilled(ts, tplan, host, str(tmp_path / "t"))
    assert tst.kind == jst.kind == "sort"
    assert tst.runs == jst.runs > 2
    got = spilled_result(ta, tv, td, tout).rows()
    jtypes = {c: SqlType(TypeKind(t.kind.value), t.precision, t.scale)
              for c, t in jd.items()}
    assert got == spilled_result(ja, jv, jtypes, jout).rows()
    ok, why = rows_match(got, run_oracle(conn, S1), ordered=True)
    assert ok and len(got) == 1000, why


def test_execute_spilled_needs_cuda_by_default(tpch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    js, ts, _conn, host = tpch
    plan, _out, _ = ts._plan_select(tparse(QUERIES[6]), None)
    js._plan_select(jparse(QUERIES[6]), None)  # keep colids in step
    providers, device_tables, types_by_table = spill_inputs(
        ts.catalog, plan, host)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tse.execute_spilled(plan, providers, str(tmp_path / "s"), BUDGET,
                            device_tables, types_by_table)


@pytest.mark.parametrize("qnum", [1, 3, 9, 13, 21])
def test_prune_scans_keeps_the_answer(tpch, qnum):
    """The scan pruning the port's spill tier applies first reads fewer
    lineitem columns and changes no in-memory result."""
    from oceanbase_tpu_torch.exec import plan as tp
    from oceanbase_tpu_torch.vector.column import to_numpy

    js, ts, _conn, _host = tpch
    ts.execute(QUERIES[qnum])  # the plan after its capacity re-plans
    js._plan_select(jparse(QUERIES[qnum]), None)  # keep colids in step
    plan, outputs = ts.last_plan, ts.last_outputs
    cols = {t: list(ts.catalog.table_data(t).columns)
            for t in ts.catalog.tables()}
    pruned = tse.prune_scans(plan, None, cols)
    scans = [n for n in _nodes(pruned) if isinstance(n, tp.TableScan)]
    assert scans and all(n.columns for n in scans)
    li = [n for n in scans if n.table == "lineitem"]
    assert all(len(n.columns) < len(cols["lineitem"]) for n in li)
    tables = {t: ts.catalog.table_data(t) for t in tp.referenced_tables(plan)}
    want = to_numpy(tp.execute_plan(plan, tables))
    got = to_numpy(tp.execute_plan(pruned, tables))
    for cid, _name in outputs:
        assert np.asarray(got[cid]).tolist() == \
            np.asarray(want[cid]).tolist(), cid


def _nodes(node):
    yield node
    for c in node.children():
        yield from _nodes(c)
