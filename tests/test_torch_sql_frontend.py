"""The port's SQL front end against the JAX package's: the 22 TPC-H
queries parse to equal ASTs, and bound on catalogs loaded from the same
TPC-H SF0.01 data, with the load-time statistics and again after ANALYZE
TABLE (whose statistics must match too), they give the same plan, node
for node: the same
``logical_hash``, the same capacities and estimates in postorder, and the
same values folded from scalar subqueries at bind time (the port folds
them with its own executor, on the CPU here).  Both binders price plans
with explicit uncalibrated cost units, so process-wide units another test
may have set cannot make them differ."""

import dataclasses
import enum
import itertools

import numpy as np
import pytest
import torch

import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu_torch.expr.ir as tir
from oceanbase_tpu.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
from oceanbase_tpu.bench.tpch_queries import QUERIES as JQUERIES
from oceanbase_tpu.catalog import Catalog as JCatalog
from oceanbase_tpu.exec import plan as jplan
from oceanbase_tpu.sql import Session as JSession
from oceanbase_tpu.sql import binder as jbinder
from oceanbase_tpu.sql import optimizer as jopt
from oceanbase_tpu.sql.parser import parse_sql as jparse
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen_tpch
from oceanbase_tpu_torch.bench.tpch_queries import QUERIES as TQUERIES
from oceanbase_tpu_torch.catalog import Catalog as TCatalog
from oceanbase_tpu_torch.exec import plan as tplan
from oceanbase_tpu_torch.sql import Session as TSession
from oceanbase_tpu_torch.sql import binder as tbinder
from oceanbase_tpu_torch.sql import optimizer as topt
from oceanbase_tpu_torch.sql.parser import parse_sql as tparse

SF = 0.01
QNUMS = sorted(JQUERIES)


def _norm(x):
    """A package-neutral rendering of an AST: dataclasses become (class
    name, fields), enums their value, containers element-wise."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_norm(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((_norm(k), _norm(v)) for k, v in x.items()))
    if isinstance(x, (np.generic,)):
        return x.item()
    return x


def test_query_texts_identical():
    assert TQUERIES == JQUERIES


@pytest.mark.parametrize("qnum", QNUMS)
def test_parse_equal_ast(qnum):
    assert _norm(tparse(TQUERIES[qnum])) == _norm(jparse(JQUERIES[qnum]))


def load_catalogs(sf):
    """(JAX catalog, port catalog on the CPU) over the same generated
    arrays (the port's generator is array-for-array the reference's)."""
    tables, jtypes = gen_tpch(sf=sf)
    _t, ttypes = tgen_tpch(sf=sf)
    jc, tc = JCatalog(), TCatalog(device="cpu")
    for name, arrays in tables.items():
        pk = TPCH_PRIMARY_KEYS[name]
        jc.load_numpy(name, arrays, primary_key=pk,
                      types={k: v for k, v in jtypes.items() if k in arrays})
        tc.load_numpy(name, arrays, primary_key=pk,
                      types={k: v for k, v in ttypes.items() if k in arrays})
    return jc, tc, tables, jtypes


@pytest.fixture(scope="module")
def catalogs():
    jc, tc, _tables, _types = load_catalogs(SF)
    return jc, tc


def _bind(binder_mod, opt_mod, catalog, parse, sql):
    b = binder_mod.Binder(catalog)
    b.cost_model = opt_mod.CostModel(units=opt_mod._default_units())
    return b.bind_select(parse(sql))


def _postorder(node):
    out = []
    for c in node.children():
        out.extend(_postorder(c))
    out.append((type(node).__name__, getattr(node, "out_capacity", None),
                getattr(node, "capacity", None), node.est_rows))
    return out


def _literals(node, ir):
    """Every literal in the plan's expressions, in walk order."""
    found = []

    def visit(v):
        if isinstance(v, ir.Literal):
            found.append((repr(v.value), repr(v.dtype)))
        if isinstance(v, ir.Expr):
            for c in v.children():
                visit(c)
        elif isinstance(v, (list, tuple)):
            for c in v:
                visit(c)
        elif isinstance(v, dict):
            for c in v.values():
                visit(c)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                visit(getattr(v, f.name))

    def walk(n):
        for k, v in vars(n).items():
            if k not in ("child", "left", "right", "inputs") and \
                    not k.startswith("_"):
                visit(v)
        for c in n.children():
            walk(c)

    walk(node)
    return found


def align_colids():
    """Start both binders' process-wide column-id counters at one value.
    Output names embed the ids, and earlier tests in the same worker may
    have bound more statements in one package than in the other."""
    start = max(next(jbinder._uid), next(tbinder._uid))
    jbinder._uid = itertools.count(start)
    tbinder._uid = itertools.count(start)


@pytest.mark.parametrize("qnum", QNUMS)
def test_bound_plan_matches(catalogs, qnum):
    jc, tc = catalogs
    align_colids()
    jp, jouts, jest = _bind(jbinder, jopt, jc, jparse, JQUERIES[qnum])
    tp, touts, test = _bind(tbinder, topt, tc, tparse, TQUERIES[qnum])
    assert tplan.logical_hash(tp) == jplan.logical_hash(jp)
    assert _postorder(tp) == _postorder(jp)
    assert test == jest
    assert [n for _c, n in touts] == [n for _c, n in jouts]
    # folded scalar subqueries (Q11, Q15, Q22, ...) compared directly
    assert _literals(tp, tir) == _literals(jp, jir)


@pytest.fixture(scope="module")
def analyzed():
    """Both packages' sessions over the same data after ANALYZE TABLE of
    every table (exact NDV, histograms, most-common values)."""
    jc, tc, tables, _types = load_catalogs(SF)
    js, ts = JSession(catalog=jc), TSession(catalog=tc)
    for name in tables:
        js.execute(f"analyze table {name}")
        ts.execute(f"analyze table {name}")
    return jc, tc, sorted(tables)


def test_analyze_stats_match(analyzed):
    jc, tc, names = analyzed
    for name in names:
        jd, td = jc.table_def(name), tc.table_def(name)
        assert td.row_count == jd.row_count
        assert td.ndv == jd.ndv
        assert td.mcv == jd.mcv
        assert sorted(td.histograms) == sorted(jd.histograms)
        for col, (edges, nf) in jd.histograms.items():
            np.testing.assert_array_equal(td.histograms[col][0], edges)
            assert td.histograms[col][1] == nf


@pytest.mark.parametrize("qnum", QNUMS)
def test_analyzed_plan_matches(analyzed, qnum):
    jc, tc, _names = analyzed
    jp, _jo, jest = _bind(jbinder, jopt, jc, jparse, JQUERIES[qnum])
    tp, _to, test = _bind(tbinder, topt, tc, tparse, TQUERIES[qnum])
    assert tplan.logical_hash(tp) == jplan.logical_hash(jp)
    assert _postorder(tp) == _postorder(jp)
    assert test == jest
    assert _literals(tp, tir) == _literals(jp, jir)


def test_capacity_ladder_matches(catalogs):
    """scale_capacities and overflow_jump_factor, the retry ladder's two
    steps, give the same plans and factors in both packages."""
    jc, tc = catalogs
    jp, _o, _e = _bind(jbinder, jopt, jc, jparse, JQUERIES[21])
    tp, _o, _e = _bind(tbinder, topt, tc, tparse, TQUERIES[21])
    for factor in (4, 16, 1 << 20):
        assert _postorder(topt.scale_capacities(tp, factor)) == \
            _postorder(jopt.scale_capacities(jp, factor))
    drops = [("join_overflow", 64, 1000), ("groupby_overflow", 512, 3)]
    assert topt.overflow_jump_factor(drops) == \
        jopt.overflow_jump_factor(drops)


def test_session_select_only_and_device(monkeypatch):
    s = TSession(device="cpu")
    assert s.device.type == "cpu"
    assert s.execute("select 1 + 2 as x").rows() == [(3,)]
    # the catalog-only statements run (tests/test_torch_dml.py); what
    # needs a Database says so
    s.execute("create table t (a int)")
    assert s.execute("insert into t values (1)").rowcount == 1
    assert s.catalog.table_data("t").device.type == "cpu"
    with pytest.raises(NotImplementedError, match="needs a Database"):
        s.execute("truncate table t")
    with pytest.raises(NotImplementedError, match="needs a Database"):
        s.execute("load data infile '/x.csv' into table t")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSession()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCatalog()
