"""The port's TPC-H slice against the JAX package end to end: the same
generated data, the Q6/Q1/Q14 plans through both ``execute_plan``s on
bit-identical inputs (poisoned dead lanes included), the numpy oracles,
and the port's import and device rules."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oceanbase_tpu.analysis.poison import poison_tables, results_identical
from oceanbase_tpu.bench import queries as jq
from oceanbase_tpu.bench.tpch import gen_tpch as jgen
from oceanbase_tpu.exec.plan import execute_plan as jexec
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge
from oceanbase_tpu_torch.bench import oracle_np
from oceanbase_tpu_torch.bench import queries as tq
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen
from oceanbase_tpu_torch.exec.plan import execute_plan as texec
from oceanbase_tpu_torch.ops import q6_filter_sum
from oceanbase_tpu_torch.vector import column as tcol

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SF = 0.01
LINEITEM_COLS = ["l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                 "l_partkey"]
PART_COLS = ["p_partkey", "p_type"]


def jax_parts(rel):
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _to_port(jtables):
    out = {}
    for name, rel in jtables.items():
        parts, mask = jax_parts(rel)
        out[name] = bridge.relation_from_parts(parts, mask, device="cpu")
    return out


@pytest.fixture(scope="module")
def tpch():
    # the port's generator gives the same arrays (test_gen_tpch_is_identical)
    tables, types = jgen(sf=SF)
    jtables = {}
    for name, cols in (("lineitem", LINEITEM_COLS), ("part", PART_COLS)):
        arrays = {c: tables[name][c] for c in cols}
        jtables[name] = jcol.from_numpy(
            arrays, types={k: v for k, v in types.items() if k in arrays})
    return tables, jtables, _to_port(jtables)


def _plans(q, n):
    return {"q6": q.q6_plan(), "q1": q.q1_plan(), "q14": q.q14_plan(n)}


def _assert_results_match(tres, jres):
    assert sorted(tres) == sorted(jres)
    for k in jres:
        x, y = np.asarray(tres[k]), np.asarray(jres[k])
        assert x.shape == y.shape, k
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-12, err_msg=k)
        elif y.dtype == object:
            assert list(map(repr, x)) == list(map(repr, y)), k
        else:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_gen_tpch_is_identical():
    tt, ttypes = tgen(sf=SF)
    jt, jtypes = jgen(sf=SF)
    assert sorted(tt) == sorted(jt)
    for name in jt:
        assert list(tt[name]) == list(jt[name]), name
        for c in jt[name]:
            a, b = tt[name][c], jt[name][c]
            assert a.dtype == b.dtype, c
            if a.dtype == object:
                assert a.tolist() == b.tolist(), c
            else:
                assert a.tobytes() == b.tobytes(), c
    assert sorted(ttypes) == sorted(jtypes)
    for c, t in jtypes.items():
        assert (ttypes[c].kind.value, ttypes[c].precision, ttypes[c].scale) \
            == (t.kind.value, t.precision, t.scale), c


@pytest.mark.parametrize("qname", ["q6", "q1", "q14"])
def test_query_matches_jax(tpch, qname):
    tables, jtables, ttables = tpch
    n = len(tables["lineitem"]["l_orderkey"])
    jres = jcol.to_numpy(jexec(_plans(jq, n)[qname], jtables))
    tout = texec(_plans(tq, n)[qname], ttables)
    assert tout.device.type == "cpu"
    _assert_results_match(tcol.to_numpy(tout), jres)


@pytest.mark.parametrize("qname", ["q6", "q1", "q14"])
def test_query_matches_numpy_oracle(tpch, qname):
    tables, _jtables, ttables = tpch
    li, part = tables["lineitem"], tables["part"]
    n = len(li["l_orderkey"])
    res = tcol.to_numpy(texec(_plans(tq, n)[qname], ttables))
    if qname == "q6":
        assert int(res["revenue"][0]) == oracle_np.numpy_q6(li)
    elif qname == "q14":
        np.testing.assert_allclose(res["promo_revenue"][0],
                                   oracle_np.numpy_q14(li, part), rtol=1e-9)
    else:
        want = oracle_np.numpy_q1(li)
        for k, v in want.items():
            if v.dtype.kind == "f":
                np.testing.assert_allclose(res[k], v, rtol=1e-12)
            else:
                assert res[k].tolist() == v.tolist(), k


@pytest.mark.parametrize("qname", ["q6", "q1", "q14"])
def test_poison_lanes_match_jax(tpch, qname):
    tables, jtables, _ttables = tpch
    n = len(tables["lineitem"]["l_orderkey"])
    padded = {name: rel.pad_to(jcol.bucket_capacity(rel.capacity + 1))
              for name, rel in jtables.items()}
    poisoned = poison_tables(padded)
    jres = jcol.to_numpy(jexec(_plans(jq, n)[qname], poisoned))
    tclean = tcol.to_numpy(texec(_plans(tq, n)[qname], _to_port(padded)))
    tpois = tcol.to_numpy(texec(_plans(tq, n)[qname], _to_port(poisoned)))
    # the poison invariant: dead lanes change no bit of the port's result
    ok, why = results_identical(tclean, tpois)
    assert ok, why
    # against the reference: exact but for float64, where XLA turns the
    # avg's division by 10**scale into a multiplication (1 ulp apart)
    _assert_results_match(tpois, jres)


def test_q6_kernel_mode_matches_oracle(tpch):
    tables, _j, _t = tpch
    li = tables["lineitem"]
    cols = [torch.from_numpy(li[c].astype(np.int32)) for c in
            ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")]
    live = torch.ones(len(li["l_orderkey"]), dtype=torch.int32)
    got = q6_filter_sum(*cols, live, **oracle_np.Q6_BOUNDS)
    assert int(got) == oracle_np.numpy_q6(li)


def test_port_imports_no_jax():
    pkg = REPO / "oceanbase_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in pkg.rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'oceanbase_tpu' or m.startswith('oceanbase_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 15


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = {"a": np.arange(4)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcol.from_numpy(arrays)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcol.from_numpy(arrays, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.relation_from_parts(
            {"a": (np.arange(4), None, ("int", 0, 0), None)})
    assert tcol.from_numpy(arrays, device="cpu").device.type == "cpu"
