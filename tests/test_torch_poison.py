"""The port's poison-lane verifier (``oceanbase_tpu_torch/analysis/
poison.py``) against the reference's: the same poisoned bytes in every
column kind, the same verdicts from ``results_identical``, and the
invariant on the port's plans, TPC-H queries and PX plans on the CPU."""

import numpy as np
import pytest
import torch

from oceanbase_tpu.analysis import poison as rpoison
from oceanbase_tpu.datatypes import SqlType as JType
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge
from oceanbase_tpu_torch.analysis import poison as ppoison
from oceanbase_tpu_torch.bench import queries as tq
from oceanbase_tpu_torch.bench.harness import (
    dead_lane_padded,
    poison_checked,
    tpch_session,
)
from oceanbase_tpu_torch.bench.tpch import gen_tpch
from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.exec.plan import execute_plan, referenced_tables
from oceanbase_tpu_torch.px.exchange import set_mesh_size
from oceanbase_tpu_torch.px.planner import execute_plan_distributed
from oceanbase_tpu_torch.sql.parser import parse_sql
from oceanbase_tpu_torch.vector import Column, Relation, from_numpy

torch.set_num_threads(2)

SF = 0.01


def _jax_parts(rel):
    """A JAX Relation as the bridge's numpy parts, every lane kept."""
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _every_kind(n=97, cap=128, seed=12):
    """A reference relation with ``cap - n`` dead lanes and one column of
    each kind: int64, float64, DECIMAL, DATE, bool, a nullable int,
    dictionary strings and a 2-D VECTOR."""
    rng = np.random.default_rng(seed)
    words = np.array(["MAIL", "SHIP", "AIR", "", "TRUCK"], dtype=object)
    arrays = {
        "i": rng.integers(-1000, 1000, n),
        "f": rng.normal(size=n),
        "dec": rng.integers(-99999, 99999, n),
        "d": rng.integers(8000, 11000, n).astype(np.int32),
        "b": rng.random(n) < 0.5,
        "ni": rng.integers(0, 50, n),
        "s": words[rng.integers(0, len(words), n)],
    }
    types = {"dec": JType.decimal(15, 2), "d": JType.date()}
    rel = jcol.from_numpy(arrays, types=types,
                          valids={"ni": rng.random(n) < 0.7})
    import jax.numpy as jnp

    vec = rng.normal(size=(n, 4)).astype(np.float32)
    cols = dict(rel.columns)
    cols["v"] = jcol.Column(jnp.asarray(vec), None, JType.vector(4))
    return jcol.Relation(columns=cols, mask=rel.mask).pad_to(cap)


def test_poison_pad_lanes_matches_the_reference_byte_for_byte():
    jrel = _every_kind()
    parts, mask = _jax_parts(jrel)
    assert not mask.all()
    trel = bridge.relation_from_parts(parts, mask, device="cpu")
    jparts, jmask = _jax_parts(rpoison.poison_pad_lanes(jrel))
    tparts, tmask = bridge.relation_to_parts(ppoison.poison_pad_lanes(trel))
    assert jmask.tobytes() == tmask.tobytes()
    assert sorted(jparts) == sorted(tparts)
    for name in jparts:
        jd, jv, jt, js = jparts[name]
        td, tv, tt, ts = tparts[name]
        assert jd.dtype == td.dtype and jd.shape == td.shape, name
        assert jd.tobytes() == td.tobytes(), name
        assert (jv is None) == (tv is None), name
        if jv is not None:
            assert jv.tobytes() == tv.tobytes(), name
        assert jt == tt, name
    dead = ~tmask
    assert np.isnan(tparts["v"][0][dead]).all()
    assert (tparts["i"][0][dead] == ppoison.INT_POISON).all()
    assert tparts["ni"][1][dead].all() and tparts["b"][0][dead].all()
    assert (tparts["s"][0][dead] == -1).all()


def test_poison_stays_on_the_relations_device():
    rel = from_numpy({"x": np.arange(10)}, device="cpu").pad_to(64)
    out = ppoison.poison_pad_lanes(rel)
    assert out.columns["x"].data.device == rel.device
    # no dead lane: the same data
    live = from_numpy({"x": np.arange(10)}, device="cpu")
    same = ppoison.poison_pad_lanes(live).columns["x"].data
    assert torch.equal(same, live.columns["x"].data)


RESULT_PAIRS = {
    "nan-equals-nan": ({"a": np.array([np.nan, 1.0])},
                       {"a": np.array([np.nan, 1.0])}),
    "negative-zero": ({"a": np.array([0.0])}, {"a": np.array([-0.0])}),
    "objects-equal": ({"s": np.array(["x", None], dtype=object)},
                      {"s": np.array(["x", None], dtype=object)}),
    "objects-differ": ({"s": np.array(["x", None], dtype=object)},
                       {"s": np.array(["x", "y"], dtype=object)}),
    "columns-differ": ({"a": np.zeros(1)}, {"b": np.zeros(1)}),
    "shapes-differ": ({"a": np.zeros(2)}, {"a": np.zeros(3)}),
    "ints-differ": ({"a": np.array([1, 2])}, {"a": np.array([1, 3])}),
}


@pytest.mark.parametrize("case", sorted(RESULT_PAIRS))
def test_results_identical_agrees_with_the_reference(case):
    a, b = RESULT_PAIRS[case]
    assert ppoison.results_identical(a, b) == \
        rpoison.results_identical(a, b)


def test_a_planted_unmasked_sum_is_caught():
    rel = dead_lane_padded(from_numpy({"x": np.arange(100)}, device="cpu"))

    def leaky(tables):
        x = tables["t"].columns["x"].data
        return Relation(columns={"s": Column(x.sum().reshape(1), None,
                                             SqlType.int_())})

    def masked(tables):
        t = tables["t"]
        x = torch.where(t.mask_or_true(), t.columns["x"].data, 0)
        return Relation(columns={"s": Column(x.sum().reshape(1), None,
                                             SqlType.int_())})

    with pytest.raises(AssertionError, match="poison-lane invariant"):
        ppoison.assert_poison_invariant(leaky, {"t": rel})
    ppoison.assert_poison_invariant(masked, {"t": rel})


@pytest.fixture(scope="module")
def tpch():
    tables, types = gen_tpch(sf=SF)
    sess, _load_s, _analyze_s = tpch_session(tables, types, device="cpu")
    padded = {t: dead_lane_padded(sess.catalog.table_data(t))
              for t in tables}
    return tables, types, sess, padded


def test_dead_lanes_at_the_bucket(tpch):
    tables, _types, _sess, padded = tpch
    n = len(tables["lineitem"]["l_orderkey"])
    li = padded["lineitem"]
    assert li.capacity == 65536 and int(li.mask.sum()) == n


def _serial(p, t, _factor):
    return execute_plan(p, t)


@pytest.mark.parametrize("q", ["q1", "q6", "q14"])
def test_hand_built_plans_hold_the_invariant(tpch, q):
    tables, _types, _sess, padded = tpch
    plan = {"q1": tq.q1_plan, "q6": tq.q6_plan,
            "q14": lambda: tq.q14_plan(len(tables["lineitem"]
                                           ["l_orderkey"]))}[q]()
    assert poison_checked(_serial, plan, padded) == 0


def _bound(sess, q):
    plan, _outs, _est = sess._plan_select(parse_sql(QUERIES[q]), None)
    return plan


@pytest.mark.parametrize("q", [3, 5, 9, 13, 16, 18, 21, 22])
def test_tpch_queries_hold_the_invariant(tpch, q):
    _tables, _types, sess, padded = tpch
    plan = _bound(sess, q)
    sub = {t: padded[t] for t in referenced_tables(plan)}
    poison_checked(_serial, plan, sub)


@pytest.mark.parametrize("q", [1, 3])
def test_px_queries_hold_the_invariant(tpch, q):
    _tables, _types, sess, padded = tpch
    plan = _bound(sess, q)
    sub = {t: padded[t] for t in referenced_tables(plan)}

    def px(p, t, factor):
        return execute_plan_distributed(p, t, dop=8, budget_factor=factor,
                                        device="cpu")

    set_mesh_size(8)
    try:
        poison_checked(px, plan, sub)
    finally:
        set_mesh_size(None)


def test_a_poisoned_overflow_alone_fails(tpch):
    """The ladder re-plans a clean overflow, never a poisoned one."""
    _tables, _types, _sess, padded = tpch
    from oceanbase_tpu_torch.exec.diag import CapacityOverflow

    runs = []

    def run(p, t, _factor):
        runs.append(t)
        if len(runs) == 2:
            raise CapacityOverflow("only the poisoned run overflowed")
        return execute_plan(p, t)

    with pytest.raises(CapacityOverflow):
        poison_checked(run, tq.q6_plan(), padded)
    assert len(runs) == 2
