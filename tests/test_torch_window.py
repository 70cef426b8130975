"""The port's window operator against the JAX package's on identical
relations (padded, dead lanes poisoned, a tenth of the live lanes masked
out): every function and frame ``oceanbase_tpu/exec/window.py`` has,
with NULL partition and order keys, descending keys, ties, NaN and empty
frames.  Then the SQL cases of ``tests/test_window.py`` and
``tests/test_window_complete.py`` through both packages' ``Session``,
row for row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceanbase_tpu.datatypes as jdt
import oceanbase_tpu.exec.window as jwin
import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu_torch.datatypes as tdt
import oceanbase_tpu_torch.exec.window as twin
import oceanbase_tpu_torch.expr.ir as tir
from oceanbase_tpu.sql import Session as JSession
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch.sql import Session as TSession
from oceanbase_tpu_torch.vector import column as tcol
from test_torch_ops import _load

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rels():
    rng = np.random.default_rng(5)
    n = 300
    x = rng.normal(size=n)
    x[::37] = np.nan
    arrays = {
        "g": rng.integers(0, 7, n),
        "s": np.array(["ash", "elm", "fir", "oak"],
                      dtype=object)[rng.integers(0, 4, n)],
        "k": rng.permutation(n),
        "o": rng.integers(0, 20, n),
        "x": x,
        "v": rng.integers(-10_000, 10_000, n),
        "b": rng.random(n) < 0.4,
        "dt": rng.integers(9000, 9100, n).astype(np.int32),
    }
    types = {"v": jdt.SqlType.decimal(15, 2), "dt": jdt.SqlType.date()}
    valids = {"g": rng.random(n) < 0.85, "s": rng.random(n) < 0.9,
              "o": rng.random(n) < 0.85, "v": rng.random(n) < 0.9}
    return _load(arrays, types, valids, seed=5)


def _assert_same(trel, jrel):
    np.testing.assert_array_equal(trel.mask_or_true().numpy(),
                                  np.asarray(jrel.mask_or_true()))
    t, j = tcol.to_numpy(trel), jcol.to_numpy(jrel)
    assert sorted(t) == sorted(j)
    for k in j:
        x, y = np.asarray(t[k]), np.asarray(j[k])
        assert x.shape == y.shape, k
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-12, err_msg=k)
        elif y.dtype == object:
            assert list(map(repr, x)) == list(map(repr, y)), k
        else:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


PARTS = {"nopart": [], "g": ["g"], "s_g": ["s", "g"]}
ORDERS = {
    "k": [("k", True)],
    "o_desc_k": [("o", False), ("k", True)],   # NULLs and ties, descending
    "x": [("x", True)],                        # NaN order keys
    "s_o": [("s", True), ("o", True)],         # NULL string keys
}

# (id, [(fn, arg, extra, frame)]): one window() call per case
RANKING = [("row_number", None, None, None), ("rank", None, None, None),
           ("dense_rank", None, None, None), ("ntile", None, [3], None),
           ("ntile", None, [7], None)]
NAVIGATION = [
    ("lead", "v", None, None), ("lag", "v", [2], None),
    ("lag", "v", [1, ("dec", "-1.25")], None),
    ("lead", "x", [3, -1.5], None),
    ("lag", "s", None, None), ("lead", "dt", [1], None),
    ("first_value", "v", None, None), ("last_value", "v", None, None),
    ("first_value", "x", None, ("rows", -2, 0)),
    ("last_value", "s", None, ("rows", 0, 2)),
    ("first_value", "v", None, ("rows", None, 0)),
    ("last_value", "v", None, ("rows", -1, None)),
    ("last_value", "v", None, ("rows", 3, 1)),          # always empty
]
AGGS = ["sum", "avg", "count", "count_star", "min", "max"]
FRAMES = {"rows_3p": ("rows", -3, 0),
          "rows_2p2f": ("rows", -2, 2), "rows_unb_p": ("rows", None, 0),
          "rows_unb_f": ("rows", 0, None), "rows_unb": ("rows", None, None),
          "rows_empty": ("rows", 2, 1)}


def _call(ir, fn, arg, extra, frame, part, order):
    dt = jdt if ir is jir else tdt
    if extra is not None:
        # ("dec", text): a DECIMAL literal; anything else a plain one
        extra = [ir.Literal(e[1], dt.SqlType.decimal(15, 2))
                 if isinstance(e, tuple) else ir.Literal(e) for e in extra]
    return ir.WindowCall(
        fn, None if arg is None else ir.col(arg),
        [ir.col(p) for p in part],
        [(ir.col(c), asc) for c, asc in order], frame, extra)


def _run(rels, specs, part, order):
    jrel, trel = rels
    jspecs = [(f"w{i}", _call(jir, *s, part, order))
              for i, s in enumerate(specs)]
    tspecs = [(f"w{i}", _call(tir, *s, part, order))
              for i, s in enumerate(specs)]
    _assert_same(twin.window(trel, tspecs), jwin.window(jrel, jspecs))


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("part", sorted(PARTS))
def test_ranking_matches(rels, part, order):
    _run(rels, RANKING, PARTS[part], ORDERS[order])


@pytest.mark.parametrize("order", ["k", "o_desc_k"])
@pytest.mark.parametrize("part", sorted(PARTS))
def test_navigation_matches(rels, part, order):
    _run(rels, NAVIGATION, PARTS[part], ORDERS[order])


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("arg", ["v", "x", "b", "dt"])
def test_aggregates_framed_match(rels, arg, frame):
    fns = [f for f in AGGS if not (arg == "dt" and f in ("sum", "avg"))]
    specs = [(f, None if f == "count_star" else arg, None, FRAMES[frame])
             for f in fns]
    _run(rels, specs, ["g"], ORDERS["k"])


@pytest.mark.parametrize("order", ["none", "k", "o_desc_k", "x"])
@pytest.mark.parametrize("part", sorted(PARTS))
def test_aggregates_running_and_unordered_match(rels, part, order):
    specs = [(f, None if f == "count_star" else a, None, None)
             for f in AGGS for a in ("v", "x")
             if not (f == "count_star" and a == "x")]
    if order == "none":
        specs += [("min", "s", None, None), ("max", "s", None, None)]
    _run(rels, specs, PARTS[part], [] if order == "none" else ORDERS[order])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 63, 64, 100, 257])
@pytest.mark.parametrize("op", ["min", "max"])
def test_segmented_scan_matches_associative_scan(n, op):
    """The log-step segmented scan against the reference's
    associative_scan, at capacities that are not powers of two, with NaN
    in the values."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    flags = rng.random(n) < 0.2
    flags[0] = True
    jop = jnp.minimum if op == "min" else jnp.maximum

    def seg_op(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, jop(av, bv)), af | bf

    want, _ = jax.jit(lambda a, f: jax.lax.associative_scan(
        seg_op, (a, f)))(jnp.asarray(x), jnp.asarray(flags))
    got = twin._segmented_scan(
        torch.from_numpy(x), torch.from_numpy(flags),
        torch.minimum if op == "min" else torch.maximum)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lag_string_default_merges_dictionaries(rels):
    """A string default the column's dictionary lacks comes out as
    itself (the reference maps it through the column's dictionary and
    returns another value; ROADMAP Queue 3)."""
    _jrel, trel = rels
    wc = tir.WindowCall("lag", tir.col("s"), [], [(tir.col("k"), True)],
                        None, [tir.Literal(1), tir.Literal("zzz")])
    out = tcol.to_numpy(twin.window(trel, [("w", wc)]))
    first = int(np.argmin(out["k"]))
    assert out["w"][first] == "zzz"
    live_s = {x for x in out["s"] if x is not None}
    assert set(x for x in out["w"] if x is not None) <= live_s | {"zzz"}


# ---------------------------------------------------------------------------
# SQL: tests/test_window.py and tests/test_window_complete.py, both
# packages' sessions
# ---------------------------------------------------------------------------


def _sessions(load):
    js, ts = JSession(), TSession(device="cpu")
    for s in (js, ts):
        load(s)
    return js, ts


@pytest.fixture(scope="module")
def emp():
    rng = np.random.default_rng(7)
    n = 500
    dept = rng.integers(0, 5, n)
    sal = rng.integers(1000, 9000, n)
    return _sessions(lambda s: s.catalog.load_numpy(
        "emp", {"eid": np.arange(n), "dept": dept, "sal": sal}))


@pytest.fixture(scope="module")
def tkv():
    rng = np.random.default_rng(7)
    n = 500
    t = {"k": np.arange(n), "g": rng.integers(0, 7, n),
         "v": rng.integers(-50, 100, n)}
    return _sessions(lambda s: s.catalog.load_numpy("t", t,
                                                    primary_key=["k"]))


@pytest.fixture(scope="module")
def tn():
    n = 60
    valid = (np.arange(n) % 5) != 0
    return _sessions(lambda s: s.catalog.load_numpy(
        "tn", {"k": np.arange(n), "g": np.arange(n) % 3,
               "v": np.arange(n, dtype=np.int64)},
        primary_key=["k"], valids={"v": valid}))


def _key(row):
    return tuple((v is None, "" if v is None else str(type(v)),
                  0 if v is None else v) for v in row)


def assert_rows_equal(got, want, ordered):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True), (g, w)
            else:
                assert a == b, (g, w)


WINDOW_SQL = [
    "select eid, row_number() over "
    "(partition by dept order by sal desc, eid) as rn from emp",
    "select eid, rank() over (partition by dept order by sal) as r, "
    "dense_rank() over (partition by dept order by sal) as dr from emp",
    "select eid, sum(sal) over (partition by dept) as total, "
    "count(*) over (partition by dept) as cnt, "
    "max(sal) over (partition by dept) as mx from emp",
    "select eid, sum(sal) over "
    "(partition by dept order by eid) as running from emp",
    "select eid, sum(sal) over (partition by dept order by sal) as running, "
    "min(sal) over (partition by dept order by eid) as rmin from emp",
    "select eid, avg(sal) over () as a, "
    "row_number() over (order by eid) as rn from emp",
    "select dept, sum(sal) as s, rank() over (order by sum(sal) desc) as r "
    "from emp group by dept",
]

COMPLETE_SQL = [
    "select k, lag(v) over (partition by g order by k) from t order by k",
    "select k, lead(v) over (partition by g order by k) from t order by k",
    "select k, lead(v, 3) over (partition by g order by k) from t "
    "order by k",
    "select k, lag(v, 2, -1) over (partition by g order by k) from t "
    "order by k",
    "select k, ntile(4) over (order by k) from t order by k",
    "select k, ntile(3) over (partition by g order by k) from t "
    "order by k",
    "select k, first_value(v) over (partition by g order by k) from t "
    "order by k",
    "select k, last_value(v) over (partition by g order by k) from t "
    "order by k",
    "select k, sum(v) over (partition by g order by k "
    "rows between unbounded preceding and current row) from t order by k",
    "select k, sum(v) over (partition by g order by k "
    "rows between 3 preceding and current row) from t order by k",
    "select k, sum(v) over (partition by g order by k "
    "rows between 2 preceding and 2 following) from t order by k",
    "select k, count(v) over (partition by g order by k "
    "rows between 1 preceding and 1 following) from t order by k",
    "select k, min(v) over (partition by g order by k "
    "rows between 5 preceding and current row) from t order by k",
    "select k, max(v) over (partition by g order by k "
    "rows between 2 preceding and 4 following) from t order by k",
    "select k, avg(v) over (partition by g order by k "
    "rows between 3 preceding and 1 following) from t order by k",
    "select k, first_value(v) over (partition by g order by k "
    "rows between 2 preceding and current row) from t order by k",
    "select k, last_value(v) over (partition by g order by k "
    "rows between current row and 2 following) from t order by k",
    "select k, sum(v) over (partition by g order by k "
    "rows between current row and unbounded following) from t "
    "order by k",
]

NULL_SQL = [
    "select k, lag(v) over (partition by g order by k) from tn order by k",
    "select k, sum(v) over (partition by g order by k "
    "rows between 2 preceding and current row) from tn order by k",
    "select k, min(v) over (partition by g order by k "
    "rows between 1 preceding and 1 following) from tn order by k",
]


@pytest.mark.parametrize("qi", range(len(WINDOW_SQL)))
def test_window_sql_matches_jax_session(emp, qi):
    js, ts = emp
    sql = WINDOW_SQL[qi]
    assert_rows_equal(ts.execute(sql).rows(), js.execute(sql).rows(),
                      ordered=False)


@pytest.mark.parametrize("qi", range(len(COMPLETE_SQL)))
def test_window_complete_sql_matches_jax_session(tkv, qi):
    js, ts = tkv
    sql = COMPLETE_SQL[qi]
    assert_rows_equal(ts.execute(sql).rows(), js.execute(sql).rows(),
                      ordered=True)


@pytest.mark.parametrize("qi", range(len(NULL_SQL)))
def test_window_null_sql_matches_jax_session(tn, qi):
    js, ts = tn
    sql = NULL_SQL[qi]
    assert_rows_equal(ts.execute(sql).rows(), js.execute(sql).rows(),
                      ordered=True)
