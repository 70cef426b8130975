"""The port's spill tier against the JAX package's on the CPU: the
temp-file store, the external merge sort, the partitioned joins (in
memory and through disk) and ``execute_spilled`` over TPC-H Q3 at
SF0.01, on the same inputs (numpy seeds, the same generated tables).

Ints, decimals, dates and strings must match exactly, float64 at 1e-12
relative.  The two binders number columns differently, so results are
compared by output position.  The TPC-H queries through
``execute_spilled`` are shared out with ``tests/test_torch_spill_tpch.py``
and ``tests/test_torch_granule.py``."""

import os

import numpy as np
import pytest
import torch

from oceanbase_tpu.exec import external_sort as jes
from oceanbase_tpu.exec import ops as jops
from oceanbase_tpu.exec import spill as jspill
from oceanbase_tpu.expr import ir as jir
from oceanbase_tpu.px import dist_ops as jdist
from oceanbase_tpu.storage.tmpfile import TempFileStore as JStore
from oceanbase_tpu_torch.exec import diag as tdiag
from oceanbase_tpu_torch.exec import external_sort as tes
from oceanbase_tpu_torch.exec import ops as tops
from oceanbase_tpu_torch.exec import spill as tspill
from oceanbase_tpu_torch.exec import spill_exec as tse
from oceanbase_tpu_torch.exec.ops import _mix64
from oceanbase_tpu_torch.expr import ir as tir
from oceanbase_tpu_torch.px import dist_ops as tdist
from oceanbase_tpu_torch.storage.tmpfile import TempFileStore
from test_torch_spill_tpch import check_spilled_query, tpch_env

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)


def _chunks(arrays, valids=None, chunk=1000):
    n = len(next(iter(arrays.values())))
    for s in range(0, n, chunk):
        yield ({k: v[s:s + chunk] for k, v in arrays.items()},
               {k: (vv[s:s + chunk] if vv is not None else None)
                for k, vv in (valids or {}).items()})


def _same_chunks(got, want):
    """Two (arrays, valids) chunk lists hold the same columns, chunk by
    chunk, exactly."""
    assert len(got) == len(want)
    for (ga, gv), (wa, wv) in zip(got, want):
        assert list(ga) == list(wa)
        for c in wa:
            assert ga[c].dtype == wa[c].dtype, c
            if wa[c].dtype == object:
                assert ga[c].tolist() == wa[c].tolist(), c
            else:
                np.testing.assert_array_equal(ga[c], wa[c], err_msg=c)
        assert sorted(k for k, v in gv.items() if v is not None) == \
            sorted(k for k, v in wv.items() if v is not None)
        for c, v in wv.items():
            if v is not None:
                np.testing.assert_array_equal(gv[c], v, err_msg=c)


def _rows(arrays, valids, cols):
    """Host columns -> sorted row tuples (None for NULL)."""
    if not arrays:
        return []
    n = len(arrays[cols[0]])
    out = []
    for i in range(n):
        row = []
        for c in cols:
            v = valids.get(c)
            row.append(None if v is not None and not v[i]
                       else arrays[c][i].item()
                       if hasattr(arrays[c][i], "item") else arrays[c][i])
        out.append(tuple(row))
    return sorted(out, key=lambda r: tuple((x is None, x) for x in r))


# ---------------------------------------------------------------------------
# temp-file store, planner split, aggregate split, hashing
# ---------------------------------------------------------------------------


def test_tmpfile_roundtrip_matches_jax(tmp_path):
    a1 = {"x": np.arange(10, dtype=np.int64),
          "s": np.array([f"v{i}" for i in range(10)], dtype=object),
          "f": np.linspace(0, 1, 10)}
    v1 = {"x": np.arange(10) % 2 == 0, "s": None}
    got = {}
    for name, cls in (("port", TempFileStore), ("jax", JStore)):
        with cls(str(tmp_path / name)) as store:
            rid = store.new_run()
            store.append_chunk(rid, a1, v1)
            store.append_chunk(rid, a1)
            got[name] = list(store.read_chunks(rid))
            assert store.run(rid).n_rows == 20
            assert store.total_bytes() > 0
            assert store.bytes_written == store.total_bytes()
            store.close_run(rid)
            assert store.total_bytes() == 0
            assert not os.path.exists(store._chunk_dir(rid))
        assert not (tmp_path / name).exists()  # swept on exit
    _same_chunks(got["port"], got["jax"])
    assert got["port"][0][0]["s"].dtype == object


def test_tmpfile_has_no_disk_plane_hooks(tmp_path):
    """The disk-budget and fault hooks wait for the storage plane: the
    store does not accept them."""
    with pytest.raises(TypeError):
        TempFileStore(str(tmp_path / "s"), budget=object())


def test_mix64_np_matches_torch_mix64():
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.integers(-2**63, 2**63 - 1, 5000, dtype=np.int64),
                        np.array([0, 1, -1, 2**63 - 1, -2**63])])
    want = tspill._mix64_np(x.view(np.uint64))
    got = _mix64(torch.from_numpy(x)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, jspill._mix64_np(x.view(np.uint64)))


@pytest.mark.parametrize("salt", [0, 1, 2])
def test_partition_of_matches_jax(salt):
    rng = np.random.default_rng(12)
    arrays = {"a": rng.integers(-10**9, 10**9, 4000),
              "b": rng.integers(0, 50, 4000).astype(np.int32)}
    for keys in (["a"], ["a", "b"]):
        np.testing.assert_array_equal(
            tspill._partition_of_salted(arrays, keys, 16, salt),
            jspill._partition_of_salted(arrays, keys, 16, salt))


def test_split_aggs_matches_jax():
    specs = [("s", "sum", "x"), ("c", "count", "x"), ("n", "count_star", None),
             ("lo", "min", "x"), ("hi", "max", "x"), ("a", "avg", "x")]
    t = tdist.split_aggs([tops.AggSpec(nm, fn, tir.col(a) if a else None)
                          for nm, fn, a in specs])
    j = jdist.split_aggs([jops.AggSpec(nm, fn, jir.col(a) if a else None)
                          for nm, fn, a in specs])
    for tpart, jpart in zip(t[:2], j[:2]):
        assert [(s.name, s.fn, repr(s.arg)) for s in tpart] == \
            [(s.name, s.fn, repr(s.arg)) for s in jpart]
    assert {k: repr(v) for k, v in t[2].items()} == \
        {k: repr(v) for k, v in j[2].items()}
    with pytest.raises(NotImplementedError):
        tdist.split_aggs([tops.AggSpec("d", "count_distinct", tir.col("x"))])


# ---------------------------------------------------------------------------
# external sort
# ---------------------------------------------------------------------------


def _sort_case(name, n, rng):
    if name == "ints":
        arrays = {"a": rng.integers(-10_000, 10_000, n).astype(np.int64),
                  "b": rng.integers(0, 3, n).astype(np.int64)}
        return arrays, {}, ["a", "b"], [True, False]
    if name == "strings_desc_nulls":
        arrays = {"s": np.array([f"w{int(i):04d}" for i in
                                 rng.integers(0, 500, n)], dtype=object),
                  "k": np.arange(n, dtype=np.int64)}
        return arrays, {"s": rng.random(n) > 0.1, "k": None}, ["s", "k"], \
            [False, True]
    # float keys with NaN and NULL, both directions, a DATE-width key
    f = rng.normal(size=n)
    f[rng.random(n) < 0.05] = np.nan
    arrays = {"f": f, "d": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
              "k": np.arange(n, dtype=np.int64)}
    return arrays, {"f": rng.random(n) > 0.1, "d": rng.random(n) > 0.2}, \
        ["f", "d", "k"], [True, False, True]


@pytest.mark.parametrize("case", ["ints", "strings_desc_nulls",
                                  "floats_nan_nulls"])
def test_external_sort_matches_jax(tmp_path, case):
    rng = np.random.default_rng(13)
    arrays, valids, keys, asc = _sort_case(case, 30_000, rng)
    got = {}
    for name, cls, mod in (("port", TempFileStore, tes),
                           ("jax", JStore, jes)):
        with cls(str(tmp_path / name)) as store:
            got[name] = list(mod.external_sort(
                _chunks(arrays, valids, chunk=3_000), keys, asc, store,
                budget_rows=5_000, out_chunk=4_096))
            assert store.bytes_written > 0  # it really spilled
            assert store._next > 6          # several runs, then merges
    _same_chunks(got["port"], got["jax"])
    n = sum(len(next(iter(a.values()))) for a, _v in got["port"])
    assert n == 30_000


# ---------------------------------------------------------------------------
# partitioned joins
# ---------------------------------------------------------------------------


def _join_inputs(rng, strings):
    nl, nr = 3_000, 1_500
    left = {"lk": rng.integers(0, 1_500, nl).astype(np.int64),
            "lk2": rng.integers(0, 3, nl).astype(np.int64),
            "lv": rng.integers(0, 100, nl).astype(np.int64)}
    right = {"rk": rng.integers(0, 1_500, nr).astype(np.int64),
             "rk2": rng.integers(0, 3, nr).astype(np.int64),
             "rv": rng.integers(0, 9, nr).astype(np.int64)}
    if not strings:
        return left, right, ["lk", "lk2"], ["rk", "rk2"]
    left["ls"] = np.array([f"s{i}" for i in left["lk"]], dtype=object)
    right["rs"] = np.array([f"s{i}" for i in right["rk"]], dtype=object)
    return left, right, ["ls", "lk2"], ["rs", "rk2"]


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("strings", [False, True])
def test_partitioned_join_matches_jax(how, strings):
    """Multi-key joins with a per-pair budget below the fan-out, so the
    pairs overflow and retry at 4x."""
    left, right, lkeys, rkeys = _join_inputs(
        np.random.default_rng(14), strings)
    stats = tse.SpillStats()
    got = tspill.partitioned_join(left, right, lkeys, rkeys, how=how,
                                  n_partitions=2, out_capacity_per_part=256,
                                  device="cpu", stats=stats)
    want = jspill.partitioned_join(left, right, lkeys, rkeys, how=how,
                                   n_partitions=2, out_capacity_per_part=256)
    cols = list(want[0])
    assert sorted(got[0]) == sorted(cols)
    assert _rows(*got, cols) == _rows(*want, cols)
    # each pair read its overflow scalar at least twice, then its rows
    assert stats.host_reads >= 3 * 2


def test_partitioned_join_raises_after_retries():
    left = {"lk": np.zeros(2_000, dtype=np.int64)}
    right = {"rk": np.zeros(2_000, dtype=np.int64)}
    with pytest.raises(tdiag.CapacityOverflow, match="still overflows"):
        tspill.partitioned_join(left, right, ["lk"], ["rk"],
                                out_capacity_per_part=1, device="cpu")


@pytest.mark.parametrize("how", ["inner", "left"])
def test_partitioned_join_spilled_recursive_matches_jax(tmp_path, how):
    """Every left key equal: the one hot pair exceeds the budget at every
    level and re-partitions with a fresh salt down to the depth limit,
    where it joins whole."""
    n = 2_000
    left = {"lk": np.full(n, 7, dtype=np.int64),
            "lv": np.arange(n, dtype=np.int64)}
    right = {"rk": np.array([7, 7, 3], dtype=np.int64),
             "rv": np.array([1, 2, 3], dtype=np.int64)}
    cols = ["lk", "lv", "rk", "rv"]
    out = {}
    for name, cls, mod, kw in (
            ("port", TempFileStore, tspill, {"device": "cpu"}),
            ("jax", JStore, jspill, {})):
        with cls(str(tmp_path / name)) as store:
            out[name] = list(mod.partitioned_join_spilled(
                _chunks(left, chunk=500), _chunks(right, chunk=500),
                ["lk"], ["rk"], store, how=how, n_partitions=4,
                budget_rows=600, **kw))
            assert store._next == 4 * 2 * 4  # four levels of 4+4 runs
            assert store.total_bytes() == 0  # every run closed
    assert len(out["port"]) == len(out["jax"]) == 1
    (ga, gv), (wa, wv) = out["port"][0], out["jax"][0]
    assert _rows(ga, gv, cols) == _rows(wa, wv, cols)
    assert len(ga["lk"]) == 2 * n and set(ga["rv"].tolist()) == {1, 2}


# ---------------------------------------------------------------------------
# execute_spilled over a TPC-H plan (the rest: test_torch_spill_tpch.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    return tpch_env()


@pytest.mark.parametrize("qnum", [3])
def test_execute_spilled_tpch_matches_jax(tpch, tmp_path, qnum,
                                          monkeypatch):
    check_spilled_query(tpch, tmp_path, qnum, monkeypatch)
