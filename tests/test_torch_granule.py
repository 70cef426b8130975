"""The port's granule-streaming tier against the JAX package's on the CPU:
``execute_streamed`` on the Q1/Q6 plans over TPC-H SF0.01 lineitem in
ragged granules, ``execute_sorted_streamed`` with LIMIT/OFFSET, poisoned
dead lanes, the group-by overflow the reference drops and the port
raises, ``prefetch_iter``'s exception and early-exit semantics, and the
spill tier's single-table and scalar-join plans (TPC-H Q1, Q6, Q14)
through ``execute_spilled`` (helpers in ``tests/test_torch_spill_tpch.py``).

Ints, decimals, dates and strings must match exactly, float64 at 1e-12
relative."""

import numpy as np
import pytest
import torch

from oceanbase_tpu.bench import queries as jq
from oceanbase_tpu.bench.tpch import gen_tpch
from oceanbase_tpu.exec import granule as jg
from oceanbase_tpu.exec import ops as jops
from oceanbase_tpu.exec import plan as jp
from oceanbase_tpu.expr import ir as jir
from oceanbase_tpu.px import planner as jplanner
from oceanbase_tpu.vector import to_numpy as jto_numpy
from oceanbase_tpu_torch.bench import oracle_np
from oceanbase_tpu_torch.bench import queries as tq
from oceanbase_tpu_torch.bench.tpch import gen_tpch as tgen
from oceanbase_tpu_torch.exec import granule as tg
from oceanbase_tpu_torch.exec import ops as tops
from oceanbase_tpu_torch.exec import plan as tp
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.expr import ir as tir
from oceanbase_tpu_torch.px import planner as tplanner
from oceanbase_tpu_torch.vector.column import to_numpy as tto_numpy
from test_torch_spill_tpch import check_spilled_query, tpch_env

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)

SF = 0.01
CHUNK = 16_384  # 60,175 lineitem rows: 4 granules, the last 11,023 live
Q_COLS = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
          "l_discount", "l_tax", "l_shipdate"]


@pytest.fixture(scope="module")
def lineitem():
    tables, jtypes = gen_tpch(sf=SF)
    _t, ttypes = tgen(sf=SF)
    li = tables["lineitem"]
    arrays = {k: li[k] for k in Q_COLS}
    return (li, arrays, {k: v for k, v in jtypes.items() if k in Q_COLS},
            {k: v for k, v in ttypes.items() if k in Q_COLS})


def _same(tres, jres):
    assert sorted(tres) == sorted(jres)
    for k, y in jres.items():
        x, y = np.asarray(tres[k]), np.asarray(y)
        assert x.shape == y.shape, k
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-12, err_msg=k)
        elif y.dtype == object:
            assert x.tolist() == y.tolist(), k
        else:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def _plan(mod, q):
    return {"q1": mod.q1_plan, "q6": mod.q6_plan}[q]()


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_streamed_matches_jax(lineitem, q):
    li, arrays, jtypes, ttypes = lineitem
    n = len(li["l_orderkey"])
    assert n // CHUNK == 3 and n % CHUNK  # three full granules, one ragged
    jres = jto_numpy(jg.execute_streamed(
        _plan(jq, q), jg.numpy_chunk_provider(arrays), chunk_rows=CHUNK,
        types=jtypes))
    stats = tg.StreamStats()
    out = tg.execute_streamed(
        _plan(tq, q), tg.numpy_chunk_provider(arrays), chunk_rows=CHUNK,
        types=ttypes, device="cpu", stats=stats)
    assert out.device.type == "cpu"
    assert stats.granules == 4
    assert stats.copy_events == [] and stats.h2d_bytes == 0  # no card
    tres = tto_numpy(out)
    _same(tres, jres)
    if q == "q6":
        assert int(tres["revenue"][0]) == oracle_np.numpy_q6(li)
    else:
        want = oracle_np.numpy_q1(li)
        for k, v in want.items():
            got = np.asarray(tres[k])
            if v.dtype.kind == "f":
                np.testing.assert_allclose(got, v, rtol=1e-12, err_msg=k)
            else:
                assert got.tolist() == v.tolist(), k


def test_streamed_cache_keeps_dicts_and_results(lineitem):
    _li, arrays, _jtypes, ttypes = lineitem
    cache = {}
    runs = [tto_numpy(tg.execute_streamed(
        tq.q1_plan(), tg.numpy_chunk_provider(arrays), chunk_rows=CHUNK,
        types=ttypes, cache=cache, device="cpu")) for _ in range(2)]
    gdicts = cache["gdicts"]
    assert sorted(gdicts) == ["l_linestatus", "l_returnflag"]
    _same(runs[1], runs[0])
    tg.execute_streamed(tq.q1_plan(), tg.numpy_chunk_provider(arrays),
                        chunk_rows=CHUNK, types=ttypes, cache=cache,
                        device="cpu")
    assert cache["gdicts"] is gdicts


def test_global_dicts_match_jax(lineitem):
    _li, arrays, _jtypes, _ttypes = lineitem
    jd = jg._global_dicts(jg.numpy_chunk_provider(arrays), "lineitem", CHUNK)
    td = tg._global_dicts(tg.numpy_chunk_provider(arrays), "lineitem", CHUNK)
    assert sorted(td) == sorted(jd)
    for k in jd:
        assert td[k].values.tolist() == jd[k].values.tolist()
    # a scan that reads no string column skips them
    assert tg._global_dicts(tg.numpy_chunk_provider(arrays), "lineitem",
                            CHUNK, ["l_quantity"]) == {}


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_poisoned_dead_lanes_change_nothing(lineitem, q, monkeypatch):
    """Dead lanes of the ragged granule carry garbage payloads and
    validity; the results stay bit-identical."""
    _li, arrays, _jtypes, ttypes = lineitem
    clean = tto_numpy(tg.execute_streamed(
        _plan(tq, q), tg.numpy_chunk_provider(arrays), chunk_rows=CHUNK,
        types=ttypes, device="cpu"))
    upload = tg.GranuleUploader.upload
    rng = np.random.default_rng(5)
    poisoned = []

    def poison(self, host, n, stats=None):
        out = upload(self, host, n, stats)
        for k, t in out.items():
            if n < t.shape[0]:
                junk = rng.integers(-2**31, 2**31 - 1, t.shape[0] - n)
                t[n:] = torch.from_numpy(junk).to(t.dtype) \
                    if t.dtype != torch.bool else True
                poisoned.append(k)
        return out

    monkeypatch.setattr(tg.GranuleUploader, "upload", poison)
    dirty = tto_numpy(tg.execute_streamed(
        _plan(tq, q), tg.numpy_chunk_provider(arrays), chunk_rows=CHUNK,
        types=ttypes, device="cpu"))
    assert poisoned
    assert sorted(dirty) == sorted(clean)
    for k in clean:
        assert np.asarray(dirty[k]).tobytes() == \
            np.asarray(clean[k]).tobytes() or \
            np.asarray(dirty[k]).tolist() == np.asarray(clean[k]).tolist(), k


def _overflow_plan(pp, ops, ir):
    return pp.GroupBy(pp.TableScan("t"), {"k": ir.col("k")},
                      [ops.AggSpec("s", "sum", ir.col("v"))],
                      out_capacity=1024)


def test_streamed_group_overflow_raises_where_jax_truncates():
    """5,000 keys into a 1,024-group budget in 4,096-row granules: the
    reference runs its granule programs outside any overflow collector
    and returns 1,024 groups summing to 4,096 of the 20,000 rows
    (ROADMAP Queue 3 #9); the port raises at its one host read."""
    rng = np.random.default_rng(7)
    n = 20_000
    arrays = {"k": rng.permutation(np.arange(n) % 5_000).astype(np.int64),
              "v": np.ones(n, dtype=np.int64)}
    jres = jto_numpy(jg.execute_streamed(
        _overflow_plan(jp, jops, jir), jg.numpy_chunk_provider(arrays),
        chunk_rows=4096))
    assert len(jres["k"]) == 1024 and int(jres["s"].sum()) == 4096
    with pytest.raises(CapacityOverflow, match="groupby_overflow") as err:
        tg.execute_streamed(_overflow_plan(tp, tops, tir),
                            tg.numpy_chunk_provider(arrays),
                            chunk_rows=4096, device="cpu")
    assert {lane for lane, _cap, _rows in err.value.drops} == \
        {"groupby_overflow"}
    # with room for every group both agree
    wide = tp.GroupBy(tp.TableScan("t"), {"k": tir.col("k")},
                      [tops.AggSpec("s", "sum", tir.col("v"))],
                      out_capacity=8192)
    got = tto_numpy(tg.execute_streamed(
        wide, tg.numpy_chunk_provider(arrays), chunk_rows=4096,
        device="cpu"))
    assert len(got["k"]) == 5_000 and int(got["s"].sum()) == n


@pytest.mark.parametrize("k,offset", [(10, 0), (25, 7), (5, 59_990)])
def test_sorted_streamed_limit_offset_matches_jax(tmp_path, lineitem, k,
                                                  offset):
    li, _arrays, _jtypes, _ttypes = lineitem
    cols = ["l_extendedprice", "l_orderkey", "l_linenumber", "l_shipmode"]
    arrays = {c: li[c] for c in cols}

    def plan(pp, ir):
        return pp.Limit(pp.Sort(
            pp.Filter(pp.TableScan("lineitem"),
                      ir.col("l_shipmode").ne(ir.lit("MAIL"))),
            [ir.col("l_shipmode"), ir.col("l_extendedprice"),
             ir.col("l_orderkey"), ir.col("l_linenumber")],
            [False, False, True, True]), k, offset)

    ja, jv = jg.execute_sorted_streamed(
        plan(jp, jir), jg.numpy_chunk_provider(arrays),
        str(tmp_path / "j"), chunk_rows=8192, budget_rows=20_000)
    ta, tv = tg.execute_sorted_streamed(
        plan(tp, tir), tg.numpy_chunk_provider(arrays),
        str(tmp_path / "t"), chunk_rows=8192, budget_rows=20_000,
        device="cpu")
    assert not (tmp_path / "t").exists()
    assert sorted(ta) == sorted(ja)  # jit outputs come key-sorted
    for c in cols:
        assert ta[c].tolist() == ja[c].tolist(), c
    assert {c for c, v in tv.items() if v is not None} == \
        {c for c, v in jv.items() if v is not None}
    keep = arrays["l_shipmode"] != "MAIL"
    order = np.lexsort((arrays["l_linenumber"][keep],
                        arrays["l_orderkey"][keep],
                        -arrays["l_extendedprice"][keep],
                        -np.unique(arrays["l_shipmode"][keep],
                                   return_inverse=True)[1]))
    want = arrays["l_orderkey"][keep][order][offset:offset + k]
    assert ta["l_orderkey"].tolist() == want.tolist()


def test_extract_column_bounds_matches_jax():
    assert tg.extract_column_bounds(tq.q6_plan()) == \
        jg.extract_column_bounds(jq.q6_plan())
    assert tg.extract_column_bounds(tq.q1_plan()) == \
        jg.extract_column_bounds(jq.q1_plan())


@pytest.mark.parametrize("rows", [1, 64, 8192, 10_000, 1 << 21,
                                  (1 << 21) + 1])
def test_snap_chunk_rows_matches_jax(rows):
    assert tg.snap_chunk_rows(rows) == jg.snap_chunk_rows(rows)


def test_split_top_matches_jax():
    for tplan, jplan in ((tq.q1_plan(), jq.q1_plan()),
                         (tq.q6_plan(), jq.q6_plan()),
                         (tq.q14_plan(100), jq.q14_plan(100))):
        ttop, tagg, troot = tplanner.split_top(tplan)
        jtop, jagg, jroot = jplanner.split_top(jplan)
        assert [type(n).__name__ for n in ttop] == \
            [type(n).__name__ for n in jtop]
        assert (tagg is None) == (jagg is None)
        assert repr(troot) == repr(jroot)
    probe = tp.IndexProbe(tp.TableScan("a"), "b", "ix", tir.col("k"))
    with pytest.raises(tplanner.NotDistributable, match="IndexProbe"):
        tplanner.split_top(tp.Limit(probe, 3))


# ---------------------------------------------------------------------------
# prefetch_iter
# ---------------------------------------------------------------------------


def _boom(n_ok):
    for i in range(n_ok):
        yield i
    raise ValueError("producer failed")


@pytest.mark.parametrize("mod", [tg, jg], ids=["port", "jax"])
def test_prefetch_iter_reraises_producer_error(mod):
    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in mod.prefetch_iter(_boom(3)):
            got.append(item)
    assert got == [0, 1, 2]


@pytest.mark.parametrize("mod", [tg, jg], ids=["port", "jax"])
def test_prefetch_iter_early_break_closes_producer(mod):
    import threading

    closed = threading.Event()
    produced = []

    def producer():
        try:
            for i in range(1_000):
                produced.append(i)
                yield i
        finally:
            closed.set()

    for item in mod.prefetch_iter(producer(), depth=2):
        if item == 3:
            break
    assert closed.wait(5), "the abandoned producer was not closed"
    assert len(produced) < 1_000  # it stopped running ahead


def test_streamed_needs_cuda_by_default(lineitem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _li, arrays, _jtypes, ttypes = lineitem
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.execute_streamed(tq.q6_plan(), tg.numpy_chunk_provider(arrays),
                            chunk_rows=CHUNK, types=ttypes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.GranuleUploader(None, CHUNK)


@pytest.fixture(scope="module")
def tpch():
    return tpch_env()


@pytest.mark.parametrize("qnum", [1, 6, 14])
def test_execute_spilled_tpch_matches_jax(tpch, tmp_path, qnum,
                                          monkeypatch):
    check_spilled_query(tpch, tmp_path, qnum, monkeypatch)
