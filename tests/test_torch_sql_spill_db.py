"""The port's SQL spill route under a ``Database``: the cases of
``tests/test_sql_spill.py`` that do not read ``v$sql_workarea`` or
EXPLAIN counters (the measurement plane's, outside this file) — an over-budget
ORDER BY, GROUP BY, scalar aggregate, probe-side join, co-partitioned
join and DISTINCT stream from the LSM through the disk tier with their
``SpillStats`` and equal the numpy answer, under-budget and disabled
spill stay in memory — and the vectorized ``segment_chunk_provider``
held equal to the reference's row-loop provider on multi-version keys,
tombstones that hide older base rows and memtable rows over segment
rows."""

import numpy as np
import pytest
import torch

from oceanbase_tpu.datatypes import SqlType as JSqlType
from oceanbase_tpu.exec.granule import \
    segment_chunk_provider as jsegment_chunk_provider
from oceanbase_tpu.storage.segment import Segment as JSegment
from oceanbase_tpu.storage.tablet import Tablet as JTablet
from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.exec.granule import segment_chunk_provider
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.storage.segment import Segment
from oceanbase_tpu_torch.storage.tablet import Tablet

# the tier-1 run puts several test processes on one host: two intra-op
# threads each keep torch from oversubscribing the cores the
# reference's subprocess-cluster tests time their elections on
torch.set_num_threads(2)

N = 12_000  # rows; the budget drops to 1024 so these are ~10x over it


def _mk(tmp_path, budget=1024):
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    s.execute(f"alter system set sql_work_area_rows = {budget}")
    return db, s


def _load_big(db, s, name="t", n=N, seed=1):
    """Half the rows direct-loaded into a baseline segment, half inserted
    through SQL into the memtable, then a few of the segment's rows
    updated and deleted — every spilled scan merges both LSM levels."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    v = rng.integers(0, 1_000_000, n)
    g = rng.integers(0, n // 2, n)
    s.execute(f"create table {name} (k int primary key, v int, g int)")
    half = n // 2
    db.engine.bulk_load(name, {"k": k[:half], "v": v[:half],
                               "g": g[:half]})
    db.catalog.invalidate(name)
    rows = ", ".join(f"({k[i]}, {v[i]}, {g[i]})" for i in range(half, n))
    s.execute(f"insert into {name} values {rows}")
    # update a few base rows (newer versions in the memtable) and delete
    # one (a tombstone over the segment row), keeping k, v, g in step
    for i in (3, 17, 400):
        v[i] += 7
        s.execute(f"update {name} set v = {v[i]} where k = {i}")
    s.execute(f"delete from {name} where k = 5")
    keep = k != 5
    return k[keep], v[keep], g[keep]


def test_order_by_over_budget_spills_and_completes(tmp_path):
    db, s = _mk(tmp_path)
    k, v, _g = _load_big(db, s)
    got = s.execute("select k, v from t order by v, k limit 20").rows()
    order = np.lexsort((k, v))
    assert got == [(int(k[i]), int(v[i])) for i in order[:20]]
    st = s.last_spill
    assert st is not None and st.kind.startswith("sort")
    assert st.runs > 0 and st.bytes > 0 and st.spilled_rows > 0
    db.close()


def test_group_by_over_budget_spills_with_parity(tmp_path):
    db, s = _mk(tmp_path)
    _k, v, g = _load_big(db, s)
    got = s.execute("select g, count(*) as c, sum(v) as sv, min(v) as mn "
                    "from t group by g order by g").rows()
    exp = {}
    for gi, vi in zip(g.tolist(), v.tolist()):
        c, sv, mn = exp.get(gi, (0, 0, None))
        exp[gi] = (c + 1, sv + vi, vi if mn is None else min(mn, vi))
    assert got == [(gi, *exp[gi]) for gi in sorted(exp)]
    assert "groupby" in s.last_spill.kind
    db.close()


def test_scalar_agg_over_budget_streams(tmp_path):
    db, s = _mk(tmp_path)
    _k, v, _g = _load_big(db, s)
    cnt, sv, av, mx = s.execute(
        "select count(*), sum(v), avg(v), max(v) from t").rows()[0]
    assert (cnt, sv, mx) == (len(v), int(v.sum()), int(v.max()))
    assert abs(av - v.mean()) < 1e-6 * abs(v.mean())
    assert "scalar" in s.last_spill.kind
    db.close()


def test_join_big_probe_small_build_spills(tmp_path):
    db, s = _mk(tmp_path)
    _k, v, g = _load_big(db, s)
    s.execute("create table d (g int primary key, name varchar(16))")
    dkeys = range(0, N // 2, 16)
    s.execute("insert into d values " + ", ".join(
        f"({i}, 'n{i % 7}')" for i in dkeys))
    got = s.execute("select d.name as name, count(*) as c, sum(t.v) as sv "
                    "from t join d on t.g = d.g "
                    "group by d.name order by name").rows()
    dset = {i: f"n{i % 7}" for i in dkeys}
    exp = {}
    for gi, vi in zip(g.tolist(), v.tolist()):
        nm = dset.get(gi)
        if nm is not None:
            c, sv = exp.get(nm, (0, 0))
            exp[nm] = (c + 1, sv + vi)
    assert got == [(nm, *exp[nm]) for nm in sorted(exp)]
    assert "join" in s.last_spill.kind
    db.close()


def test_join_both_sides_over_budget_copartitions(tmp_path):
    db, s = _mk(tmp_path)
    n, q = 6_000, 1_500
    a_v = np.random.default_rng(5).integers(0, 100, n)
    s.execute("create table a (k int primary key, j int, v int)")
    s.execute("insert into a values " + ", ".join(
        f"({i}, {i % q}, {a_v[i]})" for i in range(n)))
    s.execute("create table b (k int primary key, j int, w int)")
    s.execute("insert into b values " + ", ".join(
        f"({i}, {i % q}, {i % 13})" for i in range(n)))
    cnt, sv = s.execute("select count(*) as c, sum(a.v + b.w) as sv "
                        "from a join b on a.j = b.j").rows()[0]
    assert cnt == 16 * q  # each j value 4x on each side
    exp = sum(int(a_v[i]) + (m % 13) for i in range(n)
              for m in range(i % q, n, q))
    assert sv == exp
    assert s.last_spill is not None and s.last_spill.spilled_rows > 0
    db.close()


def test_distinct_over_budget_spills(tmp_path):
    db, s = _mk(tmp_path)
    _k, _v, g = _load_big(db, s)
    assert len(s.execute("select distinct g from t order by g").rows()) == \
        len(set(g.tolist()))
    assert "groupby" in s.last_spill.kind
    # COUNT(DISTINCT) is not splittable: the in-memory engine answers
    assert s.execute("select count(distinct g) from t").rows()[0][0] == \
        len(set(g.tolist()))
    assert s.last_spill is None
    db.close()


def test_under_budget_and_disabled_stay_in_memory(tmp_path):
    db, s = _mk(tmp_path, budget=1 << 22)
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i * 3})" for i in range(500)))
    assert s.execute("select k from t order by v desc limit 3").rows() == \
        [(499,), (498,), (497,)]
    assert s.last_spill is None
    s.execute("alter system set sql_work_area_rows = 100")
    s.execute("select k from t order by v desc limit 3")
    assert s.last_spill is not None
    s.execute("alter system set enable_sql_spill = false")
    assert s.execute("select count(*) from t").rows() == [(500,)]
    assert s.last_spill is None
    db.close()


# ---------------------------------------------------------------------------
# segment_chunk_provider: vectorized vs the reference's row loop
# ---------------------------------------------------------------------------


def _chunks(provider, chunk_rows, bounds=None):
    out = []
    for arrays, valids in provider("t", chunk_rows, bounds):
        out.append(({k: a.tolist() for k, a in sorted(arrays.items())},
                    {k: (None if x is None else x.tolist())
                     for k, x in sorted(valids.items())}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_segment_chunk_provider_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cols = ["k1", "k2", "s", "v"]
    ttypes = {"k1": SqlType.int_(), "k2": SqlType.string(),
              "s": SqlType.string(), "v": SqlType.int_()}
    jtypes = {"k1": JSqlType.int_(), "k2": JSqlType.string(),
              "s": JSqlType.string(), "v": JSqlType.int_()}
    tabs = [Tablet(1, cols, ttypes, ["k1", "k2"]),
            JTablet(1, cols, jtypes, ["k1", "k2"])]
    # a bulk-loaded baseline with duplicate keys across the load
    n = 3000
    base = {"k1": rng.integers(0, 300, n),
            "k2": rng.choice(np.array(["a", "b", "c"], dtype=object), n),
            "s": rng.choice(np.array(["x", "yy", "zzz"], dtype=object), n),
            "v": rng.integers(0, 1000, n)}
    for t, seg_cls, ty in ((tabs[0], Segment, ttypes),
                           (tabs[1], JSegment, jtypes)):
        t.add_segment(seg_cls.build(1, 2, base, ty, None, 1, 1,
                                    chunk_rows=512))
    version, tx = 1, 0
    keys = list({(int(a), str(b)) for a, b in zip(base["k1"], base["k2"])})
    for step in range(40):
        tx += 1
        picks = [keys[i] for i in rng.choice(len(keys), 5, replace=False)]
        new = (int(rng.integers(300, 320)), "n")
        ops = [(key, "delete" if rng.random() < 0.3 else "update")
               for key in picks] + [(new, "insert")]
        vals = [{"k1": key[0], "k2": key[1],
                 "s": None if rng.random() < 0.1 else "m",
                 "v": int(rng.integers(0, 1000))} for key, _op in ops]
        for t in tabs:
            for (key, op), val in zip(ops, vals):
                try:
                    t.write(key, op, dict(val), tx_id=tx)
                except Exception:  # noqa: BLE001 — same on both sides
                    pass
        if step % 7 == 6:
            for t in tabs:
                t.abort(tx, [key for key, _ in ops])
            continue
        version += 1
        for t in tabs:
            t.commit(tx, version, [key for key, _ in ops])
        if step % 9 == 8:
            for t in tabs:
                t.freeze()
                t.mini_compact(snapshot=version - 1)
    # one uncommitted write: invisible to every provider snapshot
    for t in tabs:
        t.write(keys[0], "update", {"k1": keys[0][0], "k2": keys[0][1],
                                    "s": "u", "v": -1}, tx_id=999)
    for snap in (1, version // 2, version):
        for chunk_rows, bounds in ((700, None), (4096, {"k1": (50, 120)})):
            got = _chunks(segment_chunk_provider(tabs[0], snap),
                          chunk_rows, bounds)
            want = _chunks(jsegment_chunk_provider(tabs[1], snap),
                           chunk_rows, bounds)
            assert got == want, (snap, chunk_rows)


def test_decimal_bound_prunes_no_segment_rows(tmp_path):
    """ROADMAP Queue 3 #11: a spilled GROUP BY filtering a DECIMAL column
    by an integer literal.  The reference's ``segment_chunk_provider``
    prunes the flushed segment's chunks by the unscaled literal (24
    against stored 2450-style scaled ints) and returns no groups; the
    port prunes only columns of the literal's own value domain and
    answers like SQLite."""
    import json as _json

    from oceanbase_tpu.server.database import Database as JDatabase

    sql = "select g, count(*) from t where q < 24 group by g order by g"
    out = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        root.mkdir()
        if pkg == "jax":
            (root / "config.json").write_text(
                _json.dumps({"enable_calibration": False}))
            db = JDatabase(str(root))
        else:
            db = Database(str(root), device="cpu")
        s = db.session()
        s.execute("alter system set sql_work_area_rows = 100")
        s.execute("create table t (k int primary key, q decimal(10,2), "
                  "g int)")
        s.execute("insert into t values " + ", ".join(
            f"({i}, {i % 50}.50, {i % 3})" for i in range(1000)))
        db.checkpoint()  # the rows move into a zone-mapped segment
        out[pkg] = s.execute(sql).rows()
        db.close()
    assert out["port"] == [(0, 160), (1, 160), (2, 160)]
    assert out["jax"] == []


def test_capacity_overflow_backstop_spills_the_largest_table(tmp_path):
    """A plan bound against stale statistics overflows its group-by
    budget; with the re-plan ladder exhausted (``max_capacity_retry`` =
    0) the session streams the largest table through the spill tier
    (``force_largest``) instead of raising, though no table is over the
    work area."""
    db = Database(str(tmp_path / "db"), device="cpu")
    s = db.session()
    s.execute("create table t (k int primary key, g int, v int)")
    n = 20_000
    db.engine.bulk_load("t", {"k": np.arange(n), "g": np.arange(n) % 9000,
                              "v": np.arange(n)})
    db.catalog.invalidate("t")
    td = db.engine.tables["t"].tdef
    td.row_count, td.ndv["g"] = 1, 1  # the statistics of an empty table
    s.execute("set max_capacity_retry = 0")
    rows = s.execute("select g, count(*), sum(v) from t group by g "
                     "order by g").rows()
    assert s.last_spill is not None and "groupby" in s.last_spill.kind
    g, v = np.arange(n) % 9000, np.arange(n)
    assert rows == [(i, int((g == i).sum()), int(v[g == i].sum()))
                    for i in range(9000)]
    db.close()
