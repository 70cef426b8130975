"""VECTOR columns, the distance functions, vector and fulltext indexes
and the ANN access path: the port against the JAX package on the CPU,
the cases of ``tests/test_vector_fts_sql.py`` run through both packages
on the same seeded inputs (a catalog-only ``Session`` and a
``Database``), with numpy's brute force as the oracle where both must
equal it.  Ids and row sets are compared exactly; float64 distances at
1e-6 relative (float32 arithmetic underneath), with a 1e-6 absolute
floor for inner products of unit-scale vectors that cancel toward 0.

Also here: the reference faults ROADMAP Queue 3 #22 (the ANN cache
survives DROP TABLE), #23 (ANALYZE flattens a VECTOR column), #24 (the
wire's VECTOR text), #25 (a VECTOR table in the spill tier), #27 (NULL
embeddings under a vector index) and #28 (the approximate opt-in across
metrics), each with the reference's answer beside the port's."""

import json

import numpy as np
import pytest
import torch

from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu.sql import Session as JSession
from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.exec import plan as tplan
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.sql import Session as TSession
from oceanbase_tpu_torch.vector import column as tcol

torch.set_num_threads(2)

RTOL = 1e-6
#: a float32 sum of d products that cancels (an inner product near 0)
#: differs between the two packages' summation orders by a few ulps of
#: its terms, not of its result
ATOL = 1e-6


def _qtxt(q) -> str:
    return "[" + ", ".join(f"{x:.6f}" for x in q) + "]"


def _vec_env(n=2000, d=16, seed=0):
    """The reference test's table, loaded into a catalog-only session of
    each package -> ((jax session, port session), vectors)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    arrays = {"id": np.arange(n), "v": vecs, "tag": np.arange(n) % 5}
    js, ts = JSession(), TSession(device="cpu")
    js.catalog.load_numpy("emb", arrays, primary_key=["id"])
    ts.catalog.load_numpy("emb", arrays, primary_key=["id"])
    return (js, ts), vecs


def _rows_equal(jrows, trows):
    """Rows equal cell by cell: floats at RTOL, a VECTOR cell (the
    reference's is an object row of float32, the port's a float32
    array) element by element, everything else exactly."""
    assert len(jrows) == len(trows)
    for jr, tr in zip(jrows, trows):
        assert len(jr) == len(tr)
        for a, b in zip(jr, tr):
            if a is None or b is None:
                assert a is None and b is None
            elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                np.testing.assert_array_equal(
                    np.asarray(b, np.float32), np.asarray(a, np.float32))
            elif isinstance(a, float):
                assert b == pytest.approx(a, rel=RTOL, abs=ATOL)
            else:
                assert a == b


def _both(sessions, sql):
    out = [s.execute(sql).rows() for s in sessions]
    _rows_equal(*out)
    return out[1]


def _pair(tmp_path, **cfg):
    """A reference and a port Database, both booted from a config.json
    with calibration off (and ``cfg``)."""
    dbs = []
    for name in ("jax", "port"):
        root = tmp_path / name
        root.mkdir(parents=True, exist_ok=True)
        (root / "config.json").write_text(
            json.dumps({"enable_calibration": False, **cfg}))
        dbs.append(JDatabase(str(root)) if name == "jax"
                   else Database(str(root), device="cpu"))
    return dbs


# ---------------------------------------------------------------------------
# distance functions
# ---------------------------------------------------------------------------


def test_distance_functions_match_jax_and_numpy():
    (js, ts), vecs = _vec_env()
    q = vecs[7]
    qt = _qtxt(q)
    rows = _both((js, ts), f"select id, l2_distance(v, '{qt}') as d "
                 "from emb order by d limit 3")
    assert rows[0][0] == 7 and rows[0][1] < 1e-3
    dist = np.linalg.norm(vecs - q, axis=1)
    assert [r[0] for r in rows] == np.argsort(dist, kind="stable")[:3].tolist()
    qf = np.asarray([float(x) for x in qt[1:-1].split(",")], np.float32)
    got = _both((js, ts), "select id, inner_product(v, '{0}'), "
                "negative_inner_product(v, '{0}'), cosine_distance(v, "
                "'{0}'), l2_distance(v, '{0}') from emb where id < 6 "
                "order by id".format(qt))
    for i, ip, nip, cd, l2 in got:
        v = vecs[i]
        assert ip == pytest.approx(float(v @ qf), rel=1e-5)
        assert nip == -ip
        want = 1.0 - float(v @ qf) / (np.linalg.norm(v) * np.linalg.norm(qf))
        assert cd == pytest.approx(want, rel=1e-5, abs=1e-6)
        assert l2 == pytest.approx(float(np.linalg.norm(v - qf)), rel=1e-5)


def test_distance_functions_with_null_vectors():
    """A NULL embedding gives a NULL distance in both packages; the two
    columns' validities merge (column against column)."""
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(6, 4)).astype(np.float32)
    other = rng.normal(size=(6, 4)).astype(np.float32)
    valid_a = np.array([1, 0, 1, 1, 0, 1], bool)
    valid_b = np.array([1, 1, 0, 1, 1, 1], bool)
    sessions = (JSession(), TSession(device="cpu"))
    for s in sessions:
        s.catalog.load_numpy(
            "t", {"id": np.arange(6), "a": vecs, "b": other},
            valids={"a": valid_a, "b": valid_b})
    rows = _both(sessions, "select id, l2_distance(a, '[1, 0, 0, 1]'), "
                 "cosine_distance(a, b), inner_product(b, a) from t "
                 "order by id")
    assert [r[1] is None for r in rows] == (~valid_a).tolist()
    assert [r[2] is None for r in rows] == (~(valid_a & valid_b)).tolist()
    assert rows[0][3] == pytest.approx(float(vecs[0] @ other[0]), rel=1e-5)


def test_vector_cells_read_back_as_stored():
    (js, ts), vecs = _vec_env(n=100, d=8)
    rows = _both((js, ts), "select id, v from emb where id < 4 order by id")
    for i, v in rows:
        np.testing.assert_array_equal(v, vecs[i])
        assert v.dtype == np.float32


# ---------------------------------------------------------------------------
# vector indexes and the ANN access path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_index_equals_the_full_sort(seed):
    (js, ts), vecs = _vec_env(seed=seed)
    q = vecs[123 + seed] + 0.01
    sql = f"select id from emb order by l2_distance(v, '{_qtxt(q)}') limit 5"
    before = _both((js, ts), sql)
    assert ts.last_ann_path is None
    for s in (js, ts):
        s.execute("create vector index iv on emb (v) with (metric = 'l2')")
    got = _both((js, ts), sql)
    assert ts.last_ann_path == "exact"
    assert got == before
    dist = np.linalg.norm(vecs - np.asarray(
        [float(x) for x in _qtxt(q)[1:-1].split(",")], np.float32), axis=1)
    assert [r[0] for r in got] == np.argsort(dist, kind="stable")[:5].tolist()
    assert any(k[0] == "emb" for k in js.catalog._ann_cache)
    assert ("emb", ("ann", "v", "l2")) in ts.catalog._sidecars


def test_cosine_index():
    (js, ts), vecs = _vec_env()
    for s in (js, ts):
        s.execute("create vector index ic on emb (v) "
                  "with (metric = 'cosine')")
    for i in (55, 901):
        got = _both((js, ts), "select id, cosine_distance(v, '{}') as d "
                    "from emb order by d limit 3".format(_qtxt(vecs[i])))
        assert got[0][0] == i and ts.last_ann_path == "exact"
    # an l2 query over a cosine-only index takes the full sort
    _both((js, ts), "select id from emb order by l2_distance(v, '{}') "
          "limit 2".format(_qtxt(vecs[3])))
    assert ts.last_ann_path is None


def test_approximate_opt_in():
    """IVF only when the index opts in with approximate = true (and the
    table has 4,096 rows or more); a plain index stays exact."""
    (js, ts), vecs = _vec_env(n=5000, d=8, seed=4)
    for s in (js, ts):
        s.execute("create vector index ia on emb (v) "
                  "with (metric = 'l2', approximate = true)")
    q = _qtxt(vecs[42])
    got = _both((js, ts), f"select id from emb order by l2_distance(v, "
                f"'{q}') limit 5")
    assert got[0][0] == 42 and ts.last_ann_path == "ivf"
    from oceanbase_tpu.share.vector_index import IvfFlatIndex as JIvf
    from oceanbase_tpu_torch.share.vector_index import IvfFlatIndex as TIvf

    jhit = next(v for k, v in js.catalog._ann_cache.items() if k[0] == "emb")
    thit = ts.catalog._sidecars[("emb", ("ann", "v", "l2"))]
    assert isinstance(jhit[1], JIvf) and isinstance(thit[1], TIvf)
    assert thit[1].cap == jhit[1].cap
    np.testing.assert_array_equal(thit[1].buckets.numpy(),
                                  np.asarray(jhit[1].buckets))
    # below 4,096 rows the same opt-in searches exactly
    (js, ts), vecs = _vec_env(n=3000, d=8, seed=4)
    for s in (js, ts):
        s.execute("create vector index ia on emb (v) "
                  "with (metric = 'l2', approximate = true)")
    _both((js, ts), f"select id from emb order by l2_distance(v, "
          f"'{_qtxt(vecs[42])}') limit 5")
    assert ts.last_ann_path == "exact"


def test_approximate_opt_in_is_per_metric():
    """#28: an approximate l2 index and an exact cosine index on one
    column.  The reference takes the opt-in from any vector index on the
    column, so its cosine queries go through IVF; the port takes it from
    the indexes of the query's metric, so cosine stays exact and equals
    the full sort."""
    from oceanbase_tpu.share.vector_index import IvfFlatIndex as JIvf

    (js, ts), vecs = _vec_env(n=5000, d=8, seed=5)
    sql = ("select id, cosine_distance(v, '{}') as d from emb order by d "
           "limit 5".format(_qtxt(vecs[42] + 0.3)))
    full = ts.execute(sql).rows()
    assert ts.last_ann_path is None
    for s in (js, ts):
        s.execute("create vector index ia on emb (v) "
                  "with (metric = 'l2', approximate = true)")
        s.execute("create vector index ic on emb (v) "
                  "with (metric = 'cosine')")
    jrows, trows = (s.execute(sql).rows() for s in (js, ts))
    assert isinstance(js.catalog._ann_cache[("emb", "v", "cosine")][1],
                      JIvf)                      # the reference: IVF
    assert ts.last_ann_path == "exact"           # the port: exact
    assert isinstance(ts.catalog._sidecars[("emb", ("ann", "v", "cosine"))]
                      [1], torch.Tensor)
    _rows_equal(full, trows)
    assert len(jrows) == 5
    _both((js, ts), "select id from emb order by l2_distance(v, '{}') "
          "limit 5".format(_qtxt(vecs[7])))
    assert ts.last_ann_path == "ivf"


@pytest.mark.parametrize("mode", ["catalog", "database"])
def test_null_embeddings_take_the_full_sort(tmp_path, mode):
    """#27: NULL embeddings under an exact vector index.  A NULL
    embedding's distance is NULL, which ORDER BY ... ASC puts first.
    The reference's ANN path searches a NULL row's stored vector as an
    embedding, so its indexed answer drops the NULL rows its own full
    sort returns first (catalog-only; through its engine a NULL
    embedding already fails every read, #26).  The port takes no ANN
    path while a live embedding is NULL: its indexed answer is its full
    sort's."""
    rng = np.random.default_rng(12)
    n, d, nulls = 300, 8, [17, 40, 299]
    # rows away from the origin: a NULL row's stored zero embedding (the
    # engine's fill, set here for the catalog-only load too) is far from
    # every query near them
    vecs = (rng.normal(size=(n, d)) + 5.0).astype(np.float32)
    valid = np.ones(n, bool)
    valid[nulls] = False
    vecs[nulls] = 0.0
    q = _qtxt(vecs[123] + 0.01)
    sql = f"select id from emb order by l2_distance(v, '{q}') limit 5"
    if mode == "catalog":
        sessions = (JSession(), TSession(device="cpu"))
        for s in sessions:
            s.catalog.load_numpy("emb", {"id": np.arange(n), "v": vecs},
                                 primary_key=["id"], valids={"v": valid})
        full = _both(sessions, sql)
    else:
        dbs = _pair(tmp_path)
        sessions = tuple(db.session() for db in dbs)
        for s in sessions:
            s.execute("create table emb (id int primary key, v vector(8))")
            s.execute("insert into emb values " + ", ".join(
                f"({i}, " + ("null" if not valid[i] else
                             f"'{_qtxt(vecs[i])}'") + ")"
                for i in range(n)))
        with pytest.raises(ValueError):
            sessions[0].execute(sql)
        full = sessions[1].execute(sql).rows()
    assert {r[0] for r in full[:3]} == set(nulls)
    ts = sessions[1]
    for s in sessions:
        s.execute("create vector index iv on emb (v) with (metric = 'l2')")
    got = ts.execute(sql).rows()
    assert got == full and ts.last_ann_path is None
    assert ts.catalog._sidecars[("emb", ("ann", "v", "l2"))][1] is False
    if mode == "catalog":
        # the reference: the five nearest embeddings, the NULL rows lost
        qf = np.asarray([float(x) for x in q[1:-1].split(",")], np.float32)
        dist = np.where(valid, np.linalg.norm(vecs - qf, axis=1), np.inf)
        want = np.argsort(dist, kind="stable")[:5].tolist()
        assert [r[0] for r in sessions[0].execute(sql).rows()] == want
        assert [r[0] for r in full[3:]] == want[:2]
    else:
        for db in dbs:
            db.close()


def test_ann_path_shapes_it_leaves_alone():
    """DESC order, a limit whose fetch (4 x (k + offset)) covers the
    table, a filter under the sort and a limit past 64 rows' table all
    take the full path; an offset inside the fetch takes the ANN path;
    every one with the reference's rows."""
    (js, ts), vecs = _vec_env(n=300, d=8, seed=6)
    for s in (js, ts):
        s.execute("create vector index iv on emb (v) with (metric = 'l2')")
    q = _qtxt(vecs[9])
    for sql, ann in [
            (f"select id from emb order by l2_distance(v, '{q}') limit 5",
             "exact"),
            (f"select id from emb order by l2_distance(v, '{q}') desc "
             "limit 5", None),
            (f"select id from emb order by l2_distance(v, '{q}') "
             "limit 3 offset 70", "exact"),
            (f"select id from emb order by l2_distance(v, '{q}') "
             "limit 3 offset 80", None),
            (f"select id from emb where tag = 2 order by "
             f"l2_distance(v, '{q}') limit 5", None),
            (f"select id, l2_distance(v, '{q}') as d from emb "
             "order by d limit 100", None)]:
        _both((js, ts), sql)
        assert ts.last_ann_path == ann, sql


def test_catalog_only_delete_leaves_interior_dead_rows():
    """A catalog-only DELETE masks rows in place: dead rows inside the
    live prefix would need a row-id remap, so the full path runs."""
    (js, ts), vecs = _vec_env(n=500, d=8, seed=8)
    for s in (js, ts):
        s.execute("create vector index iv on emb (v) with (metric = 'l2')")
        s.execute("delete from emb where id in (3, 4, 5)")
    got = _both((js, ts), "select id from emb order by l2_distance(v, "
                "'{}') limit 5".format(_qtxt(vecs[4])))
    assert ts.last_ann_path is None and 4 not in [r[0] for r in got]


def test_poisoned_dead_lanes_change_no_answer():
    """Dead bucket lanes (a masked suffix) holding NaN embeddings: the
    ANN path searches the live prefix only and the full sort puts dead
    lanes last, so both answer as over the live rows alone."""
    rng = np.random.default_rng(9)
    n, cap, d = 700, 1024, 8
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    poisoned = np.full((cap, d), np.nan, np.float32)
    poisoned[:n] = vecs
    ids = np.full(cap, -7, np.int64)
    ids[:n] = np.arange(n)
    s = TSession(device="cpu")
    s.execute("create table emb (id int, v vector(8))")
    rel = tcol.from_numpy({"id": ids, "v": poisoned}, device="cpu")
    mask = torch.zeros(cap, dtype=torch.bool)
    mask[:n] = True
    s.catalog.set_data("emb", rel.with_mask(mask))
    q = vecs[17] + 0.01
    sql = f"select id from emb order by l2_distance(v, '{_qtxt(q)}') limit 6"
    full = [r[0] for r in s.execute(sql).rows()]
    s.execute("create vector index iv on emb (v) with (metric = 'l2')")
    ann = [r[0] for r in s.execute(sql).rows()]
    assert s.last_ann_path == "exact"
    qf = np.asarray([float(x) for x in _qtxt(q)[1:-1].split(",")],
                    np.float32)
    want = np.argsort(np.linalg.norm(vecs - qf, axis=1),
                      kind="stable")[:6].tolist()
    assert full == ann == want


def test_plan_monitor_shows_the_ann_scan_rows(tmp_path):
    """With a Database the scan under the ANN path reads the fetch count
    (max(4k, 64) = 64 for k = 10), not the table, in the plain query's
    monitor rows of both packages and in the port's EXPLAIN ANALYZE."""
    rng = np.random.default_rng(10)
    vecs = rng.normal(size=(3000, 8)).astype(np.float32)
    q = _qtxt(vecs[5])
    sql = f"select id, l2_distance(e, '{q}') as d from items order by d limit 10"
    scans = []
    for db in _pair(tmp_path):
        s = db.session()
        s.catalog.load_numpy("items", {"id": np.arange(3000), "e": vecs},
                             primary_key=["id"])
        s.execute("create vector index iv on items (e) with (metric = 'l2')")
        rows = s.execute(sql).rows()
        assert rows[0][0] == 5
        rec = db.plan_monitor.recent(1000)[-1]
        scans.append([x["rows"] for x in rec.op_stats
                      if x["op"] == "TableScan"])
        if isinstance(db, Database):
            text = s.execute("explain analyze " + sql).plan_text
            scan_line = next(ln for ln in text.splitlines()
                             if "TableScan" in ln)
            assert "act=64" in scan_line, text
        db.close()
    assert scans[0] == scans[1] == [64]


# ---------------------------------------------------------------------------
# through a Database: INSERT, DDL persistence, SHOW INDEX
# ---------------------------------------------------------------------------


def test_insert_through_the_engine(tmp_path):
    outs = []
    for db in _pair(tmp_path):
        s = db.session()
        s.execute("create table items (id int primary key, e vector(3))")
        s.execute("insert into items values (1, '[1, 0, 0]'), "
                  "(2, '[0, 1, 0]'), (3, '[0.9, 0.1, 0]')")
        with pytest.raises(ValueError, match="dim 2"):
            s.execute("insert into items values (5, '[1, 0]')")
        outs.append([
            s.execute("select id from items "
                      "order by l2_distance(e, '[1, 0, 0]') limit 2").rows(),
            s.execute("select id, e from items order by id").rows(),
            s.execute("select count(*) from items").rows()])
        db.close()
    for a, b in zip(*outs):
        _rows_equal(a, b)
    assert outs[1][0] == [(1,), (3,)]
    assert outs[1][2] == [(3,)]


@pytest.mark.parametrize("case", ["null", "insert_select"])
def test_vector_writes_the_reference_fails_on(tmp_path, case):
    """#26: two VECTOR writes through the engine.  A NULL embedding
    commits in both packages, but the reference fills its lane with a
    scalar 0 beside [d] rows, so every later read of the table raises
    ValueError; INSERT ... SELECT of a VECTOR column raises ValueError
    in the reference (``.item()`` of a row).  The port stores a zero
    embedding behind the validity and a row as its list of floats."""
    outs = []
    for db in _pair(tmp_path):
        s = db.session()
        s.execute("create table items (id int primary key, e vector(3))")
        s.execute("insert into items values (1, '[1, 0, 0]'), "
                  "(3, '[0.9, 0.1, 0]')")
        try:
            if case == "null":
                s.execute("insert into items values (4, null)")
            else:
                s.execute("insert into items select id + 10, e from items")
            outs.append(s.execute(
                "select id, l2_distance(e, '[1, 0, 0]') as d from items "
                "order by d, id").rows())
        except ValueError as e:
            outs.append(type(e).__name__)
        db.close()
    assert outs[0] == "ValueError"
    got = outs[1]
    if case == "null":
        assert got[0] == (4, None) and [r[0] for r in got[1:]] == [1, 3]
    else:
        assert [r[0] for r in got] == [1, 11, 3, 13]
        assert got[3][1] == pytest.approx(np.sqrt(0.02), rel=1e-6)


def test_wal_replay_restores_vectors(tmp_path):
    """Rows inserted after the last checkpoint come back from the WAL,
    float32 for float32, in both packages."""
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(20, 5)).astype(np.float32)
    outs = []
    for db in _pair(tmp_path):
        s = db.session()
        s.execute("create table items (id int primary key, e vector(5))")
        s.execute("insert into items values " + ", ".join(
            f"({i}, '{_qtxt(v)}')" for i, v in enumerate(vecs)))
        root = db.root
        reopened = (JDatabase(root) if isinstance(db, JDatabase)
                    else Database(root, device="cpu"))
        outs.append(reopened.session().execute(
            "select id, e from items order by id").rows())
        reopened.close()
    _rows_equal(*outs)
    assert len(outs[1]) == 20


def test_index_persistence_across_restart(tmp_path):
    for db in _pair(tmp_path):
        is_port = isinstance(db, Database)
        root = db.root

        def reopen():
            return (Database(root, device="cpu") if is_port
                    else JDatabase(root))

        s = db.session()
        s.execute("create table items (id int primary key, e vector(3), "
                  "body varchar(40))")
        s.execute("insert into items values (1, '[1, 0, 0]', 'a fox'), "
                  "(2, '[0, 1, 0]', 'a dog')")
        s.execute("create vector index iv on items (e) with (metric = 'l2')")
        db.checkpoint()
        s.execute("create fulltext index ft on items (body)")  # slog only
        db.close()
        db2 = reopen()
        s2 = db2.session()
        assert set(s2.catalog.table_def("items").aux_indexes) == {"iv", "ft"}
        with pytest.raises(ValueError):
            s2.execute("create vector index iv on items (e)")
        s2.execute("create vector index if not exists iv on items (e)")
        s2.execute("drop index iv on items")
        assert "iv" not in s2.catalog.table_def("items").aux_indexes
        db2.close()
        db3 = reopen()
        s3 = db3.session()
        assert set(s3.catalog.table_def("items").aux_indexes) == {"ft"}
        # re-created under the same name, with another metric
        s3.execute("create vector index iv on items (e) "
                   "with (metric = 'cosine')")
        db3.close()
        db4 = reopen()
        spec = db4.session().catalog.table_def("items").aux_indexes["iv"]
        assert spec["metric"] == "cosine"
        db4.close()


@pytest.mark.parametrize("sql", [
    "create vector index iv on items (body)",
    "create fulltext index ft on items (e)",
    "create vector index iv on items (e, body)",
    "create vector index iv on items (nope)",
])
def test_aux_index_ddl_refusals_match(tmp_path, sql):
    outs = []
    for db in _pair(tmp_path):
        s = db.session()
        s.execute("create table items (id int primary key, e vector(3), "
                  "body varchar(40))")
        try:
            s.execute(sql)
            outs.append("ok")
        except Exception as e:  # noqa: BLE001 — the error is the outcome
            outs.append(type(e).__name__)
        assert not s.catalog.table_def("items").aux_indexes
        db.close()
    assert outs[0] == outs[1] != "ok"


def test_show_index_lists_aux_indexes():
    (js, ts), _ = _vec_env(n=100, d=4)
    for s in (js, ts):
        s.execute("create vector index iv on emb (v) with (metric = 'l2')")
        s.execute("create index ix on emb (tag)")
    got = _both((js, ts), "show index from emb")
    assert got == [("PRIMARY", "id", 1, "primary"), ("ix", "tag", 0,
                                                     "normal"),
                   ("iv", "v", 0, "vector")]


def test_empty_vector_table():
    """A VECTOR column of a table created without data (a flat
    placeholder typed VECTOR(3)), and CREATE TABLE with a VECTOR column:
    typed, empty, and its distance query returns no rows."""
    from oceanbase_tpu.datatypes import SqlType as JSqlType

    for s, st in ((JSession(), JSqlType), (TSession(device="cpu"), SqlType)):
        s.catalog.load_numpy(
            "ev", {"id": np.zeros(1, np.int64), "v": np.zeros(1, np.float32)},
            types={"v": st.vector(3)})
        assert s.catalog.table_def("ev").column("v").dtype.precision == 3
        s.execute("create table e2 (id int, v vector(5))")
        assert s.execute("select id, l2_distance(v, '[1,2,3,4,5]') "
                         "from e2").rows() == []
        assert s.catalog.table_def("e2").column("v").dtype.precision == 5


# ---------------------------------------------------------------------------
# fulltext
# ---------------------------------------------------------------------------


def test_match_against_with_a_fulltext_index():
    docs = np.array([
        "the quick brown fox", "jumped over the lazy dog",
        "quick quick slow", "a dog and a fox", "nothing relevant here",
    ], dtype=object)
    sessions = (JSession(), TSession(device="cpu"))
    for s in sessions:
        s.catalog.load_numpy("docs", {"id": np.arange(5), "body": docs},
                             primary_key=["id"])
        s.execute("create fulltext index ft on docs (body)")
    assert _both(sessions, "select id from docs where match(body) "
                 "against('fox') order by id") == [(0,), (3,)]
    rows = _both(sessions, "select id, match(body) against('quick fox') "
                 "as s from docs where match(body) against('quick fox') "
                 "order by s desc, id")
    assert rows[0] == (0, 2.0) and {x[0] for x in rows} == {0, 2, 3}
    assert _both(sessions, "select count(*) from docs where match(body) "
                 "against('dog' in boolean mode)") == [(2,)]
    assert _both(sessions, "show index from docs")[-1] == \
        ("ft", "body", 0, "fulltext")


# ---------------------------------------------------------------------------
# reference faults (ROADMAP Queue 3 #22-#25)
# ---------------------------------------------------------------------------


def _drop_create_round(s, seed):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(200, 4)).astype(np.float32)
    s.execute("create table items (id int primary key, e vector(4))")
    s.execute("insert into items values " + ", ".join(
        f"({i}, '{_qtxt(v)}')" for i, v in enumerate(vecs)))
    s.execute("create vector index iv on items (e) with (metric = 'l2')")
    rows = s.execute("select id, l2_distance(e, '[0.5, -0.5, 0.25, 1.0]') "
                     "as d from items order by d limit 5").rows()
    stored = np.asarray([float(x) for x in ",".join(
        _qtxt(v)[1:-1] for v in vecs).split(",")], np.float32).reshape(200, 4)
    q = np.array([0.5, -0.5, 0.25, 1.0], np.float32)
    want = np.argsort(np.linalg.norm(stored - q, axis=1),
                      kind="stable")[:5].tolist()
    return [r[0] for r in rows], want


def test_ann_cache_does_not_survive_drop_table(tmp_path):
    """#22: the reference keys its ANN cache on (table, column, metric)
    and checks only the tablet's data version, which a re-created table
    counts from 0 again; its second round picks candidates with the
    dropped table's vectors.  The port's entry serves only the relation
    it was built from (and DROP TABLE frees it)."""
    jdb, tdb = _pair(tmp_path)
    results = []
    for db in (jdb, tdb):
        s = db.session()
        first = _drop_create_round(s, 100)
        s.execute("drop table items")
        second = _drop_create_round(s, 101)
        results.append((first, second))
        db.close()
    (jfirst, jsecond), (tfirst, tsecond) = results
    assert jfirst[0] == jfirst[1] and tfirst[0] == tfirst[1]
    assert jsecond[0] != jsecond[1]           # the reference's stale ids
    assert tsecond[0] == tsecond[1]           # the port equals numpy


def test_analyze_keeps_the_vector_ndv_rule():
    """#23: ANALYZE of a VECTOR column: the reference runs np.unique over
    the flattened [n, d] floats (an NDV above the row count, and a
    histogram of loose floats); the port keeps load_numpy's rule, NDV =
    the live row count and no histogram."""
    (js, ts), _ = _vec_env(n=2000, d=16, seed=3)
    for s in (js, ts):
        assert s.catalog.table_def("emb").ndv["v"] == 2000
        s.execute("analyze table emb")
    jtd, ttd = js.catalog.table_def("emb"), ts.catalog.table_def("emb")
    assert jtd.ndv["v"] > 2000 and "v" in jtd.histograms
    assert ttd.ndv["v"] == 2000 and "v" not in ttd.histograms
    assert jtd.ndv["tag"] == ttd.ndv["tag"] == 5
    assert jtd.row_count == ttd.row_count == 2000


def test_wire_vector_cells_are_oceanbase_text(tmp_path):
    """#24: the reference writes str() of a numpy row (no commas, which
    no client can send back); the port writes [x,y,...] with each float32
    in its shortest round-tripping form."""
    from oceanbase_tpu.server.mysql_protocol import MySQLServer as JServer
    from oceanbase_tpu_torch.expr.compile import parse_vector_text
    from oceanbase_tpu_torch.server.mysql_protocol import MySQLServer
    from test_torch_mysql_protocol import MiniClient

    rng = np.random.default_rng(13)
    vecs = rng.normal(size=(3, 4)).astype(np.float32)
    cells = []
    for db, srv_cls in zip(_pair(tmp_path), (JServer, MySQLServer)):
        db.session().catalog.load_numpy(
            "items", {"id": np.arange(3), "e": vecs}, primary_key=["id"])
        srv = srv_cls(db).start()
        c = MiniClient(srv.host, srv.port)
        cells.append([r[1] for r in c.query(
            "select id, e from items order by id")["rows"]])
        c.close()
        srv.stop()
        db.close()
    jcells, tcells = cells
    assert all("," not in x and x.startswith("[") for x in jcells)
    for i, x in enumerate(tcells):
        assert x.startswith("[") and x.endswith("]") and " " not in x
        np.testing.assert_array_equal(parse_vector_text(x), vecs[i])
    assert tcells[0] == "[" + ",".join(
        np.format_float_positional(v, unique=True, trim="-")
        for v in vecs[0]) + "]"


def test_vector_table_over_the_work_area_runs_in_memory(tmp_path):
    """#25: a VECTOR table over the work area reaches the spill tier;
    the reference stacks its [n, d] column against [n] ones and raises
    ValueError, the port's tier refuses it (NotDistributable) and the
    statement runs in memory, equal to numpy."""
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(1000, 4)).astype(np.float32)
    q = np.array([0.5, -0.5, 0.25, 1.0], np.float32)
    sql = ("select id from items order by "
           "l2_distance(e, '[0.5, -0.5, 0.25, 1.0]') limit 5")
    outs = []
    for db in _pair(tmp_path, sql_work_area_rows=256):
        s = db.session()
        s.catalog.load_numpy("items", {"id": np.arange(1000), "e": vecs},
                             primary_key=["id"])
        try:
            outs.append([r[0] for r in s.execute(sql).rows()])
        except ValueError as e:
            outs.append(type(e).__name__)
        db.close()
    want = np.argsort(np.linalg.norm(vecs - q, axis=1),
                      kind="stable")[:5].tolist()
    assert outs == ["ValueError", want]


def test_analytic_bytes_count_a_vector_lane_at_its_width():
    """gv$plan_cache's bytes_accessed counts a [n, d] float32 column at
    d x 4 bytes a lane: a Project of l2_distance over an 8-row VECTOR(16)
    scan reads 8 x 16 x 4 bytes and writes 8 float64 distances."""
    from oceanbase_tpu_torch.expr import ir

    rel = tcol.from_numpy({"v": np.ones((8, 16), np.float32)},
                          device="cpu")
    plan = tplan.Project(tplan.TableScan("t"), {
        "d": ir.FuncCall("l2_distance", [ir.col("v"), ir.lit("[" + ",".join(
            ["0"] * 16) + "]")])})
    tplan.execute_plan(plan, {"t": rel})
    st = tplan._plan_stats(plan)
    assert st.bytes_accessed == 8 * 16 * 4 + 8 * 8
    assert st.flops == 8
