"""The port's DTL pushdown (``px/dtl.py``) held against the reference's.

Same inputs, made from a seed with numpy, through both packages:

- ``encode_plan`` of a query bound by each package's binder (column ids
  aligned first, ``test_torch_sql_frontend.py::align_colids``) is equal
  JSON, and each package decodes the other's back to the same plan;
- ``split_pushdown`` qualifies the same shapes as the reference
  (``tests/test_dtl_pushdown.py``'s cases and more);
- ``slice_mask`` is equal over int, float and string keys;
- ``execute_fragment`` replies (rows, validity, types, digest) and the
  coordinator's ``merge_fragments`` plus final plan are equal on the
  same tablet snapshot, with NULLs and strings; the merged relation's
  pad lanes, poisoned, change nothing;
- ``verify_reply`` detects a tampered reply (the reference's
  ``tests/test_scrub.py::test_dtl_reply_digest_detects_tamper``);
- ``CancelRegistry`` pins, tombstones and evicts as the reference does.

Tolerance: exact, but float64 avgs at 1e-9 relative.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import oceanbase_tpu.px.dtl as jdtl
import oceanbase_tpu.sql.binder as jbinder
import oceanbase_tpu.sql.parser as jparser
import oceanbase_tpu_torch.px.dtl as tdtl
import oceanbase_tpu_torch.sql.binder as tbinder
import oceanbase_tpu_torch.sql.parser as tparser
from oceanbase_tpu_torch.analysis.poison import poison_pad_lanes
from oceanbase_tpu_torch.vector import to_numpy as t_to_numpy
from test_torch_sql_frontend import align_colids
from torch_pair import J, T

torch.set_num_threads(2)

N = 2000


def _data(seed=7, n=N):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    v = rng.integers(0, 100, n)
    d = rng.integers(0, 1000, n)
    s = np.array([f"s{x}" for x in rng.integers(0, 6, n)], dtype=object)
    vnull = rng.random(n) < 0.1
    return k, v, d, s, vnull


def _seed(P, root, seed=7):
    db = P.db(root)
    s = db.session()
    s.execute("create table t (k int primary key, v int, d int, "
              "s varchar(8), f double)")
    k, v, d, sv, vnull = _data(seed)
    for a in range(0, N, 500):
        vals = ", ".join(
            f"({k[i]}, {'null' if vnull[i] else v[i]}, {d[i]}, "
            f"'{sv[i]}', {float(d[i]) / 7.0!r})" for i in range(a, a + 500))
        s.execute(f"insert into t values {vals}")
    return db


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtl")
    jdb, tdb = _seed(J, root / "j"), _seed(T, root / "t")
    yield jdb, tdb
    jdb.close()
    tdb.close()


def _bind(binder, parser, catalog, sql):
    plan, _outs, _ = binder.Binder(catalog).bind_select(
        parser.parse_sql(sql))
    return plan


PUSHABLE = [
    "select sum(v), count(*), min(d), max(d), avg(v) from t "
    "where d < 500 and v > 3",
    "select d, sum(v) from t where d in (1, 2, 3) group by d",
    "select k, v from t where d < 5 or d > 990",
    "select s, count(*), sum(f) from t where s like 's1%' group by s",
    "select sum(case when v > 50 then 1 else 0 end), count(v) from t "
    "where v is not null and d between 10 and 700",
    "select k, s from t where not (d >= 30) and s <> 's3'",
    "select s, avg(v) as a from t where d < 100 group by s "
    "order by a desc limit 3",
    "select sum(v * 2 + d), min(s) from t where k % 7 = 1",
    "select abs(v - 50), k from t where v is null or d = 17",
]

NOT_PUSHABLE = [
    "select a.k from t a, t b where a.k = b.k",
    "select k from t",
    "select count(distinct v) from t where d < 9",
    "select k, v from t order by v limit 5",
]


@pytest.mark.parametrize("sql", PUSHABLE)
def test_encode_plan_json_matches_reference(dbs, sql):
    jdb, tdb = dbs
    align_colids()
    jp = _bind(jbinder, jparser, jdb.catalog, sql)
    tp = _bind(tbinder, tparser, tdb.catalog, sql)
    jpush, tpush = jdtl.split_pushdown(jp), tdtl.split_pushdown(tp)
    assert jpush is not None and tpush is not None
    jjson = json.dumps(jpush.encoded, sort_keys=True)
    tjson = json.dumps(tpush.encoded, sort_keys=True)
    assert tjson == jjson
    assert (tpush.table, tpush.has_agg) == (jpush.table, jpush.has_agg)
    # decoding round-trips, and each package reads the other's message
    assert tdtl.decode_plan(tpush.encoded).fingerprint() == \
        tpush.remote.fingerprint()
    assert json.dumps(tdtl.encode_plan(tdtl.decode_plan(
        jpush.encoded)), sort_keys=True) == jjson
    assert json.dumps(jdtl.encode_plan(jdtl.decode_plan(
        tpush.encoded)), sort_keys=True) == tjson
    # the rebuilt coordinator plan is the same shape
    assert type(tpush.rebuilt).__name__ == type(jpush.rebuilt).__name__


@pytest.mark.parametrize("sql", NOT_PUSHABLE)
def test_split_pushdown_declines_the_same_shapes(dbs, sql):
    jdb, tdb = dbs
    align_colids()
    assert jdtl.split_pushdown(
        _bind(jbinder, jparser, jdb.catalog, sql)) is None
    assert tdtl.split_pushdown(
        _bind(tbinder, tparser, tdb.catalog, sql)) is None


def test_encode_type_and_literal_never_leak_torch():
    from oceanbase_tpu.datatypes import SqlType as JT
    from oceanbase_tpu_torch.datatypes import SqlType as TT

    for jt, tt in ((JT.decimal(15, 2), TT.decimal(15, 2)),
                   (JT.string(), TT.string()), (JT.date(), TT.date()),
                   (JT.double(), TT.double()), (None, None)):
        assert tdtl._enc_type(tt) == jdtl._enc_type(jt)
    from oceanbase_tpu_torch.expr import ir as tir

    with pytest.raises(tdtl.NotPushable):
        tdtl.encode_expr(tir.Literal(torch.tensor(1), None))
    e = tdtl.encode_expr(tir.Literal(np.int64(3), None))
    assert e == {"e": "lit", "v": 3, "t": None} and \
        type(e["v"]) is int


@pytest.mark.parametrize("nparts", [1, 2, 3, 5])
def test_slice_mask_matches_reference(nparts):
    rng = np.random.default_rng(nparts)
    n = 5000
    arrays = {"a": rng.integers(-10**12, 10**12, n),
              "f": rng.normal(size=n),
              "s": np.array([f"k{x}" for x in rng.integers(0, 999, n)],
                            dtype=object),
              "b": rng.random(n) < 0.5}
    for keys in (["a"], ["a", "s"], ["f"], ["s", "b"]):
        total = np.zeros(n, dtype=np.int64)
        for p in range(nparts):
            jm = jdtl.slice_mask(arrays, keys, p, nparts)
            tm = tdtl.slice_mask(arrays, keys, p, nparts)
            assert np.array_equal(jm, tm), (keys, p)
            total += tm
        assert (total == 1).all()  # disjoint and complete


FRAGMENT_SQL = [
    "select sum(v), count(*), min(d), max(d), avg(v) from t "
    "where d < 500",
    "select s, sum(v), count(v), avg(f) from t where d < 800 group by s",
    "select k, v, s from t where d < 60",
]


def _fragment_run(P, dtl, db, plan, nparts, poison=False):
    push = dtl.split_pushdown(plan)
    ts = db.engine.tables["t"]
    snap = db.tx.gts.current()
    kw = {"device": "cpu"} if P.is_port else {}
    replies = [dtl.execute_fragment(ts, push.encoded, snap, p, nparts,
                                    with_ops=True, **kw)
               for p in range(nparts)]
    for r in replies:
        dtl.verify_reply(r, 0, 0)
    rel = dtl.merge_fragments(replies, **kw)
    if poison:
        rel = poison_pad_lanes(rel)
    out = P.plan.execute_plan(push.rebuilt, {dtl.DTL_TABLE: rel})
    return replies, (t_to_numpy(out) if P.is_port
                     else P.to_numpy(out))


def _canon(host: dict):
    """Result columns as sorted row tuples (the two packages' output
    order may differ for a group-by)."""
    names = sorted(k for k in host if not k.startswith("__valid__"))
    cols = []
    for nm in names:
        a = np.asarray(host[nm])
        v = host.get("__valid__" + nm)
        cols.append([None if (v is not None and not v[i]) else
                     (a[i].item() if hasattr(a[i], "item") else a[i])
                     for i in range(len(a))])
    return names, sorted(zip(*cols), key=repr)


def _rows_close(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert np.isclose(x, y, rtol=1e-9, atol=0.0), (x, y)
            else:
                assert x == y


@pytest.mark.parametrize("sql", FRAGMENT_SQL)
@pytest.mark.parametrize("nparts", [1, 3])
def test_fragment_and_merge_match_reference(dbs, sql, nparts):
    jdb, tdb = dbs
    import importlib

    J.plan = importlib.import_module("oceanbase_tpu.exec.plan")
    J.to_numpy = importlib.import_module("oceanbase_tpu.vector").to_numpy
    T.plan = importlib.import_module("oceanbase_tpu_torch.exec.plan")
    align_colids()
    jp = _bind(jbinder, jparser, jdb.catalog, sql)
    tp = _bind(tbinder, tparser, tdb.catalog, sql)
    jrep, jout = _fragment_run(J, jdtl, jdb, jp, nparts)
    trep, tout = _fragment_run(T, tdtl, tdb, tp, nparts)
    for jr, tr in zip(jrep, trep):
        assert tr["rows"] == jr["rows"] and tr["scanned"] == jr["scanned"]
        assert tr["types"] == jr["types"]
        assert tr["ops"] == jr["ops"]
        assert len(tr["tm"]) == 5
        jn, jrows = _canon({**jr["arrays"], **{"__valid__" + k: v for
                                               k, v in jr["valids"].items()}})
        tn, trows = _canon({**tr["arrays"], **{"__valid__" + k: v for
                                               k, v in tr["valids"].items()}})
        assert tn == jn
        _rows_close(trows, jrows)
        if not any(t[0] == "double" for t in tr["types"].values()):
            assert tr["crc"] == jr["crc"]
    jn, jrows = _canon(jout)
    tn, trows = _canon(tout)
    assert tn == jn
    _rows_close(trows, jrows)
    # the merged relation's dead pad lanes, poisoned, change nothing
    _rep, tpois = _fragment_run(T, tdtl, tdb, tp, nparts, poison=True)
    assert _canon(tpois) == _canon(tout)


def test_fragment_ships_zero_device_time_on_the_cpu(dbs):
    _jdb, tdb = dbs
    align_colids()
    plan = _bind(tbinder, tparser, tdb.catalog,
                 "select sum(v) from t where d < 10")
    push = tdtl.split_pushdown(plan)
    r = tdtl.execute_fragment(tdb.engine.tables["t"], push.encoded,
                              tdb.tx.gts.current(), 0, 1, device="cpu")
    host_us, device_us, _fl, _by, calls = r["tm"]
    assert device_us == 0 and calls == 1 and host_us >= 0


def test_verify_reply_detects_tamper():
    from oceanbase_tpu.storage.integrity import (
        CorruptionError as JCorrupt,
    )
    from oceanbase_tpu.storage.integrity import arrays_crc as jcrc
    from oceanbase_tpu_torch.storage.integrity import (
        CorruptionError,
        arrays_crc,
    )

    arrays = {"a": np.arange(10, dtype=np.int64),
              "s": np.array(["x", None, "zz"] * 3 + ["w"], dtype=object)}
    valids = {"a": np.ones(10, dtype=bool)}
    assert arrays_crc(arrays, valids) == jcrc(arrays, valids)
    reply = {"arrays": {k: v.copy() for k, v in arrays.items()},
             "valids": valids, "crc": arrays_crc(arrays, valids)}
    tdtl.verify_reply(reply, part=1, peer=2)
    reply["arrays"]["a"][3] = 999
    with pytest.raises(CorruptionError):
        tdtl.verify_reply(reply, part=1, peer=2)
    with pytest.raises(JCorrupt):
        jdtl.verify_reply(reply, part=1, peer=2)
    tdtl.verify_reply({"arrays": arrays, "valids": valids}, 1, 2)


def test_cancel_registry_matches_reference():
    def run(mod):
        reg = mod.CancelRegistry()
        reg.MAX_ENTRIES = 4
        out = []
        ev = reg.pin("live")
        out.append(reg.cancel("ghost"))          # tombstone
        out.append(reg.cancel("ghost"))          # already set
        for i in range(10):
            reg.entry(f"idle{i}")
        out.append("live" in reg._entries)       # pinned survives LRU
        out.append(ev is reg.entry("live"))
        reg.unpin("live")
        out.append(reg.cancel("live"))
        out.append(sorted(reg._entries))
        return out

    assert run(tdtl) == run(jdtl)


def test_remote_ctx_observes_the_cancel_flag():
    import threading

    from oceanbase_tpu_torch.server import admission as qadmission

    ev = threading.Event()
    ctx = qadmission.RemoteCtx(ev, token="tok")
    with qadmission.activate(ctx):
        qadmission.checkpoint()
        assert qadmission.current() is ctx
        ev.set()
        with pytest.raises(qadmission.QueryKilled, match="dtl.cancel"):
            qadmission.checkpoint()
    assert qadmission.current() is None
    # a statement's ctx carries the token dtl.cancel correlates on
    assert len(qadmission.StmtCtx().token) == 16


def test_fragment_times_stay_per_thread_beside_a_statement(dbs):
    """An rpc server runs a fragment on its connection's thread while a
    session statement runs on another: each fragment's shipped split
    counts its own one execution, however the two interleave (the
    accumulator, the pending executions and the admission context are
    per thread)."""
    import threading

    from oceanbase_tpu_torch.exec.plan import exec_times, reset_exec_times

    _jdb, tdb = dbs
    align_colids()
    plan = _bind(tbinder, tparser, tdb.catalog,
                 "select sum(v) from t where d < 700")
    push = tdtl.split_pushdown(plan)
    ts = tdb.engine.tables["t"]
    snap = tdb.tx.gts.current()
    stop = threading.Event()
    errors = []

    def statements():
        s = tdb.session()
        try:
            while not stop.is_set():
                s.execute("select count(*), sum(d) from t where k > 5")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=statements)
    th.start()
    try:
        reset_exec_times()
        for p in range(12):
            r = tdtl.execute_fragment(ts, push.encoded, snap, p % 3, 3,
                                      device="cpu")
            assert r["tm"][4] == 1, r["tm"]
        assert exec_times().calls == 12
    finally:
        stop.set()
        th.join(timeout=60)
    assert not errors
