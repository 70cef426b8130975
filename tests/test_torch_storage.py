"""The port's storage plane against the JAX package's: the native codecs
byte for byte (library and numpy paths), the column encodings, zone-map
pruning, segment files (written by one package, read by the other) and
the crc check on a flipped byte, tablet MVCC, compaction and
uncommitted visibility, the vectorized newest-wins dedup on random
multi-version histories, and engine persistence and recovery — the cases
of ``tests/test_storage.py`` on both packages."""

import numpy as np
import pytest

import oceanbase_tpu.native as jnative
import oceanbase_tpu_torch.native as tnative
from oceanbase_tpu.catalog import ColumnDef as JColumnDef
from oceanbase_tpu.catalog import TableDef as JTableDef
from oceanbase_tpu.datatypes import SqlType as JSqlType
from oceanbase_tpu.storage import encoding as jenc
from oceanbase_tpu.storage.engine import StorageEngine as JEngine
from oceanbase_tpu.storage.segment import Segment as JSegment
from oceanbase_tpu.storage.tablet import Tablet as JTablet
from oceanbase_tpu_torch.catalog import ColumnDef, TableDef
from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.storage import encoding as tenc
from oceanbase_tpu_torch.storage.engine import StorageCatalog, StorageEngine
from oceanbase_tpu_torch.storage.integrity import CorruptionError
from oceanbase_tpu_torch.storage.segment import Segment, keep_last
from oceanbase_tpu_torch.storage.tablet import Tablet
from oceanbase_tpu_torch.tx.errors import WriteConflict


# ---------------------------------------------------------------------------
# native codecs
# ---------------------------------------------------------------------------


def test_native_library_builds_into_the_port():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert "oceanbase_tpu_torch" in str(path)


@pytest.mark.parametrize("use_native", [True, False])
def test_native_codecs_byte_equal_to_reference(use_native):
    rng = np.random.default_rng(3)
    blobs = [b"", b"a", bytes(range(256)) * 3,
             rng.integers(0, 256, 1001, dtype=np.uint8).tobytes()]
    for b in blobs:
        for seed in (0, 12345):
            assert tnative.crc64(b, seed=seed, use_native=use_native) == \
                jnative.crc64(b, seed=seed)
    ints = [np.zeros(0, dtype=np.int64),
            rng.integers(-10**12, 10**12, 777),
            np.cumsum(rng.integers(0, 9, 500)),
            np.array([np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0,
                      -1, 1], dtype=np.int64)]
    for a in ints:
        enc = tnative.delta_varint_encode(a, use_native=use_native)
        assert enc == jnative.delta_varint_encode(a)
        np.testing.assert_array_equal(
            tnative.delta_varint_decode(enc, len(a), use_native=use_native),
            a)
        np.testing.assert_array_equal(
            tnative.rle_run_starts(a, use_native=use_native),
            jnative.rle_run_starts(a))


# ---------------------------------------------------------------------------
# encodings, zone maps, segments
# ---------------------------------------------------------------------------

_CASES = {
    "rand": lambda r: r.integers(0, 1_000_000, 10000),
    "runs": lambda r: np.repeat(r.integers(0, 5, 100), 100),
    "lowcard": lambda r: r.integers(0, 10, 10000),
    "monotonic": lambda r: np.cumsum(r.integers(1, 5, 10000)),
    "floats": lambda r: r.random(1000),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_encodings_roundtrip_byte_equal(case):
    arr = np.asarray(_CASES[case](np.random.default_rng(42)))
    te, je = tenc.encode_column(arr, None), jenc.encode_column(arr, None)
    assert te.encoding == je.encoding
    assert sorted(te.payload) == sorted(je.payload)
    for k in te.payload:
        a, b = np.asarray(te.payload[k]), np.asarray(je.payload[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (te.zone.vmin, te.zone.vmax) == (je.zone.vmin, je.zone.vmax)
    np.testing.assert_array_equal(tenc.decode_column(te), arr)
    if case == "runs":
        assert te.encoding == "rle"
    if case == "monotonic":
        assert te.encoding in ("delta", "varint")


def test_zone_map_pruning():
    arr = np.arange(200000)
    seg = Segment.build(1, 2, {"a": arr}, {"a": SqlType.int_()})
    jseg = JSegment.build(1, 2, {"a": arr}, {"a": JSqlType.int_()})
    assert seg.n_chunks == jseg.n_chunks == 4  # 65536-row chunks
    for lo, hi in ((100_000, 120_000), (None, 10), (199_999, None)):
        mask = seg.prune_chunks("a", lo, hi)
        assert mask.tolist() == jseg.prune_chunks("a", lo, hi).tolist()
    mask = seg.prune_chunks("a", 100_000, 120_000)
    assert mask.tolist() == [False, True, False, False]
    arrays, _ = seg.decode(chunk_mask=mask)
    assert arrays["a"].min() == 65536 and arrays["a"].max() == 131071


def _seg_inputs():
    rng = np.random.default_rng(7)
    arr = {"k": np.arange(1000),
           "s": rng.choice(np.array(["aa", "bb", "cc"]), 1000).astype(object),
           "v": rng.integers(0, 100, 1000)}
    valids = {"v": rng.random(1000) > 0.1}
    return arr, valids


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segment_files_cross_load(tmp_path, writer):
    """A segment saved by one package loads, crc-verified, in the other:
    the file format is the same."""
    arr, valids = _seg_inputs()
    types = {"k": SqlType.int_(), "s": SqlType.string(), "v": SqlType.int_()}
    jtypes = {"k": JSqlType.int_(), "s": JSqlType.string(),
              "v": JSqlType.int_()}
    p = str(tmp_path / "seg.npz")
    if writer == "port":
        Segment.build(7, 1, arr, types, valids).save(p)
        loaded = JSegment.load(p)
    else:
        JSegment.build(7, 1, arr, jtypes, valids).save(p)
        loaded = Segment.load(p)
    a2, v2 = loaded.decode()
    np.testing.assert_array_equal(a2["k"], arr["k"])
    np.testing.assert_array_equal(a2["s"].astype(str), arr["s"].astype(str))
    np.testing.assert_array_equal(v2["v"], valids["v"])
    assert loaded.level == 1 and loaded.segment_id == 7


def test_segment_crc_rejects_a_flipped_byte(tmp_path):
    arr, valids = _seg_inputs()
    seg = Segment.build(7, 1, arr, {"k": SqlType.int_(),
                                    "s": SqlType.string(),
                                    "v": SqlType.int_()}, valids)
    p = tmp_path / "seg.npz"
    seg.save(str(p))
    raw = bytearray(p.read_bytes())
    for off in (len(raw) // 3, len(raw) // 2, 2 * len(raw) // 3):
        bad = bytearray(raw)
        bad[off] ^= 0x40
        q = tmp_path / f"bad{off}.npz"
        q.write_bytes(bytes(bad))
        with pytest.raises(CorruptionError):
            Segment.load(str(q))
    Segment.load(str(p))  # the intact file still loads


# ---------------------------------------------------------------------------
# tablets
# ---------------------------------------------------------------------------


def _pair():
    t = Tablet(1, ["k", "v"], {"k": SqlType.int_(), "v": SqlType.int_()},
               ["k"])
    j = JTablet(1, ["k", "v"], {"k": JSqlType.int_(), "v": JSqlType.int_()},
                ["k"])
    return t, j


def _rows(tab, snapshot, tx_id=0):
    a, v = tab.snapshot_arrays(snapshot=snapshot, tx_id=tx_id)
    valid = v["v"] if v["v"] is not None else np.ones(len(a["v"]), bool)
    return sorted((int(k), int(x) if ok else None)
                  for k, x, ok in zip(a["k"], a["v"], valid))


def test_tablet_mvcc_and_compaction():
    tabs = _pair()

    def both(method, *args, **kw):
        return [getattr(t, method)(*args, **kw) for t in tabs]

    def read(snapshot):
        got = [_rows(t, snapshot) for t in tabs]
        assert got[0] == got[1]
        return got[0]

    both("write", (1,), "insert", {"k": 1, "v": 100}, tx_id=1)
    both("write", (2,), "insert", {"k": 2, "v": 200}, tx_id=1)
    both("commit", 1, 10, [(1,), (2,)])
    both("write", (1,), "update", {"k": 1, "v": 111}, tx_id=2)
    both("write", (2,), "delete", {"k": 2, "v": 200}, tx_id=2)
    both("commit", 2, 20, [(1,), (2,)])
    assert read(15) == [(1, 100), (2, 200)]
    assert read(25) == [(1, 111)]
    both("freeze")
    segs = both("mini_compact", snapshot=30)
    assert segs[0].level == 0
    assert read(25) == [(1, 111)]
    both("write", (3,), "insert", {"k": 3, "v": 300}, tx_id=3)
    both("commit", 3, 40, [(3,)])
    both("freeze")
    both("mini_compact", snapshot=50)
    assert len([s for s in tabs[0].segments if s.level == 0]) == 2
    both("minor_compact")
    assert len(tabs[0].segments) == 1 and tabs[0].segments[0].level == 1
    merged = both("major_compact")
    assert merged[0].level == 2 and merged[0].n_rows == merged[1].n_rows
    assert read(50) == [(1, 111), (3, 300)]


def test_uncommitted_visibility():
    t, _j = _pair()
    t.write((1,), "insert", {"k": 1, "v": 1}, tx_id=5)
    assert _rows(t, 100) == []
    assert _rows(t, 100, tx_id=5) == [(1, 1)]
    with pytest.raises(WriteConflict):
        t.write((1,), "update", {"k": 1, "v": 2}, tx_id=6)
    t.abort(5, [(1,)])
    assert _rows(t, 100, tx_id=5) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_histories_match_reference(seed):
    """Random inserts, updates, deletes and aborts over few keys, with
    freezes, flushes and compactions between them: every snapshot of
    every version reads the same rows in both packages (the port's
    newest-wins dedup is vectorized, the reference's a row loop), and
    ``keep_last`` agrees with the reference's loop directly."""
    rng = np.random.default_rng(seed)
    tabs = _pair()
    live, version, tx = {}, 0, 0
    for step in range(60):
        tx += 1
        keys = sorted({int(k) for k in rng.integers(0, 12, 3)})
        writes = []
        for k in keys:
            op = "delete" if k in live and rng.random() < 0.3 else \
                "update" if k in live else "insert"
            vals = {"k": k, "v": None if rng.random() < 0.2
                    else int(rng.integers(0, 1000))}
            for t in tabs:
                t.write((k,), op, dict(vals), tx_id=tx)
            writes.append((k, op))
        if rng.random() < 0.15:
            for t in tabs:
                t.abort(tx, [(k,) for k, _ in writes])
        else:
            version += 10
            for t in tabs:
                t.commit(tx, version, [(k,) for k, _ in writes])
            for k, op in writes:
                live[k] = op != "delete"
        r = rng.random()
        if r < 0.2:
            for t in tabs:
                t.freeze()
                t.mini_compact(snapshot=version)
        elif r < 0.25:
            for t in tabs:
                t.minor_compact()
        elif r < 0.28:
            for t in tabs:
                t.major_compact()
        for snap in {version, max(version - 25, 0), version // 2}:
            assert _rows(tabs[0], snap) == _rows(tabs[1], snap), (step, snap)
    keys = [rng.integers(0, 4, 500), rng.integers(0, 3, 500)]
    seen, want = set(), np.zeros(500, dtype=bool)
    for i in range(499, -1, -1):
        key = (keys[0][i], keys[1][i])
        if key not in seen:
            seen.add(key)
            want[i] = True
    np.testing.assert_array_equal(keep_last(keys), want)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _tdef(cls_t, cls_c, sqltype):
    return cls_t("t", [cls_c("k", sqltype.int_()), cls_c("v", sqltype.int_())],
                 primary_key=["k"])


def test_engine_persistence_and_recovery(tmp_path):
    root = str(tmp_path / "db")
    eng = StorageEngine(root)
    eng.create_table(_tdef(TableDef, ColumnDef, SqlType))
    eng.bulk_load("t", {"k": np.arange(100), "v": np.arange(100) * 2})
    ts = eng.tables["t"]
    ts.tablet.write((200,), "insert", {"k": 200, "v": 400}, tx_id=1)
    ts.tablet.commit(1, 5, [(200,)])
    eng.freeze_and_flush("t", snapshot=10)
    eng.checkpoint()

    eng2 = StorageEngine(root)
    a, _ = eng2.tables["t"].tablet.snapshot_arrays(snapshot=10)
    assert len(a["k"]) == 101 and 200 in set(a["k"].tolist())
    # the reference's engine opens the port's root: same manifest,
    # slog and segment files
    ja, _ = JEngine(root).tables["t"].tablet.snapshot_arrays(snapshot=10)
    assert sorted(ja["k"].tolist()) == sorted(a["k"].tolist())

    eng2.major_compact("t")  # compaction after recovery + slog replay
    eng3 = StorageEngine(root)
    a, _ = eng3.tables["t"].tablet.snapshot_arrays(snapshot=10)
    assert len(a["k"]) == 101


def test_engine_refuses_partitioned_tables(tmp_path):
    """A RANGE-partitioned table whose primary key lacks the partition
    column is refused by both engines (uniqueness could only be checked
    across partitions); one whose key holds it is created, one tablet
    per partition."""
    for eng, (tc, cc, st) in (
            (StorageEngine(str(tmp_path / "t")),
             (TableDef, ColumnDef, SqlType)),
            (JEngine(str(tmp_path / "j")),
             (JTableDef, JColumnDef, JSqlType))):
        tdef = _tdef(tc, cc, st)
        tdef.partition = ("v", [10])
        with pytest.raises(ValueError, match="partitioning function"):
            eng.create_table(tdef)
        assert "t" not in eng.tables
        tdef.partition = ("k", [10, 20])
        eng.create_table(tdef)
        assert len(eng.tables["t"].tablet.partitions) == 3


def test_storage_catalog_executor_integration():
    from oceanbase_tpu_torch.exec.ops import AggSpec
    from oceanbase_tpu_torch.exec.plan import (
        ScalarAgg,
        TableScan,
        execute_plan,
    )
    from oceanbase_tpu_torch.expr import ir
    from oceanbase_tpu_torch.vector import to_numpy

    eng = StorageEngine(None)
    cat = StorageCatalog(eng, device="cpu")
    cat.load_numpy("t", {"k": np.arange(50), "v": np.arange(50) * 3},
                   primary_key=["k"])
    rel = cat.table_data("t")
    assert rel.device.type == "cpu" and cat.table_data("t") is rel
    plan = ScalarAgg(TableScan("t"), [AggSpec("s", "sum", ir.col("v"))])
    assert to_numpy(execute_plan(plan, {"t": rel}))["s"][0] == \
        sum(range(50)) * 3
    # DML through the tablet invalidates the snapshot cache by version
    ts = eng.tables["t"]
    ts.tablet.write((100,), "insert", {"k": 100, "v": 1000}, tx_id=9)
    ts.tablet.commit(9, 99, [(100,)])
    rel2 = cat.table_data("t")
    assert int(rel2.mask_or_true().sum()) == 51 and rel2.capacity >= 51
    # the cache counts tensor bytes
    assert cat.device_bytes() > 0
