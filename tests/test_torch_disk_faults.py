"""The disk-fault plane of the port against the JAX package's: the
FaultPlane's disk rules (enospc, eio, partial, bitflip, truncate), the
typed errors and crash-safe unwind of every durable writer the rules
reach (WAL, slog, manifest, segments, temp files), the boot-time
corrupt-segment policies and the torn-tail/crc rules of the slog and the
WAL.  Each scenario mirrors a case of ``tests/test_disk.py`` (85-296) or
``tests/test_scrub.py`` (160-366), runs once per package with the same
seeds, asserts the reference's expectations on each, and holds the two
outcome records equal."""

from __future__ import annotations

import errno
import glob
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from torch_pair import J, T, both, outcome

torch.set_num_threads(2)


def _leader(P, root, n_entries=0):
    r = P.PalfReplica(0, log_dir=str(root / "wal"))
    r.role = "leader"
    r.current_term = 1
    if n_entries:
        r.leader_append([f"e{i}".encode() for i in range(n_entries)])
    return r


def _flip_segment(P, path, seeds=range(1, 64)):
    """Flip one seeded bit that lands in covered bytes (see
    tests/test_scrub.py::_flip_segment); -> the seed used."""
    for seed in seeds:
        with tempfile.NamedTemporaryFile(delete=False) as tf:
            probe = tf.name
        shutil.copyfile(path, probe)
        P.bitflip_file(probe, seed=seed)
        try:
            P.Segment.load(probe)
        except P.integrity.CorruptionError:
            os.remove(probe)
            P.bitflip_file(path, seed=seed)
            return seed
        finally:
            if os.path.exists(probe):
                os.remove(probe)
    raise AssertionError("no seed produced a detectable flip")


# ---------------------------------------------------------------------------
# the FaultPlane's disk rules
# ---------------------------------------------------------------------------


def _scn_rules_validate(P, _root):
    fp = P.FaultPlane(seed=0)
    out = [outcome(fp.inject, "send", "enospc"),
           outcome(fp.disk, "enospc", kind="nonsense"),
           outcome(fp.inject, "send", "bitflip"),
           outcome(fp.inject, "disk", "drop"),
           outcome(fp.disk, "bitflip", kind="nope")]
    fp.disk("enospc", kind="wal")
    out.append(fp.check_write("segment", "/x"))
    with pytest.raises(OSError) as ei:
        fp.check_write("wal", "/x")
    assert ei.value.errno == errno.ENOSPC
    out.append(fp.check_write("wal", "/x"))  # one-shot budget spent
    rid = fp.disk("bitflip", kind="segment")
    out.append(fp.rules()[-1]["where"])
    fp.clear(rid)
    return out


def test_disk_rules_validate_and_scope(tmp_path):
    out = both(_scn_rules_validate, tmp_path)
    assert out[:5] == [("error", "ValueError")] * 5


def _scn_partial_seeded(P, _root, seed):
    fp = P.FaultPlane(seed=seed)
    fp.disk("partial", kind="wal", seed=seed)
    first = outcome(fp.check_write, "wal", "/x")
    fp2 = P.FaultPlane(seed=seed)
    fp2.disk("partial", kind="wal", seed=seed)
    cut = fp2.check_write("wal", "/x", nbytes=1000)
    assert cut is not None and 1 <= cut < 1000
    return [first, cut]


@pytest.mark.parametrize("seed", [7, 19])
def test_disk_partial_rule_seeded_and_bounded(tmp_path, seed):
    assert both(_scn_partial_seeded, tmp_path, seed)[0] == \
        ("error", "OSError")


def _scn_bitflip_offset(P, root):
    root.mkdir(parents=True)
    p = root / "a"
    p.write_bytes(bytes(range(256)) * 16)
    off = P.bitflip_file(str(p), seed=99)
    return [off, p.read_bytes()]


def test_bitflip_offset_deterministic(tmp_path):
    both(_scn_bitflip_offset, tmp_path)


# ---------------------------------------------------------------------------
# WAL: typed errors + crash-safe unwind
# ---------------------------------------------------------------------------


def _scn_wal_errno(P, root, action, exc):
    r = _leader(P, root, n_entries=4)
    pre_size = os.path.getsize(r._log_path())
    pre_last = r.last_lsn()
    fp = P.FaultPlane(seed=1)
    fp.disk(action, kind="wal")
    r.faults = fp
    with pytest.raises(getattr(P.diskmgr, exc)) as ei:
        r.leader_append([b"doomed"])
    assert r.last_lsn() == pre_last
    assert os.path.getsize(r._log_path()) == pre_size
    r.leader_append([b"after"])
    r.close()
    r2 = P.PalfReplica(0, log_dir=str(root / "wal"))
    out = [type(ei.value).__name__, r2.last_lsn(),
           [e.payload for e in r2.entries], pre_size]
    r2.close()
    return out


@pytest.mark.parametrize("action,exc", [("enospc", "DiskFull"),
                                        ("eio", "DiskIOError")])
def test_wal_errno_fault_typed_and_unwound(tmp_path, action, exc):
    out = both(_scn_wal_errno, tmp_path, action, exc)
    assert out[1] == 5 and out[2][-1] == b"after"


def _scn_wal_partial(P, root, seed):
    r = _leader(P, root, n_entries=3)
    pre_size = os.path.getsize(r._log_path())
    oracle = [(e.term, e.lsn, e.payload) for e in r.entries]
    fp = P.FaultPlane(seed=seed)
    fp.disk("partial", kind="wal", seed=seed)
    r.faults = fp
    with pytest.raises(P.diskmgr.DiskFull):
        r.leader_append([b"x" * 512, b"y" * 512])
    assert os.path.getsize(r._log_path()) == pre_size
    assert r.last_lsn() == 3
    r.close()
    r2 = P.PalfReplica(0, log_dir=str(root / "wal"))
    assert [(e.term, e.lsn, e.payload) for e in r2.entries] == oracle
    r2.role, r2.current_term = "leader", 1
    r2.leader_append([b"clean"])
    out = [r2.last_lsn(), oracle]
    r2.close()
    return out


@pytest.mark.parametrize("seed", [5, 23])
def test_wal_partial_write_truncates_back(tmp_path, seed):
    assert both(_scn_wal_partial, tmp_path, seed)[0] == 4


def _scn_wal_bitflip_rule(P, root):
    """An armed bitflip on kind="wal" rots the entries just persisted;
    the reopen's crc scan drops the poisoned suffix instead of serving
    it."""
    r = _leader(P, root, n_entries=3)
    fp = P.FaultPlane(seed=13)
    fp.disk("bitflip", kind="wal", count=1)
    r.faults = fp
    r.leader_append([b"rot-me" * 40])
    r.close()
    r2 = P.PalfReplica(0, log_dir=str(root / "wal"))
    out = [e.payload for e in r2.entries]
    r2.close()
    return [fp.rules()[0]["fired"], out]


def test_wal_bitflip_rule_never_served(tmp_path):
    fired, payloads = both(_scn_wal_bitflip_rule, tmp_path)
    assert fired == 1 and b"rot-me" * 40 not in payloads


# ---------------------------------------------------------------------------
# slog / manifest / segments (storage/engine.py)
# ---------------------------------------------------------------------------


def _scn_slog(P, root, action, exc):
    eng = P.StorageEngine(str(root))
    eng.create_table(P.tdef("t1"))
    fp = P.FaultPlane(seed=2)
    fp.disk(action, kind="slog")
    eng.faults = fp
    err = outcome(eng.create_table, P.tdef("t2"))
    eng2 = P.StorageEngine(str(root))
    seen = sorted(eng2.tables)
    eng2.create_table(P.tdef("t2"))
    eng3 = P.StorageEngine(str(root))
    return [err, seen, sorted(eng3.tables)]


@pytest.mark.parametrize("action,exc", [("enospc", "DiskFull"),
                                        ("eio", "DiskIOError")])
def test_slog_fault_typed_and_restart_clean(tmp_path, action, exc):
    err, seen, after = both(_scn_slog, tmp_path, action, exc)
    assert err == ("error", exc) and seen == ["t1"]
    assert after == ["t1", "t2"]


def _scn_manifest(P, root):
    eng = P.StorageEngine(str(root))
    eng.create_table(P.tdef())
    eng.bulk_load("t", {"k": np.arange(50), "v": np.arange(50) * 2})
    eng.checkpoint()
    eng.create_table(P.tdef("u"))
    fp = P.FaultPlane(seed=3)
    fp.disk("enospc", kind="manifest")
    eng.faults = fp
    err = outcome(eng.checkpoint)
    assert not os.path.exists(eng._manifest_path() + ".tmp")
    eng2 = P.StorageEngine(str(root))
    a, _ = eng2.tables["t"].tablet.snapshot_arrays(snapshot=10)
    mid = [sorted(eng2.tables), len(a["k"])]
    eng.checkpoint()
    eng3 = P.StorageEngine(str(root))
    return [err, mid, sorted(eng3.tables)]


def test_manifest_fault_keeps_previous_generation(tmp_path):
    err, mid, after = both(_scn_manifest, tmp_path)
    assert err == ("error", "DiskFull") and mid == [["t", "u"], 50]


def _scn_segment(P, root, action):
    eng = P.StorageEngine(str(root))
    eng.create_table(P.tdef())
    eng.bulk_load("t", {"k": np.arange(100), "v": np.arange(100)})
    eng.checkpoint()
    ts = eng.tables["t"]
    ts.tablet.write((500,), "insert", {"k": 500, "v": 1}, tx_id=1)
    ts.tablet.commit(1, 5, [(500,)])
    fp = P.FaultPlane(seed=4)
    fp.disk(action, kind="segment")
    eng.faults = fp
    err = outcome(eng.freeze_and_flush, "t", snapshot=10)
    segdir = os.path.join(str(root), "segments")
    tmps = [f for f in os.listdir(segdir) if f.endswith(".tmp")]
    eng2 = P.StorageEngine(str(root))
    a, _ = eng2.tables["t"].tablet.snapshot_arrays(snapshot=10)
    return [err, tmps, len(a["k"])]


@pytest.mark.parametrize("action,exc", [("enospc", "DiskFull"),
                                        ("eio", "DiskIOError")])
def test_segment_fault_no_torn_file(tmp_path, action, exc):
    assert both(_scn_segment, tmp_path, action) == \
        [("error", exc), [], 100]


def _scn_segment_pending(P, root):
    eng = P.StorageEngine(str(root))
    eng.create_table(P.tdef())
    ts = eng.tables["t"]
    ts.tablet.write((1,), "insert", {"k": 1, "v": 10}, tx_id=1)
    ts.tablet.commit(1, 5, [(1,)])
    fp = P.FaultPlane(seed=11)
    fp.disk("enospc", kind="segment")
    eng.faults = fp
    err = outcome(eng.freeze_and_flush, "t", snapshot=10)
    parked = len(eng._pending_segs)
    a, _ = ts.tablet.snapshot_arrays(snapshot=10)
    live = list(a["k"])
    eng.checkpoint()
    eng2 = P.StorageEngine(str(root))
    a2, _ = eng2.tables["t"].tablet.snapshot_arrays(snapshot=10)
    return [err, parked, live, len(eng._pending_segs), list(a2["k"])]


def test_segment_fault_pending_retry_persists(tmp_path):
    assert both(_scn_segment_pending, tmp_path) == \
        [("error", "DiskFull"), 1, [1], 0, [1]]


def _scn_segment_bitflip_rule(P, root):
    eng = P.StorageEngine(str(root))
    fp = P.FaultPlane(seed=7)
    fp.disk("bitflip", kind="segment", count=1)
    eng.faults = fp
    eng.create_table(P.TableDef("t", [P.ColumnDef("k", P.SqlType.int_())],
                                primary_key=["k"]))
    eng.bulk_load("t", {"k": np.arange(500, dtype=np.int64)})
    path = glob.glob(os.path.join(str(root), "segments", "t_*.npz"))[0]
    err = outcome(P.Segment.load, path)
    fired = fp.rules()[0]["fired"]
    r = eng.scrub_verify_table("t")
    quarantined = [q["table"] for q in eng.quarantined]
    ok = eng.rewrite_segment_from_memory("t", r["corrupt"][0])
    P.Segment.load(eng._segment_file("t", r["corrupt"][0]))
    return [err, fired, r["checked"], len(r["corrupt"]), quarantined,
            ok, eng.quarantined]


def test_disk_fault_corrupts_next_segment_write(tmp_path):
    out = both(_scn_segment_bitflip_rule, tmp_path)
    assert out == [("error", "CorruptionError"), 1, 1, 1, ["t"], True, []]


def _scn_truncate_rule(P, root):
    """A truncate rule on kind="manifest" cuts the just-published
    manifest: the next boot fails its checksum typed."""
    eng = P.StorageEngine(str(root))
    eng.create_table(P.tdef())
    eng.bulk_load("t", {"k": np.arange(20), "v": np.arange(20)})
    fp = P.FaultPlane(seed=21)
    fp.disk("truncate", kind="manifest", count=1)
    eng.faults = fp
    eng.checkpoint()
    return [fp.rules()[0]["fired"], outcome(P.StorageEngine, str(root))]


def test_truncate_rule_fails_boot_typed(tmp_path):
    assert both(_scn_truncate_rule, tmp_path) == \
        [1, ("error", "CorruptionError")]


# ---------------------------------------------------------------------------
# temp files (storage/tmpfile.py)
# ---------------------------------------------------------------------------


def _scn_spill_fault(P, root, action):
    fp = P.FaultPlane(seed=6)
    fp.disk(action, kind="spill")
    with P.TempFileStore(str(root / "spill"), faults=fp) as store:
        rid = store.new_run()
        arrays = {"x": np.arange(64, dtype=np.int64)}
        err = outcome(store.append_chunk, rid, arrays)
        residue = [store.run(rid).n_chunks,
                   os.listdir(store._chunk_dir(rid))]
        store.append_chunk(rid, arrays)
        (got, _), = list(store.read_chunks(rid))
        return [err, residue, got["x"].tolist()]


@pytest.mark.parametrize("action,exc", [("enospc", "DiskFull"),
                                        ("eio", "DiskIOError")])
def test_spill_fault_typed_no_residue(tmp_path, action, exc):
    err, residue, got = both(_scn_spill_fault, tmp_path, action)
    assert err == ("error", exc) and residue == [0, []]
    assert got == list(range(64))


# ---------------------------------------------------------------------------
# boot-time corrupt-segment policies; slog and WAL integrity rules
# ---------------------------------------------------------------------------


def _scn_boot_policy(P, root):
    eng = P.StorageEngine(str(root))
    eng.create_table(P.TableDef("t", [P.ColumnDef("k", P.SqlType.int_())],
                                primary_key=["k"]))
    eng.bulk_load("t", {"k": np.arange(400, dtype=np.int64)})
    eng.checkpoint()
    eng.create_table(P.TableDef("u", [P.ColumnDef("k", P.SqlType.int_())],
                                primary_key=["k"]))
    eng.bulk_load("u", {"k": np.arange(300, dtype=np.int64)})
    # t's segment reaches boot through the manifest, u's through the
    # slog's add_segment record: the policy covers both load paths
    segs = sorted(glob.glob(os.path.join(str(root), "segments", "*.npz")))
    for p in segs:
        _flip_segment(P, p)
    loud = outcome(P.StorageEngine, str(root))
    eng2 = P.StorageEngine(str(root), corrupt_policy="quarantine")
    q = sorted(x["table"] for x in eng2.quarantined)
    gone = [os.path.exists(p) for p in segs]
    kept = len(glob.glob(os.path.join(str(root), "segments",
                                      "*.corrupt.*")))
    return [loud, q, gone, kept]


def test_boot_corrupt_policy_raise_and_quarantine(tmp_path):
    assert both(_scn_boot_policy, tmp_path) == \
        [("error", "CorruptionError"), ["t", "u"], [False, False], 2]


def _scn_slog_tail(P, root):
    root.mkdir(parents=True)
    eng = P.StorageEngine(str(root))
    eng._log_meta({"op": "create_view", "name": "v1", "sql": "select 1"})
    slog = eng._slog_path()
    with open(slog, "a") as f:
        f.write('{"crc": 1, "rec": "')
    ops = [o["op"] for o in P.engine.read_slog(slog)]
    with open(slog, "w") as f:
        f.write('{"crc": 12345, "rec": "{\\"op\\": \\"drop_view\\"}"}\n')
    return [ops, outcome(lambda: list(P.engine.read_slog(slog)))]


def test_slog_torn_tail_tolerated_bad_crc_raises(tmp_path):
    assert both(_scn_slog_tail, tmp_path) == \
        [["create_view"], ("error", "CorruptionError")]


def _scn_wal_entry_flip(P, root):
    root.mkdir(parents=True)
    r = P.PalfReplica(1, str(root))
    r.role, r.current_term = "leader", 1
    r.leader_append([f"p{i}".encode() for i in range(8)])
    r.close()
    path = os.path.join(str(root), "replica_1.log")
    buf = open(path, "rb").read()
    hdr, off, last = P.palf_log._HDR, len(P.palf_log._MAGIC), None
    while off + hdr.size <= len(buf):
        _t, _l, plen, _c = hdr.unpack_from(buf, off)
        last = off + hdr.size
        off += hdr.size + plen
    with open(path, "r+b") as f:
        f.seek(last)
        b = f.read(1)
        f.seek(last)
        f.write(bytes([b[0] ^ 0x01]))
    r2 = P.PalfReplica(1, str(root))
    out = [[e.payload for e in r2.entries],
           os.path.getsize(path) < len(buf)]
    r2.close()
    return out


def test_wal_flipped_entry_never_served(tmp_path):
    payloads, truncated = both(_scn_wal_entry_flip, tmp_path)
    assert payloads == [f"p{i}".encode() for i in range(7)] and truncated


# ---------------------------------------------------------------------------
# the database-level wiring: arm_disk_faults reaches every writer
# ---------------------------------------------------------------------------


def test_arm_disk_faults_needs_the_knob_and_reaches_writers(tmp_path):
    db = T.db(tmp_path / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    fp = T.FaultPlane(seed=3)
    with pytest.raises(PermissionError):
        db.arm_disk_faults(fp)
    s.execute("alter system set enable_disk_faults = true")
    db.arm_disk_faults(fp)
    t = db.tenant("sys")
    assert t.engine.faults is fp and db.faults is fp
    assert all(r.faults is fp for r in t.wal.replicas.values())
    fp.disk("enospc", kind="wal")
    with pytest.raises(T.diskmgr.DiskFull):
        s.execute("insert into t values (1, 1)")
    s.execute("insert into t values (2, 2)")   # one-shot budget spent
    db.arm_disk_faults(None)
    assert t.engine.faults is None and db.faults is None
    assert s.execute("select k from t").rows() == [(2,)]
    db.close()
    db2 = T.db(tmp_path / "db")
    assert db2.session().execute("select k from t").rows() == [(2,)]
    db2.close()


def test_no_bare_oserror_out_of_durable_writers(tmp_path):
    """Every durable writer of the port turns an OSError into the disk
    manager's typed errors, never a bare OSError."""
    D = T.diskmgr
    for kind, run in (
            ("slog", lambda e: e.create_table(T.tdef("x"))),
            ("manifest", lambda e: e.checkpoint()),
            ("segment", lambda e: e.bulk_load(
                "t", {"k": np.arange(5), "v": np.arange(5)}))):
        eng = T.StorageEngine(str(tmp_path / kind))
        eng.create_table(T.tdef())
        fp = T.FaultPlane(seed=1)
        fp.disk("eio", kind=kind)
        eng.faults = fp
        with pytest.raises(Exception) as ei:
            run(eng)
        assert type(ei.value) is D.DiskIOError, kind
        assert isinstance(ei.value.__cause__, OSError), kind


def test_port_matches_reference_class_names():
    for name in ("DiskFull", "DiskIOError", "TenantReadOnly",
                 "SpillBudgetExceeded"):
        j, t = getattr(J.diskmgr, name), getattr(T.diskmgr, name)
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in j.__mro__]
