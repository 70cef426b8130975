"""The port's PALF WAL and transaction service against the JAX package's:
the cases of ``tests/test_palf_tx.py`` (replication and commit, leader
failover, no quorum, disk recovery, single-participant and 2PC commit,
conflict and rollback, WAL-replay recovery) run on both packages with
the same calls, holding entries, commit points, commit versions, the
on-disk log bytes and the replayed rows equal; plus torn-tail
truncation, recycle, and the WAL's refusal of a torch value."""

import json

import numpy as np
import pytest
import torch

from oceanbase_tpu.catalog import ColumnDef as JColumnDef
from oceanbase_tpu.catalog import TableDef as JTableDef
from oceanbase_tpu.datatypes import SqlType as JSqlType
from oceanbase_tpu.palf.cluster import PalfCluster as JPalfCluster
from oceanbase_tpu.storage.engine import StorageEngine as JEngine
from oceanbase_tpu.tx.service import TransService as JTransService
from oceanbase_tpu_torch.catalog import ColumnDef, TableDef
from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.palf.cluster import NoQuorum, PalfCluster
from oceanbase_tpu_torch.storage.engine import StorageEngine
from oceanbase_tpu_torch.tx.errors import WriteConflict
from oceanbase_tpu_torch.tx.service import TransService, TxState


def _entries(c):
    return {i: [(e.term, e.lsn, e.payload) for e in r.entries]
            for i, r in c.replicas.items()}


def test_palf_replication_and_commit():
    c, j = PalfCluster(3), JPalfCluster(3)
    assert c.elect() == j.elect()
    lsn = c.append([b"a", b"b", b"c"])
    assert lsn == j.append([b"a", b"b", b"c"]) and lsn >= 3
    for r in c.replicas.values():
        assert r.committed_lsn == c.replicas[c.leader_id].committed_lsn
        assert [e.payload for e in r.entries[-3:]] == [b"a", b"b", b"c"]
    assert _entries(c) == _entries(j)


def test_palf_leader_failover():
    applied = {i: [] for i in (1, 2, 3)}

    def cb_factory(i):
        return lambda e: applied[i].append(e.payload)

    c = PalfCluster(3, apply_cb_factory=cb_factory)
    j = JPalfCluster(3)
    for x in (c, j):
        x.elect()
        x.append([b"x1"])
    old = c.leader_id
    for x in (c, j):
        x.kill(old)
    new = c.elect()
    assert new != old and new == j.elect()
    for x in (c, j):
        x.append([b"x2"])
    payloads = [e.payload for e in c.replicas[new].entries]
    assert b"x1" in payloads and b"x2" in payloads
    for x in (c, j):
        x.revive(old)
        x.tick()
    assert [e.payload for e in c.replicas[old].entries] == payloads
    assert _entries(c) == _entries(j)
    assert b"x2" in applied[new]


def test_palf_no_quorum():
    c = PalfCluster(3)
    c.elect()
    c.kill(2)
    c.kill(3)
    with pytest.raises(NoQuorum):
        c.append([b"y"])


def test_palf_disk_recovery_and_bytes(tmp_path):
    for pkg, cls in (("port", PalfCluster), ("jax", JPalfCluster)):
        c = cls(3, log_root=str(tmp_path / pkg))
        c.elect()
        c.append([b"p1", b"p2"])
        c.close()
    # the same on-disk log format, byte for byte
    for i in (1, 2, 3):
        assert (tmp_path / "port" / f"replica_{i}.log").read_bytes() == \
            (tmp_path / "jax" / f"replica_{i}.log").read_bytes()
    c2 = PalfCluster(3, log_root=str(tmp_path / "port"))
    assert all(r.last_lsn() >= 2 for r in c2.replicas.values())
    c2.elect()
    c2.append([b"p3"])
    ldr = c2.replicas[c2.leader_id]
    assert [e.payload for e in ldr.entries
            if e.payload.startswith(b"p")] == [b"p1", b"p2", b"p3"]
    c2.close()


def test_palf_torn_tail_and_recycle(tmp_path):
    root = tmp_path / "wal"
    c = PalfCluster(3, log_root=str(root))
    c.elect()
    c.append([b"q1", b"q2", b"q3"])
    c.close()
    log1 = root / "replica_1.log"
    good = log1.read_bytes()
    log1.write_bytes(good + b"\x01\x02\x03")  # a torn append
    c2 = PalfCluster(3, log_root=str(root))
    assert log1.read_bytes() == good  # truncated back before any append
    c2.elect()
    committed = c2.committed_lsn()
    freed = c2.recycle(committed - 1)
    assert freed > 0
    r1 = c2.replicas[1]
    assert r1.base_lsn == committed - 1 and len(r1.entries) == 1
    c2.append([b"q4"])
    c2.close()
    c3 = PalfCluster(3, log_root=str(root))
    assert [e.payload for e in c3.replicas[1].entries][-1] == b"q4"
    c3.close()


def _engines():
    out = []
    for eng, tdef, col, st in ((StorageEngine(None), TableDef, ColumnDef,
                                SqlType),
                               (JEngine(None), JTableDef, JColumnDef,
                                JSqlType)):
        for name in ("t1", "t2"):
            eng.create_table(tdef(name, [col("k", st.int_()),
                                         col("v", st.int_())],
                                  primary_key=["k"]))
        out.append(eng)
    return out


def _keys(tablet, snapshot):
    a, _ = tablet.snapshot_arrays(snapshot=snapshot)
    return sorted(zip(a["k"].tolist(), a["v"].tolist()))


def test_tx_single_and_2pc():
    engs = _engines()
    versions = []
    for eng, svc in zip(engs, (TransService(), JTransService())):
        t1, t2 = eng.tables["t1"].tablet, eng.tables["t2"].tablet
        tx = svc.begin()
        svc.write(tx, "t1", t1, (1,), "insert", {"k": 1, "v": 10})
        v1 = svc.commit(tx)
        tx = svc.begin()
        svc.write(tx, "t1", t1, (2,), "insert", {"k": 2, "v": 20})
        svc.write(tx, "t2", t2, (2,), "insert", {"k": 2, "v": 200})
        v2 = svc.commit(tx)
        assert v2 > v1 > 0
        assert _keys(t1, v2) == [(1, 10), (2, 20)]
        assert _keys(t2, v2) == [(2, 200)]
        # atomic visibility: both participants commit at the SAME version
        assert _keys(t2, v2 - 1) == []
        versions.append((v1, v2))
    assert versions[0] == versions[1]


def test_tx_conflict_and_rollback():
    eng = _engines()[0]
    svc = TransService()
    t1 = eng.tables["t1"].tablet
    txa = svc.begin()
    svc.write(txa, "t1", t1, (1,), "insert", {"k": 1, "v": 1})
    txb = svc.begin()
    with pytest.raises(WriteConflict):
        svc.write(txb, "t1", t1, (1,), "insert", {"k": 1, "v": 2})
    svc.rollback(txa)
    assert txa.state == TxState.ABORT
    svc.write(txb, "t1", t1, (1,), "insert", {"k": 1, "v": 2})
    v = svc.commit(txb)
    assert _keys(t1, v) == [(1, 2)]
    # first-committer-wins: a snapshot older than a newer commit
    txc, txd = svc.begin(), svc.begin()
    svc.write(txd, "t1", t1, (1,), "update", {"k": 1, "v": 3})
    svc.commit(txd)
    with pytest.raises(WriteConflict):
        svc.write(txc, "t1", t1, (1,), "update", {"k": 1, "v": 4})


def test_tx_wal_replay_recovery():
    results, payloads = [], []
    for pkg in ("port", "jax"):
        wal = PalfCluster(3) if pkg == "port" else JPalfCluster(3)
        wal.elect()
        eng = _engines()[0 if pkg == "port" else 1]
        svc = (TransService if pkg == "port" else JTransService)(wal=wal)
        t1 = eng.tables["t1"].tablet
        tx = svc.begin()
        svc.write(tx, "t1", t1, (1,), "insert", {"k": 1, "v": 42})
        svc.write(tx, "t1", t1, (3,), "insert", {"k": 3, "v": np.int64(7)})
        svc.commit(tx)
        tx2 = svc.begin()
        svc.write(tx2, "t1", t1, (2,), "insert", {"k": 2, "v": 43})
        svc.rollback(tx2)  # aborted: must NOT reappear on replay
        ldr = wal.replicas[wal.leader_id]
        entries = ldr.entries[: ldr.committed_lsn]
        payloads.append([json.loads(e.payload) for e in entries])
        eng2 = _engines()[0 if pkg == "port" else 1]
        replay = (TransService if pkg == "port" else JTransService).replay
        max_ts = replay(entries, eng2)
        results.append(_keys(eng2.tables["t1"].tablet, max_ts))
    assert results[0] == results[1] == [(1, 42), (3, 7)]
    assert payloads[0] == payloads[1]


def test_wal_refuses_torch_values():
    eng = _engines()[0]
    svc = TransService()
    tx = svc.begin()
    with pytest.raises(TypeError, match="torch value"):
        svc.write(tx, "t1", eng.tables["t1"].tablet, (1,), "insert",
                  {"k": 1, "v": torch.tensor(5)})
