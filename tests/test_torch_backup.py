"""The port's backup service against the JAX package's: full and
incremental backups (manifest kind, skipped count and file set), WAL
archiving and its suffix-only progress, restore of the chain, the
point-in-time cut (of a plain WAL and of one the log reclaim recycled:
the base record stays, the tail is renumbered), the WAL crc gates of
backup and cut, and ``Database.backup``.  The cases mirror
``tests/test_backup_pitr.py`` and ``tests/test_disk.py:337-382`` /
``tests/test_scrub.py:427-455``; each runs once per package and holds
the outcome records equal."""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch

from torch_pair import J, T, both, outcome

torch.set_num_threads(2)


def _manifest(path):
    with open(os.path.join(path, "BACKUP_MANIFEST.json")) as fh:
        m = json.load(fh)
    return m


def _files(root):
    """Relative paths under ``root`` (the restored tree's shape)."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _s, fs in os.walk(root) for f in fs
                  if not f.startswith("cost_units"))


def _scn_incremental(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i * 2})" for i in range(3000)))
    full = P.backup.full_backup(db, str(root / "b0"))
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i * 2})" for i in range(3000, 5000)))
    s.execute("create table u (k int primary key, s varchar(8))")
    s.execute("insert into u values (1, 'x'), (2, 'y')")
    inc = P.backup.incremental_backup(db, str(root / "b1"), full)
    db.close()
    mf, mi = _manifest(full), _manifest(inc)
    target = str(root / "restored")
    P.backup.restore_chain(inc, target)
    db2 = P.db(target)
    s2 = db2.session()
    got = [s2.execute("select count(*), sum(v) from t").rows(),
           s2.execute("select k, s from u order by k").rows()]
    db2.close()
    return [mf["kind"], mi["kind"], mi["skipped"] > 0, mi["skipped"],
            _files(full), _files(inc), got]


def test_incremental_backup_restore(tmp_path):
    out = both(_scn_incremental, tmp_path)
    assert out[:3] == ["full", "incremental", True]
    assert out[-1] == [[(5000, sum(i * 2 for i in range(5000)))],
                       [(1, "x"), (2, "y")]]


def _scn_pitr(P, root, recycle):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (1, 10), (2, 20)")
    if recycle:
        # the log reclaim: checkpoint, then recycle the WAL below the
        # replay point — the cut must keep the base record
        db.tenant("sys").reclaim_log_disk()
        s.execute("insert into t values (7, 70)")
    full = P.backup.full_backup(db, str(root / "base"))
    s.execute("insert into t values (3, 30)")
    cut_version = db.tx.gts.current()
    s.execute("insert into t values (4, 40)")
    s.execute("update t set v = 999 where k = 1")
    archive = P.backup.archive_wal(db, str(root / "arch"))
    db.close()
    target = str(root / "pitr")
    P.backup.restore_chain(full, target)
    P.backup.overlay_archive(archive, target)
    P.backup.pitr_cut(target, cut_version)
    wals = sorted(glob.glob(os.path.join(target, "tenants", "sys", "wal",
                                         "replica_*.log")))
    cut_bytes = [open(w, "rb").read() for w in wals]
    db2 = P.db(target)
    s2 = db2.session()
    rows = s2.execute("select k, v from t order by k").rows()
    s2.execute("insert into t values (5, 50)")
    n = s2.execute("select count(*) from t").rows()
    db2.close()
    return [rows, n, [len(b) for b in cut_bytes], cut_bytes]


@pytest.mark.parametrize("recycle", [False, True])
def test_wal_archive_and_pitr(tmp_path, recycle):
    rows, n, _sizes, _bytes = both(_scn_pitr, tmp_path, recycle)
    want = [(1, 10), (2, 20), (3, 30)] + ([(7, 70)] if recycle else [])
    assert rows == want and n == [(len(want) + 1,)]


def test_pitr_cut_of_a_recycled_wal_keeps_its_base(tmp_path):
    """The recycle base record survives the cut and the tail after it
    is renumbered from the base: the port's cut of its own WAL and the
    reference's cut of the same copy give the same bytes."""
    db = T.db(tmp_path / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    for i in range(6):
        s.execute(f"insert into t values ({i}, {i})")
    db.tenant("sys").reclaim_log_disk()
    s.execute("insert into t values (10, 10)")
    full = T.backup.full_backup(db, str(tmp_path / "b"))
    s.execute("insert into t values (11, 11)")
    cut_version = db.tx.gts.current()
    s.execute("insert into t values (12, 12)")
    archive = T.backup.archive_wal(db, str(tmp_path / "arch"))
    db.close()
    outs = []
    for P in (J, T):
        target = str(tmp_path / f"cut_{P.name}")
        P.backup.restore_chain(full, target)
        P.backup.overlay_archive(archive, target)
        P.backup.pitr_cut(target, cut_version)
        wals = sorted(glob.glob(os.path.join(target, "tenants", "sys",
                                             "wal", "replica_*.log")))
        outs.append([open(w, "rb").read() for w in wals])
        r = T.PalfReplica(1, os.path.dirname(wals[0]))
        assert r.base_lsn > 0           # the recycle base record stayed
        assert [e.lsn for e in r.entries] == \
            list(range(r.base_lsn + 1, r.base_lsn + 1 + len(r.entries)))
        r.close()
    assert outs[0] == outs[1]
    db2 = T.db(tmp_path / f"cut_{T.name}")
    assert db2.session().execute("select max(k) from t").rows() == [(11,)]
    db2.close()


def _scn_cut_below_base(P, root):
    """A cut to a version older than the base backup's checkpoint: the
    base's segments already hold the later rows, and the cut keeps them
    without a word (ROADMAP Queue 3 #19)."""
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (1, 1)")
    cut_version = db.tx.gts.current()
    s.execute("insert into t values (2, 2)")
    full = P.backup.full_backup(db, str(root / "b"))
    db.close()
    target = str(root / "cut")
    P.backup.restore_chain(full, target)
    cut = outcome(P.backup.pitr_cut, target, cut_version)
    db2 = P.db(target)
    rows = db2.session().execute("select k from t order by k").rows()
    db2.close()
    return [cut[0], rows]


def test_pitr_cut_below_the_base_checkpoint_keeps_later_rows(tmp_path):
    # the reference's answer, which the port keeps: row 2 committed
    # after the cut point survives the cut
    assert both(_scn_cut_below_base, tmp_path) == ["ok", [(1,), (2,)]]


def _scn_archive_incremental(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key)")
    s.execute("insert into t values (1)")
    arch = str(root / "arch")
    P.backup.archive_wal(db, arch)
    with open(os.path.join(arch, "ARCHIVE_STATE.json")) as fh:
        st1 = json.load(fh)
    s.execute("insert into t values (2)")
    P.backup.archive_wal(db, arch)
    with open(os.path.join(arch, "ARCHIVE_STATE.json")) as fh:
        st2 = json.load(fh)
    db.close()
    return [sorted(st1), any(st2[k] > st1.get(k, 0) for k in st2),
            [st2[k] - st1.get(k, 0) for k in sorted(st2)]]


def test_archive_is_incremental(tmp_path):
    assert both(_scn_archive_incremental, tmp_path)[1] is True


def _flip_first_wal_payload(P, root):
    path = sorted(glob.glob(os.path.join(
        root, "tenants", "sys", "wal", "replica_*.log")))[0]
    with open(path, "r+b") as f:
        buf = f.read()
        off = len(P.palf_log._MAGIC) + P.palf_log._HDR.size
        f.seek(off)
        f.write(bytes([buf[off] ^ 0x02]))


def _seed(P, root):
    db = P.db(root)
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " +
              ", ".join(f"({i}, {i * 3})" for i in range(200)))
    db.checkpoint()
    return db


def _scn_backup_corrupt_wal(P, root):
    db = _seed(P, root / "db")
    _flip_first_wal_payload(P, str(root / "db"))
    dest = str(root / "bk")
    err = outcome(P.backup.full_backup, db, dest)
    db.close()
    return [err, os.path.exists(dest)]


def test_backup_fails_loudly_on_corrupt_wal(tmp_path):
    assert both(_scn_backup_corrupt_wal, tmp_path) == \
        [("error", "CorruptionError"), False]


def _scn_pitr_crc(P, root):
    db = _seed(P, root / "db")
    dest = str(root / "bk")
    P.backup.full_backup(db, dest)
    db.close()
    _flip_first_wal_payload(P, dest)
    return outcome(P.backup.pitr_cut, dest, until_version=2**62)


def test_pitr_cut_verifies_entry_crc(tmp_path):
    assert both(_scn_pitr_crc, tmp_path) == ("error", "CorruptionError")


def _scn_db_backup(P, root):
    db = _seed(P, root / "db")
    db.session().execute("insert into t values (9001, 1)")
    dest = str(root / "copy")
    db.backup(dest)
    err = outcome(db.backup, dest)          # the destination exists
    db.close()
    db2 = P.db(dest)
    got = db2.session().execute("select count(*), sum(v) from t").rows()
    db2.close()
    return [err, got]


def test_database_backup_is_a_bootable_copy(tmp_path):
    err, got = both(_scn_db_backup, tmp_path)
    assert err == ("error", "FileExistsError")
    assert got == [(201, sum(i * 3 for i in range(200)) + 1)]
