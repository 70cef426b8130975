"""The reference's ``tests/test_failover.py`` cases over a single
``Database`` with its three in-process WAL replicas, run once per
package on the same statements and held equal: the WAL leader lost mid
workload (the next write re-elects, the dead replica revives and
catches up, a reopen replays the post-failover log), and an ERRSIM
storm on ``palf.append`` (every acknowledged row, and only those, reads
back).  The storm's coin flips come from Python's ``random``, seeded
the same before each package's run."""

from __future__ import annotations

import random

import torch

from torch_pair import both, outcome

torch.set_num_threads(2)


def _scn_wal_leader_failover(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (1, 1), (2, 2)")
    old = db.wal.leader_id
    db.wal.kill(old)
    # the next write re-elects and succeeds
    s.execute("insert into t values (3, 3)")
    moved = db.wal.leader_id != old
    s.execute("update t set v = 30 where k = 3")
    got = s.execute("select k, v from t order by k").rows()
    # the dead replica revives and catches up
    db.wal.revive(old)
    db.wal.tick()
    lsns = {r.last_lsn() for r in db.wal.replicas.values()}
    db.close()
    db2 = P.db(root / "db")
    reopened = db2.session().execute("select k, v from t order by k").rows()
    db2.close()
    return [moved, got, len(lsns), reopened]


def test_wal_leader_failover_mid_workload(tmp_path):
    moved, got, n_lsns, reopened = both(_scn_wal_leader_failover, tmp_path)
    assert moved and n_lsns == 1
    assert got == reopened == [(1, 1), (2, 2), (3, 30)]


def _scn_errsim_storm(P, root):
    E = P.errsim.ERRSIM
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    out, applied = [], 0
    E.reset()
    random.seed(1)
    E.arm("palf.append", error=IOError("disk gremlin"), count=3, prob=0.5)
    try:
        for i in range(30):
            o = outcome(s.execute, f"insert into t values ({i}, {i})")
            out.append(o[0] if o[0] == "ok" else o)
            applied += o[0] == "ok"
    finally:
        E.reset()
    got = s.execute("select count(*) from t").rows()[0][0]
    total = s.execute("select sum(v) from t").rows()[0][0]
    ks = [r[0] for r in s.execute("select k from t").rows()]
    db.close()
    return [out, applied, got, total == sum(ks)]


def test_errsim_storm_keeps_consistency(tmp_path):
    out, applied, got, intact = both(_scn_errsim_storm, tmp_path)
    assert got == applied and intact
    assert 27 <= applied < 30
    assert out.count(("error", "OSError")) == 30 - applied
