"""The port's change-data capture (``cdc.py``, ``Tenant.cdc()``) held
against the reference's.

The same statements (autocommit INSERT/UPDATE/DELETE, an explicit
transaction that commits, one that rolls back, a REPLACE) run on a
``Database`` of each package; ``cdc().poll()`` then returns equal
events — table, operation, key, values, commit version and transaction
— in commit order (LSNs in increasing order), with nothing of the
rolled-back transaction, and a second pump replays the same stream.
Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_pair import J, T


def _scenario(P, root, seed):
    rng = np.random.default_rng(seed)
    db = P.db(root)
    s = db.session()
    s.execute("create table t (k int primary key, v int, s varchar(8))")
    pump = db.tenant("sys").cdc()
    ks = [int(x) for x in rng.choice(1000, 12, replace=False)]
    s.execute("insert into t values " + ", ".join(
        f"({k}, {int(rng.integers(0, 99))}, 'a{k % 3}')" for k in ks[:8]))
    first = pump.poll(max_events=3)
    s.execute(f"update t set v = v + 1 where k = {ks[0]}")
    s.execute(f"delete from t where k = {ks[1]}")
    s.execute("begin")
    s.execute(f"insert into t values ({ks[8]}, 1, 'rolled')")
    s.execute(f"update t set s = 'gone' where k = {ks[2]}")
    s.execute("rollback")
    s.execute("begin")
    s.execute(f"insert into t values ({ks[9]}, 2, 'kept')")
    s.execute(f"update t set s = 'kept' where k = {ks[3]}")
    s.execute("commit")
    s.execute(f"replace into t values ({ks[4]}, 77, 'rep')")
    rest = pump.poll()
    # a second consumer replays everything from the start
    again = db.tenant("sys").cdc().poll()
    db.close()

    def ev(e):
        return (e.table, e.op, tuple(e.key), dict(e.values),
                e.commit_version, e.tx_id)

    # the commit record's LSN is the log's own: a lease lapse between
    # statements (a slower host) puts a re-election noop in either log,
    # so LSNs are held to their order, not to the reference's values
    lsns = [e.lsn for e in again]
    assert lsns == sorted(lsns)
    return [ev(e) for e in first], [ev(e) for e in rest], \
        [ev(e) for e in again]


@pytest.mark.parametrize("seed", [0, 1])
def test_cdc_events_match_reference(tmp_path, seed):
    jf, jr, ja = _scenario(J, tmp_path / "j", seed)
    tf, tr, ta = _scenario(T, tmp_path / "t", seed)
    assert (tf, tr, ta) == (jf, jr, ja)
    # max_events stops at a commit boundary: the whole first commit
    assert len(tf) == 8
    assert ta == tf + tr
    # commit order, and nothing of the rolled-back transaction
    versions = [e[4] for e in ta]
    assert versions == sorted(versions)
    assert all("rolled" not in str(e[3]) and "gone" not in str(e[3])
               for e in ta)
    assert any("kept" in str(e[3]) for e in ta)
