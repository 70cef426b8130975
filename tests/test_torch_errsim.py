"""The port's ERRSIM points against the JAX package's: ``v$errsim``, and
each of the three sites — ``tx.commit`` (``TransService.commit``),
``storage.flush`` (``StorageEngine.freeze_and_flush``) and
``palf.append`` (``PalfCluster.append``) — armed with the same error and
budget in both packages, failing the same statement or checkpoint the
same way, after which every acknowledged row reads back, before and
after a reopen.  ``ERRSIM`` is process-global in each package: every
scenario resets it on the way out."""

from __future__ import annotations

import pytest
import torch

from torch_pair import both, outcome

torch.set_num_threads(2)


class Injected(RuntimeError):
    pass


def _run(P, root, point, stmts, count=1, checkpoint_at=None):
    """Arm ``point`` for ``count`` fires, run ``stmts`` (and a
    checkpoint after statement ``checkpoint_at``), then read back."""
    E = P.errsim.ERRSIM
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values (0, 0)")
    E.reset()
    E.arm(point, error=Injected(f"injected at {point}"), count=count)
    out = []
    try:
        for i, sql in enumerate(stmts):
            out.append(outcome(lambda: s.execute(sql).rows()))
            if checkpoint_at == i:
                out.append(("checkpoint", outcome(db.checkpoint)))
        stats = E.stats()
        view = s.execute("select tracepoint, hits, fired, armed"
                         " from v$errsim order by tracepoint").rows()
    finally:
        E.reset()
    acked = s.execute("select k, v from t order by k").rows()
    db.close()
    db2 = P.db(root / "db")
    reopened = db2.session().execute("select k, v from t order by k").rows()
    db2.close()
    fired = {p: f for p, (_h, f) in stats.items()}
    return [out, fired, [(r[0], r[2], bool(r[3])) for r in view
                    if r[0] == point], acked, reopened]


def test_v_errsim_lists_registered_points(tmp_path):
    def scn(P, root):
        E = P.errsim.ERRSIM
        E.reset()
        # the registry of points ever hit is process-wide: start it empty
        # so both packages list what this scenario's statements hit
        E.registered.clear()
        db = P.db(root / "db")
        s = db.session()
        try:
            s.execute("create table t (k int primary key)")
            s.execute("insert into t values (1)")
            names = s.execute("select tracepoint from v$errsim").rows()
            cnt = s.execute("select count(*) from v$errsim"
                            " where armed").rows()
        finally:
            E.reset()
            db.close()
        return [sorted(names), cnt]

    names, cnt = both(scn, tmp_path)
    assert ("tx.commit",) in names and ("palf.append",) in names
    assert cnt == [(0,)]


@pytest.mark.parametrize("count", [1, 2])
def test_tx_commit_fails_the_statement_then_recovers(tmp_path, count):
    stmts = [f"insert into t values ({i}, {i * 10})" for i in range(1, 5)]
    out, fired, view, acked, reopened = both(
        _run, tmp_path, "tx.commit", stmts, count=count)
    assert [o[0] for o in out[:count]] == ["error"] * count
    assert out[0] == ("error", "Injected")
    assert fired == {"tx.commit": count}
    assert acked == reopened and len(acked) == 1 + 4 - count


def test_tx_commit_in_an_explicit_transaction(tmp_path):
    stmts = ["begin", "insert into t values (1, 1)",
             "update t set v = 5 where k = 0", "commit",
             "select count(*) from t", "begin",
             "insert into t values (2, 2)", "commit"]
    out, fired, _view, acked, reopened = both(
        _run, tmp_path, "tx.commit", stmts)
    assert out[3] == ("error", "Injected")
    # the failed COMMIT left its transaction open; the next BEGIN
    # commits it implicitly (both packages), so every row read back was
    # acknowledged by a later statement
    assert acked == reopened == [(0, 5), (1, 1), (2, 2)]


def test_storage_flush_fails_the_checkpoint_typed(tmp_path):
    stmts = ["insert into t values (1, 1)", "insert into t values (2, 2)",
             "insert into t values (3, 3)"]
    out, fired, view, acked, reopened = both(
        _run, tmp_path, "storage.flush", stmts, checkpoint_at=1)
    assert out[2] == ("checkpoint", ("error", "Injected"))
    assert fired == {"storage.flush": 1}
    assert view == [("storage.flush", 1, True)]   # still listed armed
    assert acked == reopened == [(i, i) for i in range(4)]


@pytest.mark.parametrize("count", [1, 3])
def test_palf_append_fails_the_commit(tmp_path, count):
    stmts = [f"insert into t values ({i}, {i})" for i in range(1, 6)]
    out, fired, view, acked, reopened = both(
        _run, tmp_path, "palf.append", stmts, count=count)
    assert out[0] == ("error", "Injected")
    assert fired == {"palf.append": count}
    assert acked == reopened and len(acked) == 1 + 5 - count


def test_errsim_unarmed_point_registers_without_firing(tmp_path):
    def scn(P, root):
        E = P.errsim.ERRSIM
        E.reset()
        E.registered.clear()
        try:
            E.arm("storage.flush", error=Injected("x"), count=0)
            E.hit("palf.append")
            return [E.stats(), sorted(E.registered & {"palf.append",
                                                      "storage.flush"})]
        finally:
            E.reset()

    both(scn, tmp_path)


@pytest.mark.parametrize("sql", ["select count(*) from v$errsim",
                                 "profile select * from v$errsim",
                                 "select tracepoint, armed from v$errsim"
                                 " where hits > 0 order by tracepoint"])
def test_v_errsim_statements_with_a_database(tmp_path, sql):
    """Statements a Database refused before the plane was ported, now
    answered as the reference answers them."""
    def scn(P, root):
        E = P.errsim.ERRSIM
        E.reset()
        E.registered.clear()      # process-wide: start it empty
        db = P.db(root / "db")
        s = db.session()
        try:
            s.execute("create table t (k int primary key)")
            s.execute("insert into t values (1)")
            r = s.execute(sql)
            # an aggregate's output name embeds each binder's column id
            out = ([n for n in r.names if not n.startswith("expr")],
                   r.rows() if sql.startswith("select") else
                   r.rowcount > 0)
        finally:
            E.reset()
            db.close()
        return out

    both(scn, tmp_path)
