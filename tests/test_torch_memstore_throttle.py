"""The port's memstore throttle against the JAX package's: the byte
accounting, the ramp past ``writing_throttle_trigger_pct``, the typed
``MemstoreFull`` at the hard limit, the pressure flush and its one-shot
token, the flush listener's re-base, and the SQL-level backpressure of
a write flood while an open transaction pins the flush horizon.  The
cases mirror the throttle tests of ``tests/test_admission.py``; each
runs once per package and holds the two outcome records equal."""

from __future__ import annotations

import time
from importlib import import_module

import pytest
import torch

from torch_pair import T, both, outcome

torch.set_num_threads(2)


def _config(P, **over):
    cfg = import_module(f"{P.name}.server.config").Config()
    for k, v in over.items():
        cfg.set(k, v)
    return cfg


def _scn_exact_limit(P, _root):
    cfg = _config(P, enable_rate_limit=True, memstore_limit_bytes=1000,
                  writing_throttle_trigger_pct=99,
                  writing_throttle_max_sleep_s=0.001)
    thr = P.admission.MemstoreThrottle(cfg)
    row = {"a": 1}
    nb = thr.row_bytes(row)
    fits = 1000 // nb
    for _ in range(fits):
        thr.admit_write("t", row)
    used = thr.used_bytes()
    err = outcome(thr.admit_write, "t", row)
    return [nb, fits, used, err, thr.used_bytes(), thr.full_rejections]


def test_accepts_exactly_to_the_limit(tmp_path):
    nb, fits, used, err, after, rej = both(_scn_exact_limit, tmp_path)
    assert used == fits * nb <= 1000 and after == used
    assert err == ("error", "MemstoreFull") and rej == 1


def _scn_hard_limit(P, _root, row_pad):
    cfg = _config(P, enable_rate_limit=True, memstore_limit_bytes=4096,
                  writing_throttle_trigger_pct=50,
                  writing_throttle_max_sleep_s=0.001)
    flushed = []
    thr = P.admission.MemstoreThrottle(cfg, flush_cb=flushed.append)
    row = {"a": 1, "b": "x" * row_pad}
    admitted = 0
    err = None
    for _ in range(1000):
        try:
            thr.admit_write("t", row)
            admitted += 1
        except P.admission.MemstoreFull as e:
            err = type(e).__name__
            break
    st = thr.stats()
    assert st["memstore_bytes"] <= 4096
    mid = [st["throttle_state"], thr.throttle_sleeps > 0, flushed[:1]]
    thr.on_flush("t", remaining_rows=0)
    thr.admit_write("t", row)
    return [admitted, err, mid, thr.stats()["throttle_state"],
            thr.row_bytes(row)]


@pytest.mark.parametrize("row_pad", [100, 7])
def test_hard_limit_typed_and_recovers(tmp_path, row_pad):
    out = both(_scn_hard_limit, tmp_path, row_pad)
    assert out[1] == "MemstoreFull"
    assert out[2][0] in ("throttle", "full") and out[2][1]
    assert out[2][2] == ["t"] and out[3] in ("ok", "throttle")


def _scn_rebase(P, _root):
    thr = P.admission.MemstoreThrottle(
        _config(P, enable_rate_limit=True, memstore_limit_bytes=1 << 20))
    for _ in range(10):
        thr.admit_write("t", {"a": 1})
    before = thr.used_bytes()
    thr.on_flush("t", remaining_rows=5)
    mid = thr.used_bytes()
    thr.on_flush("t", remaining_rows=50)   # a re-base never grows
    thr.drop_table("t")
    return [before, mid, thr.used_bytes()]


def test_accounting_rebase_keeps_avg(tmp_path):
    before, mid, dropped = both(_scn_rebase, tmp_path)
    assert 0 < mid < before and dropped == 0


def _scn_flush_token(P, _root):
    cfg = _config(P, enable_rate_limit=True, memstore_limit_bytes=2048,
                  writing_throttle_trigger_pct=50,
                  writing_throttle_max_sleep_s=0.001)
    flushed = []
    thr = P.admission.MemstoreThrottle(cfg, flush_cb=flushed.append)
    first = outcome(thr.admit_write, "t", {"a": "x" * 4096})
    inflight = thr._flush_inflight
    small = {"a": "y" * 400}
    n = 0
    with pytest.raises(P.admission.MemstoreFull):
        for _ in range(100):
            thr.admit_write("t", small)
            n += 1
    return [first, inflight, n, flushed]


def test_flush_token_survives_unflushable_kick(tmp_path):
    first, inflight, _n, flushed = both(_scn_flush_token, tmp_path)
    assert first == ("error", "MemstoreFull") and not inflight and flushed


def _scn_disabled_and_states(P, _root):
    cfg = _config(P, enable_rate_limit=False, memstore_limit_bytes=100)
    thr = P.admission.MemstoreThrottle(cfg)
    for _ in range(50):
        thr.admit_write("t", {"a": "z" * 64})
    off = [thr.state(), thr.used_bytes()]
    cfg.set("enable_rate_limit", True)
    return [off, thr.state(), sorted(thr.stats())]


def test_disabled_throttle_accounts_nothing(tmp_path):
    off, on, keys = both(_scn_disabled_and_states, tmp_path)
    assert off == ["off", 0] and on == "ok"


def test_throttle_is_on_by_default_with_reference_defaults():
    from oceanbase_tpu.server.config import Config as JConfig
    from oceanbase_tpu_torch.server.config import Config as TConfig

    for k in ("enable_rate_limit", "memstore_limit_bytes",
              "writing_throttle_trigger_pct",
              "writing_throttle_max_sleep_s"):
        assert TConfig()[k] == JConfig()[k], k
    assert TConfig()["enable_rate_limit"] is True
    with pytest.raises(ValueError):
        TConfig().set("writing_throttle_trigger_pct", 0)


# ---------------------------------------------------------------------------
# SQL level: the tenant's throttle through TransService.write
# ---------------------------------------------------------------------------


def _scn_backpressure_sql(P, root):
    db = P.db(root / "db")
    s = db.session()
    s.execute("create table w (a int primary key, b varchar(300))")
    pin = db.session()
    pin.execute("begin")
    pin.execute("insert into w values (-1, 'pin')")
    db.config.set("memstore_limit_bytes", 40000)
    db.config.set("writing_throttle_trigger_pct", 50)
    db.config.set("writing_throttle_max_sleep_s", 0.001)
    thr = db.tenant("sys").throttle
    payload = "y" * 200
    outcomes = []
    acked = []
    for i in range(300):
        o = outcome(s.execute, f"insert into w values ({i}, '{payload}')")
        outcomes.append(o[0] if o[0] == "ok" else o[1])
        if o[0] == "ok":
            acked.append(i)
    full = outcomes.count("MemstoreFull")
    assert full > 0 and thr.peak_bytes <= 40000
    assert thr.throttle_sleeps > 0
    gv = s.execute("select tenant, throttle_state from gv$tenant_resource"
                   " where tenant = 'sys'").rows()
    pin.execute("commit")
    for _ in range(50):
        o = outcome(s.execute, "insert into w values (100000, 'ok')")
        if o[0] == "ok":
            break
        time.sleep(0.02)
    else:
        raise AssertionError("writes never recovered after the flush")
    got = s.execute("select b from w where a = 100000").rows()
    keys = [r[0] for r in s.execute("select a from w where a >= 0"
                                    " and a < 100000 order by a").rows()]
    assert keys == acked          # every acknowledged row reads back
    db.close()
    db2 = P.db(root / "db")
    n = db2.session().execute("select count(*) from w").rows()
    db2.close()
    return [outcomes, gv, got, n]


def test_backpressure_sql_under_a_pinned_flush(tmp_path):
    outcomes, gv, got, n = both(_scn_backpressure_sql, tmp_path)
    assert set(outcomes) == {"ok", "MemstoreFull"}
    assert gv[0][1] in ("throttle", "full") and got == [("ok",)]
    assert n == [(outcomes.count("ok") + 2,)]


def test_throttle_wired_through_the_tenant(tmp_path):
    db = T.db(tmp_path / "db")
    t = db.tenant("sys")
    assert t.tx.throttle is t.throttle
    assert t.engine.flush_listener == t.throttle.on_flush
    s = db.session()
    s.execute("create table u (k int primary key, v int)")
    s.execute("insert into u values (1, 1), (2, 2)")
    assert t.throttle.used_bytes() > 0
    db.checkpoint()                    # the flush listener re-bases
    assert t.throttle.used_bytes() == 0
    s.execute("drop table u")
    # a pressure flush of a table dropped mid-pressure forgets it
    t._pressure_flush("u")
    assert "u" not in t.throttle._tables
    db.close()
