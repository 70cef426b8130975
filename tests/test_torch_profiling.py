"""The port's roofline calibration (``server/calibrate.py``), device-time
split and PROFILE (``server/profiler.py``) against the JAX package's, on
the CPU.

- the probe suite: the same cases (names, rungs, analytic flops/bytes)
  as the reference's, constants produced, each probe kernel equal to the
  reference's on the same inputs and blind to poisoned dead lanes;
- persistence: units round-trip, a corrupt file is quarantined and
  re-probed, and a ``cost_units.json`` written from the same units is
  byte-equal to the reference's;
- ``time_q_error`` and ``predict_seconds`` equal the reference's;
- the live plane through a ``Database``: the split on the CPU (device_s
  0, host_s the wall time), the knobs, gv$cost_units / gv$backend /
  gv$device_profile, ALTER SYSTEM CALIBRATE, PROFILE joined to
  gv$sql_audit by trace_id, knobs off running plain, errors propagating.

On the card the split is a CUDA event pair and PROFILE's rows carry
kernel time; ``chip_smoke.py`` phase "measure" holds those."""

import json
import os

import numpy as np
import pytest
import torch

from oceanbase_tpu.server import calibrate as jcal
from oceanbase_tpu.server.monitor import PlanChoiceLedger as JChoice
from oceanbase_tpu.server.monitor import TimeCalibration as JTimeCal
from oceanbase_tpu_torch.exec import plan as tplan
from oceanbase_tpu_torch.server import calibrate as tcal
from oceanbase_tpu_torch.server import profiler as tprof
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.server.monitor import PlanChoiceLedger, TimeCalibration
from oceanbase_tpu_torch.storage.integrity import CorruptionError

torch.set_num_threads(2)

_KERNELS = {"stream_copy", "masked_reduce", "segment_groupby",
            "searchsorted", "small_matmul"}


@pytest.fixture()
def db(tmp_path):
    d = Database(str(tmp_path / "db"), device="cpu")
    yield d
    d.close()


# ---------------------------------------------------------------------------
# the probe suite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["boot", "full"])
def test_probe_cases_match_the_reference(preset):
    want = [(n, r, f, b) for n, r, _build, f, b in
            jcal.probe_cases(preset)]
    got = [(n, r, f, b) for n, r, _build, f, b in
           tcal.probe_cases(preset, "cpu")]
    assert got == want


def test_probe_produces_constants():
    u = tcal.run_probe("boot", "cpu")
    assert (u.backend, u.device_kind, u.device_count) == ("cpu", "cpu", 1)
    assert u.peak_flops_s > 0.0 and u.peak_bytes_s > 0.0
    assert 0.0 < u.eff_bytes_s <= u.peak_bytes_s
    assert u.launch_overhead_s > 0.0 and u.calibrated_ts > 0.0
    assert {m["kernel"] for m in u.measurements} == _KERNELS
    for m in u.measurements:
        assert m["device_s"] > 0.0 and m["flops"] >= 0 and m["bytes"] >= 0


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("case_ix", range(5))
def test_probe_kernels_match_the_reference_and_ignore_poison(case_ix):
    from oceanbase_tpu.analysis.poison import INT_POISON

    name, _rows, tbuild, _f, _b = tcal.probe_cases("boot", "cpu")[case_ix]
    _n, _r, jbuild, _f2, _b2 = jcal.probe_cases("boot")[case_ix]
    tfn, targs = tbuild()
    jfn, jargs = jbuild()
    for a, b in zip(targs, jargs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    clean = _np(tfn(*targs))
    want = np.asarray(jfn(*jargs))
    if name == "small_matmul":
        np.testing.assert_allclose(clean, want, rtol=1e-4, atol=1e-3)
    elif name == "searchsorted":
        np.testing.assert_array_equal(clean, want)
    else:
        np.testing.assert_allclose(clean, want, rtol=1e-6)
    mask = targs[-1]
    pois = []
    for a in targs[:-1]:
        if a.is_floating_point():
            m = mask[:, None] if a.ndim == 2 else mask
            pois.append(torch.where(m, a, torch.nan))
        elif name == "searchsorted" and a is targs[0]:
            pois.append(a)  # the sorted key column is not masked input
        else:
            # the reference's poison value, wrapped to the lane's width
            poison = np.array(INT_POISON).astype(_np(a).dtype)
            pois.append(torch.where(mask, a, torch.tensor(poison.item(),
                                                          dtype=a.dtype)))
    out = _np(tfn(*pois, mask))
    assert out.tobytes() == clean.tobytes()


def test_predict_and_time_q_error_match_the_reference():
    tu = tcal.CostUnits(backend="cpu", peak_flops_s=3e10,
                        peak_bytes_s=2e10, eff_bytes_s=5e9,
                        launch_overhead_s=2e-5)
    ju = jcal.CostUnits(backend="cpu", peak_flops_s=3e10,
                        peak_bytes_s=2e10, eff_bytes_s=5e9,
                        launch_overhead_s=2e-5)
    preds = []
    for n in (1_000, 10_000, 100_000, 1_000_000, 10_000_000):
        p = tcal.predict_seconds(tu, 2.0 * n, 8.0 * n)
        assert p == jcal.predict_seconds(ju, 2.0 * n, 8.0 * n)
        preds.append(p)
    assert preds == sorted(preds)
    assert tcal.predict_seconds(tu, 1e6, 1e6, calls=4) >= \
        tcal.predict_seconds(tu, 1e6, 1e6, calls=1)
    rng = np.random.default_rng(3)
    for p, a in rng.exponential(0.01, (50, 2)).tolist() + \
            [(0.0, 1.0), (1.0, 0.0), (2.0, 1.0), (3.0, 3.0)]:
        assert tcal.time_q_error(p, a) == jcal.time_q_error(p, a)


def test_time_ledgers_match_the_reference():
    rng = np.random.default_rng(9)
    tc, jc = TimeCalibration(), JTimeCal()
    tch, jch = PlanChoiceLedger(), JChoice()
    for i in range(40):
        op = ("GroupBy", "HashJoin", "ScalarAgg")[i % 3]
        pred, dev, host = rng.exponential(0.01, 3).tolist()
        tc.observe(op, pred, dev, host_s=host)
        jc.observe(op, pred, dev, host_s=host)
        choices = [{"pred_s": pred, "runner_up_s": 2 * pred,
                    "enumerated": 3, "method": "dp", "n_rels": 2}]
        tch.record(f"h{i % 4}", choices)
        jch.record(f"h{i % 4}", choices)
        tch.observe(f"h{i % 4}", dev)
        jch.observe(f"h{i % 4}", dev)

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "last_ts"}
                for r in rows]

    assert strip(tc.rows()) == strip(jc.rows())
    assert strip(tch.rows()) == strip(jch.rows())


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def test_units_roundtrip_and_corruption(tmp_path, monkeypatch):
    # the boot path reads the file only when the process has no units
    monkeypatch.setattr(tcal, "_PROC_UNITS", None)
    root = str(tmp_path)
    u = tcal.run_probe("boot", "cpu")
    tcal.save_units(root, u)
    loaded = tcal.load_units(root)
    assert loaded == u
    path = os.path.join(root, tcal.UNITS_FILE)
    body = open(path).read().replace('"peak_flops_s"', '"peak_flops_sX"', 1)
    with open(path, "w") as fh:
        fh.write(body)
    with pytest.raises(CorruptionError):
        tcal.load_units(root)
    units = tcal.ensure_units(root, device="cpu")  # quarantine + probe
    assert units.peak_flops_s > 0
    assert os.path.exists(path + ".corrupt")
    assert tcal.load_units(root).backend == "cpu"
    assert tcal.load_units(str(tmp_path / "none")) is None


def test_probe_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Without a device the probes run on ``cuda``: with no card they
    raise instead of probing the CPU, and nothing is cached or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tcal, "_PROC_UNITS", None)
    root = str(tmp_path)
    for call in (lambda: tcal.probe_cases("boot"),
                 lambda: tcal.run_probe("boot"),
                 lambda: tcal.ensure_units(root)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tcal._PROC_UNITS is None
    assert tcal.load_units(root) is None


def test_cost_units_file_is_byte_equal_to_the_reference(tmp_path):
    fields = dict(backend="cpu", device_kind="cpu", device_count=1,
                  peak_flops_s=1.5e11, peak_bytes_s=1.25e10,
                  eff_bytes_s=6.5e8, launch_overhead_s=8.5e-6,
                  calibrated_ts=1792225000.25, preset="full",
                  probe_s=1.5,
                  measurements=[{"kernel": "stream_copy", "rows": 65536,
                                 "flops": 65536.0, "bytes": 589824.0,
                                 "device_s": 2.5e-5, "raw_s": 3e-5,
                                 "gflops": 2.6214, "gbps": 23.5929}])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jcal.save_units(str(tmp_path / "j"), jcal.CostUnits(**fields))
    tcal.save_units(str(tmp_path / "t"), tcal.CostUnits(**fields))
    assert (tmp_path / "t" / "cost_units.json").read_bytes() == \
        (tmp_path / "j" / "cost_units.json").read_bytes()
    # and each package reads the other's file
    assert tcal.load_units(str(tmp_path / "j")) == tcal.CostUnits(**fields)


# ---------------------------------------------------------------------------
# the live plane
# ---------------------------------------------------------------------------


def _load(sess, n=300):
    sess.execute("create table pt (id int primary key, v int)")
    sess.execute("insert into pt values "
                 + ",".join(f"({i},{i % 5})" for i in range(n)))


def test_split_on_the_cpu(db):
    s = db.session()
    _load(s)
    for _ in range(2):
        s.execute("select v, count(*) from pt group by v")
    execs, dev_execs, gflops, dev_s, host_s = s.execute(
        "select executions, device_executions, achieved_gflops,"
        " device_s_total, host_s_total from gv$plan_cache"
        " order by executions desc limit 1").rows()[0]
    assert execs >= 2 and dev_execs >= 2
    # the CPU has no device half: everything is host time
    assert dev_s == 0.0 and gflops == 0.0 and host_s > 0.0
    host, dev, disp = s.execute(
        "select host_s, device_s, dispatch_s from gv$sql_audit"
        " where sql like 'select v%' order by start_ts desc limit 1"
    ).rows()[0]
    assert host > 0.0 and dev == 0.0 and disp == host
    tm = {r[0]: r[1] for r in s.execute(
        "select phase, seconds from gv$time_model").rows()}
    assert tm["dispatch_s"] > 0 and tm["elapsed_s"] >= tm["dispatch_s"]


def test_enable_profiling_off_stops_split(db):
    s = db.session()
    _load(s)
    s.execute("select count(*) from pt")
    s.execute("alter system set enable_profiling = false")
    assert not tplan.time_split_enabled()
    before = {e.plan_hash: e.device_executions
              for e in tplan.plan_cache_stats()}
    s.execute("select count(*) from pt")
    after = {e.plan_hash: e.device_executions
             for e in tplan.plan_cache_stats()}
    assert after == before
    host = s.execute("select host_s from gv$sql_audit where sql like"
                     " 'select count%' order by start_ts desc limit 1"
                     ).rows()[0][0]
    assert host > 0.0
    s.execute("alter system set enable_profiling = true")
    assert tplan.time_split_enabled()


def test_monitor_time_columns_on_the_cpu(db):
    s = db.session()
    _load(s)
    assert db.cost_units is not None  # the boot probe ran
    s.execute("select v, count(*) from pt group by v")
    dev, pred, tq, host = s.execute(
        "select device_s, pred_s, time_q_error, host_s from"
        " gv$sql_plan_monitor order by ts desc limit 1").rows()[0]
    # nothing to predict against without a device half
    assert (dev, pred, tq) == (0.0, 0.0, 0.0) and host > 0.0
    assert s.execute("select count(*) from gv$time_calibration"
                     ).rows() == [(0,)]


def test_explain_analyze_roofline_line(db):
    s = db.session()
    _load(s)
    text = s.execute(
        "explain analyze select v, count(*) from pt group by v").plan_text
    assert "roofline: [pred=" in text and "dev=" in text
    assert "tq=uncalibrated" in text and "worst_phase=dispatch_s" in text


def test_cost_units_rows(db):
    rows = db.session().execute(
        "select kind, name, value, unit from gv$cost_units").rows()
    assert {r[0] for r in rows} == {"constant", "probe"}
    consts = {r[1]: r[2] for r in rows if r[0] == "constant"}
    assert set(consts) == {"peak_flops_s", "peak_bytes_s", "eff_bytes_s",
                           "launch_overhead_s", "rpc_s_per_byte"}
    assert consts["peak_flops_s"] > 0
    assert 0 < consts["eff_bytes_s"] <= consts["peak_bytes_s"]
    assert {r[1] for r in rows if r[0] == "probe"} == _KERNELS


def test_alter_system_calibrate(db):
    s = db.session()
    before = db.cost_units.calibrated_ts
    got = dict(s.execute("alter system calibrate").rows())
    assert got["backend"] == "cpu" and float(got["peak_gflops"]) > 0
    assert db.cost_units.calibrated_ts >= before
    assert db.cost_units.preset == "full"
    assert tcal.load_units(db.root).preset == "full"
    s.execute("alter system set enable_calibration = false")
    with pytest.raises(ValueError):
        s.execute("alter system calibrate")


def test_profile_statement_and_device_profile_rows(db):
    s = db.session()
    _load(s)
    s.execute("select sum(v) from pt")
    assert s.execute("profile select sum(v) from pt").rows() == [(600,)]
    tid = s.execute(
        "select trace_id from gv$sql_audit where sql like 'profile%'"
        " order by start_ts desc limit 1").rows()[0][0]
    assert tid
    dp = s.execute(
        f"select kernel, kind, occurrences, total_s, device from"
        f" gv$device_profile where trace_id = '{tid}'").rows()
    assert dp
    for _k, kind, occ, total, dev in dp:
        # the CPU: every row is aten:: dispatch without device time
        assert (kind, dev) == ("runtime", "cpu")
        assert occ >= 1 and total >= 0.0
    assert any(k.startswith("aten::") for k, *_ in dp)
    # joined to the audit row and to the statement's trace
    joined = s.execute(
        "select a.sql from gv$sql_audit a, gv$device_profile p"
        " where a.trace_id = p.trace_id").rows()
    assert joined and all(q.startswith("profile") for q, in joined)
    assert len(s.execute("show profile").rows()) == len(dp)


def test_show_profile_without_capture(db):
    rows = db.session().execute("show profile").rows()
    assert len(rows) == 1 and "no PROFILE captured" in rows[0][1]


def test_profile_knob_off_runs_plain(db):
    s = db.session()
    _load(s)
    s.execute("alter system set enable_profiling = false")
    assert s.execute("profile select count(*) from pt").rows() == [(300,)]
    assert s.execute("select count(*) from gv$device_profile"
                     ).rows() == [(0,)]
    s.execute("alter system set enable_profiling = true")


def test_profile_propagates_statement_errors(db):
    with pytest.raises(KeyError):
        db.session().execute("profile select * from no_such_table_xyz")


def test_concurrent_profile_runs_unprofiled_with_a_note():
    assert tprof._PROFILE_LOCK.acquire(blocking=False)
    try:
        out, rows, note = tprof.profile_statement(lambda: 7)
    finally:
        tprof._PROFILE_LOCK.release()
    assert (out, rows) == (7, []) and "busy" in note


@pytest.mark.parametrize("preset", [None, "1"])
def test_cuda_capture_keeps_cupti_attached(monkeypatch, preset):
    """A capture with CUDA activity sets torch's ``TEARDOWN_CUPTI`` to 0
    before it starts, unless the caller set it: torch's default detaches
    CUPTI after each capture and the next capture then loses kernels."""
    if preset is None:
        monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    else:
        monkeypatch.setenv("TEARDOWN_CUPTI", preset)
    out, _rows, _note = tprof.profile_statement(lambda: 7, cuda=True)
    assert out == 7
    assert os.environ["TEARDOWN_CUPTI"] == (preset or "0")


def test_profile_with_tracing_off_still_joinable(db):
    s = db.session()
    _load(s, n=100)
    s.execute("alter system set enable_query_trace = false")
    assert s.execute("profile select sum(v) from pt").rowcount == 1
    sp = s.execute("show profile").rows()
    assert sp and sp[0][2] != "note"
    tids = set(s.execute("select trace_id from gv$device_profile").rows())
    assert len(tids) == 1 and ("",) not in tids


def test_gv_backend_row(db):
    platform, kind, count, fb, age, preset = db.session().execute(
        "select platform, device_kind, device_count, cpu_fallback,"
        " calibration_age_s, calibration_preset from gv$backend"
    ).rows()[0]
    assert (platform, kind, count, fb) == ("cpu", "cpu", 1, True)
    assert age >= 0.0 and preset in ("boot", "full")


def _nocal(tmp_path, name):
    root = tmp_path / name
    root.mkdir()
    (root / "config.json").write_text(
        json.dumps({"enable_calibration": False}))
    return Database(str(root), device="cpu")


def test_calibration_disabled_boot(tmp_path):
    d = _nocal(tmp_path, "nocal")
    assert d.cost_units is None
    s = d.session()
    _load(s, n=50)
    assert s.execute("select count(*) from pt").rows() == [(50,)]
    assert not os.path.exists(os.path.join(d.root, "cost_units.json"))
    assert s.execute("select calibration_age_s from gv$backend"
                     ).rows() == [(-1.0,)]
    d.close()


def test_calibration_disabled_predicts_nothing(tmp_path):
    tcal.ensure_units(None, device="cpu")  # the process cache is warm
    d = _nocal(tmp_path, "nocal2")
    s = d.session()
    _load(s, n=100)
    s.execute("select v, count(*) from pt group by v")
    assert s.execute("select pred_s, time_q_error from"
                     " gv$sql_plan_monitor order by ts desc limit 1"
                     ).rows() == [(0.0, 0.0)]
    d.close()


def test_units_persisted_at_boot(db):
    assert os.path.exists(os.path.join(db.root, "cost_units.json"))
    loaded = tcal.load_units(db.root)
    assert loaded is not None and loaded.peak_flops_s > 0


def test_exec_times_accumulator():
    tplan.reset_exec_times()
    tplan.add_exec_times(host_s=0.5, device_s=0.25, flops=10.0,
                         bytes=20.0, calls=2)
    t = tplan.exec_times()
    assert (t.host_s, t.device_s, t.flops, t.bytes, t.calls) == \
        (0.5, 0.25, 10.0, 20.0, 2)
    tplan.reset_exec_times()
    assert tplan.exec_times().calls == 0


def test_profiler_classifies_events():
    class Evt:
        def __init__(self, key, dev, cpu_us, dev_us, count=1):
            self.key, self.count = key, count
            self.device_type = "DeviceType.CUDA" if dev else \
                "DeviceType.CPU"
            self.self_cpu_time_total = cpu_us
            self.self_device_time_total = dev_us

    rows = tprof.parse_events([
        Evt("q6_filter_sum_kernel", True, 0.0, 30.0, 2),
        Evt("Memcpy DtoH (Device -> Pinned)", True, 0.0, 10.0),
        Evt("cudaLaunchKernel", False, 5.0, 0.0, 3),
        Evt("aten::sum", False, 7.0, 0.0),
        Evt("my_python_range", False, 100.0, 0.0),
    ])
    by = {r["kernel"]: r for r in rows}
    assert by["q6_filter_sum_kernel"]["kind"] == "kernel"
    assert by["q6_filter_sum_kernel"]["total_s"] == pytest.approx(30e-6)
    assert by["q6_filter_sum_kernel"]["pct"] == pytest.approx(75.0)
    assert by["Memcpy DtoH (Device -> Pinned)"]["kind"] == "kernel"
    assert by["cudaLaunchKernel"]["kind"] == "runtime"
    assert by["aten::sum"]["kind"] == "runtime"
    assert "my_python_range" not in by  # host frames are dropped
    assert tprof.kernel_seconds(rows) == pytest.approx(40e-6)
    assert tprof.parse_events([]) == []
