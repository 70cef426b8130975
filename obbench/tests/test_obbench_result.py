"""A whole run at a tiny size on the CPU: the last line's keys, the
metrics by name, and the refusals without a card."""

import json
import shutil
import subprocess
import sys

import pytest

from obbench import harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_keys(tiny, cell, traced):
    out = tiny.run_cell(SPEC, tiny.find_cell(SPEC, cell), 2**31 + 5, 0.5,
                        traced, device="cpu")
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = {m["name"]: m["unit"]
            for m in tiny.cell_metrics(SPEC, cell, traced)}
    assert set(out["metrics"]) <= set(want)
    for name, m in out["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # the host-side readings exist on the CPU too; no device number
        # is read from a CPU run
        assert "compile_ms" in " ".join(out["metrics"])
        assert not any(n.startswith(("roofline", "device_"))
                       for n in out["metrics"])
    else:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out, allow_nan=False)


def test_same_seed_same_statements(tiny):
    from obbench import traffic
    from obbench.datasets import vectors

    cfg = tiny.load_config("bigann10m")
    mix = traffic.load("knn")
    a = vectors.make(cfg, 77, "cpu")
    b = vectors.make(cfg, 77, "cpu")
    assert (a["base"] == b["base"]).all()
    sa = traffic.Schedule(vectors, cfg, mix, a, 77).stmts
    sb = traffic.Schedule(vectors, cfg, mix, b, 77).stmts
    assert sa == sb


def test_searches_in_a_seeded_order(tiny):
    from obbench import traffic
    from obbench.datasets import vectors

    cfg = tiny.load_config("bigann10m")
    mix = traffic.load("knn")
    data = vectors.make(cfg, 77, "cpu")
    keys = {s: [k for _l, _q, k in traffic.Schedule(
        vectors, cfg, mix, data, s).stmts] for s in (77, 78)}
    # every query once, in an order that the seed draws
    assert sorted(keys[77]) == list(range(cfg["queries"]))
    assert keys[77] != keys[78]


class _Rec:
    def __init__(self, trace_id, dispatch_s):
        self.trace_id, self.dispatch_s = trace_id, dispatch_s


class _Span:
    def __init__(self, trace_id, name, start_ts, elapsed_s):
        self.trace_id, self.name = trace_id, name
        self.start_ts, self.elapsed_s = start_ts, elapsed_s


class _Ring:
    def __init__(self, items):
        self.items = items

    def recent(self, n):
        return self.items if n is None else self.items[-n:]


class _Db:
    def __init__(self, recs, spans):
        self.audit, self.trace_registry = _Ring(recs), _Ring(spans)


def test_window_records_are_read_once_after_the_window():
    # a warm-up record before the window, two window statements; the
    # second statement's trace was not kept
    recs = [_Rec("w", 9.0), _Rec("a", 0.002), _Rec("", 0.003)]
    spans = [_Span("w", "compile", 1.0, 0.5),
             _Span("a", "statement", 2.0, 0.010),
             _Span("a", "compile", 2.0, 0.001),
             _Span("a", "plan.execute", 2.001, 0.004)]
    out, spans_of = harness._window_records(_Db(recs, spans), ["x", "y"])
    assert out == [{"label": "x", "dispatch_s": 0.002, "compile_s": 0.001},
                   {"label": "y", "dispatch_s": 0.003}]
    assert spans_of == [[("statement", 2.0, 0.010), ("compile", 2.0, 0.001)],
                        []]
    # a ring that lost window statements is an error, not a shifted map
    with pytest.raises(RuntimeError):
        harness._window_records(_Db(recs[2:], spans), ["x", "y"])


def test_main_refuses_without_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "tpch_sf1.q1", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_run_refuses_in_a_bare_checkout(tmp_path):
    # a directory with BENCHMARK.json and obbench/ alone: no program
    root = harness.CHECKOUT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "obbench", tmp_path / "obbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "obbench/run.py", "--workload", "tpch_sf1.q1",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
