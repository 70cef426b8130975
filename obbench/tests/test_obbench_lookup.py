"""BENCHMARK.json against the contract, and every name found by file."""

import json
import re

import pytest

from obbench import harness, roofline, traffic

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["obbench"]
    assert SPEC["command"] == ["python3", "obbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_full_check_fits_its_time():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to
    # compile, 1200 s spare: all of it with 24 cells in 43,200 s
    cells = 24
    total = ((2 + 14 * cells) * (SPEC["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_unique_and_well_formed(key):
    names = [e["name"] for e in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_fields():
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        e2e = {e["name"]: e for e in SPEC["end_to_end"]}
        assert m["moves"] in e2e
        # every cell the metric lists reports the metric it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    w = harness.find_cell(SPEC, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = harness.load_config(w["config"])
    assert (harness.HERE / "datasets" / f"{cfg['dataset']}.py").exists()
    traffic.load(w["traffic"])
    e2e = harness.cell_metrics(SPEC, cell, traced=False)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.cell_metrics(SPEC, cell, traced=True)
    assert per_layer
    for m in e2e + per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_config_files_under_paths():
    for c in SPEC["configs"]:
        assert c["file"] == f"obbench/configs/{c['name']}.json"
        with open(harness.CHECKOUT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert set(cfg["limits"]) and all(v >= 0 for v in
                                          cfg["limits"].values())


def test_cell_lookup_is_by_name():
    with pytest.raises(KeyError):
        harness.find_cell(SPEC, "no_such.cell")
    assert [m["name"] for m in harness.cell_metrics(
        SPEC, "tpch_sf1.q1", traced=True)].count("roofline_share.q1") == 1
    assert "roofline_share.q1" not in [m["name"] for m in harness.cell_metrics(
        SPEC, "tpch_sf1.power", traced=True)]
    # Q1 is held to a bound of its own, not to the power test's
    e2e = {c: [m["name"] for m in harness.cell_metrics(SPEC, c, traced=False)]
           for c in ("tpch_sf1.q1", "tpch_sf1.power")}
    assert e2e == {"tpch_sf1.q1": ["q1_qps", "setup_s"],
                   "tpch_sf1.power": ["tpch_qps", "setup_s"]}


def test_roofline_bytes():
    # 1 B for each flag, 4 B for a date, 8 B for a decimal: 38 B a row
    assert roofline.Q1_ROW_B == 38
    assert roofline.q1_bytes(6_001_215) == 228_046_170
    assert roofline.knn_bytes(10_000_000, 128) == 5_120_000_000
