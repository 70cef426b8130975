"""``oceanbase_tpu_torch/bench/disk.py`` (the port of
``scripts/disk_bench.py``) on the CPU: the seeded ENOSPC surfaces, the
degrade round, gv$disk against ``du`` and the restart once over each
package's ``Database`` on the same seeded rows, their records equal
field by field but for timings; the overhead half's fields; ``failures``
naming each broken invariant; and, ``slow``, the whole run over both
packages at the reference script's default size."""

from __future__ import annotations

import copy
import os

import pytest
import torch

from oceanbase_tpu_torch.bench import disk
from torch_pair import J, T, both
from torch_script import run_script

torch.set_num_threads(2)


ROWS = 2000
#: segments of ``t`` in the two-package cases: the reference compiles
#: one program per 2^21-lane granule on the CPU, so 40 would take ~30 s
SEGMENTS = 4


def _gauntlet(P, root):
    path = str(root / "db")
    db = P.db(path)
    try:
        s = db.session()
        keys = disk.load(db, ROWS, SEGMENTS)
        disk.workload_block(s, keys)
        surf = disk.surfaces(db, s, keys, str(root), ROWS // SEGMENTS,
                             P.FaultPlane, P.backup.full_backup)
        deg = disk.degrade(db, s)
        acct = disk.accounting(db, s)
        rs, db = disk.restart(db, s, P.db, path)
    finally:
        db.close()
    return {
        "surfaces": [(r["surface"], r["typed_error"], r["recovered"],
                      r["error"], r.get("answer_ok"), r.get("rows"),
                      r.get("runs"), r.get("residue"))
                     for r in surf["surfaces"]],
        "surfaces_pass": surf["pass"],
        "degrade": {k: v for k, v in deg.items() if k != "round_trip_s"},
        "accounting": {k: (v if k == "pass" else v["delta_pct"])
                       for k, v in acct.items()},
        "restart": rs,
    }


def test_gauntlet_equal_across_packages(tmp_path):
    got = both(_gauntlet, tmp_path)
    assert [x[:3] for x in got["surfaces"]] == [
        (s, True, True) for s in disk.SURFACES]
    spill = got["surfaces"][disk.SURFACES.index("spill")]
    assert spill[4] is True and spill[5] > ROWS and spill[7] == []
    assert spill[6] > 1  # sorted runs: the granules of several segments
    assert got["degrade"]["pass"] and got["degrade"]["gv_disk_state"] == \
        "readonly"
    assert got["accounting"]["pass"] and got["restart"]["pass"]


def test_overhead_fields(tmp_path):
    db = T.db(tmp_path / "db")
    try:
        s = db.session()
        keys = disk.load(db, ROWS)
        start = keys[0]
        o = disk.overhead(s, keys, blocks=2)
        n = s.execute("select count(*) from t").rows()[0][0]
    finally:
        db.close()
    assert set(o) == {"off_s", "on_s", "median_off_s", "median_on_s",
                      "min_max_off_s", "min_max_on_s", "overhead_pct",
                      "blocks", "pass"}
    assert o["blocks"] == 2 and isinstance(o["pass"], bool)
    assert o["median_off_s"] > 0 and o["median_on_s"] > 0
    writes = 2 * 2 * disk.BLOCK_STATEMENTS * disk.BLOCK_WRITES
    assert keys[0] == start + writes and n == ROWS + writes


def test_expected_sorted_and_du(tmp_path):
    k, v = disk.expected_sorted([2000], lost=[5, 1002])
    assert len(k) == 1998 and 5 not in k and 1002 not in k
    assert list(v) == sorted(v) and (v == k % disk.V_MOD).all()
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "x").write_bytes(b"1234")
    (tmp_path / "y").write_bytes(b"12")
    assert disk.du([str(tmp_path / "a"), str(tmp_path / "y")]) == 6
    assert os.path.exists(tmp_path / "y")


def _good_record() -> dict:
    surf = [{"surface": s, "typed_error": True, "recovered": True,
             "error": ""} for s in disk.SURFACES]
    surf[disk.SURFACES.index("spill")].update(answer_ok=True, residue=[],
                                              runs=40)
    return {
        "overhead": {"pass": True, "overhead_pct": 0.5},
        "surfaces": {"surfaces": surf},
        "degrade": {"entered_readonly": True, "write_rejected_typed": True,
                    "reads_serve_in_readonly": True, "exited_readonly": True,
                    "writes_resume": True, "gv_disk_state": "readonly",
                    "gv_vs_du_pct": 0.0, "reclaims": 1},
        "accounting": {"log": {"delta_pct": 0.0},
                       "data": {"delta_pct": 1.0}},
        "restart": {"expect": [3, 6], "got": [3, 6], "pass": True},
    }


def _set(rec, path, value):
    *head, last = path
    for k in head:
        rec = rec[k]
    rec[last] = value


SPILL = disk.SURFACES.index("spill")
BROKEN = {
    "overhead_pct": (("overhead", "pass"), False),
    "wal typed_error": (("surfaces", "surfaces", 0, "typed_error"), False),
    "backup recovered": (("surfaces", "surfaces", 5, "recovered"), False),
    "spill answer_ok": (("surfaces", "surfaces", SPILL, "answer_ok"), False),
    "spill residue": (("surfaces", "surfaces", SPILL, "residue"), ["r0"]),
    "spill runs": (("surfaces", "surfaces", SPILL, "runs"), 1),
    "degrade entered_readonly": (("degrade", "entered_readonly"), False),
    "degrade write_rejected_typed": (("degrade", "write_rejected_typed"),
                                     False),
    "degrade exited_readonly": (("degrade", "exited_readonly"), False),
    "degrade gv_disk_state": (("degrade", "gv_disk_state"), "normal"),
    "degrade gv_vs_du_pct": (("degrade", "gv_vs_du_pct"), 5.5),
    "degrade reclaims": (("degrade", "reclaims"), 0),
    "accounting data": (("accounting", "data", "delta_pct"), 7.0),
    "restart": (("restart", "got"), [3, 5]),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_failures_names_each_broken_invariant(name):
    assert disk.failures(_good_record()) == []
    rec = copy.deepcopy(_good_record())
    path, value = BROKEN[name]
    _set(rec, path, value)
    bad = disk.failures(rec)
    assert len(bad) == 1 and bad[0].startswith(name), bad
    if name == "overhead_pct":
        assert disk.failures(rec, overhead_gated=False) == []


def test_script_prints_the_reference_line_on_the_cpu():
    rc, rec, before, after = run_script("torch_disk_bench.py",
                                     {"BENCH_ROWS": "2000"})
    assert before == after
    assert {"metric", "rows", "overhead", "surfaces", "degrade",
            "accounting", "restart", "pass", "sysstat"} <= set(rec)
    assert rec["metric"] == "disk_bench" and rec["rows"] == 2000
    # the 2% contract is the script's gate, as in the reference
    assert rc == (0 if rec["pass"] else 1)
    assert disk.failures(rec, overhead_gated=False) == []


@pytest.mark.slow
def test_whole_run_at_the_reference_default_both_packages(tmp_path):
    recs = {}
    for P in (J, T):
        rec = disk.run(P.db, str(tmp_path / P.name), 4000,
                       fault_plane=P.FaultPlane,
                       full_backup=P.backup.full_backup, metrics=P.metrics)
        assert disk.failures(rec, overhead_gated=False) == [], (P, rec)
        recs[P.name] = {
            "surfaces": [(r["surface"], r["typed_error"], r["recovered"],
                          r.get("answer_ok"), r.get("rows"))
                         for r in rec["surfaces"]["surfaces"]],
            "degrade": {k: v for k, v in rec["degrade"].items()
                        if k != "round_trip_s"},
            "accounting": rec["accounting"]["pass"],
            "restart": rec["restart"],
        }
    assert recs[T.name] == recs[J.name]
