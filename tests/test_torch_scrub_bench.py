"""The data-integrity plane's standing contract (``scripts/scrub_bench.py``)
over both packages' node processes on the CPU.

One module-scoped 3-node cluster per package (``bench/cluster.py::boot``,
the reference's ``oceanbase_tpu.net.node`` beside the port's), each
loaded with 2,000 rows of the slice on node 1; ``bench/scrub.py::run``
drives each: every node checkpointed, the leader's answers against
SQLite, the scrubber off and on at a 2 s cadence over 8 blocks, then a
seeded bit flip in node 3's ``lineitem`` segment repaired by one
``scrub.run``.  The non-timing records are held equal: the flip's seed,
detected, repaired, failed, the repair's bytes and the SQLite match of
the mended replica (the overhead against 2% is timing and is not held
here).  Then the twin ``scripts/torch_scrub_bench.py`` on the CPU at
the same size: the reference's line, its exit code, nothing written
into the repo.
"""

from __future__ import annotations

import json
import sqlite3

import pytest
import torch

from oceanbase_tpu_torch.bench import cluster as bc
from oceanbase_tpu_torch.bench import planes, scrub
from torch_pair import NODE_PACKAGES
from torch_script import run_script

torch.set_num_threads(2)

ROWS = 2000
REPEATS = 8
#: the reference's line (``scrub_bench.py:162-272``)
LINE_KEYS = {"metric", "rows", "load_s", "oracle_match_before", "overhead",
             "repair", "pass", "sysstat"}
REPAIR_KEYS = ("seed", "detected", "repaired", "failed", "repair_bytes",
               "oracle_match", "mended_clean", "pass")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    cs, out = {}, {}
    try:
        for tag, module in NODE_PACKAGES:  # both boot at once
            cs[tag] = bc.boot(str(tmp_path_factory.mktemp(tag)), "cpu",
                              module, wait=False)
        for tag, c in cs.items():
            c.wait_ready()
            load = bc.load_slice(c, ROWS)
            out[tag] = scrub.run(c, ROWS, REPEATS, load["load_s"])
    finally:
        for c in cs.values():
            c.close()
    return out


def test_scrub_round_trip_on_both_packages(records):
    for tag, rec in records.items():
        assert set(rec) == LINE_KEYS and rec["metric"] == "scrub_bench"
        assert scrub.failures(rec, timing=False) == [], (tag, rec)
        assert rec["repair"]["repair_peer"] in (1, 2)
        assert rec["repair"]["repair_bytes"] > 0
        assert rec["sysstat"]["scrub.repairs{source=peer}"] >= 1
    assert {k: records["port"]["repair"][k] for k in REPAIR_KEYS} == \
        {k: records["ref"]["repair"][k] for k in REPAIR_KEYS}
    assert records["port"]["oracle_match_before"] == \
        records["ref"]["oracle_match_before"] is True


def test_overhead_blocks_on_both_packages(records):
    for tag, rec in records.items():
        o = rec["overhead"]
        assert o["queries"] == REPEATS * 2 * len(planes.QUERIES), (tag, o)
        assert o["off_s"] > 0 and o["on_s"] > 0
        assert o["pass"] == (o["overhead_pct"] <= scrub.BOUND * 100)


def test_sqlite_oracle_is_the_slice():
    cols = planes.gen(ROWS)
    want = scrub.sqlite_oracle(ROWS)
    conn = sqlite3.connect(":memory:")
    conn.execute("create table t (q int, p int, d int, s int)")
    conn.executemany("insert into t values (?,?,?,?)", [
        tuple(int(cols[c][i]) for c in ("l_quantity", "l_extendedprice",
                                        "l_discount", "l_shipdate"))
        for i in range(ROWS)])
    (q6,), = conn.execute(
        "select sum(p * d) from t where s >= 8766 and s < 9131"
        " and d >= 5 and d <= 7 and q < 24").fetchall()
    conn.close()
    assert want["q6"] == [(q6,)]
    assert sum(r[-1] for r in want["q1"]) == \
        int((cols["l_shipdate"] <= 10000).sum())


def test_twin_prints_the_reference_line(tmp_path):
    out = tmp_path / "line.json"
    rc, rec, before, after = run_script(
        "torch_scrub_bench.py",
        {"BENCH_ROWS": str(ROWS), "BENCH_REPEATS": str(REPEATS)},
        ("--out", str(out)))
    assert before == after
    assert json.loads(out.read_text()) == rec
    assert set(rec) == LINE_KEYS and rec["rows"] == ROWS
    assert scrub.failures(rec, timing=False) == [], rec
    assert rc == (0 if rec["pass"] and not scrub.failures(rec) else 1)
