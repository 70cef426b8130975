#!/usr/bin/env python3
"""The rate at which a restarted node replays its whole WAL.

    python3 scripts/torch_replay_rate.py make DIR [--rows 50000]
    python3 scripts/torch_replay_rate.py replay DIR [--device cuda]

``make`` builds the root of a single node with no peers: TPC-H lineitem
(16 columns, ``gen_tpch``'s first ``--rows`` rows) INSERTed in 2,000-row
statements, a checkpoint after the first half.  ``replay`` copies that
root, flips a bit of its manifest (the seed of ``bench/chaos.py``'s rot
scenario), so the boot quarantines the manifest and the node replays
every WAL entry through its apply path, as a follower does after the rot
scenario's restart; it then times the boot and the replay and prints
one JSON line.  The package comes from ``PYTHONPATH`` (a checkout's
root), so one ``make`` serves several trees.  Runs on the card unless
``--device cpu``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

MANIFEST_FLIP_SEED = 5  # bench/chaos.py
BATCH = 2000


def _node(root: str, device: str):
    from oceanbase_tpu_torch.net.node import NodeServer

    return NodeServer(1, "127.0.0.1", 0, {}, root=root, bootstrap=True,
                      lease_ms=1500, device=device)


def _wait_applied(node, deadline_s: float):
    r = node.palf.replica
    end = time.monotonic() + deadline_s
    while not (node.palf.is_leader
               and r.applied_lsn == r.committed_lsn == r.last_lsn()):
        if time.monotonic() > end:
            raise TimeoutError(f"applied {r.applied_lsn} of "
                               f"{r.committed_lsn} in {deadline_s} s")
        time.sleep(0.01)


def make(root: str, n: int, device: str):
    from oceanbase_tpu_torch.bench.tbl import create_table_sql, values_row
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    tables, types = gen_tpch(sf=max(0.01, n / 5_000_000))
    li = tables["lineitem"]
    if len(li["l_orderkey"]) < n:
        raise SystemExit(f"gen_tpch made {len(li['l_orderkey'])} rows")
    arrays = {c: a[:n] for c, a in li.items()}
    types = {c: types[c] for c in arrays if c in types}
    shutil.rmtree(root, ignore_errors=True)
    node = _node(root, device)
    node.start()
    try:
        _wait_applied(node, 120)
        node.execute(create_table_sql("lineitem", arrays, types,
                                      ["l_orderkey", "l_linenumber"]))
        for s in range(0, n, BATCH):
            if s == (n // 2) // BATCH * BATCH:
                node.tenant.checkpoint()
            node.execute("insert into lineitem values " + ", ".join(
                values_row(arrays, types, i)
                for i in range(s, min(s + BATCH, n))))
        print(json.dumps({"made": root, "rows": n,
                          "last_lsn": node.palf.replica.last_lsn()}))
    finally:
        node.stop()


def replay(root: str, device: str):
    from oceanbase_tpu_torch.net.faults import bitflip_file

    run = root.rstrip("/") + ".run"
    shutil.rmtree(run, ignore_errors=True)
    shutil.copytree(root, run)
    try:
        bitflip_file(f"{run}/data/manifest.json", seed=MANIFEST_FLIP_SEED)
        t0 = time.monotonic()
        node = _node(run, device)
        t1 = time.monotonic()
        node.start()
        try:
            _wait_applied(node, 1200)
            t2 = time.monotonic()
            n = node.palf.replica.applied_lsn
            rows = node.execute("select count(*) from lineitem")
            count = int(rows["arrays"][rows["names"][0]][0])
        finally:
            node.stop()
    finally:
        shutil.rmtree(run, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if device == "cuda" else "cpu"
    print(json.dumps({"entries": n, "rows": count,
                      "node_init_s": round(t1 - t0, 6),
                      "replay_s": round(t2 - t1, 6),
                      "entries_per_s": round(n / (t2 - t1), 1),
                      "card": card}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("make", "replay"))
    ap.add_argument("root")
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_replay_rate: no CUDA device", file=sys.stderr)
            return 2
    if a.what == "make":
        make(a.root, a.rows, a.device)
    else:
        replay(a.root, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
