"""What the port's SF1 scripts share (``chip_smoke.py``,
``scripts/torch_sql_profile.py``, ``scripts/torch_index_ab.py``).

- ``tpch_session``: a ``Session`` over the TPC-H tables as the JAX
  package's SF1 parity run configures it (``scripts/sf_parity.py``):
  every table loaded with its primary key, then ANALYZEd;
- ``key_indexes``: that run's secondary indexes, one on every ``*key``
  column;
- ``timed_statement``: the host-clock statement timer, CUDA-synchronized;
- ``card_line``: the card's name and power limit from ``nvidia-smi``.

The timer and ``card_line`` need a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
from oceanbase_tpu_torch.sql import Session


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tpch_session(tables: dict, types: dict, device="cuda"):
    """Load ``tables`` (``gen_tpch`` output) into a new ``Session`` on
    ``device`` and ANALYZE every table -> (session, load s, ANALYZE s).
    Exact statistics before the run, as the SF1 parity run gathers them:
    the load-time sampled NDVs under-budget SF1 joins past the re-plan
    ladder."""
    t0 = time.perf_counter()
    sess = Session(device=device)
    for name, arrays in tables.items():
        sess.catalog.load_numpy(
            name, arrays, primary_key=TPCH_PRIMARY_KEYS[name],
            types={k: v for k, v in types.items() if k in arrays})
    if sess.catalog.device.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in tables:
        sess.execute(f"analyze table {name}")
    return sess, load_s, time.perf_counter() - t0


def key_indexes(tables: dict) -> list[tuple[str, str, str]]:
    """(index, table, column) for every column whose name ends in
    ``key``, named ``idx_<table>_<column>`` as the SF1 parity run names
    them."""
    return [(f"idx_{name}_{c}", name, c) for name, arrays in tables.items()
            for c in arrays if c.endswith("key")]


def timed_statement(sess: Session, sql: str, runs: int):
    """One checked run (peak memory from it), then the median of
    ``runs`` timed runs (0: the checked run's time) -> (result, ms,
    re-plans, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    res = sess.execute(sql)
    torch.cuda.synchronize()
    times = [(time.perf_counter() - t1) * 1e3]
    retries, peak = sess.last_retries, torch.cuda.max_memory_allocated()
    if runs:
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sess.execute(sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
    return res, statistics.median(times), retries, peak
