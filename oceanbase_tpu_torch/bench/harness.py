"""What the port's SF1 scripts share (``chip_smoke.py``,
``scripts/torch_sql_profile.py``, ``scripts/torch_index_ab.py``).

- ``tpch_session``: a ``Session`` over the TPC-H tables as the JAX
  package's SF1 parity run configures it (``scripts/sf_parity.py``):
  every table loaded with its primary key, then ANALYZEd;
- ``key_indexes``: that run's secondary indexes, one on every ``*key``
  column;
- ``timed_statement``: the host-clock statement timer, CUDA-synchronized;
- ``card_line``: the card's name and power limit from ``nvidia-smi``,
  ``pcie_link``: its host link and that link's nominal rate;
- ``spill_inputs`` and ``spilled_result``: a bound plan's inputs to
  ``exec/spill_exec.py::execute_spilled`` and its host columns back as a
  ``Result``, as the reference session's spill route builds them;
- ``dead_lane_padded`` and ``poison_checked``: a table padded to its
  capacity bucket with dead lanes, and a plan held to the poison-lane
  invariant under the session's capacity-retry ladder.

The timer, ``card_line`` and ``pcie_link`` need a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from oceanbase_tpu_torch.analysis.poison import assert_poison_invariant
from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.exec.granule import numpy_chunk_provider
from oceanbase_tpu_torch.exec.plan import referenced_tables
from oceanbase_tpu_torch.sql import Session
from oceanbase_tpu_torch.sql.optimizer import scale_capacities
from oceanbase_tpu_torch.sql.session import materialize_host
from oceanbase_tpu_torch.vector import Relation, bucket_capacity


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: GT/s per lane by PCIe generation; 8b/10b coding up to gen 2, 128b/130b after
_PCIE_GTS = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}


def pcie_link() -> tuple[str, float, str]:
    """(the link as ``nvidia-smi --query-gpu=pcie.link.gen.current,
    pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max``
    prints it for the first card, that link's nominal rate in GB/s per
    direction, which pair the rate is from: "current", "max" when the
    current one reads "[N/A]", or "not reported" with a NaN rate)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = out.stdout.strip().splitlines()[0]
    fields = [f.strip() for f in line.split(",")]
    for basis, (gen, width) in (("current", fields[0:2]),
                                ("max", fields[2:4])):
        if gen.isdigit() and width.isdigit() and int(gen) in _PCIE_GTS:
            coding = 0.8 if int(gen) <= 2 else 128 / 130
            return line, _PCIE_GTS[int(gen)] * int(width) * coding / 8, basis
    return line, float("nan"), "not reported"


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


def spill_inputs(catalog, plan, host_tables: dict):
    """(providers, device_tables, types_by_table) for ``execute_spilled``:
    each table of ``host_tables`` ({table: {column: array}}) that the
    plan reads streams from those arrays in granules, typed by the
    catalog's definition; every other table it reads is the catalog's
    device relation."""
    providers, device_tables, types_by_table = {}, {}, {}
    for t in referenced_tables(plan):
        if t in host_tables:
            providers[t] = numpy_chunk_provider(host_tables[t])
            types_by_table[t] = {c.name: c.dtype
                                 for c in catalog.table_def(t).columns}
        elif catalog.has_table(t):
            device_tables[t] = catalog.table_data(t)
    return providers, device_tables, types_by_table


#: ``execute_spilled``'s host columns -> a ``Result`` over the
#: statement's outputs, as the session's spill route builds it
spilled_result = materialize_host


def dead_lane_padded(rel: Relation) -> Relation:
    """``rel`` padded to its capacity bucket with the added lanes dead in
    the mask, as ``storage/engine.py::StorageCatalog._bucketed``
    materializes a snapshot (the next rung when the rows fill one
    exactly, so there are lanes to poison)."""
    cap = bucket_capacity(rel.capacity)
    if cap == rel.capacity:
        cap = bucket_capacity(rel.capacity + 1)
    return rel.pad_to(cap)


def poison_checked(run, plan, tables: dict) -> int:
    """``assert_poison_invariant`` for ``run(plan, tables, factor)``
    under the session's capacity-retry ladder (as many re-plans as
    ``max_capacity_retry`` allows by default): a clean run that
    overflows re-plans with 4x the capacities (``factor`` scales a PX
    run's exchange budgets too); an overflow of the poisoned run alone
    is a dead lane influencing the result and fails -> the retries."""
    max_retry = Session.MAX_CAPACITY_RETRIES
    factor = 1
    for attempt in range(max_retry + 1):
        p = plan if factor == 1 else scale_capacities(plan, factor)
        calls = []

        def once(t, p=p, f=factor):
            calls.append(t)
            return run(p, t, f)

        try:
            assert_poison_invariant(once, tables)
            return attempt
        except CapacityOverflow:
            if len(calls) > 1:
                raise  # the poisoned run alone overflowed
        factor *= 4
    raise CapacityOverflow(f"still overflowing after {max_retry} re-plans")
