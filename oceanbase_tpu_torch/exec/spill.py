"""Spill-partitioned join: joins whose inputs exceed the device budget.

Port of ``oceanbase_tpu/exec/spill.py`` (≙ the unified hash-partitioning
spill infrastructure, ob_hp_infras_vec_op.h; recursive partition dump in
ob_hash_join_vec_op.h:413 build_hash_table_for_recursive).  Both sides
hash-partition on the join key on the host (numpy), then each
co-partition pair runs through the device join; a pair whose output
overflows its budget grows the budget and is redone.

The host hash ``_mix64_np`` is bit-identical to ``exec/ops.py::_mix64``
(splitmix64's finalizer) and to the reference's, so a row lands in the
same partition in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.exec import diag, ops
from oceanbase_tpu_torch.exec.ops import _M1, _M2  # one source for constants
from oceanbase_tpu_torch.exec.plan import check_overflow
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.vector.column import Relation, from_numpy, to_numpy


def _mix64_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_M1 & 0xFFFFFFFFFFFFFFFF)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_M2 & 0xFFFFFFFFFFFFFFFF)
        return x ^ (x >> np.uint64(31))


def _key_hash(arrays: dict, keys: list[str]) -> np.ndarray:
    h = np.zeros(len(next(iter(arrays.values()))), dtype=np.uint64)
    for k in keys:
        kv = arrays[k]
        if kv.dtype == object or kv.dtype.kind in "US":
            kv = np.array([hash(x) & 0xFFFFFFFFFFFFFFFF for x in kv],
                          dtype=np.uint64)
        h = _mix64_np(h ^ _mix64_np(kv.astype(np.int64).view(np.uint64)
                                    if kv.dtype.kind in "iu"
                                    else kv.astype(np.uint64)))
    return h


def _partition_of(arrays: dict, keys: list[str], n_parts: int) -> np.ndarray:
    h = _key_hash(arrays, keys)
    return (h % np.uint64(n_parts)).astype(np.int64)


def _count_read(stats) -> None:
    if stats is not None:
        stats.host_reads += 1


def partitioned_join(
    left: dict, right: dict, left_keys: list[str], right_keys: list[str],
    how: str = "inner", n_partitions: int = 8,
    left_types: dict | None = None, right_types: dict | None = None,
    out_capacity_per_part: int | None = None, device=None, stats=None,
):
    """Join two host-resident column sets partition-by-partition on
    ``device`` (default ``"cuda"``).

    left/right: {col -> numpy array} (column names must be disjoint,
    as in the planner's join contract).  Returns (arrays, valids):
    {col -> numpy array} plus {col -> bool array} for columns carrying
    NULLs (left-join unmatched sides).  Keys hash-copartition, so every
    match lands in the same pair; per-pair capacity overflow grows the
    budget 4x and redoes the pair.  ``stats`` (a ``SpillStats``) counts
    the device-to-host reads: the overflow scalar and the result, per
    attempt."""
    dev = default_device(device)
    lp = _partition_of(left, left_keys, n_partitions)
    rp = _partition_of(right, right_keys, n_partitions)
    lkeys_e = [ir.col(k) for k in left_keys]
    rkeys_e = [ir.col(k) for k in right_keys]

    out_parts: list[dict] = []
    for p in range(n_partitions):
        lsel = lp == p
        rsel = rp == p
        la, ra = bool(lsel.any()), bool(rsel.any())
        if not la or (how == "inner" and not ra):
            continue
        lrel = from_numpy({k: v[lsel] for k, v in left.items()},
                          types=left_types, device=dev)
        rrel = (from_numpy({k: v[rsel] for k, v in right.items()},
                           types=right_types, device=dev)
                if ra else _empty_like(right, right_types, dev))
        cap = out_capacity_per_part or max(int(lsel.sum()) * 2, 1024)
        for _attempt in range(4):
            with diag.collect() as entries:
                j = ops.join(lrel, rrel, lkeys_e, rkeys_e, how=how,
                             out_capacity=cap)
            _count_read(stats)
            try:
                check_overflow(entries)
            except diag.CapacityOverflow:
                cap *= 4  # ≙ recursive re-partition: grow and redo
                continue
            break
        else:
            raise diag.CapacityOverflow(
                f"spill partition {p} still overflows at capacity {cap}")
        _count_read(stats)
        out_parts.append(to_numpy(j))

    if not out_parts:
        return {}, {}
    cols = [c for c in out_parts[0] if not c.startswith("__valid__")]
    arrays = {c: np.concatenate([pt[c] for pt in out_parts if c in pt])
              for c in cols}
    valids = {}
    for c in cols:
        vkey = "__valid__" + c
        if any(vkey in pt for pt in out_parts):
            valids[c] = np.concatenate(
                [pt.get(vkey, np.ones(len(pt[c]), dtype=bool))
                 for pt in out_parts])
    return arrays, valids


def partitioned_join_spilled(
    left_chunks, right_chunks, left_keys: list[str],
    right_keys: list[str], store, how: str = "inner",
    n_partitions: int = 16, left_types: dict | None = None,
    right_types: dict | None = None, budget_rows: int = 1 << 22,
    device=None, stats=None, _salt: int = 0, _depth: int = 0,
):
    """Disk-tier join: inputs arrive as (arrays, valids) chunk streams,
    hash-partition to temp-file runs, then join co-partition pairs one
    pair at a time on ``device`` — peak host memory is one pair,
    everything else lives on disk (≙ the recursive partition dump of
    ob_hash_join_vec_op.h:413 over src/storage/tmp_file/).

    A partition pair that still exceeds ``budget_rows`` recursively
    re-partitions with a different hash salt (up to 3 levels).  Yields
    (arrays, valids) output batches."""
    lruns = [store.new_run() for _ in range(n_partitions)]
    rruns = [store.new_run() for _ in range(n_partitions)]

    def scatter(chunks, keys, runs):
        for arrays, valids in chunks:
            n = len(next(iter(arrays.values()))) if arrays else 0
            if n == 0:
                continue
            part = _partition_of_salted(arrays, keys, n_partitions, _salt)
            for p in range(n_partitions):
                sel = part == p
                if not sel.any():
                    continue
                store.append_chunk(
                    runs[p], {k: v[sel] for k, v in arrays.items()},
                    {k: (v[sel] if v is not None else None)
                     for k, v in (valids or {}).items()})

    scatter(left_chunks, left_keys, lruns)
    scatter(right_chunks, right_keys, rruns)

    for p in range(n_partitions):
        lrows = store.run(lruns[p]).n_rows
        rrows = store.run(rruns[p]).n_rows
        if lrows == 0:
            store.close_run(lruns[p])
            store.close_run(rruns[p])
            continue
        if max(lrows, rrows) > budget_rows and _depth < 3:
            # recursive re-partition of this pair with a fresh salt
            yield from partitioned_join_spilled(
                store.read_chunks(lruns[p]), store.read_chunks(rruns[p]),
                left_keys, right_keys, store, how=how,
                n_partitions=n_partitions, left_types=left_types,
                right_types=right_types, budget_rows=budget_rows,
                device=device, stats=stats, _salt=_salt + 1,
                _depth=_depth + 1)
            store.close_run(lruns[p])
            store.close_run(rruns[p])
            continue
        if how == "inner" and rrows == 0:
            store.close_run(lruns[p])
            store.close_run(rruns[p])
            continue
        la, lv = _load_run(store, lruns[p])
        if rrows:
            ra, rv = _load_run(store, rruns[p])
        else:
            # outer/anti with an empty build side: typed empty columns
            ra = {c: (np.zeros(0, dtype=object) if t.is_string
                      else np.zeros(0, dtype=t.np_dtype))
                  for c, t in (right_types or {}).items()}
            rv = {}
        store.close_run(lruns[p])
        store.close_run(rruns[p])
        arrays, valids = partitioned_join(
            la, ra, left_keys, right_keys, how=how,
            n_partitions=1, left_types=left_types,
            right_types=right_types, device=device, stats=stats)
        if arrays:
            yield arrays, valids


def _partition_of_salted(arrays, keys, n_parts, salt):
    if salt == 0:
        return _partition_of(arrays, keys, n_parts)
    h = _key_hash(arrays, keys)
    h = _mix64_np(h ^ np.uint64(
        (0x9E3779B97F4A7C15 * (salt + 1)) & 0xFFFFFFFFFFFFFFFF))
    return (h % np.uint64(n_parts)).astype(np.int64)


def _load_run(store, run_id):
    parts_a, parts_v = [], []
    for arrays, valids in store.read_chunks(run_id):
        parts_a.append(arrays)
        parts_v.append(valids)
    if not parts_a:
        return {}, {}
    cols = list(parts_a[0])
    out_a = {}
    out_v = {}
    for c in cols:
        chunks = [p[c] for p in parts_a]
        if any(x.dtype == object for x in chunks):
            chunks = [x.astype(object) for x in chunks]
        out_a[c] = np.concatenate(chunks)
        if any(v.get(c) is not None for v in parts_v):
            out_v[c] = np.concatenate(
                [v[c] if v.get(c) is not None
                 else np.ones(len(a[c]), dtype=bool)
                 for v, a in zip(parts_v, parts_a)])
    return out_a, out_v


def _empty_like(arrays: dict, types, device):
    one = {}
    valids = {}
    for k, v in arrays.items():
        if v.dtype == object or v.dtype.kind in "US":
            one[k] = np.array([""], dtype=object)
        else:
            one[k] = np.zeros(1, dtype=v.dtype)
        valids[k] = np.array([False])
    rel = from_numpy(one, types=types, valids=valids, device=device)
    return Relation(columns=rel.columns,
                    mask=torch.zeros(1, dtype=torch.bool, device=rel.device))


__all__ = ["partitioned_join", "partitioned_join_spilled"]
