"""Distributed ORDER BY: sampled RANGE repartition + shard-local sort.

Port of ``oceanbase_tpu/px/range_sort.py`` (≙ the RANGE slice strategy
fed by the range-distribution datahub, src/sql/engine/px/ob_slice_calc.h
RANGE and datahub/components/ob_dh_range_dist_wf.h).  The "datahub round
trip" is an all_gather of per-shard samples: every shard derives the SAME
splitters, ships rows by searchsorted(splitters, key), and sorts its
slice locally.  Gathering the shards in mesh order then yields a globally
sorted relation — the coordinator never sorts anything.

Equal first-key values always map to one destination (dest is a pure
function of the key value), so multi-key sorts stay correct: the shard
holding a first-key run lexsorts it by the remaining keys locally.
"""

from __future__ import annotations

from typing import Sequence

import torch

from oceanbase_tpu_torch.exec.ops import sort_rows
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import eval_expr
from oceanbase_tpu_torch.px.exchange import Mesh, all_gather, exchange_by_dest
from oceanbase_tpu_torch.vector.column import Relation, take

SAMPLES_PER_SHARD = 64
_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


def _primary_scalar(rel: Relation, key: ir.Expr, asc: bool):
    """First sort key -> one monotonically ordered scalar per row, with
    MySQL NULL placement (NULL smallest) and DESC folded in by negation.
    String columns order by their dictionary codes (order-preserving)."""
    c = eval_expr(key, rel)
    d = c.data
    if d.dtype == torch.bool:
        d = d.to(torch.int32)
    if d.is_floating_point():
        d = d.to(torch.float64)
        if not asc:
            d = -d
        # the local comparator orders NaN LAST for ASC and DESC alike, so
        # NaN maps to +inf AFTER the DESC negation
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        if c.valid is not None:
            # NULL sorts smallest: first under ASC, last under DESC
            nullv = float("-inf") if asc else float("inf")
            d = torch.where(c.valid, d, torch.full_like(d, nullv))
        return d
    d = d.to(torch.int64)
    if not asc:
        d = -d
    if c.valid is not None:
        d = torch.where(c.valid, d,
                        torch.full_like(d, _I64_MIN if asc else _I64_MAX))
    return d


def _splitters(prims: Sequence[torch.Tensor], lives: Sequence[torch.Tensor],
               mesh: Mesh) -> list:
    """Per-shard strided sample -> all_gather -> identical splitters on
    every shard (the datahub negotiation as one collective)."""
    ndev = mesh.size
    svs, sls = [], []
    for prim, live in zip(prims, lives):
        n = prim.shape[0]
        k = min(SAMPLES_PER_SHARD, n)
        stride = max(n // k, 1)
        idx = torch.arange(k, device=prim.device) * stride
        sv, sl = take(prim, idx), take(live, idx)
        # dead samples sort to the top and are excluded by live-count math
        dead = float("inf") if prim.is_floating_point() else _I64_MAX
        svs.append(torch.where(sl, sv, torch.full_like(sv, dead)))
        sls.append(sl)
    allv = all_gather(svs, mesh)
    alll = all_gather(sls, mesh)

    def one(v, lv):
        v = torch.sort(v).values
        total_live = lv.to(torch.int64).sum()
        # quantile positions among the live (sorted-first) samples
        pos = (torch.arange(1, ndev, device=v.device) * total_live) // ndev
        return take(v, torch.clamp(pos, 0, v.shape[0] - 1))

    return [one(v, lv) for v, lv in zip(allv, alll)]


def dist_sort_shard(shards: Sequence[Relation], keys: Sequence[ir.Expr],
                    ascending: Sequence[bool] | None, mesh: Mesh,
                    cap_per_dest: int):
    """Range-exchange by the first sort key, then a full local lexsort.
    After gathering the shards in mesh order the relation is globally
    sorted (dead rows interleave at each shard's tail; downstream limit
    and materialize are mask-aware).  -> (locally sorted shards,
    per-shard overflow)."""
    ndev = mesh.size
    if ascending is None:
        ascending = [True] * len(keys)
    ms = [r.mask_or_true() for r in shards]
    prims = [_primary_scalar(r, keys[0], ascending[0]) for r in shards]
    spl = _splitters(prims, ms, mesh)
    dests = []
    for prim, m, s in zip(prims, ms, spl):
        d = torch.searchsorted(s, prim, right=True)
        dests.append(torch.where(m, d, torch.full_like(d, ndev)))
    recv, ovf = exchange_by_dest(shards, dests, mesh, cap_per_dest)
    return [sort_rows(r, keys, ascending) for r in recv], ovf


__all__ = ["SAMPLES_PER_SHARD", "dist_sort_shard"]
