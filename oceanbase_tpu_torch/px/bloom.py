"""Runtime join (bloom) filter for PX HASH-HASH joins.

Port of ``oceanbase_tpu/px/bloom.py`` (≙ ObPxBloomFilter created by the
build DFO, shipped through the datahub and applied inside the probe
side's table scan, src/sql/engine/px/ob_px_bloom_filter.h and the
join-filter operators of src/sql/engine/px/p2p_datahub/).  The filter
is a dense bitmap; the datahub union is one psum of the shards' 0/1
counts (an add of 0/1 ≙ OR), and the probe side's non-matching rows are
marked dead BEFORE the probe exchange, so its buffer can be budgeted for
the filtered cardinality instead of the full scan.
"""

from __future__ import annotations

from typing import Sequence

import torch

from oceanbase_tpu_torch.exec.ops import _as_int64, _combined_key, _mix64
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import eval_expr
from oceanbase_tpu_torch.px.exchange import Mesh, datahub_psum, replicate
from oceanbase_tpu_torch.vector.column import Relation

BLOOM_BITS = 1 << 17  # 128k-entry bitmap, 2 probes; ~1% fp at ~8k keys
_GOLDEN = _as_int64(0x9E3779B97F4A7C15)


def _hashes(rel: Relation, keys: Sequence[ir.Expr]):
    cols = [eval_expr(e, rel) for e in keys]
    k, _ = _combined_key(cols)
    h1 = _mix64(k)
    h2 = _mix64(h1 ^ _GOLDEN)
    valid = torch.ones(rel.capacity, dtype=torch.bool, device=k.device)
    for c in cols:
        if c.valid is not None:
            valid = valid & c.valid  # NULL keys never match an equi-join
    # BLOOM_BITS is a power of two: the uint64 modulo is a mask
    return h1 & (BLOOM_BITS - 1), h2 & (BLOOM_BITS - 1), valid


def build_bloom(build: Sequence[Relation], keys: Sequence[ir.Expr],
                mesh: Mesh) -> list:
    """Per-shard local bitmap from the build side's live keys, unioned
    across shards (psum of 0/1 ≙ the datahub bitmap merge) -> the bool
    bitmap, one per shard."""
    local = []
    for r in build:
        i1, i2, valid = _hashes(r, keys)
        live = r.mask_or_true() & valid
        zero = torch.zeros_like(i1)
        w = live.to(torch.int32)
        bm = torch.zeros(BLOOM_BITS, dtype=torch.int32, device=i1.device)
        bm.index_add_(0, torch.where(live, i1, zero), w)
        bm.index_add_(0, torch.where(live, i2, zero), w)
        local.append(bm)
    return replicate(datahub_psum(local) > 0, mesh)


def apply_bloom(probe: Relation, keys: Sequence[ir.Expr],
                bloom: torch.Tensor) -> Relation:
    """Mark probe rows whose key cannot be in the build side dead.
    Rows with NULL keys are kept for outer joins (they produce
    NULL-extended output, not matches — the join handles them)."""
    i1, i2, valid = _hashes(probe, keys)
    hit = bloom.index_select(0, i1) & bloom.index_select(0, i2)
    keep = torch.where(valid, hit, torch.ones_like(hit))
    return probe.with_mask(probe.mask_or_true() & keep)


__all__ = ["BLOOM_BITS", "apply_bloom", "build_bloom"]
