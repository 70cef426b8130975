"""Distributed operators: partial-agg + repartition + final-agg, dist join.

Port of ``oceanbase_tpu/px/dist_ops.py``: the two-DFO group-by / join
shapes the PX planner emits (partial agg DFO -> HASH exchange -> final
agg DFO; ob_dfo_mgr.h:19 splits at ObLogExchange boundaries).  A
"shard body" here takes the list of P per-shard relations and returns a
list; each exchange is a collective of ``px/exchange.py``.

Aggregate split mirrors the reference's partial/final aggregate rewrite
(ObHashGroupByVecOp in a PX plan computes partials; the final DFO merges),
which the granule and spill tiers use too:
    sum   -> sum of partial sums        count -> sum of partial counts
    min   -> min of partial mins        max   -> max of partial maxs
    avg   -> sum(psum)/sum(pcount) as a post-projection

Every shard body returns its LOCAL overflow counts, one device scalar per
shard; callers sum them (the reference's psum) as they need.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from oceanbase_tpu_torch.exec import diag
from oceanbase_tpu_torch.exec.ops import (
    AggSpec,
    _combined_key,
    _mix64,
    _neq_prev,
    _segment_minmax,
    compact,
    concat,
    hash_groupby,
    join,
    project,
    segment_sum,
)
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import eval_expr
from oceanbase_tpu_torch.px.exchange import (
    Mesh,
    _umod,
    all_gather,
    all_to_all_repartition,
    broadcast_gather,
    datahub_psum,
    exchange_by_dest,
    shard_relation,
    unshard_relation,
)
from oceanbase_tpu_torch.vector.column import Relation, take


def split_aggs(aggs: Sequence[AggSpec]):
    """-> (partial_specs, final_specs, post_projection exprs)."""
    partial_specs: list[AggSpec] = []
    final_specs: list[AggSpec] = []
    post: dict[str, ir.Expr] = {}
    for a in aggs:
        if a.fn in ("sum", "count", "count_star"):
            pname = f"__p_{a.name}"
            if a.fn == "count_star":
                partial_specs.append(AggSpec(pname, "count_star"))
            else:
                partial_specs.append(AggSpec(pname, a.fn, a.arg))
            final_specs.append(AggSpec(a.name, "sum", ir.col(pname)))
            post[a.name] = ir.col(a.name)
        elif a.fn in ("min", "max"):
            pname = f"__p_{a.name}"
            partial_specs.append(AggSpec(pname, a.fn, a.arg))
            final_specs.append(AggSpec(a.name, a.fn, ir.col(pname)))
            post[a.name] = ir.col(a.name)
        elif a.fn == "avg":
            ps, pc = f"__ps_{a.name}", f"__pc_{a.name}"
            partial_specs.append(AggSpec(ps, "sum", a.arg))
            partial_specs.append(AggSpec(pc, "count", a.arg))
            fs, fc = f"__fs_{a.name}", f"__fc_{a.name}"
            final_specs.append(AggSpec(fs, "sum", ir.col(ps)))
            final_specs.append(AggSpec(fc, "sum", ir.col(pc)))
            post[a.name] = ir.Arith("/", ir.col(fs), ir.col(fc))
        else:
            raise NotImplementedError(f"distributed {a.fn}")
    return partial_specs, final_specs, post


def dist_groupby_shard(shards: Sequence[Relation], keys: dict[str, ir.Expr],
                       aggs: Sequence[AggSpec], mesh: Mesh, local_cap: int,
                       out_cap: int):
    """Partial agg -> all_to_all by group-key hash -> final agg.  Each
    shard ends up owning a disjoint set of groups.  -> (shards, per-shard
    overflow: rows an exchange buffer or a group-by dropped; callers
    must fail or re-plan, see exec/diag.py)."""
    partial_specs, final_specs, post = split_aggs(aggs)
    part = [hash_groupby(r, keys, partial_specs, out_capacity=local_cap,
                         return_overflow=True) for r in shards]
    key_cols = [ir.col(k) for k in keys]
    recv, x_ovf = all_to_all_repartition(
        [p[0] for p in part], key_cols, mesh, cap_per_dest=local_cap)
    outs = {k: ir.col(k) for k in keys}
    outs.update(post)
    rels, ovfs = [], []
    for r, (_p, l_ovf), x in zip(recv, part, x_ovf):
        final, f_ovf = hash_groupby(
            r, {k: ir.col(k) for k in keys}, final_specs,
            out_capacity=out_cap, return_overflow=True)
        rels.append(project(final, outs))
        ovfs.append(l_ovf + x + f_ovf)
    return rels, ovfs


def dist_groupby(rel: Relation, keys: dict[str, ir.Expr],
                 aggs: Sequence[AggSpec], mesh: Mesh, local_cap: int = 4096,
                 out_cap: int = 4096) -> Relation:
    """Shard a relation over the mesh, run the distributed group-by,
    return the merged (unsharded) result relation."""
    out, local_ovf = dist_groupby_shard(
        shard_relation(rel, mesh), keys, aggs, mesh, local_cap, out_cap)
    overflow = datahub_psum(local_ovf)
    # enqueue the gather before the overflow read
    res = unshard_relation(out, rel.device)
    n_over = int(overflow)  # obcheck: ok(trace.host-sync)
    if n_over > 0:
        raise diag.CapacityOverflow(
            f"exchange buffer overflow: {n_over} rows dropped; "
            f"increase local_cap")
    return res


_HOT_SENTINEL = int(np.iinfo(np.int64).max)


def _topk_counts(vals: torch.Tensor, cnts: torch.Tensor, k_out: int):
    """Merge duplicate values (sort, segment-sum counts per run) and keep
    the ``k_out`` largest counts -> (values, counts), _HOT_SENTINEL for
    empty picks.  ``lax.top_k``'s order: a stable descending sort cut to
    k keeps the lower index first among equal counts."""
    k_out = min(k_out, int(vals.shape[0]))
    order = torch.sort(vals, stable=True).indices
    sv = take(vals, order)
    sc = take(cnts, order)
    nn = sv.shape[0]
    gid = torch.cumsum(_neq_prev(sv).to(torch.int64), 0) - 1
    tot = segment_sum(sc, gid, nn)
    val = _segment_minmax("max", sv, gid, nn)
    tot = torch.where(val == _HOT_SENTINEL, torch.zeros_like(tot), tot)
    top = torch.sort(tot, descending=True, stable=True)
    top_c, top_i = top.values[:k_out], top.indices[:k_out]
    return torch.where(top_c > 0, take(val, top_i),
                       torch.full_like(top_c, _HOT_SENTINEL)), top_c


def _global_hot_keys(shards: Sequence[Relation], keys: Sequence[ir.Expr],
                     n_hot: int, mesh: Mesh):
    """Top-``n_hot`` globally most frequent join-key values across the
    mesh (≙ the HYBRID_HASH skew sampler feeding
    ObSliceIdxCalc::HYBRID_HASH_*, src/sql/engine/px/ob_slice_calc.h).

    Per shard: sort keys, run-length count, local top-k; all_gather the
    candidates; re-merge and re-top-k.  -> (per shard: the hot values,
    _HOT_SENTINEL-padded; per shard: the combined key and the live mask,
    so callers don't recompute them)."""
    ks, ms, local_v, local_c = [], [], [], []
    for r in shards:
        k, _ = _combined_key([eval_expr(e, r) for e in keys])
        m = r.mask_or_true()
        v, c = _topk_counts(
            torch.where(m, k, torch.full_like(k, _HOT_SENTINEL)),
            torch.ones(r.capacity, dtype=torch.int64, device=k.device),
            n_hot)
        ks.append(k)
        ms.append(m)
        local_v.append(v)
        local_c.append(c)
    gv = all_gather(local_v, mesh)
    gc = all_gather(local_c, mesh)
    hot = [_topk_counts(v, c, n_hot)[0] for v, c in zip(gv, gc)]
    return hot, ks, ms


def dist_join_shard_hybrid(left: Sequence[Relation],
                           right: Sequence[Relation],
                           left_keys: Sequence[ir.Expr],
                           right_keys: Sequence[ir.Expr], mesh: Mesh,
                           cap_per_dest: int, out_capacity: int | None,
                           how: str = "inner",
                           probe_cap_per_dest: int | None = None,
                           n_hot: int = 8):
    """Skew-resistant HASH-HASH join (≙ HYBRID_HASH_{BROADCAST,RANDOM}):

    - hot join-key values (global top-``n_hot`` of BOTH sides) are
      exempt from the hash exchange: hot BUILD rows broadcast to every
      shard, hot PROBE rows stay on their home shard — a dominant key
      never funnels into one destination's static buffer;
    - cold rows hash-repartition exactly as the plain HASH-HASH path.

    Classification is by combined key value, identical on both sides, so
    hot and cold match sets stay disjoint and the union join is exact.
    ``full`` must not use this path (broadcast build rows would emit
    unmatched copies per shard).  -> (shards, per-shard overflow)."""
    assert how != "full", "hybrid path cannot preserve a broadcast build"
    ndev = mesh.size
    hot_l, lks, lms = _global_hot_keys(left, left_keys, n_hot, mesh)
    hot_r, rks, rms = _global_hot_keys(right, right_keys, n_hot, mesh)

    def classify(k, m, hotset):
        return (k[:, None] == hotset[None, :]).any(dim=1) & m

    def hash_dest(k, m, is_hot):
        d = _umod(_mix64(k), ndev)
        return torch.where(m & ~is_hot, d, torch.full_like(d, ndev))

    l_hot, r_hot, l_dest, r_dest = [], [], [], []
    for j in range(ndev):
        hotset = torch.cat([hot_l[j], hot_r[j]])
        lh = classify(lks[j], lms[j], hotset)
        rh = classify(rks[j], rms[j], hotset)
        l_hot.append(lh)
        r_hot.append(rh)
        l_dest.append(hash_dest(lks[j], lms[j], lh))
        r_dest.append(hash_dest(rks[j], rms[j], rh))
    l_cap = (probe_cap_per_dest if probe_cap_per_dest is not None
             else cap_per_dest)
    lrecv, lov = exchange_by_dest(left, l_dest, mesh, l_cap)
    rrecv, rov = exchange_by_dest(right, r_dest, mesh, cap_per_dest)
    # hot probe rows stay home; hot build rows compact + broadcast.  The
    # hot-build budget is a FRACTION of a destination bucket: hot rows
    # span at most 2*n_hot distinct keys, and a small static buffer keeps
    # the appended broadcast from doubling every unskewed join's build
    # capacity (overflow feeds the session retry ladder)
    hot_cap = max(cap_per_dest // 8, 512)
    hot_build_local, hot_ovf = [], []
    for r, rh in zip(right, r_hot):
        hot_build_local.append(compact(r.with_mask(rh), capacity=hot_cap))
        hot_ovf.append(torch.clamp(rh.to(torch.int64).sum() - hot_cap,
                                   min=0))
    hot_build = broadcast_gather(hot_build_local, mesh)
    outs, ovfs = [], []
    for j in range(ndev):
        probe_all = concat([lrecv[j], left[j].with_mask(l_hot[j])])
        build_all = concat([rrecv[j], hot_build[j]])
        outs.append(join(probe_all, build_all, left_keys, right_keys,
                         how=how, out_capacity=out_capacity))
        ovfs.append(lov[j] + rov[j] + hot_ovf[j])
    return outs, ovfs


def dist_join_shard(left: Sequence[Relation], right: Sequence[Relation],
                    left_keys: Sequence[ir.Expr],
                    right_keys: Sequence[ir.Expr], mesh: Mesh,
                    cap_per_dest: int, out_capacity: int | None,
                    how: str = "inner",
                    probe_cap_per_dest: int | None = None):
    """HASH-HASH distributed join: repartition both inputs on the join key
    so matching keys co-locate, then a local sort-join per shard
    (≙ PX HASH dist join, ObSliceIdxCalc::SliceCalcType HASH both sides).
    ``probe_cap_per_dest`` lets a runtime join filter budget the probe
    exchange below the build exchange.  -> (shards, per-shard overflow)."""
    lrecv, lov = all_to_all_repartition(
        left, left_keys, mesh,
        probe_cap_per_dest if probe_cap_per_dest is not None
        else cap_per_dest)
    rrecv, rov = all_to_all_repartition(right, right_keys, mesh,
                                        cap_per_dest)
    outs = [join(lr, rr, left_keys, right_keys, how=how,
                 out_capacity=out_capacity) for lr, rr in zip(lrecv, rrecv)]
    return outs, [a + b for a, b in zip(lov, rov)]


__all__ = ["dist_groupby", "dist_groupby_shard", "dist_join_shard",
           "dist_join_shard_hybrid", "split_aggs"]
