"""PX planner: lower a physical plan to P shard programs over a mesh.

Port of ``oceanbase_tpu/px/planner.py`` (≙ the DFO manager splitting
plans at exchange boundaries, ObDfoMgr src/sql/engine/px/ob_dfo_mgr.h:19,
plus the scheduler running producer/consumer DFO pairs,
ob_dfo_scheduler.cpp).  The reference compiles the whole DFO graph into
ONE ``shard_map`` program; the port lowers it over a list of P per-shard
relations driven in lockstep by one controller (``px/exchange.py``):
a shard-local operator runs on each shard in turn and each exchange is a
collective between the shards.

Lowering rules (per node):
- TableScan            -> the shard's slice of the row-sharded table
- Filter/Project/
  Compact/Union        -> shard-local (no data movement)
- GroupBy              -> partial agg -> all_to_all(hash keys) -> final agg
- ScalarAgg            -> shard-local partials; the final merge runs on the
                          gathered result (tiny), via the partial/final
                          agg split
- HashJoin /
  SemiJoinResidual     -> BROADCAST the build side when small (all_gather,
                          ≙ BC2HOST dist method) else HASH-HASH
                          repartition both sides (all_to_all) with a
                          runtime bloom join filter applied to the probe
                          side before its exchange; scan-to-scan joins
                          get partition-wise co-sharding and skip the
                          exchange entirely
- Sort                 -> RANGE repartition (sampled splitters) + local
                          sort (px/range_sort.py)
- Limit                -> on the gathered result

``split_top`` and ``NotDistributable`` are also the coordinator split the
streaming and spill tiers use.  Capacity overflow inside the shard
programs goes to the diagnostics lane as device scalars, summed on the
device and read once at the result boundary; the session's retry loop
re-plans with bigger budgets (``budget_factor``).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import torch

from oceanbase_tpu_torch.datatypes import TypeKind
from oceanbase_tpu_torch.exec import diag, ops
from oceanbase_tpu_torch.exec import plan as pp
from oceanbase_tpu_torch.exec.window import window as exec_window
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import eval_expr
from oceanbase_tpu_torch.px.bloom import apply_bloom, build_bloom
from oceanbase_tpu_torch.px.dist_ops import (
    dist_groupby_shard,
    dist_join_shard,
    dist_join_shard_hybrid,
    split_aggs,
)
from oceanbase_tpu_torch.px.exchange import (
    Mesh,
    all_to_all_repartition,
    broadcast_gather,
    datahub_psum,
    default_mesh,
    shard_relation,
    shard_relation_by_hash,
    unshard_relation,
)
from oceanbase_tpu_torch.px.range_sort import dist_sort_shard
from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.vector.column import Relation, bucket_capacity

BROADCAST_THRESHOLD_BYTES = 4 << 20  # build sides smaller than this replicate

# key type kinds safe for affinity hashing (strings are excluded:
# dictionary codes are relation-local, not comparable)
_AFFINITY_KINDS = (TypeKind.INT, TypeKind.DATE, TypeKind.DATETIME,
                   TypeKind.DECIMAL, TypeKind.BOOL)


def _row_bytes(rel: Relation) -> int:
    """Estimated bytes per row of a lowered Relation (data + null bitmap);
    the broadcast decision is bytes-based, not rows-based (a 65k-row wide
    build side must not replicate just because its row count is small)."""
    b = 0
    for c in rel.columns.values():
        b += c.data.element_size() + (1 if c.valid is not None else 0)
    return max(b, 1)


def _snap_budget(n: int) -> int:
    """Exchange buffer budgets ride the shared capacity-bucket ladder
    (rounding UP never drops rows; overflow stays counted and retried)."""
    return bucket_capacity(n, floor=1024)


_DIST_OK = (pp.TableScan, pp.Filter, pp.Project, pp.GroupBy,
            pp.HashJoin, pp.SemiJoinResidual, pp.Union, pp.Compact,
            pp.Window, pp.ScalarAgg)


class NotDistributable(Exception):
    pass


def _elide_inner_sorts(node: pp.PlanNode, under_limit: bool = False):
    """Drop Sort nodes that are neither at the root nor directly under a
    Limit: SQL gives no ordering guarantee for subquery/derived-table
    intermediates, so the sort is dead work.  Sort+Limit (top-k) keeps
    its Sort."""
    if isinstance(node, pp.Sort) and not under_limit:
        return _elide_inner_sorts(node.child, False)
    fields = {}
    changed = False
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, pp.PlanNode):
            nv = _elide_inner_sorts(v, isinstance(node, pp.Limit))
            fields[f.name] = nv
            changed = changed or nv is not v
        elif f.name == "inputs" and isinstance(v, list):
            nv = [_elide_inner_sorts(c, False) for c in v]
            fields[f.name] = nv
            changed = changed or any(a is not b for a, b in zip(nv, v))
    if not changed:
        return node
    return dataclasses.replace(node, **fields)


def split_top(plan: pp.PlanNode):
    """Peel coordinator-side ops off the root
    -> (top_chain, scalar_agg|None, dist_root).

    top_chain (outermost-first) re-applies on the gathered result.  A
    root-chain ScalarAgg splits into partials + a final merge; Projects
    above it move to the top chain (they reference the final aggregate
    names).  Raises NotDistributable when the rest holds an operator no
    tier can split (IndexProbe, a Sort under a Limit, ...)."""
    top = []
    node = plan
    scalar_agg = None
    while True:
        if isinstance(node, (pp.Sort, pp.Limit)) and scalar_agg is None:
            top.append(node)
            node = node.child
            continue
        if isinstance(node, pp.Project) and scalar_agg is None:
            top.append(node)
            node = node.child
            continue
        if isinstance(node, pp.ScalarAgg) and scalar_agg is None:
            scalar_agg = node
            node = node.child
            continue
        break
    node = _elide_inner_sorts(node)
    _check_distributable(node)
    return top, scalar_agg, node


def _check_distributable(node: pp.PlanNode):
    if not isinstance(node, _DIST_OK):
        raise NotDistributable(type(node).__name__)
    for c in node.children():
        _check_distributable(c)


_SPLIT_FNS = ("sum", "count", "count_star", "min", "max", "avg")


def _replicated(node: pp.PlanNode) -> bool:
    """Would ``_dlower`` leave every shard holding the COMPLETE relation
    of ``node`` (its ``_px_replicated`` mark)?  Raises the refusal the
    lowering would raise on a replicated input, a window without one
    common PARTITION BY or an aggregate with no partial/final split, so
    such a plan falls back before any table is sharded.  The refusals
    that depend on key types (``_keys_hash_partitionable``) stay in the
    lowering."""
    if isinstance(node, pp.TableScan):
        return False
    if isinstance(node, (pp.Filter, pp.Project, pp.Compact)):
        return _replicated(node.child)
    if isinstance(node, pp.Union):
        if any([_replicated(c) for c in node.inputs]):
            raise NotDistributable("UNION over a replicated input")
        return False
    if isinstance(node, pp.GroupBy):
        if _replicated(node.child):
            raise NotDistributable("GroupBy over a replicated input")
        splittable = all(a.fn in _SPLIT_FNS for a in node.aggs)
        return not splittable and not node.keys
    if isinstance(node, pp.HashJoin):
        left, right = _replicated(node.left), _replicated(node.right)
        if right and node.how == "full":
            raise NotDistributable("full join with a replicated build")
        if left and not right and node.how != "inner":
            raise NotDistributable(
                f"replicated probe side with {node.how} join")
        return left and right
    if isinstance(node, pp.ScalarAgg):
        if not _replicated(node.child):
            _check_split(node.aggs)
        return True
    if isinstance(node, pp.Window):
        if _replicated(node.child):
            raise NotDistributable("window over a replicated input")
        pkeys = None
        for _out, wc in node.specs:
            pk = tuple(map(repr, wc.partition_by or []))
            if not pk or (pkeys is not None and pk != pkeys):
                raise NotDistributable(
                    "window without common PARTITION BY")
            pkeys = pk
        return False
    if isinstance(node, pp.SemiJoinResidual):
        left = _replicated(node.left)
        _replicated(node.right)
        if left:
            raise NotDistributable("semi join over a replicated probe")
        return False
    raise NotDistributable(type(node).__name__)


def _check_split(aggs) -> None:
    """A sharded ScalarAgg runs as partials plus a final merge
    (``split_aggs``), which only the decomposable aggregates have."""
    for a in aggs:
        if a.fn not in _SPLIT_FNS:
            raise NotImplementedError(f"distributed {a.fn}")


def check_lowering(droot: pp.PlanNode, scalar_agg=None) -> None:
    """Every refusal of the lowering that the plan's shape decides,
    before any execution: the ones on replication, the replicated root
    and a root ScalarAgg without a partial/final split."""
    if _replicated(droot):
        raise NotDistributable("replicated distributed root")
    if scalar_agg is not None:
        _check_split(scalar_agg.aggs)


# ---------------------------------------------------------------------------
# partition-wise (affinity) co-sharding: exchange elision
# ---------------------------------------------------------------------------


def _scan_chain(node):
    """Filter*/Compact* chain over a TableScan -> (scan, inv_rename) or
    None.  (Projects would re-derive columns; keep the conservative
    shape.)"""
    while isinstance(node, (pp.Filter, pp.Compact)):
        node = node.child
    if isinstance(node, pp.TableScan):
        inv = {cid: base for base, cid in (node.rename or {}).items()}
        return node, inv
    return None


def _base_key_cols(keys, inv, tables, table):
    """Join-key exprs -> (base column names, dtypes), or None when any
    key is not a plain column / not affinity-hashable."""
    out = []
    dts = []
    rel = tables.get(table)
    if rel is None:
        return None
    for k in keys:
        if not isinstance(k, ir.ColumnRef):
            return None
        base = inv.get(k.name, k.name)
        col = rel.columns.get(base)
        if col is None or col.dtype.kind not in _AFFINITY_KINDS:
            return None
        out.append(base)
        dts.append(col.dtype)
    return out, dts


def _reps_match(ldts, rdts) -> bool:
    """Affinity hashing works on RAW stored values; both sides must use
    the same representation per key pair (mismatched DECIMAL scales or
    kinds would co-shard inconsistently and silently drop matches)."""
    for lt, rt in zip(ldts, rdts):
        if lt.kind != rt.kind:
            return False
        if lt.kind == TypeKind.DECIMAL and lt.scale != rt.scale:
            return False
    return True


def choose_affinity(droot, tables):
    """Co-hash-shard EVERY qualifying scan-to-scan hash join on its join
    key, eliding both repartition exchanges per join (≙ partition-wise
    join matching, src/sql/optimizer/ob_pwj_comparer.h — the 'matching
    partitioning' is CREATED at granule-assignment time).  Joins are
    collected bottom-most-first; each table co-shards for at most one
    join.  -> (affinity: {table: [key cols]}, elide: frozenset of join
    node ids) — empty when no join qualifies."""
    scan_counts: dict[str, int] = {}

    def count(node):
        if isinstance(node, pp.TableScan):
            scan_counts[node.table] = scan_counts.get(node.table, 0) + 1
        for c in node.children():  # children() covers Union.inputs
            count(c)

    count(droot)
    found: list = []

    def visit(node):
        for c in node.children():
            visit(c)
        if not isinstance(node, pp.HashJoin):
            return
        ls = _scan_chain(node.left)
        rs = _scan_chain(node.right)
        if ls is None or rs is None:
            return
        lscan, linv = ls
        rscan, rinv = rs
        if lscan.table == rscan.table:
            return
        if scan_counts.get(lscan.table) != 1 or \
                scan_counts.get(rscan.table) != 1:
            return
        lres = _base_key_cols(node.left_keys, linv, tables, lscan.table)
        rres = _base_key_cols(node.right_keys, rinv, tables, rscan.table)
        if lres is None or rres is None:
            return
        lcols, ldts = lres
        rcols, rdts = rres
        if not _reps_match(ldts, rdts):
            return
        found.append((node, lscan.table, lcols, rscan.table, rcols))

    visit(droot)
    affinity: dict = {}
    elide: set = set()
    for node, lt, lc, rt, rc in found:  # bottom-most first (postorder)
        if lt in affinity or rt in affinity:
            continue  # table already co-sharded for an earlier join
        affinity[lt] = lc
        affinity[rt] = rc
        elide.add(id(node))
    return affinity, frozenset(elide)


# ---------------------------------------------------------------------------
# per-shard lowering
# ---------------------------------------------------------------------------


def _rep(shards) -> bool:
    """Does every shard hold the COMPLETE relation (a datahub result)?"""
    return getattr(shards[0], "_px_replicated", False)


def _mark_rep(shards):
    for r in shards:
        r._px_replicated = True
    return shards


def _copy_rep(out, src):
    """Propagate the replicated-relation mark through shard-local ops."""
    return _mark_rep(out) if _rep(src) else out


def _push(ovfs) -> None:
    diag.push("px_exchange_overflow", datahub_psum(ovfs))


def _per_dest(cap: int, ndev: int, factor: int) -> int:
    return _snap_budget((cap + ndev - 1) // ndev * 2) * factor


def _local_cap(cap, ndev: int):
    return cap if cap is None else max(cap // ndev * 2, 1024)


def _dlower(node: pp.PlanNode, tables: dict, mesh: Mesh, factor: int = 1,
            elide: frozenset = frozenset()) -> list:
    ndev = mesh.size

    def lower(n):
        return _dlower(n, tables, mesh, factor, elide)

    if isinstance(node, pp.TableScan):
        out = []
        for rel in tables[node.table]:
            if node.columns is not None:
                rel = rel.select(node.columns)
            if node.rename:
                rel = Relation(
                    columns={node.rename.get(n, n): c
                             for n, c in rel.columns.items()},
                    mask=rel.mask)
            out.append(rel)
        return out
    if isinstance(node, pp.Filter):
        child = lower(node.child)
        return _copy_rep([ops.filter_rows(r, node.pred) for r in child],
                         child)
    if isinstance(node, pp.Project):
        child = lower(node.child)
        return _copy_rep([ops.project(r, node.outputs) for r in child],
                         child)
    if isinstance(node, pp.Compact):
        child = lower(node.child)
        return _copy_rep([ops.compact(r, node.capacity, strict=node.strict)
                          for r in child], child)
    if isinstance(node, pp.Union):
        kids = [lower(c) for c in node.inputs]
        if any(_rep(k) for k in kids):
            # mixed replicated/sharded concatenation double-counts
            raise NotDistributable("UNION over a replicated input")
        return [ops.concat(list(parts)) for parts in zip(*kids)]
    if isinstance(node, pp.GroupBy):
        child = lower(node.child)
        if _rep(child):
            raise NotDistributable("GroupBy over a replicated input")
        # node.out_capacity was already scaled by scale_capacities on
        # retries; apply the factor only to the built-in default
        local_cap = (node.out_capacity if node.out_capacity is not None
                     else (1 << 16) * factor)
        splittable = all(a.fn in _SPLIT_FNS for a in node.aggs)
        if not splittable:
            # non-decomposable aggregate (count_distinct): repartition
            # RAW rows by group-key hash so every group lands whole on
            # one shard, then the full aggregate runs locally — ≙ the
            # one-phase hash groupby under a HASH exchange
            if node.keys:
                recv, ovf = all_to_all_repartition(
                    child, list(node.keys.values()), mesh,
                    _per_dest(child[0].capacity, ndev, factor))
                _push(ovf)
            else:
                recv = broadcast_gather(child, mesh)
            rel = [ops.hash_groupby(r, node.keys, node.aggs,
                                    out_capacity=local_cap) for r in recv]
            return rel if node.keys else _mark_rep(rel)
        rel, ovf = dist_groupby_shard(child, node.keys, node.aggs, mesh,
                                      local_cap=local_cap,
                                      out_cap=local_cap)
        _push(ovf)
        return rel
    if isinstance(node, pp.HashJoin):
        left = lower(node.left)
        right = lower(node.right)
        if id(node) in elide:
            # partition-wise join: both inputs were co-hash-sharded on
            # the join key at granule assignment — matching keys are
            # already co-located, no exchange at all
            local_cap = _local_cap(node.out_capacity, ndev)
            return [ops.join(lr, rr, node.left_keys, node.right_keys,
                             how=node.how, out_capacity=local_cap)
                    for lr, rr in zip(left, right)]
        return _djoin(left, right, node.left_keys, node.right_keys,
                      node.how, node.out_capacity, mesh, factor)
    if isinstance(node, pp.ScalarAgg):
        # mid-plan scalar aggregate (a scalar-subquery fragment): local
        # partials -> all_gather (the datahub barrier) -> final merge;
        # every shard holds the identical global scalar, so the
        # cross-join above it stays shard-local (≙ the PX datahub's
        # whole-DFO aggregation, ob_dh_barrier.h).  REPLICATED: joins
        # must not broadcast it again.
        child = lower(node.child)
        if _rep(child):
            rel = [ops.scalar_agg(r, node.aggs) for r in child]
        else:
            partial_specs, final_specs, post = split_aggs(node.aggs)
            part = [ops.scalar_agg(r, partial_specs) for r in child]
            rel = [ops.project(ops.scalar_agg(g, final_specs), dict(post))
                   for g in broadcast_gather(part, mesh)]
        return _mark_rep(rel)
    if isinstance(node, pp.Window):
        child = lower(node.child)
        if _rep(child):
            raise NotDistributable("window over a replicated input")
        # distributed window: hash-repartition on the PARTITION BY keys
        # so each partition lands whole on one shard, then the local
        # window operator runs unchanged (≙ PKEY repartition feeding
        # ObWindowFunctionVecOp; single-partition windows can't split)
        pkeys = None
        for _out, wc in node.specs:
            pk = tuple(map(repr, wc.partition_by or []))
            if not pk or (pkeys is not None and pk != pkeys[0]):
                raise NotDistributable(
                    "window without common PARTITION BY")
            pkeys = (pk, wc.partition_by)
        keys = pkeys[1]
        if not _keys_hash_partitionable(child[0], child[0], keys, keys):
            raise NotDistributable("window partition keys not hashable")
        recv, ovf = all_to_all_repartition(
            child, keys, mesh, _per_dest(child[0].capacity, ndev, factor))
        _push(ovf)
        return [exec_window(r, node.specs) for r in recv]
    if isinstance(node, pp.SemiJoinResidual):
        left = lower(node.left)
        right = lower(node.right)
        if _rep(left):
            # membership decisions would emit once per shard
            raise NotDistributable("semi join over a replicated probe")
        big = right[0].capacity * _row_bytes(right[0]) > \
            BROADCAST_THRESHOLD_BYTES
        if node.left_keys and big and _keys_hash_partitionable(
                left[0], right[0], node.left_keys, node.right_keys):
            # with equi-keys, HASH-HASH co-locates every candidate pair;
            # the residual evaluates locally — no need to replicate a
            # large inner side
            per_dest = _per_dest(max(left[0].capacity, right[0].capacity),
                                 ndev, factor)
            lrecv, lov = all_to_all_repartition(
                left, node.left_keys, mesh, per_dest)
            rrecv, rov = all_to_all_repartition(
                right, node.right_keys, mesh, per_dest)
            _push(lov + rov)
            local_cap = _local_cap(node.out_capacity, ndev)
            return [ops.semi_join_residual(
                lr, rr, node.left_keys, node.right_keys, node.residual,
                anti=node.anti, out_capacity=local_cap)
                for lr, rr in zip(lrecv, rrecv)]
        # keyless (pure residual) or small inner: replicate it — the
        # complete candidate set must be visible to every probe row
        bright = broadcast_gather(right, mesh)
        return [ops.semi_join_residual(
            lr, rr, node.left_keys, node.right_keys, node.residual,
            anti=node.anti, out_capacity=node.out_capacity)
            for lr, rr in zip(left, bright)]
    raise NotDistributable(type(node).__name__)


def _keys_hash_partitionable(left, right, lkeys, rkeys) -> bool:
    """HASH-HASH repartition hashes each side's RAW key values, so both
    sides must share a representation: string dictionary codes are
    relation-local and mixed DECIMAL scales/kinds only reconcile inside
    the local join's rescaling — either would scatter matching rows to
    different shards and silently lose matches.  Such joins must
    broadcast instead."""
    for lk, rk in zip(lkeys, rkeys):
        lt = eval_expr(lk, left).dtype
        rt = eval_expr(rk, right).dtype
        if lt.kind == TypeKind.STRING or rt.kind == TypeKind.STRING:
            return False
        if lt.kind != rt.kind:
            return False
        if lt.kind == TypeKind.DECIMAL and lt.scale != rt.scale:
            return False
    return True


def _djoin(left, right, lkeys, rkeys, how, cap, mesh: Mesh, factor=1):
    ndev = mesh.size
    if _rep(right):
        # the build side already holds the COMPLETE relation on every
        # shard (a datahub scalar/fragment): join locally, never
        # re-broadcast (that would emit ndev duplicate matches)
        if how == "full":
            # unmatched-build emission would repeat once per shard
            raise NotDistributable("full join with a replicated build")
        out = [ops.join(lr, rr, lkeys, rkeys, how=how, out_capacity=cap)
               for lr, rr in zip(left, right)]
        return _mark_rep(out) if _rep(left) else out
    if _rep(left):
        # replicated probe over a sharded build: each build row lives on
        # exactly one shard, so a local inner join partitions the output
        # correctly; outer/semi/anti would emit unmatched or membership
        # decisions once PER SHARD
        if how != "inner":
            raise NotDistributable(
                f"replicated probe side with {how} join")
        return [ops.join(lr, rr, lkeys, rkeys, how=how, out_capacity=cap)
                for lr, rr in zip(left, right)]
    per_dest = _per_dest(max(left[0].capacity, right[0].capacity), ndev,
                         factor)
    if how == "full":
        # broadcast would emit each unmatched build row once PER SHARD;
        # only hash-hash co-location keeps unmatched-build emission
        # single (≙ the reference forcing HASH dist for full outer)
        if not lkeys or not _keys_hash_partitionable(left[0], right[0],
                                                     lkeys, rkeys):
            raise NotDistributable("full outer join needs "
                                   "hash-partitionable keys")
        out, ovf = dist_join_shard(
            left, right, lkeys, rkeys, mesh, cap_per_dest=per_dest,
            probe_cap_per_dest=per_dest,
            out_capacity=_local_cap(cap, ndev), how=how)
        _push(ovf)
        return out
    if right[0].capacity * _row_bytes(right[0]) <= \
            BROADCAST_THRESHOLD_BYTES or not lkeys or \
            not _keys_hash_partitionable(left[0], right[0], lkeys, rkeys):
        # small build side, keyless, or hash-unsafe key representation:
        # replicate it (BROADCAST dist)
        bright = broadcast_gather(right, mesh)
        return [ops.join(lr, rr, lkeys, rkeys, how=how, out_capacity=cap)
                for lr, rr in zip(left, bright)]
    # HASH-HASH repartition (≙ ObSliceIdxCalc HASH both sides); the
    # per-destination budget scales with the session's retry factor
    # because exchange caps derive from input capacities, which
    # plan-level scale_capacities cannot reach
    if how in ("inner", "semi"):
        # runtime join filter (≙ ObPxBloomFilter through the datahub):
        # the build side's key bitmap kills probe rows BEFORE the probe
        # exchange, so its buffer can be budgeted at half — the retry
        # loop restores headroom on the (counted) overflow path
        bloom = build_bloom(right, rkeys, mesh)
        left = [apply_bloom(lr, lkeys, b) for lr, b in zip(left, bloom)]
        l_per_dest = max(per_dest // 2, 1024)
    else:
        l_per_dest = per_dest
    # HYBRID_HASH: hot keys bypass the hash exchange (hot build rows
    # broadcast, hot probe rows stay home) so a skewed key can't funnel
    # into one destination's static buffer
    out, ovf = dist_join_shard_hybrid(
        left, right, lkeys, rkeys, mesh, cap_per_dest=per_dest,
        probe_cap_per_dest=l_per_dest, out_capacity=_local_cap(cap, ndev),
        how=how)
    _push(ovf)
    return out


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

# first executions per (plan fingerprint, affinity, P, budget factor) —
# the reference's shard-program cache (an lru of 64 compiled programs)
_SEEN: "OrderedDict[tuple, None]" = OrderedDict()
_SEEN_MAX = 64
_SEEN_LOCK = threading.Lock()


def _first_execution(sig: tuple) -> bool:
    with _SEEN_LOCK:
        if sig in _SEEN:
            _SEEN.move_to_end(sig)
            return False
        _SEEN[sig] = None
        if len(_SEEN) > _SEEN_MAX:
            _SEEN.popitem(last=False)
        return True


def execute_plan_distributed(plan: pp.PlanNode, tables: dict,
                             mesh: Mesh | None = None, dop: int | None = None,
                             budget_factor: int = 1,
                             device=None) -> Relation:
    """Run a physical plan distributed over the mesh -> the final
    relation, on the device of the plan's tables.  Raises
    NotDistributable when the plan shape isn't supported (the caller
    falls back to single-node).  Without a ``mesh``, the first ``dop``
    shards of ``default_mesh`` on ``device`` (``cuda`` by default).
    ``budget_factor`` scales exchange buffer budgets on CapacityOverflow
    retries (plan-level scale_capacities cannot reach them).  A shape
    the lowering refuses is refused here before any table is sharded
    (``check_lowering``), but for the key-type refusals."""
    top, scalar_agg, droot = split_top(plan)
    check_lowering(droot, scalar_agg)
    if mesh is None:
        mesh = default_mesh(dop, device)
    with qtrace.span("px.execute", dop=mesh.size, factor=budget_factor):
        return _execute_distributed(plan, tables, mesh, budget_factor, top,
                                    scalar_agg, droot)


def _execute_distributed(plan, tables, mesh: Mesh, budget_factor, top,
                         scalar_agg, droot) -> Relation:
    qadmission.checkpoint()
    ndev = mesh.size
    # partition-wise co-sharding of scan-to-scan joins' base tables
    affinity, elide = choose_affinity(droot, tables)

    # distributed ORDER BY: the Sort adjacent to the dist root runs as a
    # RANGE repartition + local sort inside the shard programs; gathering
    # shards in mesh order yields global order, so the coordinator-side
    # re-sort disappears
    dist_sort = None
    if top and isinstance(top[-1], pp.Sort) and scalar_agg is None:
        s = top[-1]
        dist_sort = (list(s.keys), list(s.ascending) if s.ascending else None)
        top = top[:-1]

    needed = sorted(pp.referenced_tables(droot))
    out_dev = tables[needed[0]].device if needed else mesh.devices[0]
    aff_key = tuple(sorted((t, tuple(c)) for t, c in affinity.items()))
    if _first_execution((pp.plan_fingerprint(plan), aff_key, ndev,
                         budget_factor)):
        # a new PX signature: the plan-regression watchdog skips this
        # statement's sample, as it skips a first execution of a plan
        pp.mark_compiled()

    with pp.device_span(out_dev), diag.collect() as entries:
        sharded = {}
        for t in needed:
            if t in affinity:
                sharded[t] = shard_relation_by_hash(tables[t], affinity[t],
                                                    mesh)
            else:
                sharded[t] = shard_relation(tables[t], mesh)
        shards = _dlower(droot, sharded, mesh, budget_factor, elide)
        if _rep(shards):
            # a replicated ROOT would gather ndev duplicate copies (or
            # ndev-overcounted partials) — run such (tiny, scalar-only)
            # plans serially instead
            raise NotDistributable("replicated distributed root")
        if scalar_agg is not None:
            partial_specs, final_specs, post = split_aggs(scalar_agg.aggs)
            shards = [ops.scalar_agg(r, partial_specs) for r in shards]
        if dist_sort is not None:
            keys, asc = dist_sort
            # per-(sender,dest) budget: local rows average out at
            # capacity/ndev per destination; skew overflows are counted
            # and the session retry loop scales ``factor``
            cap = _snap_budget(
                max(shards[0].capacity * 2 // ndev, 128)) * budget_factor
            shards, s_ovf = dist_sort_shard(shards, keys, asc, mesh, cap)
            _push(s_ovf)
        total_ovf = torch.zeros((), dtype=torch.int64, device=out_dev)
        for _name, v, _cap in entries:
            total_ovf = total_ovf + v.to(out_dev, torch.int64)
        rel = unshard_relation(shards, out_dev)
        if scalar_agg is not None:
            # final merge of the gathered per-shard partials
            rel = ops.scalar_agg(rel, final_specs)
            rel = ops.project(rel, dict(post))
        # re-apply the coordinator-side top chain, innermost first
        for node in reversed(top):
            if isinstance(node, pp.Sort):
                rel = ops.sort_rows(rel, node.keys, node.ascending)
            elif isinstance(node, pp.Limit):
                rel = ops.limit(rel, node.k, node.offset)
            elif isinstance(node, pp.Project):
                rel = ops.project(rel, node.outputs)
    # audited result-boundary sync: the one host read that decides
    # whether the (fully enqueued) result is valid or must be re-planned
    n_over = int(total_ovf)  # obcheck: ok(trace.host-sync)
    if n_over > 0:
        raise diag.CapacityOverflow(
            f"PX exchange overflow: {n_over} rows dropped")
    qadmission.checkpoint()
    return rel


__all__ = ["BROADCAST_THRESHOLD_BYTES", "NotDistributable",
           "check_lowering", "choose_affinity", "execute_plan_distributed",
           "split_top"]
