"""Spill-orchestrated SQL execution: whole plans over inputs that exceed
the device/work-area budget.

Port of ``oceanbase_tpu/exec/spill_exec.py`` (≙ the SQL memory manager
deciding per-operator spill, src/sql/engine/ob_tenant_sql_memory_manager.h,
driving the spillable operators — external merge sort, recursive
hash-partition join and the dump-capable group-by — over the temp-file
system, src/storage/tmp_file).

The big table streams granule-by-granule through the device scan
program (scan/filter/project and partial aggregation stay on the card);
host-side chunk streams carry what cannot fit — sorted runs
(exec/external_sort.py), hash partitions
(exec/spill.py::partitioned_join_spilled), and sorted partial-aggregate
runs merged by key — in the temp-file store (storage/tmpfile.py).  Small
tables are whole device relations; per-batch operators run the same
``exec.ops`` operators eagerly.

Supported plan shapes (dispatch in :func:`execute_spilled`):

- ``[Project*/Limit?/Sort?] over scan-pipeline``          -> streamed sort
- ``... over GroupBy over scan-pipeline``                 -> partial
  group-by per granule, disk merge by key (unbounded NDV)
- ``... over ScalarAgg over scan-pipeline``               -> partial fold
- ``... over [GroupBy|ScalarAgg]? over join tree``        -> the join tree
  streams: each HashJoin either probes a device-resident build side
  batch-by-batch, or — when both sides are over budget — co-partitions
  to disk.  LEFT joins stream only on the preserved side.

Anything else raises NotDistributable (the caller falls back to the
in-memory engine).  Every batch drains to the host by design, as in the
reference; ``SpillStats.host_reads`` counts those device-to-host reads.

Differences from the reference: the build side of a streamed join and
every granule program run under ``execute_plan``'s overflow check (the
reference lowers them without a collector, so an overflow there would
vanish); ``prune_scans`` drops the scanned columns no operator reads
before anything streams; and final aggregates merged on the host keep
their partial's type (ROADMAP Queue 3 #10).  Every host batch passes the
statement's cancel/deadline checkpoint (``server/admission.py``), as
in the reference, and a granule stream that unwinds waits for its
in-flight host-to-device copies before its pinned buffers go.  A
spilled query runs under the reference's ``spill.execute`` and
``spill.finish`` spans, counts its ``spill.*`` metrics at the result
boundary, and times its device work into the statement's host/device
split (``exec/plan.py::device_span``).  Waiting for another slice: the disk-budget, fault and label
hooks of the temp-file store (ROADMAP Queue 1 item 5b, sub-items 10-11).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.exec import diag, ops
from oceanbase_tpu_torch.exec import plan as pp
from oceanbase_tpu_torch.exec.external_sort import external_sort
from oceanbase_tpu_torch.exec.granule import (
    DEFAULT_CHUNK_ROWS,
    GranuleUploader,
    _chunk_to_relation,
    _find_single_scan,
    _global_dicts,
    _is_string,
    _pick,
    extract_column_bounds,
    prefetch_iter,
    scan_columns,
    snap_chunk_rows,
)
from oceanbase_tpu_torch.exec.spill import partitioned_join_spilled
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.px.dist_ops import split_aggs
from oceanbase_tpu_torch.px.planner import NotDistributable, split_top
from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.storage.tmpfile import TempFileStore
from oceanbase_tpu_torch.vector.column import Relation, from_numpy, to_numpy

# spill-tier accounting (host side, recorded once per spilled query at
# the result boundary — same place the spill.execute span closes)
qmetrics.declare("spill.executions", "counter",
                 "queries routed through the disk-spill tier")
qmetrics.declare("spill.bytes", "counter",
                 "bytes written to the temp-file store")
qmetrics.declare("spill.rows", "counter",
                 "rows that crossed the host/disk boundary")
qmetrics.declare("spill.execute_s", "histogram",
                 "spilled-query wall time", unit="s")

OUT_CHUNK = 1 << 16

_STREAM = "__stream__"  # placeholder scan name for per-batch lowering


@dataclass
class SpillStats:
    """What the query spilled (≙ the work-area profile the reference
    exposes per operator)."""

    kind: str = ""            # sort | groupby | join | scalar | mixed
    runs: int = 0             # temp-file runs created
    bytes: int = 0            # bytes written to the temp-file store
    spilled_rows: int = 0     # rows that crossed the host/disk boundary
    batches: int = 0          # streamed batches processed
    host_reads: int = 0       # device-to-host reads (batches, overflow)
    ops: list = field(default_factory=list)  # [(op kind, detail)]


class _Ctx:
    def __init__(self, store: TempFileStore, budget_rows: int,
                 chunk_rows: int, providers: dict, device_tables: dict,
                 types_by_table: dict, big_tables: set, device):
        self.store = store
        self.budget_rows = budget_rows
        self.chunk_rows = chunk_rows
        self.providers = providers
        self.device_tables = device_tables
        self.types_by_table = types_by_table
        self.big_tables = big_tables
        self.device = device
        self.stats = SpillStats()
        self.dtypes: dict[str, object] = {}  # col name -> SqlType

    def note(self, op: str, detail: str = ""):
        self.stats.ops.append((op, detail))

    def snap_store(self):
        self.stats.runs = self.store._next
        self.stats.bytes = self.store.bytes_written

    def record_dtypes(self, rel: Relation):
        for name, col in rel.columns.items():
            self.dtypes[name] = col.dtype

    def record_final_dtypes(self, final_specs):
        """A final aggregate merged on the host (sum/min/max of a
        partial) keeps its partial's type.  The reference records none,
        so its post projection re-infers INT and the result comes back
        undescaled (ROADMAP Queue 3 #10)."""
        for spec in final_specs:
            t = self.dtypes.get(spec.arg.name)
            if t is not None:
                self.dtypes[spec.name] = t

    def checked(self, plan: pp.PlanNode, tables: dict) -> Relation:
        """Lower ``plan`` under ``execute_plan``'s overflow check (a host
        read when the plan has capacity lanes)."""
        with diag.collect() as entries:
            out = pp._lower(plan, tables)
        if entries:
            self.stats.host_reads += 1
        pp.check_overflow(entries)
        return out


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def execute_spilled(plan: pp.PlanNode, providers: dict, spill_dir: str,
                    budget_rows: int, device_tables: dict | None = None,
                    types_by_table: dict | None = None,
                    big_tables: set | None = None,
                    chunk_rows: int = DEFAULT_CHUNK_ROWS, device=None):
    """Run ``plan`` with disk spill for everything over ``budget_rows``,
    its device work on ``device`` (default ``"cuda"``).

    providers: {table: chunk_provider} for the over-budget tables
    (re-iterable granule streams).  device_tables: {table: Relation} for
    every other referenced table (lowered whole; on ``device``).
    -> (arrays, valids, dtypes, SpillStats); raises NotDistributable for
    unsupported shapes.  DECIMAL columns come back as raw scaled ints;
    the caller descales them with the returned dtypes.
    """
    dev = default_device(device)
    chunk_rows = snap_chunk_rows(chunk_rows)
    device_tables = device_tables or {}
    types_by_table = types_by_table or {}
    table_columns = {t: list(r.columns) for t, r in device_tables.items()}
    table_columns.update({t: list(ty) for t, ty in types_by_table.items()})
    top, scalar_agg, droot = split_top(
        prune_scans(plan, None, table_columns))
    group_node = None
    if isinstance(droot, pp.GroupBy):
        group_node = droot
        inner = droot.child
    else:
        inner = droot
    big = set(big_tables if big_tables is not None else providers)
    if not big:
        raise NotDistributable("no over-budget table to stream")

    def _split(aggs):
        # the spill tier's public contract is NotDistributable for every
        # unsupported shape — including non-splittable aggregates
        try:
            return split_aggs(aggs)
        except NotImplementedError as e:
            raise NotDistributable(str(e)) from None

    m0 = time.monotonic()
    with TempFileStore(spill_dir) as store, \
            qtrace.span("spill.execute") as tsp, pp.device_span(dev):
        ctx = _Ctx(store, budget_rows, chunk_rows, providers,
                   device_tables, types_by_table, big, dev)
        try:
            batches = _stream_subtree(ctx, inner)
            if group_node is not None:
                partial_specs, final_specs, post = \
                    _split(group_node.aggs)
                keys = group_node.keys
                batches = _partial_groupby_batches(ctx, batches, keys,
                                                   partial_specs)
                batches = _merge_group_partials(ctx, batches, list(keys),
                                                final_specs, post)
                ctx.stats.kind = "groupby"
            elif scalar_agg is not None:
                partial_specs, final_specs, post = \
                    _split(scalar_agg.aggs)
                batches = _partial_scalar_batches(ctx, batches,
                                                  partial_specs)
                batches = _scalar_final(ctx, batches, final_specs, post)
                ctx.stats.kind = "scalar"
            else:
                ctx.stats.kind = "sort"
            # the granule streams above are lazy: _finish drives them,
            # so the whole spill pipeline's work lands inside this span
            with qtrace.span("spill.finish"):
                arrays, valids = _finish(ctx, batches, top)
        finally:
            ctx.snap_store()
        if any(k == "join" for k, _ in ctx.stats.ops):
            ctx.stats.kind = ("join" if ctx.stats.kind == "sort"
                              else ctx.stats.kind + "+join")
        tsp.tags.update(kind=ctx.stats.kind, runs=ctx.stats.runs,
                        bytes=ctx.stats.bytes,
                        spilled_rows=ctx.stats.spilled_rows,
                        batches=ctx.stats.batches)
        qmetrics.inc("spill.executions", kind=ctx.stats.kind)
        qmetrics.inc("spill.bytes", ctx.stats.bytes, kind=ctx.stats.kind)
        qmetrics.inc("spill.rows", ctx.stats.spilled_rows,
                     kind=ctx.stats.kind)
        qmetrics.observe("spill.execute_s", time.monotonic() - m0,
                         kind=ctx.stats.kind)
        return arrays, valids, dict(ctx.dtypes), ctx.stats


# ---------------------------------------------------------------------------
# scan pruning
# ---------------------------------------------------------------------------


def _refs(*exprs) -> set:
    out = set()
    for e in exprs:
        if e is not None:
            out.update(x.name for x in ir.walk(e)
                       if isinstance(x, ir.ColumnRef))
    return out


def _union(need, more: set):
    return None if need is None else need | more


def prune_scans(node: pp.PlanNode, need, table_columns: dict):
    """Restrict every TableScan to the columns the operators above it
    read (``need``: the names wanted from ``node``, None for all).

    The binder scans every column (``columns=None``); the reference's
    spill tier then uploads, drains and re-encodes each of them per
    batch, ``l_comment`` included.  Dropping the unread ones changes no
    result.  ``table_columns`` lists each table's columns.  Subtrees
    under an operator it does not know (Union, IndexProbe) keep theirs."""
    def down(child, child_need):
        return prune_scans(child, child_need, table_columns)

    if isinstance(node, pp.TableScan):
        cols = (node.columns if node.columns is not None
                else table_columns.get(node.table))
        if need is None or cols is None:
            return node
        rn = node.rename or {}
        keep = [c for c in cols if rn.get(c, c) in need]
        # a relation needs one column to carry its capacity (count(*))
        return dataclasses.replace(node, columns=keep or cols[:1])
    if isinstance(node, pp.Project):
        return dataclasses.replace(
            node, child=down(node.child, _refs(*node.outputs.values())))
    if isinstance(node, pp.Filter):
        return dataclasses.replace(
            node, child=down(node.child, _union(need, _refs(node.pred))))
    if isinstance(node, pp.GroupBy):
        n = _refs(*node.keys.values(), *(a.arg for a in node.aggs))
        return dataclasses.replace(node, child=down(node.child, n))
    if isinstance(node, pp.ScalarAgg):
        n = _refs(*(a.arg for a in node.aggs))
        return dataclasses.replace(node, child=down(node.child, n))
    if isinstance(node, pp.HashJoin):
        n = _union(need, _refs(*node.left_keys, *node.right_keys))
        return dataclasses.replace(node, left=down(node.left, n),
                                   right=down(node.right, n))
    if isinstance(node, pp.SemiJoinResidual):
        return dataclasses.replace(
            node,
            left=down(node.left, _union(
                need, _refs(*node.left_keys, *node.residual))),
            right=down(node.right, _refs(*node.right_keys, *node.residual)))
    if isinstance(node, pp.Sort):
        return dataclasses.replace(
            node, child=down(node.child, _union(need, _refs(*node.keys))))
    if isinstance(node, (pp.Limit, pp.Compact)):
        return dataclasses.replace(node, child=down(node.child, need))
    if isinstance(node, pp.Window):
        n = _union(need, _refs(*(call for _out, call in node.specs)))
        return dataclasses.replace(node, child=down(node.child, n))
    return node


# ---------------------------------------------------------------------------
# streaming the input tree
# ---------------------------------------------------------------------------


def _is_scan_pipeline(node) -> bool:
    if isinstance(node, pp.TableScan):
        return True
    if isinstance(node, (pp.Filter, pp.Project, pp.Compact)):
        return _is_scan_pipeline(node.child)
    return False


def _stream_subtree(ctx: _Ctx, node: pp.PlanNode):
    """-> host (arrays, valids) batch iterator for a subtree that
    references at least one over-budget table."""
    refs = set(pp.referenced_tables(node))
    if not (refs & ctx.big_tables):
        raise NotDistributable("subtree has no streamed table")
    if _is_scan_pipeline(node):
        table = _find_single_scan(node)
        if table not in ctx.providers:
            raise NotDistributable(f"no chunk provider for {table}")
        return _scan_batches(ctx, node, table)
    if isinstance(node, (pp.Filter, pp.Project, pp.Compact)):
        child_batches = _stream_subtree(ctx, node.child)
        wrapper = dataclasses.replace(node, child=pp.TableScan(_STREAM))
        return _batch_apply(ctx, wrapper, child_batches)
    if isinstance(node, pp.HashJoin):
        return _stream_join(ctx, node)
    raise NotDistributable(
        f"cannot stream {type(node).__name__} over budget")


def _scan_batches(ctx: _Ctx, subtree: pp.PlanNode, table: str):
    """Granules -> device scan/filter/project -> host batches.  A dead
    probe granule runs first to capture the output dtypes."""
    provider = ctx.providers[table]
    cols = scan_columns(subtree)
    types = _pick(ctx.types_by_table.get(table) or {}, cols)
    gdicts = _global_dicts(provider, table, ctx.chunk_rows, cols)
    bounds = extract_column_bounds(subtree)
    chunk_rows = ctx.chunk_rows
    uploader = GranuleUploader(ctx.device, chunk_rows)
    chunk_plan = pp.Compact(subtree)

    def gen():
        try:
            probe = _dead_granule(types, gdicts, chunk_rows, uploader)
            if probe is not None:
                ctx.record_dtypes(ctx.checked(chunk_plan, {table: probe}))
            for arrays, valids in prefetch_iter(
                    provider(table, chunk_rows, bounds)):
                n = len(next(iter(arrays.values()))) if arrays else 0
                if n == 0:
                    continue
                rel = _chunk_to_relation(_pick(arrays, cols),
                                         _pick(valids, cols), types,
                                         gdicts, chunk_rows, n, uploader)
                out = ctx.checked(chunk_plan, {table: rel})
                ctx.record_dtypes(out)
                yield from _host_batch(ctx, out)
        finally:
            # a KILL or timeout unwinds here too: no pinned buffer is
            # released while a copy into the card still reads it
            uploader.drain()

    ctx.note("scan-stream", table)
    return gen()


def _dead_granule(types: dict, gdicts: dict, chunk_rows: int,
                  uploader: GranuleUploader):
    """All-dead fixed-shape granule for dtype probing (one row of zeros
    padded to capacity)."""
    if not types:
        return None
    arrays = {}
    for c, t in types.items():
        if t.is_string:
            arrays[c] = np.array([""], dtype=object)
        else:
            arrays[c] = np.zeros(1, dtype=t.np_dtype)
    rel = _chunk_to_relation(arrays, {}, types, gdicts, chunk_rows, 1,
                             uploader)
    return Relation(columns=rel.columns,
                    mask=torch.zeros(rel.capacity, dtype=torch.bool,
                                     device=uploader.device))


def _host_batch(ctx: _Ctx, rel: Relation):
    """Device relation -> one host (arrays, valids) batch (live rows).
    Every produced batch funnels through here: one host read each, and
    the spill tier's per-batch cancel/deadline checkpoint."""
    qadmission.checkpoint()
    ctx.stats.host_reads += 1
    host = to_numpy(rel)
    cols = [c for c in host if not c.startswith("__valid__")]
    if not cols:
        return
    arrays = {c: host[c] for c in cols}
    if len(next(iter(arrays.values()))) == 0:
        return
    valids = {c: host.get("__valid__" + c) for c in cols}
    ctx.stats.batches += 1
    yield arrays, valids


def _pad(v, pad, fill=0):
    if pad <= 0 or v is None:
        return v
    if _is_string(v):
        return np.concatenate([v, np.array([""] * pad, dtype=object)])
    return np.concatenate([v, np.full(pad, fill, dtype=v.dtype)])


def _pad_to_relation(ctx: _Ctx, arrays: dict, valids: dict):
    """Host batch -> device relation padded to a power-of-two capacity
    with a live-row mask."""
    n = len(next(iter(arrays.values())))
    cap = 1
    while cap < max(n, 1):
        cap <<= 1
    pad = cap - n
    a = {k: _pad(np.asarray(v), pad) for k, v in arrays.items()}
    v = {k: _pad(np.asarray(x), pad, False)
         for k, x in (valids or {}).items() if x is not None}
    rel = from_numpy(a, types={k: t for k, t in ctx.dtypes.items()
                               if k in a}, valids=v, device=ctx.device)
    return Relation(columns=rel.columns,
                    mask=torch.arange(cap, device=ctx.device) < n)


def _batch_apply(ctx: _Ctx, wrapper: pp.PlanNode, batches):
    """Apply a plan fragment (with one TableScan(_STREAM) leaf) per host
    batch, eagerly on the device."""
    chunk_plan = pp.Compact(wrapper)

    def gen():
        for arrays, valids in batches:
            rel = _pad_to_relation(ctx, arrays, valids)
            out = ctx.checked(chunk_plan,
                              {**ctx.device_tables, _STREAM: rel})
            ctx.record_dtypes(out)
            yield from _host_batch(ctx, out)

    return gen()


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


def _stream_join(ctx: _Ctx, node: pp.HashJoin):
    lrefs = set(pp.referenced_tables(node.left))
    rrefs = set(pp.referenced_tables(node.right))
    lbig = bool(lrefs & ctx.big_tables)
    rbig = bool(rrefs & ctx.big_tables)
    if lbig and rbig:
        return _copartition_join(ctx, node)
    # one-side stream: build the small side whole on the device, probe
    # with streamed batches.  Outer-join safety: the streamed side must
    # be the preserved side — unmatched BUILD rows cannot be emitted per
    # batch.
    if node.how == "left" and not lbig:
        raise NotDistributable("left join with over-budget build side")
    if node.how not in ("inner", "left"):
        raise NotDistributable(f"streamed {node.how} join")
    stream_side, build_side = ((node.left, node.right) if lbig
                               else (node.right, node.left))
    skeys, bkeys = ((node.left_keys, node.right_keys) if lbig
                    else (node.right_keys, node.left_keys))
    build_rel = ctx.checked(pp.Compact(build_side), ctx.device_tables)
    batches = _stream_subtree(ctx, stream_side)
    ctx.note("join", f"stream-{'left' if lbig else 'right'} "
                     f"how={node.how}")

    def gen():
        for arrays, valids in batches:
            srel = _pad_to_relation(ctx, arrays, valids)
            n = len(next(iter(arrays.values())))
            # per-batch output budget scales with the batch, not the
            # planner's whole-query estimate; the x4 retry loop recovers
            # from underestimates, and the LAST attempt falls back to the
            # planner's whole-query estimate so extreme per-key fanout
            # (>128x batch rows) still completes instead of erroring
            cap = max(2 * n, 1024)
            last = max(cap * 4 ** 4, node.out_capacity or 0)
            for _attempt in range(5):
                if _attempt == 4:
                    cap = last
                with diag.collect() as entries:
                    if lbig:
                        j = ops.join(srel, build_rel, skeys, bkeys,
                                     how=node.how, out_capacity=cap)
                    else:
                        j = ops.join(build_rel, srel, bkeys, skeys,
                                     how=node.how, out_capacity=cap)
                ctx.stats.host_reads += 1
                try:
                    pp.check_overflow(entries)
                except diag.CapacityOverflow:
                    cap *= 4
                    continue
                break
            else:
                raise diag.CapacityOverflow(
                    f"streamed join batch overflows at {cap}")
            ctx.record_dtypes(j)
            yield from _host_batch(ctx, j)

    return gen()


def _copartition_join(ctx: _Ctx, node: pp.HashJoin):
    """Both sides over budget: hash co-partition both streams to disk,
    join pair-by-pair (exec/spill.py)."""
    if node.how not in ("inner", "left"):
        raise NotDistributable(f"spilled {node.how} join")

    def names(keys):
        out = []
        for k in keys:
            if not isinstance(k, ir.ColumnRef):
                raise NotDistributable("spilled join needs column keys")
            out.append(k.name)
        return out

    lnames, rnames = names(node.left_keys), names(node.right_keys)
    lbatches = _stream_subtree(ctx, node.left)
    rbatches = _stream_subtree(ctx, node.right)
    ctx.note("join", "copartition-disk")

    def counted(batches):
        for arrays, valids in batches:
            ctx.stats.spilled_rows += len(next(iter(arrays.values())))
            yield arrays, valids

    def gen():
        for arrays, valids in partitioned_join_spilled(
                counted(lbatches), counted(rbatches), lnames, rnames,
                ctx.store, how=node.how, budget_rows=ctx.budget_rows,
                device=ctx.device, stats=ctx.stats):
            ctx.stats.batches += 1
            # join output columns are the union of the two sides'
            # (already recorded) columns — no dtype to capture
            yield arrays, valids

    return gen()


# ---------------------------------------------------------------------------
# aggregation over streams
# ---------------------------------------------------------------------------


def _partial_groupby_batches(ctx: _Ctx, batches, keys: dict,
                             partial_specs):
    def gen():
        for arrays, valids in batches:
            rel = _pad_to_relation(ctx, arrays, valids)
            # out_capacity = the batch capacity: no group can be lost
            out = ops.hash_groupby(rel, keys, partial_specs,
                                   out_capacity=rel.capacity)
            ctx.record_dtypes(out)
            yield from _host_batch(ctx, out)

    return gen()


def _partial_scalar_batches(ctx: _Ctx, batches, partial_specs):
    def gen():
        got = False
        for arrays, valids in batches:
            rel = _pad_to_relation(ctx, arrays, valids)
            out = ops.scalar_agg(rel, partial_specs)
            ctx.record_dtypes(out)
            got = True
            yield from _host_batch(ctx, out)
        if not got:
            raise NotDistributable(
                "no input batches for spilled scalar aggregate")

    return gen()


def _scalar_final(ctx: _Ctx, batches, final_specs, post):
    """Fold 1-row partial batches into the final scalar aggregates, then
    apply the post projection (avg ratios) on the device."""

    def gen():
        parts_a, parts_v = [], []
        for arrays, valids in batches:
            parts_a.append(arrays)
            parts_v.append(valids)
        if not parts_a:
            return
        arrays, valids = _concat_batches(parts_a, parts_v)
        starts = np.array([0])
        out_a, out_v = _reduce_groups(arrays, valids, [], final_specs,
                                      starts)
        ctx.record_final_dtypes(final_specs)
        yield from _post_project(ctx, out_a, out_v, {}, post)

    return gen()


def _merge_group_partials(ctx: _Ctx, batches, key_names, final_specs,
                          post):
    """External-sort partial batches by group key, merge equal-key runs
    (≙ the sort-based fallback of the dump-capable hash group-by), then
    post-project.  Handles NDV far beyond device capacity."""

    def counted(src):
        for arrays, valids in src:
            ctx.stats.spilled_rows += len(next(iter(arrays.values())))
            yield arrays, valids

    def gen():
        sorted_chunks = external_sort(
            counted(batches), key_names, [True] * len(key_names),
            ctx.store, budget_rows=ctx.budget_rows,
            out_chunk=OUT_CHUNK)
        carry = None
        for arrays, valids in sorted_chunks:
            # every partial batch has been consumed (and typed) by now
            ctx.record_final_dtypes(final_specs)
            if carry is not None:
                arrays, valids = _concat_batches(
                    [carry[0], arrays], [carry[1], valids])
            starts = _group_starts(arrays, valids, key_names)
            if len(starts) > 1:
                cut = starts[-1]
                head_a = {k: v[:cut] for k, v in arrays.items()}
                head_v = {k: (v[:cut] if v is not None else None)
                          for k, v in valids.items()}
                out_a, out_v = _reduce_groups(
                    head_a, head_v, key_names, final_specs, starts[:-1])
                yield from _post_project(ctx, out_a, out_v,
                                         key_names, post)
            cut = starts[-1] if len(starts) else 0
            carry = ({k: v[cut:] for k, v in arrays.items()},
                     {k: (v[cut:] if v is not None else None)
                      for k, v in valids.items()})
        if carry is not None and \
                len(next(iter(carry[0].values()))) > 0:
            arrays, valids = carry
            starts = _group_starts(arrays, valids, key_names)
            out_a, out_v = _reduce_groups(arrays, valids, key_names,
                                          final_specs, starts)
            yield from _post_project(ctx, out_a, out_v, key_names, post)

    return gen()


def _post_project(ctx: _Ctx, arrays, valids, key_names, post):
    """Final outputs = group keys + post-projection of final aggregates;
    runs on the device to get expression semantics (decimal avg etc.)."""
    outs = {k: ir.col(k) for k in key_names}
    outs.update(post)
    if all(isinstance(e, ir.ColumnRef) and e.name in arrays
           for e in outs.values()):
        out_a = {nm: arrays[e.name] for nm, e in outs.items()}
        out_v = {nm: valids.get(e.name) for nm, e in outs.items()}
        for nm, e in outs.items():
            if e.name in ctx.dtypes:
                ctx.dtypes[nm] = ctx.dtypes[e.name]
        yield out_a, out_v
        return
    rel = _pad_to_relation(ctx, arrays, valids)
    out = ops.project(rel, outs)
    ctx.record_dtypes(out)
    yield from _host_batch(ctx, out)


def _group_starts(arrays, valids, key_names) -> np.ndarray:
    """Start index of each equal-key run in key-sorted host arrays.
    NULL == NULL for grouping; NaN == NaN (sorted adjacent)."""
    n = len(next(iter(arrays.values())))
    change = np.zeros(n, dtype=bool)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    change[0] = True
    for k in key_names:
        a = arrays[k]
        if a.dtype == object:
            a = a.astype("U")
        v = valids.get(k)
        with np.errstate(invalid="ignore"):
            neq = a[1:] != a[:-1]
        if a.dtype.kind == "f":
            both_nan = np.isnan(a[1:]) & np.isnan(a[:-1])
            neq &= ~both_nan
        if v is not None:
            neq = (v[1:] != v[:-1]) | (v[1:] & v[:-1] & neq)
        change[1:] |= neq
    return np.nonzero(change)[0]


_INT_SENT = {"min": np.iinfo(np.int64).max, "max": np.iinfo(np.int64).min}


def _reduce_groups(arrays, valids, key_names, final_specs, starts):
    """Merge partial-aggregate rows per equal-key group (vectorized
    ufunc.reduceat; object/NULL-heavy min/max falls back to a per-group
    loop)."""
    out_a = {k: arrays[k][starts] for k in key_names}
    out_v = {k: (valids[k][starts] if valids.get(k) is not None else None)
             for k in key_names}
    for spec in final_specs:
        pname = spec.arg.name
        a = arrays[pname]
        v = valids.get(pname)
        if spec.fn == "sum":
            av = np.where(v, a, 0) if v is not None else a
            red = np.add.reduceat(av, starts)
            rv = (np.logical_or.reduceat(v, starts)
                  if v is not None else None)
        elif spec.fn in ("min", "max"):
            ufunc = np.minimum if spec.fn == "min" else np.maximum
            if a.dtype == object or a.dtype.kind in "US":
                red, rv = _loop_minmax(a, v, starts, spec.fn == "min")
            else:
                if v is not None:
                    if a.dtype.kind == "f":
                        sent = np.inf if spec.fn == "min" else -np.inf
                    else:
                        sent = _INT_SENT[spec.fn]
                    a = np.where(v, a, np.asarray(sent, dtype=a.dtype))
                red = ufunc.reduceat(a, starts)
                rv = (np.logical_or.reduceat(v, starts)
                      if v is not None else None)
        else:
            raise NotDistributable(f"spilled final merge of {spec.fn}")
        out_a[spec.name] = red
        out_v[spec.name] = rv
    return out_a, {k: v for k, v in out_v.items() if v is not None}


def _loop_minmax(a, v, starts, is_min):
    ends = np.append(starts[1:], len(a))
    red = np.empty(len(starts), dtype=object)
    rv = np.zeros(len(starts), dtype=bool)
    for g, (s, e) in enumerate(zip(starts, ends)):
        vals = [a[i] for i in range(s, e)
                if v is None or v[i]]
        if vals:
            red[g] = min(vals) if is_min else max(vals)
            rv[g] = True
        else:
            red[g] = ""
    return red, rv


# ---------------------------------------------------------------------------
# coordinator tail: [Project* Limit? Sort?] over a batch stream
# ---------------------------------------------------------------------------


def _finish(ctx: _Ctx, batches, top):
    """Apply the coordinator chain.  A Sort externals-sorts the stream
    (early-exit under Limit); Projects above the Sort apply to the final
    (small) result, Projects below it apply per batch."""
    sort_node = None
    limit_node = None
    above_projects = []
    below = []
    for node in top:  # outermost-first
        if sort_node is None:
            if isinstance(node, pp.Sort):
                sort_node = node
            elif isinstance(node, pp.Limit):
                if limit_node is not None:
                    raise NotDistributable("stacked limits")
                limit_node = node
            elif isinstance(node, pp.Project):
                above_projects.append(node)
        else:
            if isinstance(node, pp.Project):
                below.append(node)
            else:
                raise NotDistributable(
                    f"{type(node).__name__} under streamed Sort")
    for node in reversed(below):  # innermost-first
        wrapper = dataclasses.replace(node, child=pp.TableScan(_STREAM))
        batches = _batch_apply(ctx, wrapper, batches)

    want = None
    if limit_node is not None:
        want = limit_node.k + limit_node.offset

    if sort_node is not None:
        key_cols = []
        for k in sort_node.keys:
            if not isinstance(k, ir.ColumnRef):
                raise NotDistributable("streamed sort needs column keys")
            key_cols.append(k.name)

        def counted(src):
            for arrays, valids in src:
                ctx.stats.spilled_rows += \
                    len(next(iter(arrays.values())))
                yield arrays, valids

        stream = external_sort(counted(batches), key_cols,
                               sort_node.ascending, ctx.store,
                               budget_rows=ctx.budget_rows,
                               out_chunk=OUT_CHUNK)
    else:
        stream = batches

    parts_a, parts_v = [], []
    got = 0
    for arrays, valids in stream:
        parts_a.append(arrays)
        parts_v.append(valids)
        got += len(next(iter(arrays.values())))
        if want is not None and got >= want:
            break  # merge tail stays on disk
    if not parts_a:
        return {}, {}
    arrays, valids = _concat_batches(parts_a, parts_v)
    if limit_node is not None:
        lo, hi = limit_node.offset, limit_node.offset + limit_node.k
        arrays = {c: a[lo:hi] for c, a in arrays.items()}
        valids = {c: (v[lo:hi] if v is not None else None)
                  for c, v in valids.items()}
    for node in reversed(above_projects):  # innermost-first
        outs = node.outputs
        if all(isinstance(e, ir.ColumnRef) for e in outs.values()):
            for nm, e in outs.items():
                if e.name in ctx.dtypes:
                    ctx.dtypes[nm] = ctx.dtypes[e.name]
            arrays = {nm: arrays[e.name] for nm, e in outs.items()}
            valids = {nm: valids.get(e.name) for nm, e in outs.items()}
        else:
            rel = _pad_to_relation(ctx, arrays, valids)
            out = ops.project(rel, outs)
            ctx.record_dtypes(out)
            ctx.stats.host_reads += 1
            host = to_numpy(out)
            cols = [c for c in host if not c.startswith("__valid__")]
            arrays = {c: host[c] for c in cols}
            valids = {c: host.get("__valid__" + c) for c in cols}
    return arrays, {k: v for k, v in valids.items() if v is not None}


def _concat_batches(parts_a, parts_v):
    cols = list(parts_a[0])
    arrays = {}
    valids = {}
    for c in cols:
        chunks = [np.asarray(p[c]) for p in parts_a]
        if any(x.dtype == object for x in chunks):
            chunks = [x.astype(object) for x in chunks]
        arrays[c] = np.concatenate(chunks)
        if any(v.get(c) is not None for v in parts_v):
            valids[c] = np.concatenate(
                [np.asarray(v[c]) if v.get(c) is not None
                 else np.ones(len(a[c]), dtype=bool)
                 for v, a in zip(parts_v, parts_a)])
        else:
            valids[c] = None
    return arrays, valids


__all__ = ["SpillStats", "execute_spilled", "prune_scans"]
