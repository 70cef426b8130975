"""Physical plan nodes + the eager plan executor.

Port of ``oceanbase_tpu/exec/plan.py``.  The plan nodes are the same
dataclasses, so plans are built the same way.  ``execute_plan`` lowers the
tree operator by operator over masked ``Relation``s on the tables' device
and keeps the reference's overflow contract: every static-capacity
operator pushes a device scalar, and the executor reads the stacked
lanes once at the result boundary — the only host sync of an execution.

The plan-quality metadata the binder and optimizer use is copied as it
is (``logical_hash``, ``propagate_estimates``, ``monitored_op``), so a
plan bound by the port hashes like the JAX package's.

The measurement plane (``server/{metrics,trace,monitor,calibrate,
profiler}.py``) rides the same boundary and adds no sync.  XLA gave the reference a compiled program with a cost
analysis and one fused launch; eager torch has neither, so each number
has a counterpart defined here:

- ``PlanCacheEntry.xla_traces`` (the ``xla_trace_count`` column of
  gv$plan_cache) counts FIRST EXECUTIONS per (plan fingerprint,
  capacity signature) — the signature is each input table's name,
  capacity, mask presence and column dtypes.  It stays flat while a
  table grows inside one bucket of the shape ladder, as the reference's
  retrace count does.
- ``flops``/``bytes_accessed`` are an ANALYTIC count from shapes only,
  computed on the host at a signature's first execution: per lowered
  operator, ``bytes`` = every lane of every input relation (data at its
  dtype width, validity and mask at one byte) plus every lane of the
  output that is a new tensor (a column passed through by identity is
  not written), at the relations' capacity; ``flops`` = one operation
  per input row (the input relations' capacities).  A TableScan moves
  nothing.  It is not XLA's number and does not depend on what
  implements an operator.
- ``device_s`` is a CUDA event pair: one event recorded before the first
  launch, one after the last, read with ``elapsed_time`` once the result
  boundary's one existing sync has passed (or, for an execution with no
  overflow lane to read, once the caller's result read has: the pair
  is resolved by ``resolve_pending``/``exec_times``).  It is the
  stream's SPAN from first launch to last, not the card's busy time:
  the stream idles between launches while the host lags behind, and
  that idle time counts.  So it overlaps ``host_s``, the two can sum to
  more than the wall time, and what divides by it (``achieved_gflops``/
  ``achieved_gbps``, the time q-error, gv$time_calibration) reads a
  LOWER bound on the rate and an UPPER bound on busy time; a host-bound
  plan's roofline prediction looks pessimistic for that reason alone.
  ``PROFILE``'s kernel total is the busy time.  ``host_s`` is the
  wall time from entry to that boundary minus the time the host spent
  waiting in the read.  On the CPU ``device_s`` is 0 and ``host_s`` the
  wall time, as on the reference's CPU backend.
- ``peak_memory`` is ``torch.cuda.max_memory_allocated()`` at the end
  of a signature's first execution minus ``memory_allocated()`` at its
  entry: an UPPER bound on what the execution added at its peak (the
  allocator's peak is process-wide and is reset only by whoever
  measures around the statement, never here, since a reset would cut
  their window short).  Host-side allocator reads; the reference reads
  XLA's memory analysis once per compile.
- The plan monitor's per-operator row counts are device scalars stacked
  with the overflow lanes into the one tensor the boundary reads; an
  execution without overflow lanes copies them without blocking into a
  pinned buffer from a per-thread pool, records a fence event after
  the copy, and reads the buffer only once that fence has completed.

``execute_plan`` observes the statement's cancel/deadline checkpoint
(``server/admission.py``) at entry and at close.  ``prepare_index_probes``
builds the sorted sidecar an ``IndexProbe`` reads on the base table's
device and caches it on the catalog.
"""

from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.exec import diag, ops
from oceanbase_tpu_torch.exec.window import window as window_op
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.vector.column import (
    Column,
    Relation,
    bucket_capacity,
)


# device attribution + per-plan wall time (host-side, result boundary);
# the reference's names, so a gv$sysstat row means the same in both
qmetrics.declare("plan.executions", "counter",
                 "execute_plan calls", )
qmetrics.declare("plan.compiles", "counter",
                 "first executions per plan x capacity signature (the "
                 "reference counts XLA trace+compile events here)")
qmetrics.declare("plan.execute_s", "histogram",
                 "whole-plan execution wall time", unit="s")
qmetrics.declare("plan.compile_s", "histogram",
                 "XLA lower+compile wall time (nothing compiles in the "
                 "eager port)", unit="s")
qmetrics.declare("plan.flops_compiled", "counter",
                 "analytic flops of plans at their first execution per "
                 "signature")
qmetrics.declare("plan.bytes_compiled", "counter",
                 "analytic bytes of plans at their first execution per "
                 "signature")
qmetrics.declare("plan.qerror", "histogram",
                 "worst per-operator estimate-vs-actual q-error per "
                 "monitored execution (1.0 = perfect estimate)")
qmetrics.declare("plan.capacity_retries", "counter",
                 "CapacityOverflow re-plans (the retry ladder the "
                 "cardinality-feedback store exists to shorten)")
qmetrics.declare("plan.feedback_hits", "counter",
                 "binds that found gv$plan_feedback rows for their "
                 "logical plan hash")
qmetrics.declare("plan.feedback_corrections", "counter",
                 "operator capacities raised at bind time from "
                 "observed cardinalities")
qmetrics.declare("plan.regressions", "counter",
                 "plan-regression watchdog flag transitions "
                 "(gv$plan_history.regressed going up)")
qmetrics.declare("plan.flops_executed", "counter",
                 "analytic flops of the plan behind each execution")
qmetrics.declare("plan.bytes_executed", "counter",
                 "analytic bytes of the plan behind each execution")
qmetrics.declare("plan.host_s", "histogram",
                 "host half of the execution split: entry to the result "
                 "boundary minus the wait in its read", unit="s")
qmetrics.declare("plan.device_s", "histogram",
                 "device half of the execution split: the CUDA event "
                 "pair around the execution's launches (the denominator "
                 "of achieved_gflops)", unit="s")
qmetrics.declare("plan.sidecar_builds", "counter",
                 "index-probe sidecar rebuilds (sort + pad) paid "
                 "because no cached sidecar matched the relation")
qmetrics.declare("plan.sidecar_build_s", "histogram",
                 "wall time of one sidecar rebuild inside "
                 "prepare_index_probes", unit="s")


# ---------------------------------------------------------------------------
# plan-cache observability (≙ ObPlanCache stat views: gv$plan_cache)
# ---------------------------------------------------------------------------


@dataclass
class PlanCacheEntry:
    """Per-plan execution counters surfaced by ``gv$plan_cache``.

    ``xla_traces`` counts first executions per capacity signature (the
    module docstring defines it); ``executions - xla_traces`` is the
    number of calls at a signature already seen.  ``flops``/
    ``bytes_accessed`` are the analytic count of the most recent new
    signature and ``peak_memory`` an upper bound on what its first
    execution allocated (the module docstring defines both).
    ``device_s_total`` accumulates the event-pair half of the
    host/device split over ``device_executions`` timed runs, which makes
    ``achieved_gflops``/``achieved_gbps`` measured rates of the analytic
    counts over the stream's span (lower bounds on the busy rate).
    """

    plan_hash: str            # stable digest of the plan fingerprint
    plan_text: str            # fingerprint prefix (human-readable)
    executions: int = 0       # execute_plan calls for this fingerprint
    xla_traces: int = 0       # first executions across signatures
    last_compile_s: float = 0.0  # 0.0: eager torch compiles nothing
    last_lower_s: float = 0.0    # 0.0, as last_compile_s
    sidecar_builds: int = 0   # index-probe sidecar rebuilds for plans
    #                         # sharing this fingerprint
    sidecar_build_s: float = 0.0  # summed wall time of those rebuilds
    flops: float = 0.0        # analytic flops (last new signature)
    bytes_accessed: float = 0.0  # analytic bytes (last new signature)
    peak_memory: int = 0      # allocator growth bound of that run
    device_s_total: float = 0.0   # summed device half of timed runs
    host_s_total: float = 0.0     # summed host half
    device_executions: int = 0    # runs with the time split enabled
    device_flops: float = 0.0     # flops behind the timed runs
    device_bytes: float = 0.0     # bytes behind the timed runs
    created_ts: float = field(default_factory=time.time)
    #: capacity signature -> (flops, bytes) of its first execution
    signatures: dict = field(default_factory=dict, repr=False)

    @property
    def hit_count(self) -> int:
        return max(self.executions - self.xla_traces, 0)

    @property
    def achieved_gflops(self) -> float:
        """Measured GFLOP/s over the timed executions (0.0 until one)."""
        if self.device_s_total <= 0.0:
            return 0.0
        return self.device_flops / self.device_s_total / 1e9

    @property
    def achieved_gbps(self) -> float:
        """Measured GB/s of the analytic bytes over the timed runs."""
        if self.device_s_total <= 0.0:
            return 0.0
        return self.device_bytes / self.device_s_total / 1e9


_PLAN_STATS: dict[str, PlanCacheEntry] = {}
_PLAN_STATS_LOCK = threading.Lock()
_PLAN_STATS_MAX = 4096
_MAX_SIGNATURES = 64  # >> the bucket-ladder rungs a table ever visits


def _stats_for(key: str) -> PlanCacheEntry:
    # registry keyed by digest: full fingerprints are whole-plan reprs
    # (arbitrarily long) and must not be pinned per entry
    digest = hashlib.md5(key.encode()).hexdigest()
    with _PLAN_STATS_LOCK:
        e = _PLAN_STATS.get(digest)
        if e is None:
            if len(_PLAN_STATS) >= _PLAN_STATS_MAX:
                _PLAN_STATS.pop(next(iter(_PLAN_STATS)))
            e = PlanCacheEntry(plan_hash=digest, plan_text=key[:120])
            _PLAN_STATS[digest] = e
        return e


def plan_cache_stats() -> list[PlanCacheEntry]:
    """Snapshot of per-plan execution counters (gv$plan_cache)."""
    with _PLAN_STATS_LOCK:
        return list(_PLAN_STATS.values())


def reset_plan_cache_stats():
    with _PLAN_STATS_LOCK:
        _PLAN_STATS.clear()


class PlanNode:
    """Immutable physical operator spec (≙ ObOpSpec)."""

    def children(self) -> Sequence["PlanNode"]:
        return ()

    def fingerprint(self) -> str:
        """Stable key for the plan cache."""
        return repr(self)


# Optimizer cardinality estimate riding every node (None = unknown);
# excluded from repr/compare so it never changes a fingerprint.
def _est_field():
    return field(default=None, repr=False, compare=False)


@dataclass(repr=True)
class TableScan(PlanNode):
    table: str
    columns: Optional[list[str]] = None  # projection pushdown
    rename: Optional[dict[str, str]] = None  # output qualification
    est_rows: Optional[int] = _est_field()


@dataclass(repr=True)
class Filter(PlanNode):
    child: PlanNode
    pred: ir.Expr
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


@dataclass(repr=True)
class Project(PlanNode):
    child: PlanNode
    outputs: dict  # name -> ir.Expr
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


@dataclass(repr=True)
class GroupBy(PlanNode):
    child: PlanNode
    keys: dict  # name -> ir.Expr
    aggs: list  # list[AggSpec]
    out_capacity: Optional[int] = None
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


@dataclass(repr=True)
class ScalarAgg(PlanNode):
    child: PlanNode
    aggs: list
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


@dataclass(repr=True)
class HashJoin(PlanNode):
    left: PlanNode
    right: PlanNode
    left_keys: list
    right_keys: list
    how: str = "inner"
    out_capacity: Optional[int] = None
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.left, self.right)


@dataclass(repr=True)
class SemiJoinResidual(PlanNode):
    """Semi/anti join with residual (non-equality) predicates."""

    left: PlanNode
    right: PlanNode
    left_keys: list
    right_keys: list
    residual: list
    anti: bool = False
    out_capacity: Optional[int] = None
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.left, self.right)


@dataclass(repr=True)
class IndexProbe(PlanNode):
    """Index nested-loop join into a pre-sorted index sidecar."""

    child: PlanNode
    table: str
    index: str
    key: object          # ir.Expr over the child's columns
    columns: Optional[list[str]] = None
    rename: Optional[dict[str, str]] = None
    out_capacity: Optional[int] = None
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)

    @staticmethod
    def sidecar_name(table: str, index: str) -> str:
        return f"__probe__{table}__{index}"


@dataclass(repr=True)
class Window(PlanNode):
    """Window functions: adds result columns."""

    child: PlanNode
    specs: list  # list[(out_colid, ir.WindowCall)]
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


@dataclass(repr=True)
class Union(PlanNode):
    """UNION ALL (concat); distinct layered via GroupBy above."""

    inputs: list
    est_rows: Optional[int] = _est_field()

    def children(self):
        return tuple(self.inputs)


@dataclass(repr=True)
class Sort(PlanNode):
    child: PlanNode
    keys: list
    ascending: Optional[list] = None
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


@dataclass(repr=True)
class Limit(PlanNode):
    child: PlanNode
    k: int
    offset: int = 0
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


@dataclass(repr=True)
class Compact(PlanNode):
    """Explicit cardinality-reduction point (densify live rows);
    ``strict`` surfaces rows beyond ``capacity`` on the overflow lane."""

    child: PlanNode
    capacity: Optional[int] = None
    strict: bool = False
    est_rows: Optional[int] = _est_field()

    def children(self):
        return (self.child,)


# ---------------------------------------------------------------------------
# plan-quality metadata: logical hash + estimate propagation
# ---------------------------------------------------------------------------


def _logical_repr(node: PlanNode) -> str:
    """Capacity-insensitive rendering: two plans that differ only in
    their static budgets (out_capacity scaling after CapacityOverflow)
    or estimates render identically — the key the cardinality-feedback
    store and the plan-regression watchdog aggregate on."""
    parts = []
    for k, v in vars(node).items():
        if k in ("out_capacity", "capacity", "est_rows") or \
                k.startswith("_"):
            continue
        if isinstance(v, PlanNode) or k in ("child", "left", "right",
                                            "inputs"):
            continue
        if isinstance(v, str) and k in ("table", "index", "name"):
            # hex-protect object identifiers: the colid normalization
            # below strips ``_<digits>`` suffixes, which would conflate
            # events_2024 and events_2025 into ONE feedback/history key
            # (capacity corrections and regression baselines would leak
            # across distinct tables); hex output contains no
            # underscores, so the regex cannot touch it
            parts.append(f"{k}={v.encode().hex()}")
            continue
        parts.append(f"{k}={v!r}")
    kids = ",".join(_logical_repr(c) for c in node.children())
    return f"{type(node).__name__}({','.join(parts)})[{kids}]"


_COLID_SEQ = re.compile(r"_\d+\b")


def logical_hash(node: PlanNode) -> str:
    """Stable digest of the plan MINUS capacities/estimates: the
    gv$plan_feedback / gv$plan_history key (a capacity retry or a stats
    refresh must not open a fresh history).

    Binder colids embed a session-global counter (``a_k_5``, ``o_9``),
    so the raw repr would hash differently on every rebind of the same
    statement — the counter suffixes are normalized away.  Table/index
    identifiers are hex-protected in _logical_repr so distinct tables
    never share a key; a string LITERAL ending in ``_<digits>`` still
    normalizes (worst case: two same-shaped predicates share one
    history, and apply_feedback's op-name check guards corrections).

    Memoized on the node (plans are treated as immutable once built;
    cached plans would otherwise pay the whole-tree render + digest on
    every execution)."""
    h = node.__dict__.get("_logical_hash")
    if h is None:
        text = _COLID_SEQ.sub("", _logical_repr(node))
        h = hashlib.md5(text.encode()).hexdigest()[:16]
        node.__dict__["_logical_hash"] = h
    return h


def propagate_estimates(node: PlanNode,
                        row_counts: dict | None = None) -> PlanNode:
    """Fill missing ``est_rows`` from the children (post-bind pass): the
    binder annotates the nodes it has real estimates for; everything
    else inherits a defensible bound so EVERY operator row in
    gv$sql_plan_monitor carries an estimate to q-error against.
    ``row_counts`` maps table -> live rows for un-annotated scans."""
    kids: dict = {}
    changed = False
    for fname in ("child", "left", "right"):
        if hasattr(node, fname):
            old = getattr(node, fname)
            nv = propagate_estimates(old, row_counts)
            kids[fname] = nv
            changed = changed or nv is not old
    if hasattr(node, "inputs"):
        nv_list = [propagate_estimates(c, row_counts)
                   for c in node.inputs]
        kids["inputs"] = nv_list
        changed = changed or any(a is not b for a, b in
                                 zip(nv_list, node.inputs))
    est = node.est_rows
    if est is None:
        if isinstance(node, TableScan):
            est = (row_counts or {}).get(node.table)
        elif isinstance(node, ScalarAgg):
            est = 1
        elif isinstance(node, Limit):
            ce = kids["child"].est_rows
            k = node.k + (node.offset or 0)
            est = k if ce is None else min(k, ce)
        elif isinstance(node, Union):
            subs = [c.est_rows for c in kids["inputs"]]
            known = [s for s in subs if s is not None]
            est = sum(known) if known else None
        elif isinstance(node, (HashJoin, SemiJoinResidual)):
            le = kids["left"].est_rows
            re_ = kids["right"].est_rows
            known = [v for v in (le, re_) if v is not None]
            est = max(known) if known else None
        elif "child" in kids:
            # single-child pass-through (Filter/Project/Sort/Window/
            # Compact/GroupBy without a binder estimate): the child's
            # cardinality is an upper bound
            est = kids["child"].est_rows
    if est is not None:
        est = max(int(est), 1)
    if est == node.est_rows and not changed:
        return node
    updates = dict(kids)
    if est != node.est_rows:
        updates["est_rows"] = est
    return dataclasses.replace(node, **updates)


def q_error(est: int | None, act: int) -> float:
    """Symmetric misestimate factor max(est/act, act/est), >= 1.0
    (0.0 = no estimate to compare).  The CBO literature's q-error."""
    if est is None:
        return 0.0
    e = max(float(est), 1.0)
    a = max(float(act), 1.0)
    return max(e / a, a / e)


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


# pass-through operators preserve cardinality exactly (their output
# rows ≡ the child's), so a monitor lane on them would duplicate the
# child's ledger row; ``monitored_op`` also defines the positions
# ``sql/optimizer.py::apply_feedback`` reads
PASSTHROUGH_OPS = ("Project", "Sort", "Compact", "Window")


def monitored_op(node: PlanNode, parent: "PlanNode | None" = None) -> bool:
    """Does this operator get its own estimate-vs-actual ledger row?

    Pass-through operators never do.  An inner Filter of a conjunct
    chain doesn't either: only the TOPMOST filter's output cardinality
    reaches the rest of the plan, and the binder splits one WHERE into
    a Filter per conjunct — monitoring each would pay one mask
    reduction per conjunct for rows that duplicate the chain head's."""
    if type(node).__name__ in PASSTHROUGH_OPS:
        return False
    return not (isinstance(node, Filter) and isinstance(parent, Filter))


def monitored_postorder(node: PlanNode,
                        parent: "PlanNode | None" = None) -> list:
    """The plan nodes that emit monitor lanes, in executor postorder —
    1:1 with a monitored execution's op_stats rows."""
    out = []
    for c in node.children():
        out.extend(monitored_postorder(c, node))
    if monitored_op(node, parent):
        out.append(node)
    return out


# analytic cost walk (module docstring): active only at a signature's
# first execution; maps id(node) -> the relation it lowered to, plus the
# running [flops, bytes]
_costs: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "ob_torch_costs", default=None)


def _tensors(rel: Relation):
    for c in rel.columns.values():
        yield c.data
        if c.valid is not None:
            yield c.valid
    if rel.mask is not None:
        yield rel.mask


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_inputs(node: PlanNode, tables: dict, lowered: dict) -> list:
    ins = []
    for c in node.children():
        r = lowered.get(id(c))
        if r is None and isinstance(c, Sort):
            r = lowered.get(id(c.child))  # fused top-N: Sort not lowered
        if r is not None:
            ins.append(r)
    if isinstance(node, IndexProbe):
        ins.append(tables[IndexProbe.sidecar_name(node.table, node.index)])
        ins.append(tables[node.table])
    return ins


def _count_op(acc: dict, node: PlanNode, tables: dict, rel: Relation):
    lowered = acc["lowered"]
    lowered[id(node)] = rel
    if isinstance(node, TableScan):
        return  # a scan is a view of the stored columns: moves nothing
    ins = _op_inputs(node, tables, lowered)
    seen = set()
    nbytes = 0
    for r in ins:
        for t in _tensors(r):
            seen.add((t.data_ptr(), t.numel()))
            nbytes += _nbytes(t)
    for t in _tensors(rel):
        if (t.data_ptr(), t.numel()) not in seen:
            nbytes += _nbytes(t)
    acc["flops"] += float(sum(r.capacity for r in ins))
    acc["bytes"] += float(nbytes)


def _lower(node: PlanNode, tables: dict[str, Relation],
           parent: "PlanNode | None" = None) -> Relation:
    rel = _lower_inner(node, tables)
    # per-operator row accounting (no-op unless a monitor is collecting);
    # the optimizer's static estimate rides along host-side so the
    # monitor can q-error it against the measured count
    if diag.monitor_collecting() and monitored_op(node, parent):
        cnt = (rel.mask.sum(dtype=torch.int64) if rel.mask is not None
               else torch.full((), rel.capacity, dtype=torch.int64,
                               device=rel.device))
        diag.monitor_push(type(node).__name__, cnt, est=node.est_rows)
    acc = _costs.get()
    if acc is not None:
        _count_op(acc, node, tables, rel)
    return rel


def _lower_inner(node: PlanNode, tables: dict[str, Relation]) -> Relation:
    if isinstance(node, TableScan):
        rel = tables[node.table]
        if node.columns is not None:
            rel = rel.select(node.columns)
        if node.rename:
            rel = Relation(
                columns={node.rename.get(n, n): c
                         for n, c in rel.columns.items()},
                mask=rel.mask,
            )
        return rel
    if isinstance(node, Filter):
        return ops.filter_rows(_lower(node.child, tables, node), node.pred)
    if isinstance(node, Project):
        return ops.project(_lower(node.child, tables, node), node.outputs)
    if isinstance(node, GroupBy):
        return ops.hash_groupby(_lower(node.child, tables, node),
                                node.keys, node.aggs,
                                out_capacity=node.out_capacity)
    if isinstance(node, ScalarAgg):
        return ops.scalar_agg(_lower(node.child, tables, node), node.aggs)
    if isinstance(node, HashJoin):
        return ops.join(
            _lower(node.left, tables, node),
            _lower(node.right, tables, node),
            node.left_keys, node.right_keys, how=node.how,
            out_capacity=node.out_capacity,
        )
    if isinstance(node, IndexProbe):
        return ops.index_probe(
            _lower(node.child, tables, node),
            tables[IndexProbe.sidecar_name(node.table, node.index)],
            tables[node.table], node.key, node.columns, node.rename,
            out_capacity=node.out_capacity,
        )
    if isinstance(node, SemiJoinResidual):
        return ops.semi_join_residual(
            _lower(node.left, tables, node),
            _lower(node.right, tables, node),
            node.left_keys, node.right_keys, node.residual,
            anti=node.anti, out_capacity=node.out_capacity,
        )
    if isinstance(node, Union):
        return ops.concat([_lower(c, tables, node) for c in node.inputs])
    if isinstance(node, Window):
        return window_op(_lower(node.child, tables, node), node.specs)
    if isinstance(node, Sort):
        return ops.sort_rows(_lower(node.child, tables, node), node.keys,
                             node.ascending)
    if isinstance(node, Limit):
        child = node.child
        if (isinstance(child, Sort) and node.offset == 0
                and node.k <= 4096 and len(child.keys) == 1):
            # fused top-N, as the reference lowers it: the Sort never
            # lowers, so its child's monitor lane parents to the Limit
            asc = child.ascending[0] if child.ascending else True
            return ops.top_n(_lower(child.child, tables, node),
                             child.keys[0], asc, node.k)
        return ops.limit(_lower(node.child, tables, node), node.k,
                         node.offset)
    if isinstance(node, Compact):
        return ops.compact(_lower(node.child, tables, node),
                           node.capacity, strict=node.strict)
    raise NotImplementedError(type(node).__name__)


def referenced_tables(node: PlanNode) -> set[str]:
    out = set()
    if isinstance(node, (TableScan, IndexProbe)):
        out.add(node.table)
    for c in node.children():
        out |= referenced_tables(c)
    return out


def index_probes(plan: PlanNode) -> list:
    """The plan's IndexProbe nodes."""
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, IndexProbe):
            out.append(node)
        stack.extend(node.children())
    return out


def build_sidecar(catalog, node: IndexProbe, rel: Relation) -> Relation:
    """The sorted index sidecar ``node`` reads, built from the base
    relation ``rel``: ``__key__`` the index column over its live valid
    rows, stably sorted and padded to the bucket ladder with
    ``_INT_MAX``; ``__pos__`` the matching positions into ``rel``.

    Built on ``rel``'s device with a stable ``torch.sort`` (the same
    permutation as the reference's stable numpy argsort, so the same
    sidecar).  Reading the live count to size it is its one host sync."""
    td = catalog.table_def(node.table)
    ix = next(i for i in td.indexes if i.name == node.index)
    col = rel.columns[ix.columns[0]]
    live = col.valid_or_true() & rel.mask_or_true()
    # the sidecar's one read sizes it, once per build (catalog-cached)
    # obcheck: ok(trace.host-sync)
    pos = torch.nonzero(live).reshape(-1)
    keys, order = torch.sort(col.data.to(torch.int64).index_select(0, pos),
                             stable=True)
    n = keys.shape[0]
    cap = bucket_capacity(max(n, 1))
    pk = torch.full((cap,), ops._INT_MAX, dtype=torch.int64,
                    device=keys.device)
    ppos = torch.zeros(cap, dtype=torch.int64, device=keys.device)
    pk[:n] = keys
    ppos[:n] = pos.index_select(0, order)
    return Relation(columns={
        "__key__": Column(pk, None, SqlType.int_()),
        "__pos__": Column(ppos, None, SqlType.int_())}, mask=None)


def prepare_index_probes(catalog, plan: PlanNode,
                         tables: dict[str, Relation]) -> None:
    """Inject the sidecar (``build_sidecar``) of every IndexProbe in
    ``plan`` into ``tables``, in place.  Sidecars are cached on the
    catalog for the relation they were built from: a DML statement
    installs a new relation, so the next execution rebuilds.  A rebuild
    is timed into the statement's ``sidecar_build_s`` phase and counted
    per plan fingerprint (gv$plan_cache.sidecar_builds).

    Every executor entry point that lowers a plan over catalog tables
    calls this first: session execution, EXPLAIN and bind-time
    scalar-subquery folding."""
    for node in index_probes(plan):
        rel = tables.get(node.table)
        if rel is None:
            continue  # a missing base table fails in _lower, not here
        sidecar = catalog.sidecar(node.table, node.index, rel)
        if sidecar is None:
            tb = time.perf_counter()
            sidecar = build_sidecar(catalog, node, rel)
            catalog.cache_sidecar(node.table, node.index, rel, sidecar)
            dt = time.perf_counter() - tb
            st = _plan_stats(plan)
            st.sidecar_builds += 1
            st.sidecar_build_s += dt
            qmetrics.inc("plan.sidecar_builds", table=node.table)
            qmetrics.observe("plan.sidecar_build_s", dt, table=node.table)
            add_exec_times(sidecar_build_s=dt)
        tables[IndexProbe.sidecar_name(node.table, node.index)] = sidecar


def plan_fingerprint(plan: PlanNode) -> str:
    """``plan.fingerprint()`` memoized on the node, as ``logical_hash``
    is (plans are not mutated once built): a whole-plan repr costs
    milliseconds for a plan with long literal lists."""
    key = plan.__dict__.get("_fingerprint")
    if key is None:
        key = plan.__dict__["_fingerprint"] = plan.fingerprint()
    return key


def _plan_stats(plan: PlanNode) -> PlanCacheEntry:
    """The plan's gv$plan_cache entry (its digest memoized too)."""
    st = plan.__dict__.get("_plan_stats")
    if st is None or _PLAN_STATS.get(st.plan_hash) is not st:
        st = plan.__dict__["_plan_stats"] = _stats_for(
            plan_fingerprint(plan))
    return st


def _input_signature(tables: dict[str, Relation]) -> tuple:
    """The capacity signature: per input table its name, capacity, mask
    presence and column dtypes (host metadata only)."""
    return tuple(
        (name, rel.capacity, rel.mask is None,
         tuple((c, col.data.dtype, col.valid is None)
               for c, col in sorted(rel.columns.items())))
        for name, rel in sorted(tables.items()))


# per-thread statement-scoped first-execution marker: the session resets
# it before a statement's retry ladder, and the plan-regression watchdog
# skips samples that paid a first execution at a new signature (or a
# retry replay), as the reference skips samples that paid an XLA compile
_exec_flags = threading.local()


def reset_compile_flag():
    _exec_flags.compiled = False


def compile_flag() -> bool:
    """Did a first execution at a new signature happen on this thread
    since the last reset_compile_flag()?"""
    return bool(getattr(_exec_flags, "compiled", False))


def mark_compiled():
    """Flag this thread's statement as having paid a first execution at
    a new signature (a PX program's first run at its signature)."""
    _exec_flags.compiled = True


# ---------------------------------------------------------------------------
# host/device time split: when enabled, execute_plan records a CUDA event
# pair around its launches and reads it after the result boundary, so
# every execution records host_s and device_s separately.  Process-global
# like the metrics flag; Database wires it to ``enable_profiling``.
# ---------------------------------------------------------------------------

_TIME_SPLIT = True


def set_time_split(on: bool):
    global _TIME_SPLIT
    _TIME_SPLIT = bool(on)


def time_split_enabled() -> bool:
    return _TIME_SPLIT


@dataclass
class ExecTimes:
    """Per-statement execution accounting, accumulated across every
    execute_plan call (retries, granule chunks, spill sub-plans).
    ``flops``/``bytes`` are the analytic counts of the executed plans —
    the numerators the roofline prediction prices against ``calls``
    launches of measured ``device_s``.

    The named phases decompose the host half (the gv$time_model rows):
    ``bind_s`` parse/optimize/bind (session-recorded), ``sidecar_build_s``
    index-probe sidecar rebuilds, ``lower_s``/``compile_s`` (0.0 in the
    port: nothing is traced or compiled), ``dispatch_s`` the host half
    of each execution, ``merge_s`` the DTL coordinator's host-side
    concatenation of fragment replies (``px/dtl.py``).

    ``device_s`` is each execution's stream span, which overlaps its
    ``dispatch_s`` (the host launches while the card runs).
    ``device_wait_s`` is the part of each span past its execution's
    host window: what the host waits for after it has launched the
    last kernel, the reference's device phase (a ``block_until_ready``
    after dispatch).  gv$time_model charges it as its ``device_s``, so
    its phases stay disjoint slices of the statement's wall (ROADMAP
    Queue 3 #33)."""

    host_s: float = 0.0
    device_s: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    calls: int = 0
    bind_s: float = 0.0
    sidecar_build_s: float = 0.0
    lower_s: float = 0.0
    compile_s: float = 0.0
    dispatch_s: float = 0.0
    merge_s: float = 0.0
    device_wait_s: float = 0.0

    #: the host-phase decomposition, in pipeline order (shared by
    #: gv$sql_audit columns and gv$time_model rows)
    PHASES = ("bind_s", "sidecar_build_s", "lower_s", "compile_s",
              "dispatch_s", "merge_s")

    def phase_sum(self) -> float:
        """Sum of the named host phases + device_s."""
        return (self.bind_s + self.sidecar_build_s + self.lower_s
                + self.compile_s + self.dispatch_s + self.merge_s
                + self.device_s)

    def worst_phase(self) -> tuple[str, float]:
        """(phase name, seconds) of the dominant host phase — the
        EXPLAIN ANALYZE roofline callout."""
        name = max(self.PHASES, key=lambda p: getattr(self, p))
        return name, getattr(self, name)


def _exec_acc() -> ExecTimes:
    acc = getattr(_exec_flags, "times", None)
    if acc is None:
        acc = _exec_flags.times = ExecTimes()
    return acc


def _pending() -> list:
    p = getattr(_exec_flags, "pending", None)
    if p is None:
        p = _exec_flags.pending = []
    return p


def reset_exec_times():
    """Statement start: the session clears the accumulator alongside
    reset_compile_flag(); executions a caller never resolved are
    dropped with it."""
    _exec_flags.times = ExecTimes()
    _exec_flags.pending = []


def exec_times() -> ExecTimes:
    """Snapshot of this thread's statement-scoped accumulator, after
    resolving the executions whose event pairs have completed."""
    resolve_pending()
    acc = _exec_acc()
    return ExecTimes(acc.host_s, acc.device_s, acc.flops, acc.bytes,
                     acc.calls, acc.bind_s, acc.sidecar_build_s,
                     acc.lower_s, acc.compile_s, acc.dispatch_s,
                     acc.merge_s, acc.device_wait_s)


def add_exec_times(host_s: float = 0.0, device_s: float = 0.0,
                   flops: float = 0.0, bytes: float = 0.0,  # noqa: A002
                   calls: int = 0, bind_s: float = 0.0,
                   sidecar_build_s: float = 0.0, lower_s: float = 0.0,
                   compile_s: float = 0.0, dispatch_s: float = 0.0,
                   merge_s: float = 0.0):
    """Fold externally measured work into the statement accumulator
    (the session records bind_s, prepare_index_probes sidecar_build_s;
    a DTL coordinator its remote fragments' device seconds, which it
    waits for and never overlaps with its own dispatch)."""
    acc = _exec_acc()
    acc.host_s += float(host_s)
    acc.device_s += float(device_s)
    acc.device_wait_s += float(device_s)
    acc.flops += float(flops)
    acc.bytes += float(bytes)
    acc.calls += int(calls)
    acc.bind_s += float(bind_s)
    acc.sidecar_build_s += float(sidecar_build_s)
    acc.lower_s += float(lower_s)
    acc.compile_s += float(compile_s)
    acc.dispatch_s += float(dispatch_s)
    acc.merge_s += float(merge_s)


class _Execution:
    """One execution whose device time and monitor counts are read
    after its result boundary (``_finish``)."""

    __slots__ = ("stats", "root_op", "ev0", "ev1", "done", "wall_s",
                 "host_s", "flops", "nbytes", "mon", "n_mon", "pinned",
                 "mon_names", "mon_ests", "monitor_out", "tags", "tctx",
                 "span_id", "op_spans")


_PENDING_MAX = 64  # bound for callers that never read their results
_PIN_SLOTS = 64    # int64 slots of one pooled pinned buffer


def _pinned(n: int) -> torch.Tensor:
    """A pinned host buffer of at least ``n`` int64 slots from this
    thread's pool: allocating pinned memory per execution would make the
    allocator's host allocations part of the execution."""
    pool = getattr(_exec_flags, "pinned", None)
    if pool is None:
        pool = _exec_flags.pinned = []
    for i, buf in enumerate(pool):
        if buf.numel() >= n:
            return pool.pop(i)
    return torch.empty(max(n, _PIN_SLOTS), dtype=torch.int64,
                       pin_memory=True)


def _unpin(buf: torch.Tensor):
    pool = _exec_flags.pinned
    if len(pool) < _PENDING_MAX + 1:
        pool.append(buf)


def resolve_pending(block: bool = False):
    """Finish this thread's executions whose fence events completed
    (all of them on the CPU).  ``block`` waits for the rest — for
    callers that never read a result themselves (EXPLAIN ANALYZE of a
    plan without overflow lanes); a session reads its result first,
    after which every fence has completed and nothing waits."""
    pend = _pending()
    keep = []
    for ex in pend:
        if ex.done is not None and not ex.done.query():
            if not block:
                keep.append(ex)
                continue
            # only block=True waits (EXPLAIN ANALYZE, exec_times)
            # obcheck: ok(trace.host-sync)
            ex.done.synchronize()
        _finish(ex)
    pend[:] = keep


def _finish(ex: _Execution, mon_vals: list | None = None):
    """Fold one execution's device half and monitor rows in; runs once
    its fence (the event pair's end, or the pinned copy's own event when
    the time split is off) has completed, so nothing here waits."""
    device_s = 0.0
    if ex.ev0 is not None:
        device_s = ex.ev0.elapsed_time(ex.ev1) / 1e3
    st = ex.stats
    acc = _exec_acc()
    acc.device_s += device_s
    acc.device_wait_s += max(device_s - ex.host_s, 0.0)
    if st is None:
        return  # a device_span: the statement's split only
    elapsed = max(ex.wall_s, device_s)
    if _TIME_SPLIT:
        st.device_s_total += device_s
        st.host_s_total += ex.host_s
        st.device_executions += 1
        st.device_flops += ex.flops
        st.device_bytes += ex.nbytes
        qmetrics.observe("plan.host_s", ex.host_s, op=ex.root_op)
        qmetrics.observe("plan.device_s", device_s, op=ex.root_op)
        ex.tags["host_s"] = round(ex.host_s, 6)
        ex.tags["device_s"] = round(device_s, 6)
    qmetrics.observe("plan.execute_s", elapsed, op=ex.root_op)
    if mon_vals is None:
        if ex.mon is None:
            return
        # host memory: a pinned copy whose fence has passed, or the CPU
        mon_vals = ex.mon[:ex.n_mon].tolist()
        if ex.pinned:
            _unpin(ex.mon)
    ests = ex.mon_ests
    op_rows = []
    for i, (n, v) in enumerate(zip(ex.mon_names, mon_vals)):
        act = int(v)
        op_rows.append({"op": n, "pos": i, "est": ests[i], "rows": act,
                        "q_error": q_error(ests[i], act),
                        "elapsed_s": 0.0})
    if op_rows:
        # the operators' launches overlap on the stream, so per-op time
        # is not separable without a sync per operator; the root
        # carries the plan total, as in the reference
        op_rows[-1]["elapsed_s"] = elapsed
        worst = max(op_rows, key=lambda r: r["q_error"])
        if worst["q_error"] > 0.0:
            qmetrics.observe("plan.qerror", worst["q_error"])
    ex.monitor_out.extend(op_rows)
    if not ex.op_spans:
        return
    qtrace.add_spans_to(ex.tctx, ex.span_id, [
        ("op." + r["op"], 0.0,
         {"rows": r["rows"], "est": r["est"] or 0,
          "q": round(r["q_error"], 3)})
        for r in op_rows])


class device_span:
    """Time a stretch of device work that does not run through
    ``execute_plan`` (the spill tier's batches) into the statement's
    split: ``host_s`` gets its wall time, and ``device_s`` the CUDA
    event pair recorded at entry and exit, read by ``resolve_pending``
    once the caller's result read has passed (nothing waits here)."""

    __slots__ = ("device", "_t0", "_ex")

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self._t0 = time.perf_counter()
        ex = self._ex = _Execution()
        ex.ev0 = ex.ev1 = None
        if _TIME_SPLIT and self.device.type == "cuda":
            ex.ev0 = torch.cuda.Event(enable_timing=True)
            ex.ev1 = torch.cuda.Event(enable_timing=True)
            ex.ev0.record()
        ex.done = ex.ev1
        return self

    def __exit__(self, et, ev, tb):
        ex = self._ex
        if ex.ev1 is not None:
            ex.ev1.record()
        wall = time.perf_counter() - self._t0
        _exec_acc().host_s += wall
        ex.host_s = wall
        if ex.ev0 is not None and et is None:
            ex.stats = None
            _pending().append(ex)
        return False


def execute_plan(plan: PlanNode, tables: dict[str, Relation],
                 monitor_out: list | None = None,
                 monitor_collect: bool = True,
                 op_spans: bool = True) -> Relation:
    """Run a plan against device tables, eagerly, on their device.

    Raises diag.CapacityOverflow when any static-capacity operator
    overflowed — results would be silently truncated otherwise; the
    caller re-plans with larger budgets.  IndexProbe sidecars must
    already be in ``tables`` (``prepare_index_probes``).

    The overflow lanes and, when ``monitor_out`` is given and
    ``monitor_collect`` is true, the monitored operators' row counts are
    stacked into one tensor; with overflow lanes present it is read
    once (the one host sync of an execution) and ``monitor_out`` is
    filled before return.  Without overflow lanes nothing is read: the
    counts go to pinned host memory without blocking, behind a fence
    event, and ``monitor_out`` is filled by ``resolve_pending``
    (``exec_times``) once that fence has passed — at the latest after
    the caller has read its result.  Under an active trace each ledger
    row also becomes an ``op.<name>`` span under ``plan.execute``, unless
    ``op_spans`` is false (a DTL fragment: its rows ship back as a bare
    list, and per-op spans would cost the reply wire bytes).

    A statement's cancel/deadline checkpoint (``server/admission.py``)
    runs at entry and after the overflow check: a flag and a clock read
    on the host, no device sync.
    """
    qadmission.checkpoint()
    t0 = time.perf_counter()
    pend = _pending()
    if pend:
        resolve_pending()
        del pend[:-_PENDING_MAX]
    needed = referenced_tables(plan)
    # sidecars are injected relations, not catalog tables, so
    # referenced_tables leaves them out; keep them past the filter below
    needed |= {IndexProbe.sidecar_name(n.table, n.index)
               for n in index_probes(plan)}
    sub = {k: v for k, v in tables.items() if k in needed}
    st = _plan_stats(plan)
    sig = _input_signature(sub)
    cost = st.signatures.get(sig)
    first = cost is None
    dev = next(iter(sub.values())).device if sub else torch.device("cpu")
    on_cuda = dev.type == "cuda"
    split = _TIME_SPLIT and on_cuda
    collect = monitor_out is not None and monitor_collect
    ex = _Execution()
    ex.stats, ex.root_op = st, type(plan).__name__
    ex.ev0 = ex.ev1 = ex.mon = None
    ex.pinned = False
    ex.monitor_out = monitor_out
    ex.op_spans = op_spans
    # full-link trace: one HOST-side span per plan execution
    with qtrace.span("plan.execute", plan_hash=st.plan_hash) as tsp:
        ex.tags = tsp.tags
        ex.tctx = qtrace.current()
        ex.span_id = getattr(tsp, "span_id", 0)
        if first and on_cuda:
            alloc0 = torch.cuda.memory_allocated(dev)
        if split:
            ex.ev0 = torch.cuda.Event(enable_timing=True)
            ex.ev1 = torch.cuda.Event(enable_timing=True)
            ex.ev0.record()
        ex.done = ex.ev1
        acc_tok = _costs.set({"lowered": {}, "flops": 0.0, "bytes": 0.0}
                             if first else None)
        try:
            with diag.collect() as entries:
                if collect:
                    with diag.monitor_collect() as mons:
                        out = _lower(plan, sub)
                else:
                    out = _lower(plan, sub)
                    mons = []
            cacc = _costs.get()
        finally:
            _costs.reset(acc_tok)
        lanes = [torch.clamp(v.to(torch.int64), min=0)
                 for _n, v, _cap in entries]
        counts = [v.to(torch.int64) for _n, _e, v in mons]
        vec = torch.stack(lanes + counts) if lanes or counts else None
        wait = 0.0
        vals = None
        if lanes:
            if split:
                ex.ev1.record()
            tw = time.perf_counter()
            # obcheck: ok(trace.host-sync) the one host read of the execution
            vals = vec.tolist()
            wait = time.perf_counter() - tw
        elif counts:
            ex.n_mon, ex.pinned = len(counts), on_cuda
            if on_cuda:
                host = _pinned(len(counts))
                host[:len(counts)].copy_(vec, non_blocking=True)
            else:
                host = vec
            ex.mon = host
            if split:
                ex.ev1.record()
            elif on_cuda:
                # no timing pair to wait on: the copy gets its own fence
                ex.done = torch.cuda.Event()
                ex.done.record()
        elif split:
            ex.ev1.record()
        wall = time.perf_counter() - t0
        ex.wall_s = wall
        ex.host_s = max(wall - wait, 0.0)
        if first:
            cost = (cacc["flops"], cacc["bytes"]) if cacc else (0.0, 0.0)
            if len(st.signatures) >= _MAX_SIGNATURES:
                st.signatures.pop(next(iter(st.signatures)))
            st.signatures[sig] = cost
            st.xla_traces += 1
            st.flops, st.bytes_accessed = cost
            if on_cuda:
                st.peak_memory = int(
                    torch.cuda.max_memory_allocated(dev) - alloc0)
            qmetrics.inc("plan.compiles")
            qmetrics.inc("plan.flops_compiled", int(cost[0]))
            qmetrics.inc("plan.bytes_compiled", int(cost[1]))
            _exec_flags.compiled = True
            tsp.tags["compiled"] = 1
        ex.flops, ex.nbytes = cost
        st.executions += 1
        qmetrics.inc("plan.flops_executed", int(cost[0]))
        qmetrics.inc("plan.bytes_executed", int(cost[1]))
        qmetrics.inc("plan.executions", op=ex.root_op)
        acc = _exec_acc()
        acc.host_s += ex.host_s
        acc.dispatch_s += ex.host_s
        acc.flops += cost[0]
        acc.bytes += cost[1]
        acc.calls += 1
        if collect:
            # estimates come from the CURRENT plan: a re-bound plan
            # reports its own refreshed est_rows
            live = monitored_postorder(plan)
            ex.mon_names = [n for n, _e, _v in mons]
            ex.mon_ests = ([n.est_rows for n in live]
                           if len(live) == len(mons)
                           else [e for _n, e, _v in mons])
    if vals is not None:
        n_lanes = len(lanes)
        # monitor rows first, as the reference fills them before its
        # overflow check (a retrying caller clears them)
        _finish(ex, vals[n_lanes:] if collect else None)
        if any(v > 0 for v in vals[:n_lanes]):
            drops = [(n, cap, v) for (n, _v, cap), v in
                     zip(entries, vals[:n_lanes]) if v > 0]
            detail = ", ".join(f"{n}={v}" for n, _cap, v in drops)
            raise diag.CapacityOverflow(
                f"operator capacity exceeded ({detail} rows dropped); "
                f"re-plan with larger out_capacity", drops=drops,
            )
    else:
        pend.append(ex)
    # operator-close checkpoint: a killed or expired statement unwinds at
    # the result boundary
    qadmission.checkpoint()
    return out


def check_overflow(entries: list) -> None:
    """Raise diag.CapacityOverflow when any lane a ``diag.collect()``
    gathered dropped rows.  The lanes sum on the device into one scalar,
    and reading it is the one host read (none without lanes); the
    per-lane detail is read only on the error path."""
    if not entries:
        return
    lanes = torch.stack([torch.clamp(v.to(torch.int64), min=0)
                         for _n, v, _cap in entries])
    # obcheck: ok(trace.host-sync) the one host read of a chunk plan
    if int(lanes.sum()) > 0:
        # obcheck: ok(trace.host-sync) the error path's per-lane detail
        vals = lanes.cpu().tolist()
        drops = [(n, cap, v)
                 for (n, _v, cap), v in zip(entries, vals) if v > 0]
        detail = ", ".join(f"{n}={v}" for n, _cap, v in drops)
        raise diag.CapacityOverflow(
            f"operator capacity exceeded ({detail} rows dropped); "
            f"re-plan with larger out_capacity", drops=drops,
        )
