"""Physical plan nodes + the eager plan executor.

Port of ``oceanbase_tpu/exec/plan.py``.  The plan nodes are the same
dataclasses, so plans are built the same way.  ``execute_plan`` lowers the
tree operator by operator over masked ``Relation``s on the tables' device
and keeps the reference's overflow contract: every static-capacity
operator pushes a device scalar, the executor sums them into ONE device
scalar and reads it once at the result boundary — the only host sync of
an execution — and reads the per-lane detail only on the error path.

The plan-quality metadata the binder and optimizer use is copied as it
is (``logical_hash``, ``propagate_estimates``, ``monitored_op``), so a
plan bound by the port hashes like the JAX package's.

There is no jit counterpart: torch runs eagerly.  ``execute_plan``
observes the statement's cancel/deadline checkpoint
(``server/admission.py``) at entry and at close.  The XLA executable
cache, the metrics/trace hooks and the plan-monitor lanes are not
ported yet (ROADMAP Queue 1 item 9).  ``prepare_index_probes``
builds the sorted sidecar an ``IndexProbe`` reads on the base table's
device and caches it on the catalog.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.exec import diag, ops
from oceanbase_tpu_torch.exec.window import window as window_op
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.vector.column import (
    Column,
    Relation,
    bucket_capacity,
)


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


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


# pass-through operators preserve cardinality exactly (their output
# rows ≡ the child's), so they get no ledger row; ``monitored_op``
# defines the positions ``sql/optimizer.py::apply_feedback`` reads (the
# plan-monitor lanes themselves wait for ROADMAP Queue 1 item 9)
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


def _lower(node: PlanNode, tables: dict[str, Relation]) -> Relation:
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
        return ops.filter_rows(_lower(node.child, tables), node.pred)
    if isinstance(node, Project):
        return ops.project(_lower(node.child, tables), node.outputs)
    if isinstance(node, GroupBy):
        return ops.hash_groupby(_lower(node.child, tables), node.keys,
                                node.aggs, out_capacity=node.out_capacity)
    if isinstance(node, ScalarAgg):
        return ops.scalar_agg(_lower(node.child, tables), node.aggs)
    if isinstance(node, HashJoin):
        return ops.join(
            _lower(node.left, tables), _lower(node.right, tables),
            node.left_keys, node.right_keys, how=node.how,
            out_capacity=node.out_capacity,
        )
    if isinstance(node, IndexProbe):
        return ops.index_probe(
            _lower(node.child, tables),
            tables[IndexProbe.sidecar_name(node.table, node.index)],
            tables[node.table], node.key, node.columns, node.rename,
            out_capacity=node.out_capacity,
        )
    if isinstance(node, SemiJoinResidual):
        return ops.semi_join_residual(
            _lower(node.left, tables), _lower(node.right, tables),
            node.left_keys, node.right_keys, node.residual,
            anti=node.anti, out_capacity=node.out_capacity,
        )
    if isinstance(node, Union):
        return ops.concat([_lower(c, tables) for c in node.inputs])
    if isinstance(node, Window):
        return window_op(_lower(node.child, tables), node.specs)
    if isinstance(node, Sort):
        return ops.sort_rows(_lower(node.child, tables), node.keys,
                             node.ascending)
    if isinstance(node, Limit):
        child = node.child
        if (isinstance(child, Sort) and node.offset == 0
                and node.k <= 4096 and len(child.keys) == 1):
            # fused top-N, as the reference lowers it
            asc = child.ascending[0] if child.ascending else True
            return ops.top_n(_lower(child.child, tables), child.keys[0],
                             asc, node.k)
        return ops.limit(_lower(node.child, tables), node.k, node.offset)
    if isinstance(node, Compact):
        return ops.compact(_lower(node.child, tables), node.capacity,
                           strict=node.strict)
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
    installs a new relation, so the next execution rebuilds.

    Every executor entry point that lowers a plan over catalog tables
    calls this first: session execution, EXPLAIN and bind-time
    scalar-subquery folding."""
    for node in index_probes(plan):
        rel = tables.get(node.table)
        if rel is None:
            continue  # a missing base table fails in _lower, not here
        sidecar = catalog.sidecar(node.table, node.index, rel)
        if sidecar is None:
            sidecar = build_sidecar(catalog, node, rel)
            catalog.cache_sidecar(node.table, node.index, rel, sidecar)
        tables[IndexProbe.sidecar_name(node.table, node.index)] = sidecar


def execute_plan(plan: PlanNode, tables: dict[str, Relation]) -> Relation:
    """Run a plan against device tables, eagerly, on their device.

    Raises diag.CapacityOverflow when any static-capacity operator
    overflowed — results would be silently truncated otherwise; the
    caller re-plans with larger budgets.  The overflow check is the one
    host read of an execution.  IndexProbe sidecars must already be in
    ``tables`` (``prepare_index_probes``).

    A statement's cancel/deadline checkpoint (``server/admission.py``)
    runs at entry and after the overflow check: a flag and a clock read
    on the host, no device sync.
    """
    qadmission.checkpoint()
    needed = referenced_tables(plan)
    # sidecars are injected relations, not catalog tables, so
    # referenced_tables leaves them out; keep them past the filter below
    needed |= {IndexProbe.sidecar_name(n.table, n.index)
               for n in index_probes(plan)}
    with diag.collect() as entries:
        out = _lower(plan, {k: v for k, v in tables.items() if k in needed})
    check_overflow(entries)
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
    if int(lanes.sum()) > 0:
        vals = lanes.cpu().tolist()
        drops = [(n, cap, v)
                 for (n, _v, cap), v in zip(entries, vals) if v > 0]
        detail = ", ".join(f"{n}={v}" for n, _cap, v in drops)
        raise diag.CapacityOverflow(
            f"operator capacity exceeded ({detail} rows dropped); "
            f"re-plan with larger out_capacity", drops=drops,
        )
