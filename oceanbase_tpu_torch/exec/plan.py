"""Physical plan nodes + the eager plan executor.

Port of ``oceanbase_tpu/exec/plan.py``.  The plan nodes are the same
dataclasses, so plans are built the same way.  ``execute_plan`` lowers the
tree operator by operator over masked ``Relation``s on the tables' device
and keeps the reference's overflow contract: every static-capacity
operator pushes a device scalar, the executor sums them into ONE device
scalar and reads it once at the result boundary — the only host sync of
an execution — and reads the per-lane detail only on the error path.

There is no jit counterpart: torch runs eagerly.  The XLA executable
cache, the metrics/trace/admission hooks and the plan-monitor lanes are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from oceanbase_tpu_torch.exec import diag, ops
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.vector.column import Relation

_TODO_NODE = ("waits for ROADMAP Queue 1 (window: item 4; "
              "index_probe/semi_join_residual/concat: item 3)")


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
# lowering
# ---------------------------------------------------------------------------


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
    raise NotImplementedError(f"{type(node).__name__} {_TODO_NODE}")


def referenced_tables(node: PlanNode) -> set[str]:
    out = set()
    if isinstance(node, (TableScan, IndexProbe)):
        out.add(node.table)
    for c in node.children():
        out |= referenced_tables(c)
    return out


def execute_plan(plan: PlanNode, tables: dict[str, Relation]) -> Relation:
    """Run a plan against device tables, eagerly, on their device.

    Raises diag.CapacityOverflow when any static-capacity operator
    overflowed — results would be silently truncated otherwise; the
    caller re-plans with larger budgets.  The overflow check is the one
    host read of an execution.
    """
    needed = referenced_tables(plan)
    with diag.collect() as entries:
        out = _lower(plan, {k: v for k, v in tables.items() if k in needed})
    if entries:
        lanes = torch.stack([torch.clamp(v.to(torch.int64), min=0)
                             for _n, v, _cap in entries])
        # the result-boundary read: one scalar decides validity
        if int(lanes.sum()) > 0:
            vals = lanes.cpu().tolist()
            drops = [(n, cap, v)
                     for (n, _v, cap), v in zip(entries, vals) if v > 0]
            detail = ", ".join(f"{n}={v}" for n, _cap, v in drops)
            raise diag.CapacityOverflow(
                f"operator capacity exceeded ({detail} rows dropped); "
                f"re-plan with larger out_capacity", drops=drops,
            )
    return out
