"""The coordinator split of a physical plan.

The port's copy of the two pieces of ``oceanbase_tpu/px/planner.py`` that
the streaming and spill tiers use: ``NotDistributable``, the refusal of a
plan shape, and ``split_top``, which peels the coordinator-side operators
(Sort, Limit, Project and a root ScalarAgg) off a plan.  The distributed
lowering itself (``execute_plan_distributed``, exchanges, partition-wise
joins) waits for ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import dataclasses

from oceanbase_tpu_torch.exec import plan as pp

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


__all__ = ["NotDistributable", "split_top"]
