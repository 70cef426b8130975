"""The partial/final aggregate rewrite.

The port's copy of ``oceanbase_tpu/px/dist_ops.py::split_aggs``, which the
granule and spill tiers use to aggregate per granule and merge the
partials (≙ the partial-agg DFO / final-agg DFO pair of a PX group-by):

    sum   -> sum of partial sums        count -> sum of partial counts
    min   -> min of partial mins        max   -> max of partial maxs
    avg   -> sum(psum)/sum(pcount) as a post-projection

The shard-level operators of that module (``dist_groupby``,
``dist_join``) wait for ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from typing import Sequence

from oceanbase_tpu_torch.exec.ops import AggSpec
from oceanbase_tpu_torch.expr import ir


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


__all__ = ["split_aggs"]
