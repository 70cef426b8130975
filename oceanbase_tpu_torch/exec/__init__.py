"""Vectorized physical operators on torch tensors (port of
``oceanbase_tpu.exec``): each operator is a function Relation -> Relation
run eagerly; data-dependent cardinalities live behind static capacities
and masks."""

from oceanbase_tpu_torch.exec.ops import (
    AggSpec,
    compact,
    filter_rows,
    hash_groupby,
    join,
    limit,
    project,
    scalar_agg,
    sort_rows,
)

__all__ = [
    "AggSpec", "filter_rows", "project", "hash_groupby", "scalar_agg",
    "join", "sort_rows", "limit", "compact",
]
