"""Columnar vector formats on torch tensors (port of ``oceanbase_tpu.vector``).

- VEC_FIXED          -> one dense tensor per column
- VEC_DISCRETE       -> dictionary codes (int32) + host-side value dictionary
- null bitmap        -> a bool validity tensor per column
- ObBatchRows.skip_  -> a bool row-mask per relation (True = row is live)
"""

from oceanbase_tpu_torch.vector.column import (
    Column,
    Relation,
    StringDict,
    bucket_capacity,
    empty_relation,
    from_numpy,
    to_numpy,
)

__all__ = [
    "Column",
    "Relation",
    "StringDict",
    "bucket_capacity",
    "empty_relation",
    "from_numpy",
    "to_numpy",
]
