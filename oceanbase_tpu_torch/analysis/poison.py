"""Poison-lane verifier: the Static-shape policy as an executable check.

Port of ``oceanbase_tpu/analysis/poison.py``.  Every operator must treat
masked-dead pad lanes as if they did not exist.  The static half of that
contract is ``mask_discipline``; this is the dynamic half: fill the dead
lanes of a relation with adversarial garbage, re-run the query and
require *bit-identical* results.  A pad lane that influences anything
shows up as a diff.

Poison values are the reference's:

- float    -> NaN (over the whole row of a 2-D VECTOR column)
- int      -> ``INT_POISON`` (breaks unmasked sums)
- bool     -> True (breaks unmasked counts)
- strings  -> code -1 (the reserved NULL payload; must stay clamped)
- valid    -> True on dead lanes (operators must gate on mask, not
              validity)

The poisoned relation is built on the device the relation is on, with no
host round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from oceanbase_tpu_torch.datatypes import TypeKind
from oceanbase_tpu_torch.vector.column import Column, Relation

INT_POISON = np.int64(0x5AD5AD5AD5AD5AD)  # loud, sign-safe bit pattern


def _fill(data: torch.Tensor, value) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``data``'s dtype on its device (an
    int64 pattern wraps into narrower ints as numpy's cast does)."""
    if isinstance(value, int) and not data.dtype.is_floating_point and \
            data.dtype != torch.bool:
        return torch.full((), value, dtype=torch.int64,
                          device=data.device).to(data.dtype)
    return torch.full((), value, dtype=data.dtype, device=data.device)


def _poison_data(data: torch.Tensor, dead: torch.Tensor, kind) -> torch.Tensor:
    if kind == TypeKind.STRING:
        return torch.where(dead, _fill(data, -1), data)
    if data.dtype.is_floating_point:
        if data.ndim == 2:  # vector columns: poison whole rows
            return torch.where(dead[:, None], _fill(data, float("nan")),
                               data)
        return torch.where(dead, _fill(data, float("nan")), data)
    if data.dtype == torch.bool:
        return torch.where(dead, _fill(data, True), data)
    return torch.where(dead, _fill(data, int(INT_POISON)), data)


def poison_pad_lanes(rel: Relation) -> Relation:
    """Fill masked-dead lanes with adversarial garbage (payload AND
    validity).  A relation with no dead lanes returns equivalent data."""
    mask = rel.mask_or_true()
    dead = ~mask
    cols = {}
    for name, c in rel.columns.items():
        data = _poison_data(c.data, dead, c.dtype.kind)
        valid = c.valid
        if valid is not None:
            # dead lanes become "valid": only the mask may save us
            valid = valid | dead
        cols[name] = Column(data, valid, c.dtype, c.sdict)
    return Relation(columns=cols, mask=mask)


def poison_tables(tables: dict) -> dict:
    return {name: poison_pad_lanes(rel) for name, rel in tables.items()}


def results_identical(a: dict, b: dict) -> tuple[bool, str]:
    """Bit-identical comparison of two ``to_numpy`` result dicts.
    Returns (ok, first difference description)."""
    if sorted(a) != sorted(b):
        return False, f"column sets differ: {sorted(a)} vs {sorted(b)}"
    for k in sorted(a):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            return False, f"{k}: shape {x.shape} vs {y.shape}"
        if x.dtype == object or y.dtype == object:
            if list(map(repr, x.reshape(-1))) != \
                    list(map(repr, y.reshape(-1))):
                return False, f"{k}: object values differ"
            continue
        # bit-level equality: NaN == NaN, -0.0 != 0.0
        if x.tobytes() != y.tobytes():
            return False, f"{k}: payload bits differ"
    return True, ""


def assert_poison_invariant(run, tables: dict, materialize=None) -> None:
    """Run ``run(tables)`` clean and poisoned; assert bit-identical
    results.  ``run`` maps {name: Relation} -> Relation (e.g. a bound
    ``execute_plan``); ``materialize`` overrides the host conversion
    (defaults to ``vector.to_numpy``)."""
    from oceanbase_tpu_torch.vector import to_numpy

    mat = materialize or to_numpy
    clean = mat(run(tables))
    poisoned = mat(run(poison_tables(tables)))
    ok, why = results_identical(clean, poisoned)
    assert ok, (
        f"poison-lane invariant violated: {why} — a masked-dead pad "
        f"lane influenced the result (Static-shape policy, ROADMAP)")
