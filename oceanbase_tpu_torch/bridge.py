"""Relations to and from plain numpy parts.

A database's "weights" are its data.  ``relation_to_parts`` turns a
Relation into host arrays that keep every lane, dead lanes included, and
``relation_from_parts`` loads such parts onto a device.  Parts produced
from any engine's relation in the same layout load into the port with
bit-identical inputs, which is how the port is held against the JAX
package.

``parts`` maps ``name -> (data, valid or None, (kind, precision, scale),
dict_values or None)``: ``data`` a 1-D ndarray of the physical dtype,
``valid`` a bool ndarray, ``kind`` a ``TypeKind`` value string
("int", "decimal", "date", "string", ...), ``dict_values`` the sorted
dictionary of a string column.
"""

from __future__ import annotations

import numpy as np
import torch

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.vector.column import Column, Relation, StringDict


def _upload(arr: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def relation_from_parts(parts: dict, mask=None, device=None) -> Relation:
    """Build a Relation on ``device`` from numpy parts and an optional
    live-row mask (bool ndarray)."""
    dev = default_device(device)
    cols = {}
    for name, (data, valid, (kind, precision, scale), dvals) in parts.items():
        t = SqlType(TypeKind(kind), int(precision), int(scale))
        data = np.asarray(data)
        if data.dtype != t.np_dtype:
            raise TypeError(f"{name}: {data.dtype} data for a {kind} column "
                            f"(expected {t.np_dtype})")
        cols[name] = Column(
            data=_upload(data, dev),
            valid=None if valid is None else _upload(
                np.asarray(valid, dtype=np.bool_), dev),
            dtype=t,
            sdict=None if dvals is None else StringDict(np.asarray(dvals)))
    m = None if mask is None else _upload(np.asarray(mask, dtype=np.bool_),
                                          dev)
    return Relation(columns=cols, mask=m)


def relation_to_parts(rel: Relation) -> tuple[dict, np.ndarray | None]:
    """-> (parts, mask) on the host, every lane kept."""
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            c.data.cpu().numpy(),
            None if c.valid is None else c.valid.cpu().numpy(),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values,
        )
    mask = None if rel.mask is None else rel.mask.cpu().numpy()
    return parts, mask
