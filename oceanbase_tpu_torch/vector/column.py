"""Column and Relation: the device-resident batch formats, on torch tensors.

Port of ``oceanbase_tpu/vector/column.py``.  A ``Column`` is a dense
tensor plus an optional bool validity tensor; a ``Relation`` is a set of
columns plus a live-row mask (True = live).  Operators carry the mask
instead of compacting, so every capacity stays static and identical to
the JAX package's: the bucket ladder and ``StringDict`` codes are
reproduced exactly (``bucket_capacity``, ``StringDict.encode``).

Strings are int32 dictionary codes with the dictionary on the host; a
VECTOR(d) column is one [n, d] float32 tensor (its mask and validity stay
[n]).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind

# ---------------------------------------------------------------------------
# capacity bucket ladder (the static-shape policy)
# ---------------------------------------------------------------------------

DEFAULT_BUCKET_FLOOR = 64
DEFAULT_BUCKET_GROWTH = 2.0


def bucket_capacity(n: int, floor: int = DEFAULT_BUCKET_FLOOR,
                    growth: float = DEFAULT_BUCKET_GROWTH) -> int:
    """Smallest ladder capacity >= ``n`` (geometric: floor, floor*g, ...)."""
    cap = max(int(floor), 1)
    n = max(int(n), 1)
    g = max(float(growth), 1.125)  # guard against a degenerate ladder
    while cap < n:
        cap = max(cap + 1, int(math.ceil(cap * g)))
    return cap


@dataclass(frozen=True, eq=False)  # content hash via digest (see below)
class StringDict:
    """Order-preserving dictionary for one string column.

    ``values`` is a sorted numpy array of unique python strings; a column
    stores int32 codes indexing it.  Equality and hash are content-based.
    """

    values: np.ndarray  # dtype=object or <U*, sorted ascending

    def __post_init__(self):
        assert self.values.ndim == 1

    def _content_digest(self) -> int:
        d = self.__dict__.get("_digest")
        if d is None:
            a = self.values
            u = a.astype("U") if a.dtype == object else np.ascontiguousarray(a)
            h = hashlib.blake2b(digest_size=8)
            h.update(str(u.dtype).encode())
            h.update(u.tobytes())
            d = int.from_bytes(h.digest(), "little")
            object.__setattr__(self, "_digest", d)
        return d

    def __hash__(self):
        return self._content_digest()

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, StringDict):
            return NotImplemented
        return (self.values.shape == other.values.shape
                and self._content_digest() == other._content_digest())

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    def code_of(self, s: str) -> int:
        """Exact code of ``s`` or -1 if absent."""
        i = int(np.searchsorted(self.values, s))
        if i < self.size and self.values[i] == s:
            return i
        return -1

    def lower_bound(self, s: str) -> int:
        return int(np.searchsorted(self.values, s, side="left"))

    def lut(self, fn) -> np.ndarray:
        """Evaluate a host predicate/transform over every dict value (the
        LUT a device gather then maps codes through)."""
        return np.array([fn(v) for v in self.values])

    @staticmethod
    def encode(strings: np.ndarray) -> tuple[np.ndarray, "StringDict"]:
        """Encode raw strings -> (int32 codes, dict).  An object array
        goes through a set and a hash lookup: the values and codes of
        ``np.unique(..., return_inverse=True)``, which compares Python
        objects one by one, at about a tenth of its host time."""
        arr = np.asarray(strings)
        if arr.dtype != object:
            values, codes = np.unique(arr, return_inverse=True)
            return codes.astype(np.int32), StringDict(values)
        items = arr.tolist()
        values = np.array(sorted(set(items)), dtype=object)
        index = {v: i for i, v in enumerate(values.tolist())}
        codes = np.fromiter(map(index.__getitem__, items), dtype=np.int32,
                            count=len(items))
        return codes, StringDict(values)


def take(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with indices clipped into range — JAX's ``mode="clip"``.
    An out-of-range index on CUDA is a device-side assert that poisons
    the context, so every gather goes through here."""
    idx = idx.to(torch.int64).clamp(0, max(data.shape[0] - 1, 0))
    return data.index_select(0, idx)


@dataclass
class Column:
    """One column vector: dense data + optional validity, plus metadata.

    ``data``  — tensor, shape [n] ([n, d] float32 for VECTOR(d))
    ``valid`` — optional bool tensor, shape [n]; None means all-valid
    ``dtype`` — SqlType
    ``sdict`` — StringDict for string columns (host-side)
    """

    data: torch.Tensor
    valid: Optional[torch.Tensor] = None
    dtype: SqlType = field(default_factory=SqlType.int_)
    sdict: Optional[StringDict] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_or_true(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.valid

    def with_data(self, data, valid="__keep__") -> "Column":
        v = self.valid if isinstance(valid, str) else valid
        return Column(data=data, valid=v, dtype=self.dtype, sdict=self.sdict)

    def gather(self, idx) -> "Column":
        """Row gather (sorts/joins) with clipped indices."""
        data = take(self.data, idx)
        valid = None if self.valid is None else take(self.valid, idx)
        return self.with_data(data, valid)

    def pad_to(self, capacity: int) -> "Column":
        """Extend to ``capacity`` rows with dead lanes (zero payload,
        invalid when a validity array exists)."""
        n = self.data.shape[0]
        if capacity <= n:
            return self
        pad = capacity - n
        zeros = torch.zeros((pad,) + tuple(self.data.shape[1:]),
                            dtype=self.data.dtype, device=self.data.device)
        data = torch.cat([self.data, zeros])
        valid = None
        if self.valid is not None:
            valid = torch.cat([self.valid, torch.zeros(
                pad, dtype=torch.bool, device=self.valid.device)])
        return Column(data=data, valid=valid, dtype=self.dtype,
                      sdict=self.sdict)


@dataclass
class Relation:
    """A batch of rows: named columns + live-row mask.

    ``mask`` is None when every row in [0, capacity) is live.  The live
    row count is a device scalar (``count``), never read inside a plan.
    """

    columns: dict[str, Column]
    mask: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        for c in self.columns.values():
            return c.capacity
        return 0

    @property
    def device(self) -> torch.device:
        if self.mask is not None:
            return self.mask.device
        for c in self.columns.values():
            return c.device
        return torch.device("cpu")

    def mask_or_true(self) -> torch.Tensor:
        if self.mask is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.device)
        return self.mask

    def count(self) -> torch.Tensor:
        """Live row count as a device scalar."""
        if self.mask is None:
            return torch.tensor(self.capacity, dtype=torch.int64,
                                device=self.device)
        return self.mask.to(torch.int64).sum()

    def with_mask(self, mask) -> "Relation":
        return Relation(columns=self.columns, mask=mask)

    def select(self, names) -> "Relation":
        return Relation(columns={n: self.columns[n] for n in names},
                        mask=self.mask)

    def gather(self, idx, mask=None) -> "Relation":
        return Relation(
            columns={n: c.gather(idx) for n, c in self.columns.items()},
            mask=mask,
        )

    def pad_to(self, capacity: int) -> "Relation":
        """Pad every column to ``capacity`` with the extra lanes dead in
        the mask; the mask is always materialized."""
        n = self.capacity
        if capacity < n:
            raise ValueError(
                f"pad_to({capacity}) below current capacity {n}")
        mask = self.mask_or_true()
        if capacity > n:
            mask = torch.cat([mask, torch.zeros(
                capacity - n, dtype=torch.bool, device=mask.device)])
        return Relation(
            columns={nm: c.pad_to(capacity)
                     for nm, c in self.columns.items()},
            mask=mask,
        )


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def host_column(arr: np.ndarray, want: SqlType | None = None):
    """A non-string host column -> (its physical ndarray, SqlType):
    ``want``'s dtype when given, else float64 DOUBLE, BOOL or int64 INT."""
    if want is not None:
        return arr.astype(want.np_dtype, copy=False), want
    if arr.dtype.kind == "f":
        return arr.astype(np.float64, copy=False), SqlType.double()
    if arr.dtype.kind == "b":
        return arr, SqlType.bool_()
    return arr.astype(np.int64, copy=False), SqlType.int_()


def from_numpy(
    arrays: dict[str, np.ndarray],
    types: dict[str, SqlType] | None = None,
    valids: dict[str, np.ndarray] | None = None,
    device=None,
) -> Relation:
    """Build a device Relation from host numpy columns.

    String (object/str-dtype) columns are dictionary-encoded here.
    ``device`` defaults to ``"cuda"``; the CPU is used only when asked for.
    """
    dev = default_device(device)
    cols: dict[str, Column] = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        want = types.get(name) if types else None
        vec_t = want is not None and want.kind == TypeKind.VECTOR
        if arr.dtype == object and arr.ndim == 1 and len(arr) and \
                isinstance(arr[0], (list, tuple, np.ndarray)):
            # an object array of per-row embeddings -> [n, d] float32
            arr = np.stack([np.asarray(v, dtype=np.float32) for v in arr])
            vec_t = True
        if arr.ndim == 2 or vec_t:
            if arr.ndim == 1:
                # a VECTOR column seeded from a flat placeholder (a typed
                # empty table): shape it [n, dim]
                arr = np.zeros((len(arr), want.precision or 1),
                               dtype=np.float32)
            data = np.ascontiguousarray(arr, dtype=np.float32)
            valid = None
            if valids and valids.get(name) is not None:
                valid = torch.from_numpy(np.ascontiguousarray(
                    valids[name], dtype=np.bool_)).to(dev)
            cols[name] = Column(torch.from_numpy(data).to(dev), valid,
                                SqlType.vector(data.shape[1]))
            continue
        sdict = None
        if arr.dtype.kind in ("U", "S", "O"):
            data, sdict = StringDict.encode(arr)
            dtype = want if want is not None and want.is_string \
                else SqlType.string()
        else:
            data, dtype = host_column(arr, want)
        valid = None
        if valids and valids.get(name) is not None:
            valid = torch.from_numpy(
                np.ascontiguousarray(valids[name], dtype=np.bool_)).to(dev)
        tdata = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        cols[name] = Column(data=tdata, valid=valid, dtype=dtype, sdict=sdict)
    return Relation(columns=cols, mask=None)


def empty_relation(types: dict[str, SqlType], device=None) -> Relation:
    """One all-dead row typed after ``types`` (static shapes need
    capacity >= 1)."""
    arrays, valids = {}, {}
    for name, t in types.items():
        if t.is_string:
            arrays[name] = np.array([""], dtype=object)
        elif t.kind == TypeKind.VECTOR:
            arrays[name] = np.zeros((1, t.precision or 1), dtype=np.float32)
        else:
            arrays[name] = np.zeros(1, dtype=t.np_dtype)
        valids[name] = np.array([False])
    rel = from_numpy(arrays, types=types, valids=valids, device=device)
    return Relation(columns=rel.columns,
                    mask=torch.zeros(1, dtype=torch.bool,
                                     device=rel.device))


def to_numpy(rel: Relation, limit: int | None = None) -> dict[str, np.ndarray]:
    """Materialize live rows back to host (decoding string dictionaries).

    The result-set boundary: the one place shapes become data-dependent.
    DECIMAL columns come back as raw scaled ints; only ``avg`` outputs are
    descaled doubles (they are DOUBLE columns already).
    """
    mask = rel.mask_or_true().cpu().numpy()
    out: dict[str, np.ndarray] = {}
    idx = np.nonzero(mask)[0]
    if limit is not None:
        idx = idx[:limit]
    for name, col in rel.columns.items():
        if col.dtype.kind == TypeKind.VECTOR:
            # live rows gathered on the device first; embeddings come
            # back as a 1-D object array of float32 rows
            rows = take(col.data, torch.from_numpy(idx).to(col.device))
            host = rows.cpu().numpy()
            data = np.empty(len(idx), dtype=object)
            for i in range(len(idx)):
                data[i] = host[i]
            out[name] = data
            if col.valid is not None:
                out.setdefault("__valid__" + name,
                               col.valid.cpu().numpy()[idx])
            continue
        data = col.data.cpu().numpy()[idx]
        if col.sdict is not None:
            codes = np.clip(data, 0, col.sdict.size - 1)
            data = col.sdict.values[codes]
        if col.valid is not None:
            v = col.valid.cpu().numpy()[idx]
            data = np.where(v, data, None) if data.dtype == object else data
            out[name] = data
            out.setdefault("__valid__" + name, v)
        else:
            out[name] = data
    return out


__all__ = [
    "Column", "Relation", "StringDict", "bucket_capacity", "empty_relation",
    "from_numpy", "host_column", "take", "to_numpy",
]
