"""Catalog: schemas, tables, statistics, on the port's device relations.

Port of ``oceanbase_tpu/catalog.py`` for a session without a storage
plane: ``ColumnDef``/``IndexDef``/``TableDef``, the load-time NDV
estimate ``sampled_ndv`` and a ``Catalog`` of named tables ->
(definition, device ``Relation``), with table and view DDL.  Loading
computes the same row counts and NDV statistics as the JAX package, so
its binder and optimizer choose the same plans and capacities.  External
and transient tables wait for the storage plane (ROADMAP Queue 1
item 5).

A catalog lives on one device: ``Catalog(device=None)`` resolves it to
``"cuda"`` and raises without CUDA unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.vector import Relation, from_numpy


@dataclass
class ColumnDef:
    name: str
    dtype: SqlType
    nullable: bool = True


@dataclass
class IndexDef:
    """A secondary index: its own index table keyed by (index columns +
    primary key columns), named by ``storage_table``."""

    name: str
    table: str
    columns: list[str]
    unique: bool
    storage_table: str


@dataclass
class TableDef:
    name: str
    columns: list[ColumnDef]
    primary_key: list[str] = field(default_factory=list)
    # optimizer stats
    row_count: int = 0
    ndv: dict[str, int] = field(default_factory=dict)
    # equi-height histograms from ANALYZE: col -> (edges, null_fraction)
    histograms: dict = field(default_factory=dict)
    # most-common-values lists for dict-encoded string columns
    mcv: dict = field(default_factory=dict)
    # range partitioning: (column, [upper-exclusive split points]) or None
    partition: Optional[tuple] = None
    auto_increment_cols: list = field(default_factory=list)
    indexes: list = field(default_factory=list)  # list[IndexDef]
    aux_indexes: dict = field(default_factory=dict)

    def column(self, name: str) -> ColumnDef:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]


def sampled_ndv(arr, n: int, sample: int = 8192) -> int:
    """NDV estimate from a fixed-seed sample (load-time default stats).
    A saturating sample (few distinct values) means a low-cardinality
    domain: report the sample distinct count, not a scaled guess."""
    if n == 0:
        return 1
    if n <= sample:
        return max(1, int(len(np.unique(arr[:n]))))
    idx = np.random.default_rng(0).choice(n, sample, replace=False)
    d = int(len(np.unique(arr[idx])))
    if d <= sample // 2:
        return max(d, 1)
    return max(1, min(n, int(d * (n / sample))))


class Catalog:
    """Named tables -> (definition, device-resident data).

    Thread-safe; ``schema_version`` bumps on every load and DDL."""

    def __init__(self, device=None):
        self.device = default_device(device)
        self._lock = threading.RLock()
        self._defs: dict[str, TableDef] = {}
        self._data: dict[str, Relation] = {}
        # views: name -> {"sql": body text, "cols": [alias...]|[]},
        # expanded at bind time
        self._views: dict[str, dict] = {}
        # IndexProbe sidecars: (table, index) -> (source relation,
        # sidecar); an entry serves only the relation it was built from
        self._sidecars: dict[tuple[str, str], tuple[Relation, Relation]] = {}
        self.schema_version = 1

    # -- index sidecars ---------------------------------------------------
    def sidecar(self, table: str, index: str, rel: Relation):
        """The cached sidecar of ``table.index`` built from ``rel``, or
        None (none cached, or built from another relation)."""
        with self._lock:
            hit = self._sidecars.get((table, index))
            return hit[1] if hit is not None and hit[0] is rel else None

    def cache_sidecar(self, table: str, index: str, rel: Relation,
                      sidecar: Relation):
        with self._lock:
            self._sidecars[(table, index)] = (rel, sidecar)

    def drop_sidecars(self, table: str, index: str | None = None):
        """Free the cached sidecars of ``table`` (of one index if named)."""
        with self._lock:
            for key in [k for k in self._sidecars if k[0] == table
                        and index in (None, k[1])]:
                del self._sidecars[key]

    # -- views ------------------------------------------------------------
    def create_view(self, name: str, sql: str, cols=None,
                    or_replace: bool = False):
        with self._lock:
            if self.has_table(name):
                raise ValueError(f"table {name} already exists")
            if name in self._views and not or_replace:
                raise ValueError(f"view {name} already exists")
            self._views[name] = {"sql": sql, "cols": list(cols or [])}
            self.schema_version += 1

    def drop_view(self, name: str) -> bool:
        with self._lock:
            if self._views.pop(name, None) is None:
                return False
            self.schema_version += 1
            return True

    def view_def(self, name: str):
        with self._lock:
            return self._views.get(name)

    def view_names(self) -> list[str]:
        with self._lock:
            return sorted(self._views)

    # -- DDL -------------------------------------------------------------
    def create_table(self, tdef: TableDef, if_not_exists: bool = False):
        with self._lock:
            if self.view_def(tdef.name) is not None:
                raise ValueError(f"view {tdef.name} already exists")
            if tdef.name in self._defs:
                if if_not_exists:
                    return
                raise ValueError(f"table {tdef.name} already exists")
            self._defs[tdef.name] = tdef
            self.schema_version += 1

    def drop_table(self, name: str, if_exists: bool = False):
        with self._lock:
            if name not in self._defs:
                if if_exists:
                    return
                raise KeyError(name)
            del self._defs[name]
            self._data.pop(name, None)
            self.drop_sidecars(name)
            self.schema_version += 1

    # -- data ------------------------------------------------------------
    def load_numpy(self, name: str, arrays: dict[str, np.ndarray],
                   types: dict[str, SqlType] | None = None,
                   primary_key: list[str] | None = None,
                   valids: dict[str, np.ndarray] | None = None,
                   device=None):
        """Bulk-load host arrays as a table on ``device`` (the catalog's
        device when None)."""
        rel = from_numpy(arrays, types=types, valids=valids,
                         device=self.device if device is None else device)
        n = rel.capacity
        cols = []
        ndv = {}
        for cname in arrays:
            col = rel.columns[cname]
            cols.append(ColumnDef(cname, col.dtype,
                                  nullable=col.valid is not None))
            if col.sdict is not None:
                ndv[cname] = col.sdict.size
            else:
                ndv[cname] = sampled_ndv(np.asarray(arrays[cname]), n)
        with self._lock:
            self._defs[name] = TableDef(
                name, cols, primary_key=primary_key or [], row_count=n,
                ndv=ndv)
            self._data[name] = rel
            self.drop_sidecars(name)
            self.schema_version += 1

    def set_data(self, name: str, rel: Relation):
        """Install a table's new relation; it must live on the catalog's
        device."""
        dev = rel.device
        same = dev.type == self.device.type and (
            dev.index is None or self.device.index is None
            or dev.index == self.device.index)
        if not same:
            raise ValueError(f"relation on {rel.device}, catalog on "
                             f"{self.device}")
        with self._lock:
            self._data[name] = rel
            self.drop_sidecars(name)   # built from the relation replaced
            d = self._defs.get(name)
            if d is not None:
                d.row_count = rel.capacity

    # -- lookup ----------------------------------------------------------
    def table_def(self, name: str) -> TableDef:
        with self._lock:
            if name not in self._defs:
                raise KeyError(f"unknown table {name}")
            return self._defs[name]

    def table_data(self, name: str) -> Relation:
        with self._lock:
            if name not in self._data:
                raise KeyError(f"table {name} has no data")
            return self._data[name]

    def has_table(self, name: str) -> bool:
        with self._lock:
            return name in self._defs

    def tables(self) -> list[str]:
        with self._lock:
            return sorted(n for n in self._defs
                          if not n.startswith("__idx__"))

    def device_bytes(self) -> int:
        """Bytes the tables' data, validity and masks hold on the device."""
        total = 0
        with self._lock:
            for rel in self._data.values():
                for c in rel.columns.values():
                    total += c.data.numel() * c.data.element_size()
                    if c.valid is not None:
                        total += c.valid.numel()
                if rel.mask is not None:
                    total += rel.mask.numel()
        return total


__all__ = ["Catalog", "ColumnDef", "IndexDef", "TableDef", "sampled_ndv"]
