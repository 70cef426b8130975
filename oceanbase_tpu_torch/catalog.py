"""Catalog: schemas, tables, statistics, on the port's device relations.

Port of ``oceanbase_tpu/catalog.py`` for a session without a storage
plane: ``ColumnDef``/``IndexDef``/``TableDef``, the load-time NDV
estimate ``sampled_ndv`` and a ``Catalog`` of named tables ->
(definition, device ``Relation``), with table and view DDL, and transient
tables (the gv$/v$ views a statement reads, materialized per statement by
the session; ``register_transient``).  Loading computes the same row
counts and NDV statistics as the JAX package, so its binder and optimizer
choose the same plans and capacities.  External tables (files scanned
at query time through ``share/external.py``, ``register_external``) are
cached per file mtime.

A catalog lives on one device: ``Catalog(device=None)`` resolves it to
``"cuda"`` and raises without CUDA unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.share.external import read_external
from oceanbase_tpu_torch.vector import Relation, empty_relation, from_numpy


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
        # structures derived from a table's relation: (table, name) ->
        # (source relation, structure); an entry serves only the
        # relation it was built from, which it keeps alive.  IndexProbe
        # sidecars are named by their index, vector search structures by
        # ("ann", column, metric)
        self._sidecars: dict[tuple[str, object], tuple[Relation, object]] = {}
        # transient tables: materialized virtual (gv$/v$) relations,
        # refreshed per statement (≙ virtual table iterators)
        self._transients: dict[str, tuple[TableDef, Relation]] = {}
        # external (lake) tables: name -> {"tdef", "location", "format",
        # "delimiter", "skip", "cache": (mtime, Relation)|None}
        # (≙ src/share/external_table — files scanned at query time)
        self._externals: dict[str, dict] = {}
        self.schema_version = 1

    # -- transient (virtual) tables ---------------------------------------
    def register_transient(self, name: str, arrays, types=None,
                           valids=None):
        """(Re)register a virtual table's rows as a transient relation on
        the catalog's device; an empty view gets one all-dead row, its
        column types inferred from the arrays' numpy dtypes."""
        n = len(next(iter(arrays.values()))) if arrays else 0
        if n == 0:
            def infer(v):
                kind = np.asarray(v).dtype.kind
                if kind in "OUS":
                    return SqlType.string()
                if kind == "f":
                    return SqlType.double()
                if kind == "b":
                    return SqlType.bool_()
                return SqlType.int_()

            col_types = {k: (types or {}).get(k) or infer(v)
                         for k, v in arrays.items()}
            rel = empty_relation(col_types, device=self.device)
            row_count = 0
        else:
            rel = from_numpy(arrays, types=types, valids=valids or None,
                             device=self.device)
            row_count = rel.capacity
        cols = [ColumnDef(c, rel.columns[c].dtype) for c in arrays]
        tdef = TableDef(name, cols, row_count=max(row_count, 1))
        with self._lock:
            # a transient must not shadow a view (re-registering an
            # existing transient is the normal per-statement refresh)
            if self.view_def(name) is not None:
                raise ValueError(f"view {name} already exists")
            self._transients[name] = (tdef, rel)

    def drop_transient(self, name: str):
        with self._lock:
            self._transients.pop(name, None)

    def transient(self, name: str):
        """(definition, relation) of a transient table, or None."""
        with self._lock:
            return self._transients.get(name)

    # -- index sidecars and vector search structures ---------------------
    def sidecar(self, table: str, name, rel: Relation):
        """The cached structure ``name`` of ``table`` built from ``rel``,
        or None (none cached, or built from another relation)."""
        with self._lock:
            hit = self._sidecars.get((table, name))
            return hit[1] if hit is not None and hit[0] is rel else None

    def cache_sidecar(self, table: str, name, rel: Relation, sidecar):
        with self._lock:
            self._sidecars[(table, name)] = (rel, sidecar)

    def drop_sidecars(self, table: str, name=None):
        """Free the cached structures of ``table`` (only ``name`` if
        given)."""
        with self._lock:
            for key in [k for k in self._sidecars if k[0] == table
                        and name in (None, k[1])]:
                del self._sidecars[key]

    # -- external tables --------------------------------------------------
    def register_external(self, tdef: TableDef, location: str,
                          fmt: str = "csv", delimiter: str = ",",
                          skip_lines: int = 0,
                          if_not_exists: bool = False):
        with self._lock:
            if tdef.name in self._externals:
                if if_not_exists:
                    return
                raise ValueError(f"external table {tdef.name} exists")
            # collision checks inside one locked section (no
            # check-then-act window against concurrent DDL)
            if self.has_table(tdef.name):
                raise ValueError(f"table {tdef.name} already exists")
            if self.view_def(tdef.name) is not None:
                raise ValueError(f"view {tdef.name} already exists")
            self._externals[tdef.name] = {
                "tdef": tdef, "location": location, "format": fmt,
                "delimiter": delimiter, "skip": skip_lines,
                "cache": None}
            self.schema_version += 1

    def drop_external(self, name: str) -> bool:
        with self._lock:
            if self._externals.pop(name, None) is not None:
                self.schema_version += 1
                return True
            return False

    def _external_lookup(self, name: str):
        return self._externals.get(name)

    def _external_data(self, name: str) -> Relation:
        """The external table's file read into a relation on the
        catalog's device; re-read when the file's mtime changes."""
        e = self._externals.get(name)
        if e is None:  # dropped concurrently: the missing-table path
            raise KeyError(f"unknown table {name}")
        try:
            mtime = os.path.getmtime(e["location"])
        except OSError:
            mtime = None
        with self._lock:
            hit = e["cache"]
            if hit is not None and hit[0] == mtime:
                return hit[1]
        arrays, valids, types = read_external(
            e["location"], e["format"], e["tdef"], e["delimiter"],
            e["skip"])
        rel = from_numpy(arrays, types=types, valids=valids or None,
                         device=self.device)
        with self._lock:
            e["cache"] = (mtime, rel)
            e["tdef"].row_count = rel.capacity
        return rel

    # -- views ------------------------------------------------------------
    def create_view(self, name: str, sql: str, cols=None,
                    or_replace: bool = False):
        with self._lock:
            if self.has_table(name) or name in self._externals:
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
            if tdef.name in self._defs or tdef.name in self._externals:
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
            elif col.dtype.kind == TypeKind.VECTOR:
                ndv[cname] = n
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
            t = self._transients.get(name)
            if t is not None:
                return t[0]
            e = self._externals.get(name)
            if e is not None:
                return e["tdef"]
            if name not in self._defs:
                raise KeyError(f"unknown table {name}")
            return self._defs[name]

    def table_data(self, name: str) -> Relation:
        if name in self._externals:
            return self._external_data(name)
        with self._lock:
            t = self._transients.get(name)
            if t is not None:
                return t[1]
            if name not in self._data:
                raise KeyError(f"table {name} has no data")
            return self._data[name]

    def has_table(self, name: str) -> bool:
        with self._lock:
            return name in self._defs or name in self._transients or \
                name in self._externals

    def tables(self) -> list[str]:
        with self._lock:
            # index storage tables are internal (reachable by name, but
            # hidden from SHOW TABLES / information_schema enumeration)
            return sorted([n for n in self._defs
                           if not n.startswith("__idx__")]
                          + list(self._externals))

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
