"""Session: the SQL entry point (parse -> bind -> optimize -> execute).

Port of the serial SELECT path of ``oceanbase_tpu/sql/session.py``.  A
statement is parsed, bound and optimized on the host by the port's own
front end, then run by the port's ``execute_plan`` on the catalog's
device under the reference's capacity-retry ladder: a
``CapacityOverflow`` re-plans with 4x budgets (``scale_capacities``) up
to ``max_capacity_retry`` times, then raises.  The result is read back
once and materialized on the host.  ``ANALYZE TABLE`` gathers the
optimizer statistics (exact NDV, histograms, most-common values) the
reference gathers before a benchmark run.

There is no plan cache, no parallel or pushed-down execution, no spill
tier and no tracing or metrics here.  Other statements wait for ROADMAP
Queue 1 item 5.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from oceanbase_tpu_torch.catalog import Catalog
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind, days_to_date
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.exec.plan import execute_plan, referenced_tables
from oceanbase_tpu_torch.sql import ast
from oceanbase_tpu_torch.sql.binder import Binder
from oceanbase_tpu_torch.sql.optimizer import CostModel, scale_capacities
from oceanbase_tpu_torch.sql.parser import parse_sql
from oceanbase_tpu_torch.vector import Relation, to_numpy

_POW10 = [10**i for i in range(38)]

_TODO_STMT = ("only SELECT and ANALYZE TABLE run on the port; other "
              "statements wait for ROADMAP Queue 1 item 5 (the session's "
              "other statements)")


@dataclass
class Result:
    """A materialized result set."""

    names: list
    arrays: dict            # name -> numpy array (decoded strings)
    valids: dict            # name -> bool array or None
    dtypes: dict            # name -> SqlType
    rowcount: int = 0

    def rows(self) -> list[tuple]:
        out = []
        n = len(next(iter(self.arrays.values()))) if self.names else 0
        for i in range(n):
            row = []
            for name in self.names:
                v = self.valids.get(name)
                if v is not None and not v[i]:
                    row.append(None)
                    continue
                x = self.arrays[name][i]
                t = self.dtypes.get(name)
                if t is not None and t.kind == TypeKind.DECIMAL:
                    row.append(float(x) / _POW10[t.scale])
                elif t is not None and t.kind == TypeKind.DATE:
                    row.append(days_to_date(int(x)))
                elif isinstance(x, (np.floating,)):
                    row.append(float(x))
                elif isinstance(x, (np.integer,)):
                    row.append(int(x))
                elif isinstance(x, np.str_):
                    row.append(str(x))
                else:
                    row.append(x)
            out.append(tuple(row))
        return out


class Session:
    """One client session: session variables + ``execute(sql)``.

    ``catalog`` defaults to an empty ``Catalog`` on ``device`` (None means
    ``"cuda"``; without CUDA that raises unless ``device="cpu"``).  A
    given catalog keeps its own device."""

    MAX_CAPACITY_RETRIES = 3
    HIST_BUCKETS = 64
    MCV_K = 16  # most-common-values kept per string column

    def __init__(self, catalog: Catalog | None = None, device=None):
        self.catalog = catalog if catalog is not None else Catalog(device)
        self.variables: dict[str, object] = {
            "max_capacity_retry": self.MAX_CAPACITY_RETRIES,
        }
        #: CapacityOverflow re-plans the last statement needed
        self.last_retries = 0

    @property
    def device(self):
        return self.catalog.device

    def execute(self, sql: str, params: list | None = None) -> Result:
        """Parse + execute one statement."""
        return self.execute_stmt(parse_sql(sql), params)

    def execute_stmt(self, stmt, params=None) -> Result:
        if isinstance(stmt, ast.SelectStmt):
            return self._execute_select(stmt, params)
        if isinstance(stmt, ast.AnalyzeStmt):
            return self._analyze(stmt)
        raise NotImplementedError(f"{type(stmt).__name__}: {_TODO_STMT}")

    def _plan_select(self, stmt: ast.SelectStmt, params):
        binder = Binder(self.catalog, params=params or [],
                        sysvars=self.variables)
        binder.cost_model = CostModel()
        return binder.bind_select(stmt)

    def _execute_select(self, stmt: ast.SelectStmt, params) -> Result:
        plan, outputs, _est = self._plan_select(stmt, params)
        tables = {t: self.catalog.table_data(t)
                  for t in referenced_tables(plan)
                  if self.catalog.has_table(t)}
        factor = 1
        max_retry = int(self.variables["max_capacity_retry"])
        for attempt in range(max_retry + 1):
            try:
                p = plan if factor == 1 else scale_capacities(plan, factor)
                rel = execute_plan(p, tables)
                break
            except CapacityOverflow:
                if attempt >= max_retry:
                    raise
                factor *= 4
        self.last_retries = attempt
        return self._materialize(rel, outputs)

    def _analyze(self, stmt: ast.AnalyzeStmt) -> Result:
        """Refresh a table's optimizer stats on the host: live row count,
        exact NDV, equi-height histograms for non-string columns and
        most-common-values frequency lists for dictionary columns."""
        td = self.catalog.table_def(stmt.table)
        rel = self.catalog.table_data(stmt.table)
        mask = rel.mask_or_true().cpu().numpy()
        td.row_count = int(mask.sum())
        for c in td.columns:
            col = rel.columns.get(c.name)
            if col is None:
                continue
            valid = None if col.valid is None else col.valid.cpu().numpy()
            data = col.data.cpu().numpy()[mask]
            if col.sdict is not None:
                codes = data if valid is None else data[valid[mask]]
                codes = codes[codes >= 0]
                uniq, counts = np.unique(codes, return_counts=True)
                td.ndv[c.name] = max(int(len(uniq)), 1)
                if len(uniq):
                    order = np.argsort(counts)[::-1][:self.MCV_K]
                    total = max(int(counts.sum()), 1)
                    td.mcv[c.name] = (
                        [str(col.sdict.values[int(uniq[i])]) for i in order],
                        [float(counts[i]) / total for i in order],
                    )
                else:
                    td.mcv.pop(c.name, None)
                continue
            if valid is not None:
                v = valid[mask]
                null_frac = 1.0 - (v.sum() / max(len(v), 1))
                data = data[v]
            else:
                null_frac = 0.0
            td.ndv[c.name] = int(len(np.unique(data))) if len(data) else 1
            if len(data) >= self.HIST_BUCKETS and data.dtype.kind in "iuf":
                qs = np.linspace(0, 100, self.HIST_BUCKETS + 1)
                td.histograms[c.name] = (np.percentile(data, qs),
                                         float(null_frac))
            else:
                td.histograms.pop(c.name, None)
        return Result([], {}, {}, {})

    def _materialize(self, rel: Relation, outputs) -> Result:
        raw = to_numpy(rel)
        names, arrays, valids, dtypes = [], {}, {}, {}
        for cid, name in outputs:
            col = rel.columns[cid]
            # disambiguate duplicate output names
            out_name = name
            k = 2
            while out_name in arrays:
                out_name = f"{name}_{k}"
                k += 1
            names.append(out_name)
            arrays[out_name] = raw[cid]
            valids[out_name] = raw.get("__valid__" + cid)
            dtypes[out_name] = col.dtype
        n = len(next(iter(arrays.values()))) if names else 0
        return Result(names, arrays, valids, dtypes, rowcount=n)


def _coerce_value(v, t, target: SqlType):
    """Coerce a parsed literal (value, type) to a column's storage value."""
    if v is None:
        return None
    if target.kind == TypeKind.DECIMAL:
        if t.kind == TypeKind.DECIMAL:
            return _rescale(v, t.scale, target.scale)
        if isinstance(v, int):
            return v * _POW10[target.scale]
        if isinstance(v, float):
            return round(v * _POW10[target.scale])
    if target.kind == TypeKind.DATE and isinstance(v, str):
        from oceanbase_tpu_torch.datatypes import date_to_days

        return date_to_days(v)
    if target.kind == TypeKind.BOOL:
        return bool(v)
    if target.kind == TypeKind.VECTOR:
        raise NotImplementedError(
            "VECTOR values wait for ROADMAP Queue 1 item 8")
    return v


def _rescale(v: int, from_scale: int, to_scale: int) -> int:
    if to_scale >= from_scale:
        return v * _POW10[to_scale - from_scale]
    d = _POW10[from_scale - to_scale]
    half = d // 2
    return (v + half) // d if v >= 0 else -((-v + half) // d)


__all__ = ["Result", "Session"]
