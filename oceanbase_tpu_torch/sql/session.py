"""Session: the SQL entry point (parse -> bind -> optimize -> execute).

Port of the catalog-only statement surface of
``oceanbase_tpu/sql/session.py``, the session without a ``Database``.
A SELECT is parsed, bound and optimized on the host by the port's own
front end, then run by the port's ``execute_plan`` on the catalog's
device under the reference's capacity-retry ladder: a
``CapacityOverflow`` re-plans with 4x budgets (``scale_capacities``) up
to ``max_capacity_retry`` times, then raises.  The result is read back
once and materialized on the host.

Around it: CREATE/DROP TABLE, CREATE/DROP VIEW, CREATE [UNIQUE]/DROP
INDEX (metadata; the sorted sidecar an index probe reads is built at
execution), INSERT ... VALUES / SELECT (a host-side append, as in the
reference), UPDATE and DELETE (masked updates on the device), BEGIN /
COMMIT / ROLLBACK (no-ops without a storage plane), SET, SHOW TABLES /
INDEX / VARIABLES, DESCRIBE, SHOW CREATE TABLE / VIEW, EXPLAIN and
ANALYZE TABLE.

There is no plan cache, no parallel or pushed-down execution, no spill
tier and no tracing or metrics here.  Statements that need the storage
and transaction plane raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from oceanbase_tpu_torch.catalog import Catalog, ColumnDef, IndexDef, TableDef
from oceanbase_tpu_torch.datatypes import (
    SqlType,
    TypeKind,
    date_to_days,
    days_to_date,
)
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.exec.ops import merge_dicts
from oceanbase_tpu_torch.exec.plan import (
    IndexProbe,
    PlanNode,
    build_sidecar,
    execute_plan,
    index_probes,
    prepare_index_probes,
    referenced_tables,
)
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import (
    cast_column,
    eval_expr,
    eval_predicate,
    literal_value,
)
from oceanbase_tpu_torch.sql import ast
from oceanbase_tpu_torch.sql.binder import Binder, Scope
from oceanbase_tpu_torch.sql.optimizer import CostModel, scale_capacities
from oceanbase_tpu_torch.sql.parser import parse_sql
from oceanbase_tpu_torch.vector import (
    Column,
    Relation,
    empty_relation,
    from_numpy,
    to_numpy,
)

_POW10 = [10**i for i in range(38)]

_STORAGE = "ROADMAP Queue 1 item 5 (the storage and transaction plane)"
_MEASURE = "ROADMAP Queue 1 item 9 (the measurement plane)"
_VECTOR = "ROADMAP Queue 1 items 4 and 8 (VECTOR and side device modules)"


def _needs(what: str, item: str = _STORAGE):
    return NotImplementedError(f"{what} needs a Database; it waits for "
                               f"{item}")


# statement type -> (what, ROADMAP item) for statements this session
# refuses
_NEEDS_DATABASE = {
    ast.ProfileStmt: ("PROFILE", _MEASURE),
    ast.AnalyzeWorkloadStmt: ("ANALYZE WORKLOAD REPORT", _MEASURE),
    ast.CreateExternalTableStmt: ("CREATE EXTERNAL TABLE", _STORAGE),
    ast.KillStmt: ("KILL", _STORAGE),
    ast.SavepointStmt: ("SAVEPOINT", _STORAGE),
    ast.XaStmt: ("XA", _STORAGE),
    ast.ProcedureStmt: ("a stored procedure", _STORAGE),
    ast.CallStmt: ("CALL", _STORAGE),
    ast.AlterSystemStmt: ("ALTER SYSTEM", _STORAGE),
    ast.AlterTableStmt: ("ALTER TABLE", _STORAGE),
    ast.TenantStmt: ("a tenant", _STORAGE),
    ast.UserStmt: ("a user", _STORAGE),
    ast.LoadDataStmt: ("LOAD DATA", _STORAGE),
    ast.TruncateStmt: ("TRUNCATE", _STORAGE),
    ast.SequenceStmt: ("a sequence", _STORAGE),
    ast.LockTableStmt: ("LOCK TABLES", _STORAGE),
}


@dataclass
class Result:
    """A materialized result set."""

    names: list
    arrays: dict            # name -> numpy array (decoded strings)
    valids: dict            # name -> bool array or None
    dtypes: dict            # name -> SqlType
    rowcount: int = 0
    plan_text: Optional[str] = None

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


def _strings(names) -> np.ndarray:
    return np.array(list(names), dtype=object)


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
            "autocommit": 1, "max_capacity_retry": self.MAX_CAPACITY_RETRIES,
        }
        #: CapacityOverflow re-plans the last statement needed
        self.last_retries = 0
        #: the plan the last SELECT ran (after any capacity re-plans)
        self.last_plan: PlanNode | None = None
        #: its output columns, [(column id, output name)]
        self.last_outputs: list = []

    @property
    def device(self):
        return self.catalog.device

    def execute(self, sql: str, params: list | None = None) -> Result:
        """Parse + execute one statement."""
        return self.execute_stmt(parse_sql(sql), params)

    def execute_stmt(self, stmt, params=None) -> Result:
        if isinstance(stmt, ast.SelectStmt):
            return self._execute_select(stmt, params)
        if isinstance(stmt, ast.ExplainStmt):
            return self._explain(stmt.stmt, params, analyze=stmt.analyze)
        if isinstance(stmt, ast.CreateTableStmt):
            return self._create_table(stmt)
        if isinstance(stmt, ast.DropTableStmt):
            self.catalog.drop_table(stmt.name, if_exists=stmt.if_exists)
            return _ok()
        if isinstance(stmt, ast.CreateViewStmt):
            self.catalog.create_view(stmt.name, stmt.sql_text,
                                     cols=stmt.columns,
                                     or_replace=stmt.or_replace)
            return _ok()
        if isinstance(stmt, ast.DropViewStmt):
            if not self.catalog.drop_view(stmt.name) and \
                    not stmt.if_exists:
                raise KeyError(f"unknown view {stmt.name}")
            return _ok()
        if isinstance(stmt, ast.CreateIndexStmt):
            return self._create_index(stmt)
        if isinstance(stmt, ast.DropIndexStmt):
            return self._drop_index(stmt)
        if isinstance(stmt, ast.InsertStmt):
            return self._insert(stmt, params)
        if isinstance(stmt, ast.UpdateStmt):
            return self._update(stmt, params)
        if isinstance(stmt, ast.DeleteStmt):
            return self._delete(stmt, params)
        if isinstance(stmt, ast.ShowTablesStmt):
            names = sorted(set(self.catalog.tables())
                           | set(self.catalog.view_names()))
            return Result(["table_name"], {"table_name": _strings(names)},
                          {}, {"table_name": SqlType.string()},
                          rowcount=len(names))
        if isinstance(stmt, ast.DescribeStmt):
            return self._describe(stmt.table)
        if isinstance(stmt, ast.AnalyzeStmt):
            return self._analyze(stmt)
        if isinstance(stmt, ast.TxStmt):
            return _ok()  # nothing to begin or end without a storage plane
        if isinstance(stmt, ast.SetVarStmt):
            if stmt.scope == "global":
                raise ValueError("no global config available")
            self.variables[stmt.name] = stmt.value
            return _ok()
        if isinstance(stmt, ast.ShowCreateStmt):
            return self._show_create(stmt.table)
        if isinstance(stmt, ast.ShowStmt):
            return self._show(stmt)
        needs = _NEEDS_DATABASE.get(type(stmt))
        if needs is not None:
            raise _needs(*needs)
        raise NotImplementedError(type(stmt).__name__)

    # ------------------------------------------------------------------
    # SELECT, EXPLAIN
    # ------------------------------------------------------------------
    def _plan_select(self, stmt: ast.SelectStmt, params):
        binder = Binder(self.catalog, params=params or [],
                        sysvars=self.variables)
        binder.cost_model = CostModel()
        return binder.bind_select(stmt)

    def _execute_select(self, stmt: ast.SelectStmt, params) -> Result:
        return self._materialize(*self._run_select(stmt, params))

    def _run_select(self, stmt: ast.SelectStmt, params):
        """Bind and run a SELECT on the device under the capacity-retry
        ladder -> (result relation, [(column id, output name)])."""
        plan, outputs, _est = self._plan_select(stmt, params)
        tables = {t: self.catalog.table_data(t)
                  for t in referenced_tables(plan)
                  if self.catalog.has_table(t)}
        prepare_index_probes(self.catalog, plan, tables)
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
        self.last_plan = p
        self.last_outputs = outputs
        return rel, outputs

    def _explain(self, stmt, params, analyze: bool = False) -> Result:
        if not isinstance(stmt, ast.SelectStmt):
            raise NotImplementedError("EXPLAIN supports SELECT")
        if analyze:
            raise NotImplementedError(
                f"EXPLAIN ANALYZE reads the plan-monitor lanes, which "
                f"wait for {_MEASURE}")
        binder = Binder(self.catalog, params=params or [],
                        sysvars=self.variables)
        plan, _outputs, _est = binder.bind_select(stmt)
        text = format_plan(plan)
        lines = np.array(text.splitlines(), dtype=object)
        return Result(["plan"], {"plan": lines}, {},
                      {"plan": SqlType.string()}, rowcount=len(lines),
                      plan_text=text)

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

    # ------------------------------------------------------------------
    # metadata: ANALYZE, DESCRIBE, SHOW
    # ------------------------------------------------------------------
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
        return _ok()

    def _describe(self, name: str) -> Result:
        if self.catalog.view_def(name) is not None:
            return self._describe_view(name)
        td = self.catalog.table_def(name)
        return Result(
            ["field", "type", "null", "key"],
            {"field": _strings(c.name for c in td.columns),
             "type": _strings(str(c.dtype) for c in td.columns),
             "null": _strings("YES" if c.nullable else "NO"
                              for c in td.columns),
             "key": _strings("PRI" if c.name in td.primary_key else ""
                             for c in td.columns)},
            {}, {}, rowcount=len(td.columns))

    def _describe_view(self, name: str) -> Result:
        """DESCRIBE on a view: expand the body through the binder and
        derive output names and types by running the plan over empty
        typed relations — a metadata command does not scan the view's
        base tables.  Nullability and keys are not defined for a derived
        relation."""
        plan, outputs, _est = self._plan_select(
            parse_sql(f"select * from {name}"), None)
        dtables = {}
        for t in referenced_tables(plan):
            if self.catalog.has_table(t):
                td = self.catalog.table_def(t)
                dtables[t] = empty_relation(
                    {c.name: c.dtype for c in td.columns},
                    device=self.device)
        # throwaway sidecars of the empty relations, kept out of the
        # catalog's cache
        for node in index_probes(plan):
            if node.table in dtables:
                dtables[IndexProbe.sidecar_name(node.table, node.index)] = \
                    build_sidecar(self.catalog, node, dtables[node.table])
        rel = execute_plan(plan, dtables)
        names, types = [], []
        for cid, oname in outputs:
            out_name, k = oname, 2
            while out_name in names:
                out_name = f"{oname}_{k}"
                k += 1
            names.append(out_name)
            t = rel.columns[cid].dtype
            types.append(str(t) if t is not None else "")
        return Result(
            ["field", "type", "null", "key"],
            {"field": _strings(names), "type": _strings(types),
             "null": _strings(["YES"] * len(names)),
             "key": _strings([""] * len(names))},
            {}, {}, rowcount=len(names))

    def _show_create(self, name: str) -> Result:
        vdef = self.catalog.view_def(name)
        if vdef is not None:
            cols = (" (" + ", ".join(vdef["cols"]) + ")"
                    if vdef.get("cols") else "")
            text = f"CREATE VIEW {name}{cols} AS {vdef['sql']}"
            return Result(["view", "create_view"],
                          {"view": _strings([name]),
                           "create_view": _strings([text])},
                          {}, {}, rowcount=1)
        td = self.catalog.table_def(name)
        parts = []
        for c in td.columns:
            bits = [c.name, str(c.dtype)]
            if not c.nullable:
                bits.append("NOT NULL")
            if c.name in td.auto_increment_cols:
                bits.append("AUTO_INCREMENT")
            parts.append("  " + " ".join(bits))
        if td.primary_key:
            parts.append("  PRIMARY KEY (" + ", ".join(td.primary_key) + ")")
        for ix in td.indexes:
            kw = "UNIQUE KEY" if ix.unique else "KEY"
            parts.append(f"  {kw} {ix.name} (" + ", ".join(ix.columns) + ")")
        text = f"CREATE TABLE {td.name} (\n" + ",\n".join(parts) + "\n)"
        if td.partition:
            pcol, bounds = td.partition
            ps = [f"PARTITION p{i} VALUES LESS THAN ({b})"
                  for i, b in enumerate(bounds)]
            ps.append(f"PARTITION p{len(bounds)} VALUES LESS THAN MAXVALUE")
            text += f" PARTITION BY RANGE ({pcol}) (" + ", ".join(ps) + ")"
        return Result(["table", "create_table"],
                      {"table": _strings([td.name]),
                       "create_table": _strings([text])},
                      {}, {}, rowcount=1)

    def _show(self, stmt: ast.ShowStmt) -> Result:
        if stmt.what == "index":
            td = self.catalog.table_def(stmt.table)
            names, cols, uniq, kinds = [], [], [], []
            if td.primary_key:
                names.append("PRIMARY")
                cols.append(",".join(td.primary_key))
                uniq.append(1)
                kinds.append("primary")
            for ix in td.indexes:
                names.append(ix.name)
                cols.append(",".join(ix.columns))
                uniq.append(1 if ix.unique else 0)
                kinds.append("unique" if ix.unique else "normal")
            return Result(
                ["key_name", "columns", "unique", "index_type"],
                {"key_name": _strings(names), "columns": _strings(cols),
                 "unique": np.array(uniq, dtype=np.int64),
                 "index_type": _strings(kinds)},
                {}, {}, rowcount=len(names))
        if stmt.what == "variables":
            names = sorted(self.variables)
            return Result(
                ["variable_name", "value"],
                {"variable_name": _strings(names),
                 "value": _strings(str(self.variables[n]) for n in names)},
                {}, {}, rowcount=len(names))
        if stmt.what in ("trace", "metrics", "profile", "workload_report"):
            raise _needs(f"SHOW {stmt.what.upper()}", _MEASURE)
        if stmt.what == "processlist":
            raise _needs("SHOW PROCESSLIST")
        return _ok()  # SHOW PARAMETERS: no system configuration here

    # ------------------------------------------------------------------
    # DDL
    # ------------------------------------------------------------------
    def _create_table(self, stmt: ast.CreateTableStmt) -> Result:
        # capability checks before anything is created
        if stmt.as_select is not None:
            raise _needs("CREATE TABLE ... AS SELECT")
        if stmt.indexes:
            raise _needs("an inline secondary index")
        cols = [ColumnDef(c.name, c.dtype, c.nullable) for c in stmt.columns]
        # AUTO_INCREMENT is recorded; filling it needs a sequence, which
        # needs the storage plane (an omitted value is NULL here)
        tdef = TableDef(stmt.name, cols, primary_key=stmt.primary_key,
                        partition=stmt.partition,
                        auto_increment_cols=[c.name for c in stmt.columns
                                             if c.auto_increment])
        existed = stmt.if_not_exists and self.catalog.has_table(stmt.name)
        self.catalog.create_table(tdef, if_not_exists=stmt.if_not_exists)
        if not existed:
            # one all-dead row (static shapes need capacity >= 1), on the
            # catalog's device
            self.catalog.set_data(stmt.name, empty_relation(
                {c.name: c.dtype for c in stmt.columns},
                device=self.device))
        return _ok()

    def _create_index(self, stmt: ast.CreateIndexStmt) -> Result:
        """CREATE [UNIQUE] INDEX: metadata the optimizer reads to choose
        the index-probe access path; the sorted sidecar is built from the
        device relation at execution (``prepare_index_probes``).
        Uniqueness is recorded, not enforced, as in the reference's
        session without a storage engine."""
        td = self.catalog.table_def(stmt.table)
        if stmt.kind in ("vector", "fulltext"):
            raise NotImplementedError(
                f"{stmt.kind} indexes wait for {_VECTOR}")
        if any(ix.name == stmt.name for ix in td.indexes):
            if stmt.if_not_exists:
                return _ok()
            raise ValueError(f"index {stmt.name} exists on {stmt.table}")
        for c in stmt.columns:
            td.column(c)  # existence check
        td.indexes.append(IndexDef(
            name=stmt.name, table=stmt.table, columns=list(stmt.columns),
            unique=stmt.unique, storage_table=""))
        self.catalog.schema_version += 1
        return _ok()

    def _drop_index(self, stmt: ast.DropIndexStmt) -> Result:
        td = self.catalog.table_def(stmt.table)
        before = len(td.indexes)
        td.indexes = [ix for ix in td.indexes if ix.name != stmt.name]
        if len(td.indexes) == before and not stmt.if_exists:
            raise KeyError(f"index {stmt.name} not found on {stmt.table}")
        self.catalog.drop_sidecars(stmt.table, stmt.name)
        self.catalog.schema_version += 1
        return _ok()

    # ------------------------------------------------------------------
    # DML without a storage engine
    # ------------------------------------------------------------------
    def _insert(self, stmt: ast.InsertStmt, params) -> Result:
        if stmt.replace:
            raise _needs("REPLACE INTO (primary-key enforcement)")
        td = self.catalog.table_def(stmt.table)
        cols = stmt.columns or td.column_names
        new, new_valid = {}, {}
        if stmt.rows is not None:
            vals = {c: [] for c in cols}
            for row in stmt.rows:
                if len(row) != len(cols):
                    raise ValueError("INSERT arity mismatch")
                for c, e in zip(cols, row):
                    v, t = literal_value(_as_literal(e, params))
                    vals[c].append(_coerce_value(v, t, td.column(c).dtype))
            for c in cols:
                dtype = td.column(c).dtype
                new_valid[c] = np.array([x is not None for x in vals[c]],
                                        dtype=bool)
                fill = "" if dtype.is_string else 0
                new[c] = np.array([fill if x is None else x
                                   for x in vals[c]],
                                  dtype=object if dtype.is_string
                                  else dtype.np_dtype)
            n_new = len(stmt.rows)
        else:
            rel, outputs = self._run_select(stmt.select, params)
            if len(outputs) != len(cols):
                raise ValueError("INSERT arity mismatch")
            # each result column cast on the device to its target type
            raw = to_numpy(Relation(columns={
                c: cast_column(rel.columns[cid], td.column(c).dtype)
                for c, (cid, _name) in zip(cols, outputs)}, mask=rel.mask))
            n_new = len(raw[cols[0]])
            for c in cols:
                new[c] = raw[c]
                new_valid[c] = raw.get("__valid__" + c,
                                       np.ones(n_new, dtype=bool))
        return self._append_rows(td, new, new_valid, n_new)

    def _append_rows(self, td: TableDef, new: dict, new_valid: dict,
                     n_new: int) -> Result:
        """Host-side append: decode the live rows, concatenate the new
        ones (columns not listed get NULL), re-encode on the catalog's
        device."""
        raw = to_numpy(self.catalog.table_data(td.name))
        arrays, valids = {}, {}
        for c in td.columns:
            oldv = raw.get(c.name)
            oldvalid = raw.get("__valid__" + c.name)
            if oldv is None:
                oldv = np.zeros(0, dtype=c.dtype.np_dtype)
            if oldvalid is None:
                oldvalid = np.ones(len(oldv), dtype=bool)
            if c.name in new:
                newv, newvalid = new[c.name], new_valid[c.name]
            else:
                newvalid = np.zeros(n_new, dtype=bool)
                newv = np.zeros(n_new, dtype=object if c.dtype.is_string
                                else c.dtype.np_dtype)
            valid = np.concatenate([oldvalid, newvalid])
            if c.dtype.is_string:
                # decoded NULL lanes hold None; the validity says NULL
                data = np.concatenate([oldv.astype(object),
                                       newv.astype(object)])
                data[~valid] = ""
            else:
                data = np.concatenate([oldv, newv])
            arrays[c.name], valids[c.name] = data, valid
        rel = from_numpy(arrays, types={c.name: c.dtype for c in td.columns},
                         valids={k: v for k, v in valids.items()
                                 if not v.all()},
                         device=self.device)
        self.catalog.set_data(td.name, rel)
        return _ok(rowcount=n_new)

    def _dml_target(self, table: str, where, params):
        """(relation, binder, scope, matched-row mask) of an UPDATE or
        DELETE: the WHERE evaluated on the device."""
        rel = self.catalog.table_data(table)
        binder = Binder(self.catalog, params=params or [])
        scope = Scope()
        for c in self.catalog.table_def(table).columns:
            scope.add(c.name, c.name, alias=table)
        if where is not None:
            hit = eval_predicate(binder.bind_expr(where, scope), rel)
        else:
            hit = rel.mask_or_true()
        return rel, binder, scope, hit

    def _update(self, stmt: ast.UpdateStmt, params) -> Result:
        """A masked update on the device.  A string column and its new
        values are first re-encoded into one merged dictionary
        (``merge_dicts``, as UNION does), so a value the column's
        dictionary lacks is stored as itself."""
        rel, binder, scope, hit = self._dml_target(stmt.table, stmt.where,
                                                   params)
        new_cols = dict(rel.columns)
        for cname, e in stmt.assignments:
            oldc = rel.columns[cname]
            newc = cast_column(eval_expr(binder.bind_expr(e, scope), rel),
                               oldc.dtype)
            sdict = oldc.sdict
            if oldc.dtype.is_string:
                (oldc, newc), sdict = merge_dicts([oldc, newc])
            data = torch.where(hit, newc.data.to(oldc.data.dtype), oldc.data)
            valid = None
            if oldc.valid is not None or newc.valid is not None:
                valid = torch.where(hit, newc.valid_or_true(),
                                    oldc.valid_or_true())
            new_cols[cname] = Column(data, valid, oldc.dtype, sdict)
        self.catalog.set_data(stmt.table,
                              Relation(columns=new_cols, mask=rel.mask))
        # the rowcount is read after the device work is queued
        return _ok(rowcount=int(hit.sum()))

    def _delete(self, stmt: ast.DeleteStmt, params) -> Result:
        rel, _binder, _scope, hit = self._dml_target(stmt.table, stmt.where,
                                                     params)
        self.catalog.set_data(stmt.table,
                              rel.with_mask(rel.mask_or_true() & ~hit))
        return _ok(rowcount=int(hit.sum()))


def _as_literal(e, params) -> ir.Literal:
    if isinstance(e, ir.Literal):
        return e
    if isinstance(e, ast.Param):
        return ir.Literal(params[e.index])
    if isinstance(e, ir.Arith) and isinstance(e.left, ir.Literal) and \
            isinstance(e.right, ir.Literal):
        lv, _ = literal_value(e.left)
        rv, _ = literal_value(e.right)
        return ir.Literal({"+": lv + rv, "-": lv - rv, "*": lv * rv}[e.op])
    raise ValueError("INSERT VALUES must be literals")


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
        return date_to_days(v)
    if target.kind == TypeKind.BOOL:
        return bool(v)
    if target.kind == TypeKind.VECTOR:
        raise NotImplementedError(f"VECTOR values wait for {_VECTOR}")
    return v


def _rescale(v: int, from_scale: int, to_scale: int) -> int:
    if to_scale >= from_scale:
        return v * _POW10[to_scale - from_scale]
    d = _POW10[from_scale - to_scale]
    half = d // 2
    return (v + half) // d if v >= 0 else -((-v + half) // d)


def _ok(rowcount: int = 0) -> Result:
    return Result([], {}, {}, {}, rowcount=rowcount)


def format_plan(node, indent: int = 0) -> str:
    """EXPLAIN text: one line per operator with its attributes, children
    indented below it."""
    pad = "  " * indent
    attrs = []
    for k, v in vars(node).items():
        if k == "est_rows" or k.startswith("_"):
            continue  # estimate annotation / memoized metadata
        if isinstance(v, PlanNode) or k in ("child", "left", "right",
                                            "inputs"):
            continue
        s = repr(v)
        if len(s) > 60:
            s = s[:57] + "..."
        attrs.append(f"{k}={s}")
    line = f"{pad}{type(node).__name__}({', '.join(attrs)})"
    return "\n".join([line] + [format_plan(c, indent + 1)
                               for c in node.children()])


__all__ = ["Result", "Session", "format_plan"]
