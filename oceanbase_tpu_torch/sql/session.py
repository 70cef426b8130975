"""Session: the SQL entry point (parse -> bind -> optimize -> execute).

Port of ``oceanbase_tpu/sql/session.py``.  A SELECT is parsed, bound and
optimized on the host by the port's own front end, then run by the
port's ``execute_plan`` on the catalog's device under the reference's
capacity-retry ladder: a ``CapacityOverflow`` re-plans with 4x budgets
(``scale_capacities``) up to ``max_capacity_retry`` times, then raises.
The result is read back once and materialized on the host.

Without a ``Database`` (the catalog-only session): CREATE/DROP TABLE,
CREATE/DROP VIEW, CREATE [UNIQUE]/DROP INDEX (metadata; the sorted
sidecar an index probe reads is built at execution), INSERT ... VALUES /
SELECT (a host-side append, as in the reference), UPDATE and DELETE
(masked updates on the device), BEGIN / COMMIT / ROLLBACK (no-ops), SET,
SHOW TABLES / INDEX / VARIABLES, DESCRIBE, SHOW CREATE TABLE / VIEW,
EXPLAIN and ANALYZE TABLE.

With a ``Database`` (``Database(root).session()``), the reference's
storage branches: tables live in the LSM engine; a SELECT reads the
snapshot of its transaction (``_table_snapshot``), a filter on a key or
an index prefix swaps the table's device relation for a few pruned
chunks (``sql/access_path.py``), and a table whose estimated rows exceed
``sql_work_area_rows`` streams from the LSM through the spill tier
(``_spill_candidates`` -> ``_try_spilled`` -> ``segment_chunk_provider``
-> ``execute_spilled``), which is also the backstop of an exhausted
capacity-retry ladder.  INSERT/UPDATE/DELETE write MVCC versions through
the ``TransService`` (snapshot isolation, write-conflict detection, WAL
group commit, statement rollback inside a transaction); UPDATE and
DELETE evaluate their WHERE and SET expressions on the device and read
the matched rows back once per statement.  BEGIN / COMMIT / ROLLBACK,
CREATE TABLE with inline indexes, AUTO_INCREMENT and RANGE partitions,
CREATE TABLE ... AS SELECT, engine CREATE/DROP INDEX with backfill,
TRUNCATE (under an exclusive table lock), LOAD DATA INFILE (the native
CSV tokenizer, the python ``csv`` module for what it refuses), REPLACE
INTO, parallel DML over the tenant's workers, CREATE/DROP SEQUENCE and
``nextval``, SAVEPOINT / ROLLBACK TO / RELEASE, the XA statements, ALTER
TABLE ADD/DROP COLUMN, LOCK TABLES / UNLOCK TABLES, SET GLOBAL / ALTER
SYSTEM SET for the ported knobs and ALTER SYSTEM MINOR/MAJOR FREEZE.
An INSERT (and the insert half of a key- or partition-moving UPDATE)
checks its keys against the memtables and the segments at the
statement's snapshot, so a key flushed or bulk-loaded into a segment
is not overwritten (the reference checks only the active memtable).

The server plane, with a ``Database``: a session belongs to a tenant
(``Database.session(tenant=...)``; its transactions, storage and
sequences are that tenant's), has a ``session_id`` and a SHOW
PROCESSLIST slot, and runs each query or DML statement under statement
admission (``server/admission.py``: a per-tenant slot checked out
before binding, a deadline from ``query_timeout_s``, a KILL flag, all
observed host-side at the checkpoints of ``execute_plan``, the spill
tier's batches and the retry ladder).  KILL [QUERY], SHOW PROCESSLIST,
CREATE/DROP TENANT, CREATE/DROP USER and SET PASSWORD, stored procedures
and CALL (persisted in ``procedures.json``), and a per-session LRU plan
cache of bound SELECT plans keyed by statement text, parameters and
schema version under ``plan_cache_mem_limit``.

The measurement plane, with a ``Database``: every statement is audited
(gv$sql_audit: queue, host and device seconds, the host phases, its
trace_id), traced (a root span with bind, execute, ``plan.execute`` and
per-operator children; kept by ``trace_sample_rate`` or when slow or
failed) and counted (``sql.*``, ``plan_cache.*``); a SELECT's plan
carries per-operator monitor rows (sampled by
``plan_monitor_sample_every``), cardinality feedback re-seeds its
capacities, and the plan-history watchdog, the plan-choice ledger and
the time calibration table learn from its measured device time.
EXPLAIN ANALYZE (with its roofline line), PROFILE (torch.profiler),
SHOW TRACE / METRICS / PROFILE, ALTER SYSTEM CALIBRATE and the gv$/v$
views (materialized per statement as transient tables) run.

External tables (CREATE EXTERNAL TABLE: a CSV or Parquet file read at
query time) and the workload repository's ANALYZE / SHOW WORKLOAD
REPORT run; a spilled statement's temp files count against the tenant's
spill budget.  There is no parallel or pushed-down query execution.

VECTOR(d) columns take '[x, y, ...]' literals; CREATE VECTOR INDEX ...
WITH (metric = ..., approximate = ...) serves ORDER BY <distance> LIMIT
k through the ANN access path (``_try_ann_prefilter``: exact search, or
IVF-Flat when the index opts in), and CREATE FULLTEXT INDEX records the
index beside MATCH ... AGAINST.
"""

from __future__ import annotations

import copy
import csv
import json
import os
import tempfile
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from oceanbase_tpu_torch import native
from oceanbase_tpu_torch.catalog import Catalog, ColumnDef, IndexDef, TableDef
from oceanbase_tpu_torch.datatypes import (
    DATE_EPOCH,
    SqlType,
    TypeKind,
    date_to_days,
    days_to_date,
)
from oceanbase_tpu_torch.exec import plan as qplan
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.exec.granule import segment_chunk_provider
from oceanbase_tpu_torch.exec.ops import merge_dicts
from oceanbase_tpu_torch.exec.plan import (
    IndexProbe,
    PlanNode,
    build_sidecar,
    execute_plan,
    index_probes,
    logical_hash,
    monitored_postorder,
    prepare_index_probes,
    referenced_tables,
)
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import (
    US_PER_DAY,
    cast_column,
    eval_expr,
    eval_predicate,
    literal_value,
    parse_vector_text,
)
from oceanbase_tpu_torch.px.planner import NotDistributable
from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server import calibrate as qcalibrate
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import profiler as qprofiler
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.server.monitor import AuditRecord
from oceanbase_tpu_torch.share.vector_index import IvfFlatIndex, exact_search
from oceanbase_tpu_torch.sql import access_path as ap
from oceanbase_tpu_torch.sql import ast
from oceanbase_tpu_torch.sql.binder import Binder, Scope
from oceanbase_tpu_torch.sql.optimizer import (
    CostModel,
    apply_feedback,
    overflow_jump_factor,
    scale_capacities,
)
from oceanbase_tpu_torch.sql.parser import parse_sql
from oceanbase_tpu_torch.storage.lookup import (
    estimate_rows_in_ranges,
    live_keys,
)
from oceanbase_tpu_torch.tx.errors import DuplicateKey
from oceanbase_tpu_torch.tx.service import TxState
from oceanbase_tpu_torch.vector import (
    Column,
    Relation,
    bucket_capacity,
    empty_relation,
    from_numpy,
    to_numpy,
)

# statement accounting (host side, statement boundary), the reference's
# series
qmetrics.declare("sql.statements", "counter",
                 "statements executed (labels: tenant, ok)")
qmetrics.declare("sql.statement_s", "histogram",
                 "end-to-end statement latency", unit="s")
qmetrics.declare("sql.rows_returned", "counter",
                 "result rows returned to clients")
qmetrics.declare("plan_cache.hits", "counter",
                 "session plan-cache hits")
qmetrics.declare("plan_cache.misses", "counter",
                 "session plan-cache misses (bind + optimize paid)")
qmetrics.declare("plan_cache.evictions", "counter",
                 "session plan-cache LRU evictions")

_POW10 = [10**i for i in range(38)]


def _needs_db(what: str):
    return NotImplementedError(
        f"{what} needs a Database "
        f"(oceanbase_tpu_torch.server.database.Database)")


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

    ``catalog`` defaults to the ``Database``'s catalog when ``db`` is
    given, else to an empty ``Catalog`` on ``device`` (None means
    ``"cuda"``; without CUDA that raises unless ``device="cpu"``).  A
    given catalog keeps its own device."""

    MAX_CAPACITY_RETRIES = 3
    HIST_BUCKETS = 64
    MCV_K = 16  # most-common-values kept per string column

    def __init__(self, catalog: Catalog | None = None, device=None,
                 db=None, tenant=None):
        if tenant is None and db is not None:
            tenant = db.tenant()
        if catalog is None:
            catalog = (tenant.catalog if tenant is not None
                       else Catalog(device))
        self.catalog = catalog
        #: server.database.Database when backed by the storage/tx plane
        self.db = db
        #: server.tenant.Tenant whose module stack the session runs on
        self.tenant = tenant
        self.session_id = 0
        self.variables: dict[str, object] = {
            "autocommit": 1, "max_capacity_retry": self.MAX_CAPACITY_RETRIES,
        }
        # LRU plan cache: most-recently-used last; byte-accounted against
        # plan_cache_mem_limit (≙ ObPlanCache memory-bounded eviction)
        self.plan_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._plan_cache_bytes: dict[tuple, int] = {}
        self._plan_cache_total = 0
        #: plan-cache hits, misses and LRU evictions of this session (the
        #: reference counts them in its metrics plane)
        self.plan_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}
        self._tx = None  # active explicit transaction (BEGIN ... COMMIT)
        #: this session's SHOW PROCESSLIST slot (server/monitor.py)
        self._ash_state = {"active": False, "sql": "", "state": "idle"}
        if db is not None:
            self.session_id = next(db._session_ids)
            db.ash.register(self.session_id, self._ash_state)
        #: CapacityOverflow re-plans the last statement needed
        self.last_retries = 0
        #: the plan the last SELECT ran (after any capacity re-plans)
        self.last_plan: PlanNode | None = None
        #: its output columns, [(column id, output name)]
        self.last_outputs: list = []
        #: SpillStats of the last SELECT when it took the spill route
        self.last_spill = None
        #: {table: AccessChoice} of the last SELECT, UPDATE or DELETE
        #: whose relation came from the access path (sql/access_path.py)
        self.last_access_paths: dict = {}
        #: "exact" | "ivf" when the last SELECT's scan took the ANN
        #: access path (a vector index), else None
        self.last_ann_path = None
        #: capacity of the relation the last UPDATE/DELETE evaluated
        self.last_dml_capacity = 0
        #: {"route": "native" | "python", "rows", "bytes"} of the last
        #: LOAD DATA
        self.last_load = None
        #: trace id SHOW TRACE renders (the last statement whose trace
        #: was kept)
        self._last_trace_id = ""
        self._stmt_is_show_trace = False
        #: bind window of the last SELECT (gv$sql_audit.compile_s)
        self._last_compile_s = 0.0
        #: the binder's CBO choices of the last bind (gv$plan_choice)
        self._last_cbo_choices: list = []
        #: trace id of this session's last PROFILE capture
        self._last_profile_trace_id = ""

    @property
    def device(self):
        return self.catalog.device

    # the tenant's module stack
    @property
    def _sequences(self):
        return self.tenant.sequences if self.tenant is not None else None

    @property
    def _txsvc(self):
        return self.tenant.tx

    @property
    def _engine(self):
        return self.tenant.engine

    def close(self):
        """Release the session: roll back its open transaction (and with
        it the table locks the transaction holds), leave the session
        registry and drop its admission eviction flag."""
        if self._tx is not None and self.db is not None:
            self._txsvc.rollback(self._tx)
            self._tx = None
        if self.db is not None:
            self.db.ash.unregister(self.session_id)
            self.db.admission.forget_session(self.session_id)

    # statement shapes that pay admission (queries + DML + anything that
    # executes a plan); admin and control statements — SET, SHOW, KILL,
    # ALTER SYSTEM, transaction verbs — bypass it so an operator can
    # still steer a saturated server
    _ADMITTED_STMTS = (ast.SelectStmt, ast.InsertStmt, ast.UpdateStmt,
                       ast.DeleteStmt, ast.CallStmt, ast.LoadDataStmt)

    def _needs_admission(self, stmt) -> bool:
        if isinstance(stmt, ast.ProfileStmt):
            return self._needs_admission(stmt.stmt)  # PROFILE runs it
        if isinstance(stmt, self._ADMITTED_STMTS):
            return True
        if isinstance(stmt, ast.ExplainStmt) and stmt.analyze:
            return True  # EXPLAIN ANALYZE executes the plan
        if isinstance(stmt, ast.CreateTableStmt) and \
                stmt.as_select is not None:
            return True  # CTAS executes its SELECT
        return False

    def _stmt_timeout_s(self) -> float | None:
        """Effective per-statement deadline: the session variable wins
        (SET query_timeout_s = 0.5 works sub-second), then the tenant's
        config overlay (SET GLOBAL writes there), else the cluster
        default."""
        v = self.variables.get("query_timeout_s")
        if v is None:
            v = self.tenant.config["query_timeout_s"]
        try:
            v = float(v)
        except (TypeError, ValueError):
            return None
        return v if v > 0 else None

    def execute(self, sql: str, params: list | None = None) -> Result:
        """Parse + execute one statement, with request auditing, ASH
        state and a full-link trace root span (≙ obmp_query process +
        sql_audit recording + ObTrace begin/end).

        With a ``Database``, a query or DML statement checks a per-tenant
        admission slot out BEFORE binding (typed ``ServerBusy`` when the
        bounded queue is full) and runs under a ``StmtCtx`` whose
        deadline and KILL flag the host-side checkpoints observe; the
        session's SHOW PROCESSLIST slot says QUEUED, RUNNING or KILLED
        meanwhile.  At the end the statement's host/device split is read
        (``exec_times``; its result has been read by then, so no event
        pair waits) into the audit record and the tenant's time model."""
        start = time.time()        # wall ts for the audit record
        t0 = time.monotonic()      # duration source (step-proof)
        err = ""
        out = None
        # host/device split accumulator: statement-scoped, so audit and
        # plan-monitor rows attribute exactly this statement's work
        qplan.reset_exec_times()
        tctx = qtrace.start_trace(self.db)
        self._ash_state.update(
            active=True, sql=sql, state="executing",
            trace_id=tctx.trace_id if tctx is not None else "")
        self._last_compile_s = 0.0
        self._stmt_is_show_trace = False  # set by _show_trace()
        admission = self.db.admission if self.db is not None else None
        ctx: qadmission.StmtCtx | None = None
        try:
            if admission is not None:
                # a session evicted by plain KILL <id> takes no more
                # statements (typed; the client reconnects)
                admission.check_session(self.session_id)
            with qtrace.activate(tctx):
                with qtrace.span("statement", sql=sql[:200],
                                 session=self.session_id):
                    stmt = parse_sql(sql)
                    if admission is not None and \
                            self._needs_admission(stmt):
                        ctx = qadmission.StmtCtx(
                            session_id=self.session_id,
                            tenant=self.tenant.name, sql=sql,
                            timeout_s=self._stmt_timeout_s(),
                            controller=admission,
                            ash_state=self._ash_state)
                        self._ash_state["state"] = "queued"
                        try:
                            admission.acquire(ctx)
                        finally:
                            if self._ash_state.get("state") == "queued":
                                self._ash_state["state"] = "executing"
                        if ctx.queue_s > 0:
                            # queued time is a first-class wait: a span
                            # in the statement tree + gv$sql_audit's
                            # queue_s column
                            qtrace.add_span("admission.wait",
                                            ctx.queue_s,
                                            tenant=ctx.tenant)
                    with qadmission.activate(ctx):
                        self._materialize_virtuals(stmt)
                        out = self.execute_stmt(stmt, params)
                        return out
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            if ctx is not None:
                admission.release(ctx)
            self._finish_statement(sql, start, t0, out, err, tctx, ctx)

    def _finish_statement(self, sql, start, t0, out, err, tctx, ctx):
        """Statement close: metrics, trace retention, the audit record
        and the time model."""
        times = qplan.exec_times()
        elapsed = time.monotonic() - t0
        self._ash_state.update(active=False, state="idle", trace_id="")
        tname = self.tenant.name if self.tenant is not None else "sys"
        qmetrics.inc("sql.statements", tenant=tname, ok=0 if err else 1)
        qmetrics.observe("sql.statement_s", elapsed, tenant=tname)
        if out is not None and out.rowcount > 0:
            qmetrics.inc("sql.rows_returned", out.rowcount, tenant=tname)
        trace_id = ""
        if tctx is not None:
            kept = qtrace.finish_trace(self.db, tctx, elapsed, error=err)
            if kept:
                trace_id = tctx.trace_id
                # SHOW TRACE reads the LAST statement's tree — a SHOW
                # TRACE must not clobber what it displays
                if not self._stmt_is_show_trace:
                    self._last_trace_id = trace_id
            elif not self._stmt_is_show_trace:
                # sampled away: SHOW TRACE must come up empty, not
                # attribute an older statement's tree
                self._last_trace_id = ""
        if self.db is None:
            return
        queue_s = ctx.queue_s if ctx is not None else 0.0
        self.db.audit.record(AuditRecord(
            sql=sql, session_id=self.session_id, tenant=tname,
            start_ts=start, elapsed_s=elapsed,
            rows=out.rowcount if out is not None else 0, error=err,
            compile_s=self._last_compile_s, trace_id=trace_id,
            queue_s=queue_s, host_s=times.host_s,
            device_s=times.device_s, bind_s=times.bind_s,
            sidecar_build_s=times.sidecar_build_s,
            lower_s=times.lower_s, xla_compile_s=times.compile_s,
            dispatch_s=times.dispatch_s, merge_s=times.merge_s))
        self.db.time_model.observe(tname, times, elapsed_s=elapsed,
                                   queue_s=queue_s)

    def _materialize_virtuals(self, stmt):
        """Refresh every gv$/v$ view the statement references as a
        transient catalog table (≙ virtual table iterators serving the
        query): SELECT (FROM, CTEs, set ops, expression subqueries),
        EXPLAIN, PROFILE, INSERT ... SELECT, UPDATE/DELETE WHERE
        subqueries and DESCRIBE, through view bodies too."""
        if self.db is None:
            return
        vt = self.db.virtual_tables
        seen_views: set = set()

        def refresh(name):
            arrays = vt.provide(name)
            if arrays is not None:
                self.catalog.register_transient(name, arrays)
                return
            # a view body may reference gv$/v$ tables too
            vdef = self.catalog.view_def(name)
            if vdef is None or name in seen_views:
                return
            seen_views.add(name)
            try:
                body = parse_sql(vdef["sql"])
            except Exception:
                return
            if isinstance(body, ast.SelectStmt):
                walk_sel(body)

        def walk_expr(e):
            if e is None or not isinstance(e, ir.Expr):
                return
            if isinstance(e, ast.Subquery) and e.select is not None:
                walk_sel(e.select)
            for c in e.children():
                walk_expr(c)

        def walk_from(items):
            for t in items:
                if isinstance(t, ast.TableRef):
                    refresh(t.name)
                elif isinstance(t, ast.JoinRef):
                    walk_from([t.left, t.right])
                    if isinstance(t.on, ir.Expr):
                        walk_expr(t.on)
                elif isinstance(t, ast.SubqueryRef):
                    walk_sel(t.select)

        def walk_sel(sel):
            walk_from(sel.from_)
            for e, _ in sel.items:
                walk_expr(e)
            walk_expr(sel.where)
            walk_expr(sel.having)
            for _, sub in sel.ctes:
                walk_sel(sub)
            for _, _, rhs in sel.setops:
                walk_sel(rhs)

        if isinstance(stmt, ast.ProfileStmt):
            stmt = stmt.stmt
        if isinstance(stmt, ast.ExplainStmt):
            stmt = stmt.stmt
        if isinstance(stmt, ast.SelectStmt):
            walk_sel(stmt)
        elif isinstance(stmt, ast.InsertStmt) and stmt.select is not None:
            walk_sel(stmt.select)
        elif isinstance(stmt, (ast.UpdateStmt, ast.DeleteStmt)):
            walk_expr(stmt.where)
        elif isinstance(stmt, ast.DescribeStmt):
            refresh(stmt.table)

    def execute_stmt(self, stmt, params=None) -> Result:
        if isinstance(stmt, ast.SelectStmt):
            return self._execute_select(stmt, params)
        if isinstance(stmt, ast.ExplainStmt):
            return self._explain(stmt.stmt, params, analyze=stmt.analyze)
        if isinstance(stmt, ast.ProfileStmt):
            return self._profile(stmt, params)
        if isinstance(stmt, ast.CreateTableStmt):
            return self._create_table(stmt)
        if isinstance(stmt, ast.DropTableStmt):
            if self.catalog.drop_external(stmt.name):
                return _ok()
            self.catalog.drop_table(stmt.name, if_exists=stmt.if_exists)
            return _ok()
        if isinstance(stmt, ast.CreateExternalTableStmt):
            td = TableDef(stmt.name,
                          [ColumnDef(c.name, c.dtype, c.nullable)
                           for c in stmt.columns])
            self.catalog.register_external(
                td, stmt.location, fmt=stmt.format,
                delimiter=stmt.delimiter, skip_lines=stmt.skip_lines,
                if_not_exists=stmt.if_not_exists)
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
            if self.db is not None:
                return self._insert_tx(stmt, params)
            return self._insert(stmt, params)
        if isinstance(stmt, ast.UpdateStmt):
            if self.db is not None:
                return self._update_tx(stmt, params)
            return self._update(stmt, params)
        if isinstance(stmt, ast.DeleteStmt):
            if self.db is not None:
                return self._delete_tx(stmt, params)
            return self._delete(stmt, params)
        if isinstance(stmt, ast.ShowTablesStmt):
            # the gv$ views are part of the schema surface: every
            # diagnostic view is discoverable
            vt = (self.db.virtual_tables.names() if self.db is not None
                  else ())
            names = sorted(set(self.catalog.tables())
                           | set(self.catalog.view_names()) | set(vt))
            return Result(["table_name"], {"table_name": _strings(names)},
                          {}, {"table_name": SqlType.string()},
                          rowcount=len(names))
        if isinstance(stmt, ast.DescribeStmt):
            return self._describe(stmt.table)
        if isinstance(stmt, ast.AnalyzeWorkloadStmt):
            return self._analyze_workload(stmt)
        if isinstance(stmt, ast.AnalyzeStmt):
            return self._analyze(stmt)
        if isinstance(stmt, ast.TxStmt):
            return self._tx_control(stmt.op)
        if isinstance(stmt, ast.SetVarStmt):
            if stmt.scope == "global":
                if self.db is None:
                    raise ValueError("no global config available")
                self.tenant.config.set(stmt.name, stmt.value)
            else:
                self.variables[stmt.name] = stmt.value
            return _ok()
        if isinstance(stmt, ast.AlterSystemStmt):
            return self._alter_system(stmt)
        if isinstance(stmt, ast.TruncateStmt):
            return self._truncate(stmt)
        if isinstance(stmt, ast.ShowCreateStmt):
            return self._show_create(stmt.table)
        if isinstance(stmt, ast.ShowStmt):
            return self._show(stmt)
        if isinstance(stmt, ast.LoadDataStmt):
            return self._load_data(stmt)
        if isinstance(stmt, ast.AlterTableStmt):
            return self._alter_table(stmt)
        if isinstance(stmt, ast.SequenceStmt):
            return self._sequence(stmt)
        if isinstance(stmt, ast.SavepointStmt):
            return self._savepoint(stmt)
        if isinstance(stmt, ast.XaStmt):
            return self._xa(stmt)
        if isinstance(stmt, ast.LockTableStmt):
            return self._lock_table(stmt)
        if isinstance(stmt, ast.KillStmt):
            return self._kill(stmt)
        if isinstance(stmt, ast.ProcedureStmt):
            return self._procedure_ddl(stmt)
        if isinstance(stmt, ast.CallStmt):
            return self._call_procedure(stmt, params)
        if isinstance(stmt, ast.TenantStmt):
            if self.db is None:
                raise _needs_db("a tenant")
            if stmt.op == "create":
                self.db.create_tenant(stmt.name)
            else:
                self.db.drop_tenant(stmt.name)
            return _ok()
        if isinstance(stmt, ast.UserStmt):
            if self.db is None:
                raise _needs_db("a user")
            if stmt.op == "create":
                self.db.create_user(stmt.name, stmt.password)
            elif stmt.op == "drop":
                self.db.drop_user(stmt.name)
            else:
                self.db.set_password(stmt.name, stmt.password)
            return _ok()
        raise NotImplementedError(type(stmt).__name__)

    # ------------------------------------------------------------------
    # SELECT, EXPLAIN
    # ------------------------------------------------------------------
    def _cost_model(self) -> CostModel:
        """CBO pricing context: THIS database's measured gv$cost_units
        (the process units inside CostModel when absent) with
        gv$time_calibration's per-operator corrections folded in —
        clamped, and only after a few observations, so one wild early
        sample cannot poison later plan choices."""
        if self.db is None:
            return CostModel()
        corrections: dict = {}
        for r in self.db.time_calibration.rows():
            if r["count"] >= 3 and r["correction"] > 0.0:
                corrections[r["op"]] = min(
                    max(float(r["correction"]), 0.25), 8.0)
        return CostModel(units=self.db.cost_units, corrections=corrections)

    def _binder(self, params) -> Binder:
        binder = Binder(self.catalog, params=params or [],
                        sequences=self._sequences, sysvars=self.variables)
        binder.cost_model = self._cost_model()
        return binder

    def _plan_select(self, stmt: ast.SelectStmt, params):
        binder = self._binder(params)
        out = binder.bind_select(stmt)
        self._last_cbo_choices = list(binder.cbo_choices)
        return out

    def _plan_select_cached(self, sql_key: str, stmt, params):
        """Plan-cache probe (≙ ObPlanCache::get_plan): bound plans keyed
        by statement text, parameters and schema version; parameter
        values bind as literals, so parameterized statements share one
        entry only when identical.  Plans that folded volatile or
        data-dependent values at bind time (nextval, eagerly-executed
        scalar subqueries) never cache.  Nothing downstream mutates a
        plan in place (the retry ladder, the access path, the sidecars
        and the spill tier build new nodes or fill the tables dict), so
        a cached plan runs again as it was bound."""
        key = (sql_key, tuple(params or []), self.catalog.schema_version)
        hit = self.plan_cache.get(key)
        if hit is not None:
            self.plan_cache.move_to_end(key)  # LRU touch
            self.plan_cache_stats["hits"] += 1
            qmetrics.inc("plan_cache.hits")
            # the gv$plan_choice row was recorded at the original bind;
            # a hit only re-executes the already-chosen plan
            self._last_cbo_choices = []
            return hit
        self.plan_cache_stats["misses"] += 1
        qmetrics.inc("plan_cache.misses")
        binder = self._binder(params)
        out = binder.bind_select(stmt)
        self._last_cbo_choices = list(binder.cbo_choices)
        if not binder.folded_volatile:
            self._plan_cache_put(key, out)
        return out

    # plan-cache sizing, the reference's estimate: ~10 bytes per
    # character of the key text and the plan fingerprint, plus a fixed
    # overhead per entry
    _PLAN_ENTRY_OVERHEAD = 2048
    _PLAN_BYTES_PER_CHAR = 10
    _PLAN_CACHE_MAX_ENTRIES = 4096  # backstop against tiny-entry floods

    def _plan_cache_put(self, key, out):
        """Insert with LRU eviction (oldest first) honoring
        ``plan_cache_mem_limit`` and an entry-count backstop."""
        nbytes = self._PLAN_ENTRY_OVERHEAD + self._PLAN_BYTES_PER_CHAR * (
            len(str(key[0])) + len(out[0].fingerprint()))
        limit = int(self.db.config["plan_cache_mem_limit"])
        if nbytes > limit:
            return  # a single over-budget plan is not cacheable
        old = self._plan_cache_bytes.pop(key, None)
        if old is not None:
            self._plan_cache_total -= old
            self.plan_cache.pop(key, None)
        self.plan_cache[key] = out
        self._plan_cache_bytes[key] = nbytes
        self._plan_cache_total += nbytes
        while self.plan_cache and (
                self._plan_cache_total > limit
                or len(self.plan_cache) > self._PLAN_CACHE_MAX_ENTRIES):
            k, _ = self.plan_cache.popitem(last=False)
            self._plan_cache_total -= self._plan_cache_bytes.pop(k, 0)
            self.plan_cache_stats["evictions"] += 1
            qmetrics.inc("plan_cache.evictions")

    def _execute_select(self, stmt: ast.SelectStmt, params) -> Result:
        self.last_spill = None
        if self.db is None:
            return self._materialize(*self._run_select(stmt, params))
        use_cache = (bool(self.db.config["enable_plan_cache"])
                     and self._ash_state.get("sql"))
        tb0 = time.monotonic()
        with qtrace.span("compile", cached=int(bool(use_cache))):
            if use_cache:
                plan, outputs, _est = self._plan_select_cached(
                    self._ash_state["sql"], stmt, params)
            else:
                plan, outputs, _est = self._plan_select(stmt, params)
        self._last_compile_s = time.monotonic() - tb0
        # the bind window is the first host phase of the time model
        qplan.add_exec_times(bind_s=self._last_compile_s)
        lhash = logical_hash(plan)
        if self._last_cbo_choices:
            # bind-time CBO beliefs land in gv$plan_choice; the measured
            # device seconds fold in once the plan has run
            self.db.plan_choice.record(lhash, self._last_cbo_choices)
        feedback_on = bool(self.db.config["enable_plan_feedback"])
        if feedback_on:
            # cardinality feedback (gv$plan_feedback): operators observed
            # bigger than their static budgets start at the observed
            # capacity bucket instead of re-riding the retry ladder
            corr = self.db.plan_feedback.corrections(lhash)
            if corr:
                qmetrics.inc("plan.feedback_hits")
                plan, n_fixed = _with_feedback(plan, corr)
                if n_fixed:
                    qmetrics.inc("plan.feedback_corrections", n_fixed)
        # estimate-driven spill route (≙ the SQL memory manager deciding
        # spill from work-area estimates BEFORE execution): over-budget
        # inputs never materialize whole on the device
        big = self._spill_candidates(plan)
        if big:
            res = self._try_spilled(plan, outputs, big)
            if res is not None:
                return res
        monitor = None
        mon_collect = True
        if bool(self.db.config["enable_sql_plan_monitor"]):
            # sampled ledger collection: unsampled executions push no
            # monitor lanes and record no ledger row
            monitor = []
            mon_collect = self.db.plan_monitor.should_record(
                lhash, int(self.db.config["plan_monitor_sample_every"]))
        qplan.reset_compile_flag()
        t0 = time.monotonic()  # plan-monitor total_s (step-proof delta)
        try:
            with qtrace.span("execute") as xsp:
                rel, outputs = self._run_plan(
                    plan, outputs, monitor=monitor,
                    mon_collect=mon_collect, feedback=feedback_on)
                xsp.tags.update(attempts=self.last_retries + 1)
        except CapacityOverflow:
            # backstop: re-plan retries exhausted -> disk spill tier,
            # largest input as the stream
            big = self._spill_candidates(plan, force_largest=True)
            res = self._try_spilled(plan, outputs, big) if big else None
            if res is not None:
                return res
            raise
        # the result read is the boundary after which every event pair
        # and pinned monitor copy of this statement has completed
        res = self._materialize(rel, outputs)
        qplan.resolve_pending()
        exec_elapsed = time.monotonic() - t0
        if monitor is not None and mon_collect:
            # roofline prediction vs the measured device half: the TIME
            # q-error beside the cardinality one
            times, pred_s, time_q = self._roofline(plan)
            self.db.plan_monitor.record(
                qplan.plan_fingerprint(plan)[:64], monitor, exec_elapsed,
                logical_hash=lhash, retries=self.last_retries,
                path="serial", host_s=times.host_s,
                device_s=times.device_s, pred_s=pred_s, time_q=time_q)
            # validate the CHOICE, not just the plan
            self.db.plan_choice.observe(lhash, times.device_s)
            if feedback_on and monitor:
                self.db.plan_feedback.observe(lhash, monitor)
        if self.last_retries == 0 and not qplan.compile_flag():
            # plan-regression watchdog: latency baselines per logical
            # hash, independent of the plan-monitor knob; samples that
            # paid a first execution at a new signature or a retry
            # replay are excluded
            if self.db.plan_history.record(
                    lhash, exec_elapsed,
                    float(self.db.config["plan_regress_threshold"])):
                qmetrics.inc("plan.regressions")
        return res

    def _run_select(self, stmt: ast.SelectStmt, params):
        """Bind and run a SELECT on the device under the capacity-retry
        ladder -> (result relation, [(column id, output name)])."""
        plan, outputs, _est = self._plan_select(stmt, params)
        return self._run_plan(plan, outputs)

    def _run_plan(self, plan: PlanNode, outputs, monitor=None,
                  mon_collect: bool = True, feedback: bool = False):
        """Run ``plan`` on the device under the capacity-retry ladder
        (4x per retry, or straight to the budget the overflow report
        asks for with ``feedback``); ``monitor`` collects the ledger
        rows of the successful attempt."""
        tables = {t: self._table_snapshot(t)
                  for t in referenced_tables(plan)
                  if self.catalog.has_table(t)}
        self.last_ann_path = self._try_ann_prefilter(plan, tables)
        self.last_access_paths = self._index_prefilter(plan, tables)
        prepare_index_probes(self.catalog, plan, tables)
        factor = 1
        max_retry = int(self.variables["max_capacity_retry"])
        for attempt in range(max_retry + 1):
            # retry-ladder checkpoint: a killed or expired statement must
            # not re-plan and re-execute with bigger budgets
            qadmission.checkpoint()
            try:
                p = plan if factor == 1 else scale_capacities(plan, factor)
                rel = execute_plan(p, tables, monitor_out=monitor,
                                   monitor_collect=mon_collect)
                break
            except CapacityOverflow as ovf:
                if attempt >= max_retry:
                    raise
                qmetrics.inc("plan.capacity_retries")
                factor *= (overflow_jump_factor(ovf.drops) if feedback
                           else 4)
                if monitor is not None:
                    monitor.clear()
        self.last_retries = attempt
        self.last_plan = p
        self.last_outputs = outputs
        return rel, outputs

    def _roofline(self, plan):
        """Roofline prediction for THIS statement's accumulated device
        work -> (ExecTimes, pred_s, time_q); records the pair into the
        per-operator-type calibration table.  Zeros when the split is
        off or THIS database is uncalibrated."""
        times = qplan.exec_times()
        pred_s = time_q = 0.0
        units = self.db.cost_units if self.db is not None else None
        if units is not None and times.device_s > 0.0 and \
                times.calls > 0:
            pred_s = qcalibrate.predict_seconds(
                units, times.flops, times.bytes, times.calls)
            time_q = qcalibrate.time_q_error(pred_s, times.device_s)
            self.db.time_calibration.observe(
                type(plan).__name__, pred_s, times.device_s,
                host_s=times.host_s)
        return times, pred_s, time_q

    def _explain(self, stmt, params, analyze: bool = False) -> Result:
        if not isinstance(stmt, ast.SelectStmt):
            raise NotImplementedError("EXPLAIN supports SELECT")
        # planning for EXPLAIN must not consume sequence values
        seqs = self._sequences
        binder = Binder(self.catalog, params=params or [],
                        sequences=_PeekSequences(seqs) if seqs else None,
                        sysvars=self.variables)
        plan, outputs, _est = binder.bind_select(stmt)
        row_counts = None
        extra = ""
        if analyze:
            row_counts, extra = self._explain_analyze(plan, outputs)
        text = format_plan(plan, row_counts=row_counts) + extra
        if row_counts:
            worst = max(row_counts.values(),
                        key=lambda r: r.get("q_error", 0.0))
            if worst.get("q_error", 0.0) > 0.0:
                text += (f"\nworst misestimate: {worst['op']} "
                         f"est={worst['est']} act={worst['rows']} "
                         f"q={worst['q_error']:.2f}")
        lines = np.array(text.splitlines(), dtype=object)
        return Result(["plan"], {"plan": lines}, {},
                      {"plan": SqlType.string()}, rowcount=len(lines),
                      plan_text=text)

    def _explain_analyze(self, plan, outputs):
        """Execute ``plan`` with the monitor on (whatever
        ``enable_sql_plan_monitor`` says: the user asked for actuals)
        under the retry ladder, or through the spill tier when its inputs
        are over budget -> ({id(node): ledger row}, text appended to the
        plan: the spill counters, the roofline line)."""
        big = self._spill_candidates(plan)
        if big and self._try_spilled(plan, outputs, big) is not None:
            st = self.last_spill
            return None, (f"\nspill: kind={st.kind} runs={st.runs} "
                          f"bytes={st.bytes} "
                          f"spilled_rows={st.spilled_rows} "
                          f"batches={st.batches}")
        monitor: list = []
        an0 = time.monotonic()  # ledger total_s (step-proof)
        # the same retry ladder as execution: a CapacityOverflow IS the
        # finding EXPLAIN ANALYZE exists to expose, not a failure
        self._run_plan(plan, outputs, monitor=monitor, feedback=True)
        # this statement reads no result, so its execution's event pair
        # (if it had no overflow lane to read) is waited for here
        qplan.resolve_pending(block=True)
        row_counts = dict(zip((id(n) for n in monitored_postorder(plan)),
                              monitor))
        times, pred_s, time_q = self._roofline(plan)
        extra = ""
        if times.device_s > 0.0 or self.device.type == "cpu":
            wname, wsec = times.worst_phase()
            extra = (f"\nroofline: [pred={pred_s:.3e}s "
                     f"dev={times.device_s:.3e}s "
                     f"host={times.host_s:.3e}s "
                     + (f"tq={time_q:.2f}" if time_q > 0.0
                        else "tq=uncalibrated")
                     + f" worst_phase={wname}:{wsec:.3e}s]")
        if self.db is not None:
            self.db.plan_monitor.record(
                qplan.plan_fingerprint(plan)[:64], monitor,
                time.monotonic() - an0, logical_hash=logical_hash(plan),
                retries=self.last_retries, path="serial",
                host_s=times.host_s, device_s=times.device_s,
                pred_s=pred_s, time_q=time_q)
        return row_counts, extra

    # ------------------------------------------------------------------
    # PROFILE, SHOW TRACE / METRICS / PROFILE
    # ------------------------------------------------------------------
    def _profile(self, stmt: ast.ProfileStmt, params=None) -> Result:
        """PROFILE <statement>: execute it under ``torch.profiler``;
        the per-kernel rows land in gv$device_profile keyed by this
        statement's trace_id (SHOW PROFILE shows them).  The statement's
        own result and errors pass through unchanged."""
        if self.db is None or not bool(self.db.config["enable_profiling"]):
            # no store / knob off: run the statement, skip the capture
            return self.execute_stmt(stmt.stmt, params)
        tctx = qtrace.current()
        # query tracing off: a standalone capture id keeps the rows
        # joinable to each other and to SHOW PROFILE
        trace_id = (tctx.trace_id if tctx is not None
                    else uuid.uuid4().hex[:16])
        on_cuda = self.device.type == "cuda"
        out, rows, note = qprofiler.profile_statement(
            lambda: self.execute_stmt(stmt.stmt, params), cuda=on_cuda)
        self.db.device_profiles.record(qprofiler.make_profile(
            trace_id, self._ash_state.get("sql", ""), rows, note,
            backend="gpu" if on_cuda else self.device.type))
        self._last_profile_trace_id = trace_id
        return out

    def _show_profile(self) -> Result:
        """SHOW PROFILE: this session's most recent PROFILE capture as
        per-kernel rows (total/avg time, share of device time)."""
        store = self.db.device_profiles if self.db is not None else None
        tid = self._last_profile_trace_id
        prof = store.get(tid) if (store is not None and tid) else None
        rows = prof.rows if prof is not None else []
        note = prof.note if prof is not None else \
            "no PROFILE captured in this session"
        if not rows and note:
            rows = [{"device": "", "kernel": f"({note})", "kind": "note",
                     "occurrences": 0, "total_s": 0.0, "avg_s": 0.0,
                     "pct": 0.0}]
        return Result(
            ["device", "kernel", "kind", "occurrences", "total_ms",
             "avg_us", "pct_device"],
            {"device": _strings(r["device"] for r in rows),
             "kernel": _strings(r["kernel"] for r in rows),
             "kind": _strings(r["kind"] for r in rows),
             "occurrences": np.array([r["occurrences"] for r in rows],
                                     np.int64),
             "total_ms": np.array([r["total_s"] * 1e3 for r in rows],
                                  np.float64),
             "avg_us": np.array([r["avg_s"] * 1e6 for r in rows],
                                np.float64),
             "pct_device": np.array([r["pct"] for r in rows],
                                    np.float64)},
            {}, {"device": SqlType.string(), "kernel": SqlType.string(),
                 "kind": SqlType.string()}, rowcount=len(rows))

    def _show_metrics(self) -> Result:
        """SHOW METRICS: the process's metrics as Prometheus text
        exposition, one line per row."""
        lines = qmetrics.prom_text(qmetrics.wire_snapshot()).splitlines()
        return Result(["metric"], {"metric": _strings(lines)}, {},
                      {"metric": SqlType.string()}, rowcount=len(lines))

    def _show_trace(self) -> Result:
        """SHOW TRACE: the last kept statement trace rendered as an
        indented span tree (≙ SHOW TRACE over the flt span store).
        Empty when the last statement's trace was sampled away."""
        self._stmt_is_show_trace = True  # don't clobber _last_trace_id
        cols = ["operation", "node", "start_ts", "elapsed_ms", "tags"]
        reg = self.db.trace_registry if self.db is not None else None
        tid = self._last_trace_id
        spans = reg.trace(tid) if (reg is not None and tid) else []
        by_parent: dict[int, list] = {}
        ids = {sp.span_id for sp in spans}
        for sp in spans:
            # a span whose parent was not captured (pruned by ring
            # wraparound) renders as a root
            key = sp.parent_id if sp.parent_id in ids else 0
            by_parent.setdefault(key, []).append(sp)
        for kids in by_parent.values():
            kids.sort(key=lambda sp: (sp.start_ts, sp.span_id))
        rows: list = []
        seen: set = set()

        def walk(sp, depth):
            if sp.span_id in seen:
                return  # defensive: a malformed parent loop
            seen.add(sp.span_id)
            rows.append((("  " * depth) + sp.name, sp.node, sp.start_ts,
                         sp.elapsed_s * 1000.0,
                         json.dumps(sp.tags, sort_keys=True, default=str)
                         if sp.tags else ""))
            for c in by_parent.get(sp.span_id, ()):
                walk(c, depth + 1)

        for root in by_parent.get(0, ()):
            walk(root, 0)
        return Result(
            cols,
            {"operation": _strings(r[0] for r in rows),
             "node": np.array([r[1] for r in rows], np.int64),
             "start_ts": np.array([r[2] for r in rows], np.float64),
             "elapsed_ms": np.array([r[3] for r in rows], np.float64),
             "tags": _strings(r[4] for r in rows)},
            {}, {"operation": SqlType.string(), "tags": SqlType.string()},
            rowcount=len(rows))

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
    # the storage read path (with a Database)
    # ------------------------------------------------------------------
    def _table_snapshot(self, name: str) -> Relation:
        """Read a table at the right snapshot: an active transaction sees
        its own writes plus its begin-snapshot; otherwise the latest
        committed state (the cached device relation)."""
        if self.db is not None and self._tx is not None:
            return self.catalog.table_data_at(
                name, self._tx.snapshot, self._tx.tx_id)
        return self.catalog.table_data(name)

    # -- the ANN access path (vector index) -----------------------------
    _ANN_FETCH_FACTOR = 4
    _IVF_MIN_ROWS = 4096

    def _try_ann_prefilter(self, plan, tables) -> str | None:
        """ORDER BY <distance>(vcol, '[...]') [ASC] LIMIT k over one
        vector-indexed scan: replace the scanned relation with the
        index's ``max(4k, 64)`` best candidates (row order kept), so the
        unchanged plan re-sorts those few rows by the exact distance.
        Exact search unless the index opted in with ``approximate =
        true`` and the table has 4,096 live rows or more (then IVF-Flat,
        approximate by design).  -> "exact" | "ivf" when it ran, else
        None."""
        if not isinstance(plan, qplan.Limit):
            return None
        node = plan.child
        k = plan.k + (plan.offset or 0)
        if not isinstance(node, qplan.Sort) or len(node.keys) != 1 or \
                not (node.ascending[0] if node.ascending else True):
            return None
        key = node.keys[0]
        if not isinstance(key, ir.ColumnRef):
            return None
        # the sort key through one Project (and any Compact) to the scan
        expr, cur = None, node.child
        while isinstance(cur, (qplan.Project, qplan.Compact)):
            if isinstance(cur, qplan.Project):
                if expr is not None:
                    return None  # nested projects: keep the simple shape
                expr = cur.outputs.get(key.name)
                if expr is None:
                    return None
            cur = cur.child
        if not isinstance(cur, qplan.TableScan) or \
                not isinstance(expr, ir.FuncCall):
            return None
        metric = {"l2_distance": "l2",
                  "cosine_distance": "cosine"}.get(expr.name.lower())
        colref = next((a for a in expr.args
                       if isinstance(a, ir.ColumnRef)), None)
        lit = next((a for a in expr.args if isinstance(a, ir.Literal)
                    and isinstance(a.value, str)), None)
        if metric is None or colref is None or lit is None:
            return None
        inv = {cid: base for base, cid in (cur.rename or {}).items()}
        base_col = inv.get(colref.name, colref.name)
        td = self.catalog.table_def(cur.table)
        vix = [v for v in td.aux_indexes.values()
               if v["kind"] == "vector" and v["column"] == base_col
               and v["metric"] == metric]
        rel = tables.get(cur.table)
        if not vix or rel is None:
            return None
        fetch = max(k * self._ANN_FETCH_FACTOR, 64)
        approx = any(v.get("options", {}).get("approximate") for v in vix)
        idx = self._ann_runtime(cur.table, base_col, metric, rel, fetch,
                                approx)
        if idx is None:
            return None
        q = parse_vector_text(lit.value)[None, :]
        if isinstance(idx, IvfFlatIndex):
            _s, ids = idx.search(q, fetch)
            rows = ids[0]
            # the one host read of the access path, before the plan runs:
            # the probed buckets may hold fewer than ``fetch`` rows
            rows = rows[rows >= 0]
            if rows.numel() == 0:
                return None
        else:
            _s, ids = exact_search(q, idx, fetch, metric=metric)
            rows = ids[0]
        # every candidate lies in the live prefix the structure indexes
        tables[cur.table] = rel.gather(torch.sort(rows).values)
        return "ivf" if isinstance(idx, IvfFlatIndex) else "exact"

    def _ann_runtime(self, table: str, col: str, metric: str, rel,
                     fetch: int, approx: bool):
        """The search structure of (table, col, metric) for ``rel``,
        cached on the catalog per source relation: an IvfFlatIndex when
        the index opted in and the table is large enough, else a view of
        the live vectors (exact search).  None when the live rows fit in
        ``fetch``, the column is not a [n, d] tensor, dead rows sit
        inside the live prefix (row ids would need a remap) or a live
        embedding is NULL (its distance is NULL, which the full sort
        puts first; its stored zero vector would rank as a vector).
        The last two refusals are cached too."""
        name = ("ann", col, metric)
        hit = self.catalog.sidecar(table, name, rel)
        if hit is None:
            hit = self._build_ann(rel, col, metric, approx)
            self.catalog.cache_sidecar(table, name, rel, hit)
        if hit is False:
            return None
        n_live = hit.n if isinstance(hit, IvfFlatIndex) else hit.shape[0]
        return hit if n_live > fetch else None

    def _build_ann(self, rel, col: str, metric: str, approx: bool):
        """-> the search structure over ``rel``'s live prefix, or False
        where the ANN path cannot serve ``rel`` (see ``_ann_runtime``)."""
        colv = rel.columns.get(col)
        if colv is None or colv.data.ndim != 2:
            return False
        # the structure's one host read of the live rows
        n_live = (rel.capacity if rel.mask is None
                  else int(rel.mask.sum()))
        if rel.mask is not None and not bool(rel.mask[:n_live].all()):
            return False
        if colv.valid is not None and not bool(colv.valid[:n_live].all()):
            return False
        vecs = colv.data[:n_live]
        return (IvfFlatIndex(vecs, metric=metric)
                if approx and n_live >= self._IVF_MIN_ROWS else vecs)

    def _index_prefilter(self, plan, tables) -> dict:
        """Candidate-superset access paths (sql/access_path.py): replace
        a filtered table's device relation with a small host-pruned
        candidate set.  The plan re-applies its full filter, so the
        substitution never changes results — only how few rows reach the
        device.  -> {table: AccessChoice}."""
        if self.db is None or not tables:
            return {}
        if not bool(self.variables.get("enable_index_access", 1)):
            return {}
        try:
            by_table = ap.scan_filter_ranges(plan, self._engine)
        except Exception:
            return {}
        choices: dict = {}
        for t, ranges in by_table.items():
            if t not in tables or t not in self._engine.tables:
                continue
            choice = ap.choose_path(self._engine, t, ranges)
            if choice is None:
                continue
            if self._tx is not None:
                snap, txid = self._tx.snapshot, self._tx.tx_id
            else:
                snap, txid = self._txsvc.gts.current(), 0
            try:
                arrays, valids = ap.materialize_candidates(
                    self._engine, choice, snap, txid)
            except Exception:
                continue  # any surprise -> keep the full-table path
            tables[t] = self._candidate_relation(
                self._engine.tables[t], arrays, valids)
            choices[t] = choice
        return choices

    def _candidate_relation(self, ts, arrays, valids) -> Relation:
        """Host candidate arrays -> a device Relation padded onto the
        shared capacity-bucket ladder with a live-row mask."""
        n = len(next(iter(arrays.values()))) if arrays else 0
        rel = from_numpy(
            arrays,
            types={c.name: c.dtype for c in ts.tdef.columns},
            valids={k: v for k, v in valids.items() if v is not None},
            device=self.device)
        return rel.pad_to(bucket_capacity(n))

    # ------------------------------------------------------------------
    # the spill route (≙ SQL memory manager + spillable operators)
    # ------------------------------------------------------------------
    def _spill_candidates(self, plan, force_largest: bool = False) -> set:
        """Tables whose estimated rows REACHING the plan exceed the
        work-area budget (``sql_work_area_rows``).  The estimate is
        post-access-path: a table whose filter conjuncts admit a
        selective primary/secondary path keeps the in-memory path even
        when the raw table is over budget.  With ``force_largest`` (the
        CapacityOverflow backstop) the largest table qualifies even
        under budget — the plan overflowed regardless, so stream it."""
        if self.db is None or not bool(self.db.config["enable_sql_spill"]):
            return set()
        refs = list(referenced_tables(plan))
        if self._tx is not None and \
                any(t in self._tx.participants for t in refs):
            # spill streams read committed state at a snapshot; a table
            # this tx has written must come from the own-writes read
            # path, so stay in memory when any referenced table is dirty
            return set()
        budget = int(self.db.config["sql_work_area_rows"])
        try:
            ranges_by_table = ap.scan_filter_ranges(plan, self._engine)
        except Exception:
            ranges_by_table = {}
        est = {}
        for t in refs:
            ts = self._engine.tables.get(t)
            if ts is None:
                continue
            rngs = ranges_by_table.get(t) or {}
            choice = ap.choose_path(self._engine, t, rngs) if rngs \
                else None
            est[t] = (choice.est_rows if choice is not None
                      else estimate_rows_in_ranges(ts.tablet, rngs))
        big = {t for t, e in est.items() if e > budget}
        if not big and force_largest and est:
            big = {max(est, key=est.get)}
        return big

    def _try_spilled(self, plan, outputs, big: set) -> Result | None:
        """Execute through ``exec/spill_exec.py`` (granule streams from
        the LSM + temp-file runs).  -> Result, or None when the plan
        shape is unsupported (the caller falls back to the in-memory
        engine)."""
        from oceanbase_tpu_torch.exec.spill_exec import execute_spilled

        # ONE read point for every table in the query (big streams and
        # device relations alike); inside an explicit transaction the
        # tx begin-snapshot (_spill_candidates excluded tables it wrote)
        snap = (self._tx.snapshot if self._tx is not None
                else self._txsvc.gts.current())
        providers, types_by_table, device_tables = {}, {}, {}
        for t in referenced_tables(plan):
            ts = self._engine.tables.get(t)
            if ts is None:
                continue
            if t in big:
                providers[t] = self._spill_provider(ts.tablet, snap)
                types_by_table[t] = {c.name: c.dtype
                                     for c in ts.tdef.columns}
            else:
                device_tables[t] = self.catalog.table_data_at(t, snap)
        if not providers:
            return None
        # device-resident subtrees may carry IndexProbe nodes; their
        # sorted sidecars ride in the device-table dict
        prepare_index_probes(self.catalog, plan, device_tables)
        sdir = os.path.join(self.db.root or tempfile.gettempdir(),
                            "tmpfile", f"q{uuid.uuid4().hex[:10]}")
        t0 = time.time()
        m0 = time.monotonic()
        try:
            arrays, valids, dtypes, stats = execute_spilled(
                plan, providers, sdir,
                int(self.db.config["sql_work_area_rows"]),
                device_tables, types_by_table, big, device=self.device,
                disk_budget=self.tenant.diskmgr, faults=self.db.faults,
                label=(self._ash_state.get("sql", "")[:80]
                       or f"session {self.session_id}"))
        except (NotDistributable, NotImplementedError):
            # unsupported shape OR a non-splittable aggregate
            # (count_distinct) — fall back to the in-memory engine
            return None
        self.last_spill = stats
        self.last_retries = 0
        self.last_plan = plan
        self.last_outputs = outputs
        res = materialize_host(arrays, valids, dtypes, outputs)
        self._record_spill(plan, stats, res.rowcount, t0,
                           time.monotonic() - m0)
        return res

    def _record_spill(self, plan, stats, n_out: int, t0: float,
                      elapsed: float):
        """The spill route's accounting: a v$sql_workarea row, the
        "spill io" wait event and, with the plan monitor on, one ledger
        row for the root (the tier streams batches, so only the root's
        output cardinality is observable whole)."""
        plan_hash = qplan.plan_fingerprint(plan)[:64]
        self.db.workarea_history.append({
            "ts": t0, "sql": self._ash_state.get("sql", ""),
            "plan_hash": plan_hash, "kind": stats.kind, "runs": stats.runs,
            "bytes": stats.bytes, "spilled_rows": stats.spilled_rows,
            "batches": stats.batches, "elapsed_s": elapsed})
        self.db.wait_events.add("spill io", elapsed)
        if not bool(self.db.config["enable_sql_plan_monitor"]):
            return
        # the row describes the operator that OWNS its postorder
        # position: a pass-through root emits no lane, so name and est
        # come from the last monitored node
        mon_nodes = monitored_postorder(plan)
        row_node = mon_nodes[-1] if mon_nodes else plan
        root_est = row_node.est_rows
        op_rows = [{"op": type(row_node).__name__,
                    "pos": max(len(mon_nodes) - 1, 0),
                    "est": root_est, "rows": n_out,
                    "q_error": qplan.q_error(root_est, n_out),
                    "elapsed_s": elapsed, "spill_bytes": stats.bytes}]
        times, pred_s, time_q = self._roofline(plan)
        self.db.plan_monitor.record(
            plan_hash, op_rows, elapsed, logical_hash=logical_hash(plan),
            spill_bytes=stats.bytes, path="spill", host_s=times.host_s,
            device_s=times.device_s, pred_s=pred_s, time_q=time_q)

    @staticmethod
    def _spill_provider(tablet, snapshot: int):
        """Chunk provider over one tablet (partitions chain in order:
        each partition's newest-wins merge is its own, and a row lives
        in one partition, so the chain yields every live row once)."""
        parts = getattr(tablet, "partitions", None)
        if parts is None:
            return segment_chunk_provider(tablet, snapshot)
        provs = [segment_chunk_provider(p, snapshot) for p in parts]

        def provider(table, chunk_rows, bounds=None):
            for p in provs:
                yield from p(table, chunk_rows, bounds)

        return provider

    # ------------------------------------------------------------------
    # metadata: ANALYZE, DESCRIBE, SHOW
    # ------------------------------------------------------------------
    def _analyze_workload(self, stmt: ast.AnalyzeWorkloadStmt) -> Result:
        """ANALYZE WORKLOAD REPORT [FROM <id> TO <id>]: build (and
        remember) the delta report between two workload snapshots.
        Without ids, a fresh cluster-merged snapshot is taken as the TO
        side and the previous one is the FROM side, so the statement
        works with the background thread off.  The structured rows come
        back directly (the same shape gv$workload_report serves);
        SHOW WORKLOAD REPORT renders the text tree."""
        repo = (getattr(self.db, "workload", None)
                if self.db is not None else None)
        if repo is None:
            raise NotImplementedError(
                "ANALYZE WORKLOAD REPORT needs a Database")
        rep = repo.build_report(stmt.from_id, stmt.to_id)
        rows = rep["rows"]
        return Result(
            ["section", "item", "value", "detail"],
            {"section": np.array([r["section"] for r in rows],
                                 dtype=object),
             "item": np.array([r["item"] for r in rows], dtype=object),
             "value": np.array([r["value"] for r in rows], np.float64),
             "detail": np.array([r["detail"] for r in rows],
                                dtype=object)},
            {}, {"section": SqlType.string(), "item": SqlType.string(),
                 "detail": SqlType.string()}, rowcount=len(rows))

    def _show_workload_report(self) -> Result:
        """SHOW WORKLOAD REPORT: the last ANALYZE WORKLOAD REPORT's
        indented text tree, one row per line (SHOW TRACE's style)."""
        repo = (getattr(self.db, "workload", None)
                if self.db is not None else None)
        rep = repo.last_report if repo is not None else None
        lines = rep["text"].split("\n") if rep else []
        return Result(
            ["report"],
            {"report": np.array(lines, dtype=object)},
            {}, {"report": SqlType.string()}, rowcount=len(lines))

    def _analyze(self, stmt: ast.AnalyzeStmt) -> Result:
        """Refresh a table's optimizer stats on the host: live row count,
        exact NDV, equi-height histograms for non-string columns and
        most-common-values frequency lists for dictionary columns (a
        VECTOR column's NDV is the row count, with no histogram)."""
        td = self.catalog.table_def(stmt.table)
        rel = self.catalog.table_data(stmt.table)
        mask = rel.mask_or_true().cpu().numpy()
        td.row_count = int(mask.sum())
        for c in td.columns:
            col = rel.columns.get(c.name)
            if col is None:
                continue
            if c.dtype.kind == TypeKind.VECTOR:
                # load_numpy's rule: every embedding counts as distinct,
                # and a histogram over its loose floats would mean
                # nothing (the reference flattens the [n, d] array here)
                td.ndv[c.name] = max(td.row_count, 1)
                td.histograms.pop(c.name, None)
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
            for nm, spec in td.aux_indexes.items():
                names.append(nm)
                cols.append(spec["column"])
                uniq.append(0)
                kinds.append(spec["kind"])
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
        if stmt.what == "trace":
            return self._show_trace()
        if stmt.what == "metrics":
            return self._show_metrics()
        if stmt.what == "profile":
            return self._show_profile()
        if stmt.what == "workload_report":
            return self._show_workload_report()
        if stmt.what == "processlist":
            return self._show_processlist()
        if self.db is None:
            return _ok()  # SHOW PARAMETERS: no system configuration here
        snap = self.tenant.config.snapshot()
        return Result(
            ["name", "value"],
            {"name": _strings(snap),
             "value": _strings(str(v) for v in snap.values())},
            {}, {}, rowcount=len(snap))

    # ------------------------------------------------------------------
    # DDL
    # ------------------------------------------------------------------
    def _create_table(self, stmt: ast.CreateTableStmt) -> Result:
        # capability checks before anything is created
        if stmt.as_select is not None:
            if self.db is None:
                raise _needs_db("CREATE TABLE ... AS SELECT")
            return self._create_table_as(stmt)
        if stmt.indexes and self.db is None:
            raise _needs_db("an inline secondary index")
        auto_cols = [c.name for c in stmt.columns if c.auto_increment]
        cols = [ColumnDef(c.name, c.dtype, c.nullable) for c in stmt.columns]
        # catalog-only: AUTO_INCREMENT is recorded, and an omitted value
        # is NULL
        tdef = TableDef(stmt.name, cols, primary_key=stmt.primary_key,
                        partition=stmt.partition,
                        auto_increment_cols=auto_cols)
        existed = stmt.if_not_exists and self.catalog.has_table(stmt.name)
        self.catalog.create_table(tdef, if_not_exists=stmt.if_not_exists)
        if existed:
            return _ok()
        if self.db is not None:
            # inline INDEX/UNIQUE KEY specs become secondary indexes (the
            # table is brand new: nothing to backfill or drain); the
            # engine serves the empty snapshot itself
            for i, (iname, icols, iuniq) in enumerate(stmt.indexes):
                self._engine.create_index(
                    stmt.name, iname or f"idx_{stmt.name}_{i}", icols,
                    unique=iuniq)
            # AUTO_INCREMENT backs onto a hidden persisted sequence
            # (≙ the table auto-inc service riding the sequence
            # allocator); the column list persists with the table
            for cname in auto_cols:
                try:
                    self._sequences.create(f"__ai_{stmt.name}_{cname}",
                                           start=1)
                except ValueError:
                    pass  # already exists
            return _ok()
        # one all-dead row (static shapes need capacity >= 1), on the
        # catalog's device
        self.catalog.set_data(stmt.name, empty_relation(
            {c.name: c.dtype for c in stmt.columns}, device=self.device))
        return _ok()

    def _create_index(self, stmt: ast.CreateIndexStmt) -> Result:
        """CREATE [UNIQUE] INDEX: metadata the optimizer reads to choose
        the index-probe access path; the sorted sidecar is built from the
        device relation at execution (``prepare_index_probes``).
        Uniqueness is recorded, not enforced, as in the reference's
        session without a storage engine."""
        td = self.catalog.table_def(stmt.table)
        if stmt.kind in ("vector", "fulltext"):
            return self._create_aux_index(stmt, td)
        if any(ix.name == stmt.name for ix in td.indexes):
            if stmt.if_not_exists:
                return _ok()
            raise ValueError(f"index {stmt.name} exists on {stmt.table}")
        if self.db is not None:
            # the engine's index table + backfill (≙ ObDDLService index
            # build); the schema-version bump re-resolves access paths
            if self._tx is not None and \
                    stmt.table in self._tx.participants:
                raise RuntimeError(
                    "CREATE INDEX on a table already written by the open "
                    "transaction is not supported (commit first)")
            self._engine.create_index(
                stmt.table, stmt.name, stmt.columns, unique=stmt.unique,
                drain=self._tx_drain_fence())
            self.catalog.invalidate(stmt.table)
            self.catalog.schema_version += 1
            return _ok()
        for c in stmt.columns:
            td.column(c)  # existence check
        td.indexes.append(IndexDef(
            name=stmt.name, table=stmt.table, columns=list(stmt.columns),
            unique=stmt.unique, storage_table=""))
        self.catalog.schema_version += 1
        return _ok()

    def _create_aux_index(self, stmt: ast.CreateIndexStmt,
                          td: TableDef) -> Result:
        """CREATE VECTOR / FULLTEXT INDEX: metadata only (the search
        structure builds at a query's first use per relation, MATCH reads
        none), persisted through the slog with a Database."""
        if stmt.name in td.aux_indexes:
            if stmt.if_not_exists:
                return _ok()
            raise ValueError(f"index {stmt.name} exists")
        if len(stmt.columns) != 1:
            raise ValueError(f"{stmt.kind} index takes one column")
        col = td.column(stmt.columns[0])  # existence check
        if stmt.kind == "vector" and col.dtype.kind != TypeKind.VECTOR:
            raise ValueError("vector index needs a VECTOR column")
        if stmt.kind == "fulltext" and not col.dtype.is_string:
            raise ValueError("fulltext index needs a string column")
        spec = {"kind": stmt.kind, "column": stmt.columns[0],
                "metric": str(stmt.options.get("metric", "l2")),
                "options": dict(stmt.options)}
        td.aux_indexes[stmt.name] = spec
        # the exact or IVF structure follows the metric's indexes
        self.catalog.drop_sidecars(
            stmt.table, ("ann", spec["column"], spec["metric"]))
        if self.db is not None and stmt.table in self._engine.tables:
            self._engine._log_meta({"op": "aux_index", "table": stmt.table,
                                    "name": stmt.name, "spec": spec})
        self.catalog.schema_version += 1
        return _ok()

    def _drop_index(self, stmt: ast.DropIndexStmt) -> Result:
        td = self.catalog.table_def(stmt.table)
        if stmt.name in td.aux_indexes:
            spec = td.aux_indexes.pop(stmt.name)
            self.catalog.drop_sidecars(
                stmt.table, ("ann", spec["column"], spec["metric"]))
            if self.db is not None and stmt.table in self._engine.tables:
                self._engine._log_meta({"op": "drop_aux_index",
                                        "table": stmt.table,
                                        "name": stmt.name})
            self.catalog.schema_version += 1
            return _ok()
        if self.db is not None:
            try:
                self._engine.drop_index(stmt.table, stmt.name)
            except KeyError:
                if not stmt.if_exists:
                    raise
            self.catalog.invalidate(stmt.table)
            self.catalog.schema_version += 1
            return _ok()
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
            raise _needs_db("REPLACE INTO")
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
                new[c] = dtype.host_array([dtype.null_fill if x is None
                                           else x for x in vals[c]])
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
                oldv = c.dtype.host_zeros(0)
            if oldvalid is None:
                oldvalid = np.ones(len(oldv), dtype=bool)
            if c.name in new:
                newv, newvalid = new[c.name], new_valid[c.name]
            else:
                newvalid = np.zeros(n_new, dtype=bool)
                newv = c.dtype.host_zeros(n_new)
            if c.dtype.kind == TypeKind.VECTOR:
                # decoded embeddings are object rows (None when NULL)
                oldv, newv = (c.dtype.host_array(
                    [c.dtype.null_fill if x is None else x for x in a])
                    if a.dtype == object else a for a in (oldv, newv))
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

    # ------------------------------------------------------------------
    # transactions and transactional DML (with a Database)
    # ------------------------------------------------------------------
    def _tx_control(self, op: str) -> Result:
        if self.db is None:
            return _ok()  # nothing to begin or end without a storage plane
        if self._tx is not None and self._tx.xid:
            # an XA branch only ends through XA verbs (≙ XAER_RMFAIL):
            # committing it here would strand the xid in the store
            raise RuntimeError(
                f"transaction is an XA branch "
                f"({self._tx.xid!r}); use XA END/PREPARE/COMMIT")
        if op == "begin":
            if self._tx is not None:
                self._txsvc.commit(self._tx)  # implicit commit (MySQL)
            self._tx = self._txsvc.begin()
        elif op == "commit":
            if self._tx is not None:
                self._txsvc.commit(self._tx)
                self._tx = None
        elif op == "rollback":
            if self._tx is not None:
                self._txsvc.rollback(self._tx)
                self._tx = None
        return _ok()

    def _run_in_tx(self, fn, tx_hint=None):
        """Run fn(tx) in the active explicit transaction (with
        statement-level rollback on failure) or an autocommit one
        (≙ implicit transactions around single statements).  ``tx_hint``
        supplies a pre-begun autocommit transaction so the statement's
        reads and writes share one snapshot."""
        if self._tx is not None:
            tx = self._tx
            tx.stmt_seq += 1
            seq = tx.stmt_seq
            writes_before = {t: len(p.keys)
                             for t, p in tx.participants.items()}
            try:
                return fn(tx)
            except Exception:
                stmt_writes = {}
                for t, p in tx.participants.items():
                    new = p.keys[writes_before.get(t, 0):]
                    if new:
                        stmt_writes[t] = new
                self._txsvc.rollback_statement(tx, seq, stmt_writes)
                raise
        tx = tx_hint if tx_hint is not None else self._txsvc.begin()
        try:
            out = fn(tx)
        except Exception:
            self._txsvc.rollback(tx)
            raise
        try:
            self._txsvc.commit(tx)
        except Exception:
            # a failed commit aborts the transaction
            self._txsvc.rollback(tx)
            raise
        return out

    def _stmt_tx(self):
        """-> (tx-for-this-statement, hint): the explicit tx if one is
        open, else a fresh autocommit tx whose snapshot the statement's
        reads must use (pass hint on to _run_in_tx)."""
        if self._tx is not None:
            return self._tx, None
        tx = self._txsvc.begin()
        return tx, tx

    def _insert_tx(self, stmt: ast.InsertStmt, params) -> Result:
        td = self.catalog.table_def(stmt.table)
        cols = stmt.columns or td.column_names
        rows_values: list[dict] = []
        if stmt.rows is not None:
            for row in stmt.rows:
                if len(row) != len(cols):
                    raise ValueError("INSERT arity mismatch")
                values: dict = {}
                for c, e in zip(cols, row):
                    v, t = literal_value(
                        _as_literal(e, params, self._sequences))
                    values[c] = _coerce_value(v, t, td.column(c).dtype)
                for c in td.columns:
                    values.setdefault(c.name, None)
                self._fill_auto_increment(td, values)
                rows_values.append(values)
        else:
            sub = self._execute_select(stmt.select, params)
            for i in range(sub.rowcount):
                values = {}
                for c, sn in zip(cols, sub.names):
                    x = sub.arrays[sn][i]
                    vd = sub.valids.get(sn)
                    if vd is not None and not vd[i]:
                        values[c] = None
                    else:
                        values[c] = _py(x)
                for c in td.columns:
                    values.setdefault(c.name, None)
                self._fill_auto_increment(td, values)
                rows_values.append(values)
        tablet = self._engine.tables[stmt.table].tablet
        kv = self.tenant.kv(stmt.table) if stmt.replace else None

        def op(tx):
            keyed = [(tablet.make_key(v), v) for v in rows_values]
            if kv is not None:
                # REPLACE INTO: newest version wins over an existing row
                # (≙ REPLACE as delete+insert, here one update); own-tx
                # writes, earlier rows of this statement included, count
                # as existing
                live = kv.live_keys([k for k, _v in keyed],
                                    snapshot=tx.snapshot, tx_id=tx.tx_id)
                for key, values in keyed:
                    kind = "update" if key in live else "insert"
                    self._txsvc.write(tx, stmt.table, tablet, key, kind,
                                      values)
                    live.add(key)
                return
            _refuse_live_keys(tablet, [k for k, _v in keyed], tx)
            if self._pdml_eligible(len(keyed)) and \
                    len({k for k, _v in keyed}) == len(keyed):
                # distinct keys: the write phase is order-free, fan it
                # out (intra-statement dup keys need serial first-wins
                # ordering)
                self._pdml_write(tx, stmt.table, tablet, keyed, "insert")
                return
            for key, values in keyed:
                self._txsvc.write(tx, stmt.table, tablet, key, "insert",
                                  values)

        self._run_in_tx(op)
        self.catalog.invalidate(stmt.table)
        # keep the binder's est_rows current: a plan bound while the
        # table looked empty would budget capacities for one row
        td.row_count = tablet.row_count_estimate()
        self._maybe_freeze(stmt.table)
        return _ok(rowcount=len(rows_values))

    def _matching_rows(self, table: str, where, params, tx):
        """-> (rel, mask, tablet, binder, scope): the relation at the
        statement tx's snapshot + the WHERE mask (reads and writes share
        one snapshot so the SI write-conflict check is sound).

        Point/range WHERE clauses on the primary key or an index take the
        candidate-superset access path — an OLTP UPDATE/DELETE touches a
        few pruned chunks, not a whole-table materialization.  Any
        surprise on that path falls back to the full table, as in the
        reference."""
        ts = self._engine.tables[table]
        tablet = ts.tablet
        binder = Binder(self.catalog, params=params or [])
        scope = Scope()
        for cname in tablet.columns:
            scope.add(cname, cname, alias=table)
        pred = binder.bind_expr(where, scope) if where is not None else None
        rel = None
        self.last_access_paths = {}
        if pred is not None and \
                bool(self.variables.get("enable_index_access", 1)):
            try:
                ranges = ap.ranges_of_pred(pred, tablet.types)
                choice = ap.choose_path(self._engine, table, ranges)
                if choice is not None:
                    arrays, valids = ap.materialize_candidates(
                        self._engine, choice, tx.snapshot, tx.tx_id)
                    rel = self._candidate_relation(ts, arrays, valids)
                    self.last_access_paths = {table: choice}
            except Exception:
                rel = None  # any surprise -> full-table path
                self.last_access_paths = {}
        if rel is None:
            rel = self.catalog.table_data_at(table, tx.snapshot, tx.tx_id)
        self.last_dml_capacity = rel.capacity
        mask = eval_predicate(pred, rel) if pred is not None \
            else rel.mask_or_true()
        return rel, mask, tablet, binder, scope

    def _update_tx(self, stmt: ast.UpdateStmt, params) -> Result:
        td = self.catalog.table_def(stmt.table)
        tx, tx_hint = self._stmt_tx()
        try:
            return self._update_tx_body(stmt, params, td, tx, tx_hint)
        except Exception:
            if tx_hint is not None and tx_hint.state.value == "active":
                self._txsvc.rollback(tx_hint)
            raise

    def _update_tx_body(self, stmt, params, td, tx, tx_hint) -> Result:
        """Evaluate the SET expressions over the snapshot on the device,
        then read the matched rows and their new values back once (one
        copy per column) and write Python values through the tx plane."""
        rel, mask, tablet, binder, scope = self._matching_rows(
            stmt.table, stmt.where, params, tx)
        new_cols = {}
        for cname, e in stmt.assignments:
            c = eval_expr(binder.bind_expr(e, scope), rel)
            new_cols[cname] = cast_column(c, td.column(cname).dtype)
        matched = to_numpy(rel.with_mask(mask))
        n_upd = len(next(iter(matched.values()))) if matched else 0
        midx = torch.nonzero(mask).reshape(-1)
        new_host = {}
        for cname, c in new_cols.items():
            vals = c.data.index_select(0, midx).cpu().numpy()
            if c.sdict is not None:
                vals = c.sdict.values[np.clip(vals, 0, c.sdict.size - 1)]
            vv = (c.valid.index_select(0, midx).cpu().numpy()
                  if c.valid is not None
                  else np.ones(len(vals), dtype=bool))
            new_host[cname] = (vals, vv)
        key_changed = any(c in tablet.key_cols for c, _ in stmt.assignments)
        # an update that moves a row across range partitions must also be
        # delete+insert (the versions live in different tablets)
        part_col = getattr(tablet, "part_col", None)
        part_changed = part_col is not None and \
            any(c == part_col for c, _ in stmt.assignments)

        def op(tx):
            keyed = []
            for i in range(n_upd):
                old_values = _row_values(matched, tablet.columns, i)
                values = dict(old_values)
                for cname, (vals, vv) in new_host.items():
                    values[cname] = _py(vals[i]) if vv[i] else None
                keyed.append((old_values, values))
            if not key_changed and not part_changed and \
                    self._pdml_eligible(n_upd):
                # plain (no PK/partition move) bulk update: per-row
                # target keys are distinct, the write phase fans out
                self._pdml_write(
                    tx, stmt.table, tablet,
                    [(tuple(v[k] for k in tablet.key_cols), v)
                     for _o, v in keyed], "update")
                return
            moves = []
            for old_values, values in keyed:
                old_key = tuple(old_values[k] for k in tablet.key_cols)
                new_key = tuple(values[k] for k in tablet.key_cols)
                moved = part_changed and \
                    tablet.route_partition_index(old_values) != \
                    tablet.route_partition_index(values)
                moves.append((old_key, new_key,
                              (key_changed and old_key != new_key) or moved))
            # the insert halves' keys, checked against the snapshot once
            live = live_keys(tablet, [nk for _o, nk, mv in moves if mv],
                             tx.snapshot, tx.tx_id)
            touched = set()
            for (old_values, values), (old_key, new_key, mv) in \
                    zip(keyed, moves):
                if mv:
                    # PK/partition move = delete old row + insert new
                    self._txsvc.write(tx, stmt.table, tablet, old_key,
                                      "delete", old_values)
                    touched.add(old_key)
                    if new_key in live and new_key not in touched:
                        raise DuplicateKey(f"duplicate key {new_key}")
                    self._txsvc.write(tx, stmt.table, tablet, new_key,
                                      "insert", values)
                    touched.add(new_key)
                    continue
                self._txsvc.write(tx, stmt.table, tablet, new_key, "update",
                                  values)

        self._run_in_tx(op, tx_hint=tx_hint)
        self.catalog.invalidate(stmt.table)
        self._maybe_freeze(stmt.table)
        return _ok(rowcount=n_upd)

    def _delete_tx(self, stmt: ast.DeleteStmt, params) -> Result:
        tx, tx_hint = self._stmt_tx()
        try:
            rel, mask, tablet, _b, _s = self._matching_rows(
                stmt.table, stmt.where, params, tx)
            matched = to_numpy(rel.with_mask(mask))
            n_del = len(next(iter(matched.values()))) if matched else 0

            def op(tx):
                keyed = []
                for i in range(n_del):
                    values = _row_values(matched, tablet.columns, i)
                    keyed.append((tuple(values[k] for k in tablet.key_cols),
                                  values))
                if self._pdml_eligible(n_del):
                    self._pdml_write(tx, stmt.table, tablet, keyed, "delete")
                    return
                for key, values in keyed:
                    self._txsvc.write(tx, stmt.table, tablet, key, "delete",
                                      values)

            self._run_in_tx(op, tx_hint=tx_hint)
        except Exception:
            if tx_hint is not None and tx_hint.state.value == "active":
                self._txsvc.rollback(tx_hint)
            raise
        self.catalog.invalidate(stmt.table)
        self._maybe_freeze(stmt.table)
        return _ok(rowcount=n_del)

    def _maybe_freeze(self, table: str):
        """Memstore-pressure freeze: an active memtable beyond the
        configured row budget flushes to L0 (≙ freeze trigger)."""
        ts = self._engine.tables.get(table)
        if ts is None:
            return
        cfg = self.tenant.config
        if len(ts.tablet.active) >= int(cfg["memstore_limit_rows"]):
            # horizon-clamped: versions newer than a live transaction's
            # snapshot must stay in the memtables or its write-conflict
            # check goes blind (lost update)
            self._engine.freeze_and_flush(
                table, snapshot=self._txsvc.flush_snapshot())
            self.catalog.invalidate(table)
            l0 = sum(1 for s in ts.tablet.segments if s.level == 0)
            if l0 >= int(cfg["minor_compact_trigger"]):
                self._engine.minor_compact(table)

    def _tx_drain_fence(self, timeout_s: float = 10.0):
        """-> callable waiting out transactions live NOW (their earlier
        writes predate index maintenance); the online-DDL write fence
        (≙ ObDDLService waiting on the schema-version tx barrier)."""
        svc = self._txsvc
        own_tx = self._tx.tx_id if self._tx is not None else None

        def drain():
            # captured HERE: engine.create_index calls the fence after
            # installing the IndexDef, so every transaction whose writes
            # could have escaped maintenance is in this set
            with svc._lock:
                live_before = set(svc._live)
            # the session's own open transaction cannot be waited on
            live_before.discard(own_tx)
            deadline = time.monotonic() + timeout_s
            while True:
                with svc._lock:
                    if not (live_before & set(svc._live)):
                        return
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "CREATE INDEX timed out waiting for in-flight "
                        "transactions to finish")
                time.sleep(0.01)
        return drain

    def _create_table_as(self, stmt: ast.CreateTableStmt) -> Result:
        """CREATE TABLE AS SELECT: schema inferred from the result set,
        rows direct-loaded (≙ CTAS via the direct-load path)."""
        res = self._execute_select(stmt.as_select, None)
        cols = [ColumnDef(name, res.dtypes.get(name, SqlType.int_()))
                for name in res.names]
        tdef = TableDef(stmt.name, cols)
        self.catalog.create_table(tdef, if_not_exists=stmt.if_not_exists)
        arrays, valids = {}, {}
        for name in res.names:
            arr = res.arrays[name]
            t = res.dtypes.get(name)
            if t is not None and t.is_string:
                # NULL lanes carry None payloads; validity is authoritative
                arrays[name] = np.array(
                    [x if x is not None else "" for x in arr], dtype=object)
            else:
                arrays[name] = arr
            v = res.valids.get(name)
            if v is not None and not v.all():
                valids[name] = v
        if res.rowcount:
            self._engine.bulk_load(stmt.name, arrays, valids or None,
                                   version=self._txsvc.gts.get_ts())
        self.catalog.invalidate(stmt.name)
        tdef.row_count = res.rowcount
        return _ok(rowcount=res.rowcount)

    def _truncate(self, stmt: ast.TruncateStmt) -> Result:
        """TRUNCATE TABLE: DDL semantics — implicit commit of the open
        transaction (MySQL), an exclusive table lock so live
        transactions' redo lands BEFORE the WAL barrier (it waits for
        every live writer of the table, at most 30 s), a fresh tablet,
        the AUTO_INCREMENT counters reset."""
        if self.db is None:
            raise _needs_db("TRUNCATE")
        td = self.catalog.table_def(stmt.table)  # existence check
        if self._tx is not None:
            self._txsvc.commit(self._tx)  # DDL implies COMMIT
            self._tx = None
        tx = self._txsvc.begin()
        try:
            self.tenant.locks.acquire(stmt.table, "X", tx.tx_id,
                                      timeout=30.0)
            lsn = self._txsvc._log({"op": "truncate", "table": stmt.table})
            self._engine.truncate_table(stmt.table, wal_lsn=lsn)
            # MySQL: TRUNCATE resets AUTO_INCREMENT
            for cname in td.auto_increment_cols:
                seq = f"__ai_{stmt.table}_{cname}"
                self._sequences.drop(seq)
                self._sequences.create(seq, start=1)
        finally:
            self._txsvc.commit(tx)  # releases the lock
        self.catalog.invalidate(stmt.table)
        return _ok()

    def _lock_table(self, stmt: ast.LockTableStmt) -> Result:
        """LOCK TABLES t READ|WRITE / UNLOCK TABLES (≙ tablelock as a tx
        operation; MySQL-flavored syntax).  A conflicting lock is waited
        for at most ``lock_wait_timeout_s`` (MySQL's lock_wait_timeout;
        the reference waits a fixed 10 s), then WriteConflict."""
        if self.db is None:
            raise _needs_db("LOCK TABLES")
        if stmt.unlock:
            if self._tx is not None:
                self.tenant.locks.release_all(self._tx.tx_id)
                if not self._tx.participants:
                    # lock-only implicit tx: end it so later autocommit
                    # DML doesn't silently ride (and lose) it
                    self._txsvc.commit(self._tx)
                    self._tx = None
            return _ok()
        if self._tx is None:
            self._tx = self._txsvc.begin()  # implicit tx holds the lock
        self.tenant.locks.acquire(stmt.table, stmt.mode, self._tx.tx_id,
                                  timeout=self._txsvc.lock_wait_timeout_s)
        return _ok()

    def _alter_table(self, stmt: ast.AlterTableStmt) -> Result:
        """ALTER TABLE ADD/DROP COLUMN (``StorageEngine.alter_table``):
        the cached relation and every bound plan see the new schema."""
        if self.db is None:
            raise _needs_db("ALTER TABLE")
        if stmt.action == "add_column":
            c = stmt.column
            self._engine.alter_table(stmt.table, "add_column",
                                     (c.name, c.dtype, c.nullable))
        else:
            self._engine.alter_table(stmt.table, "drop_column", stmt.column)
        self.catalog.invalidate(stmt.table)
        self.catalog.schema_version += 1
        return _ok()

    def _sequence(self, stmt: ast.SequenceStmt) -> Result:
        if self.db is None:
            raise _needs_db("a sequence")
        if stmt.op == "create":
            self._sequences.create(stmt.name, stmt.start, stmt.increment,
                                   stmt.cache)
        else:
            self._sequences.drop(stmt.name)
        return _ok()

    def _fill_auto_increment(self, td, values: dict):
        seqs = self._sequences
        for cname in td.auto_increment_cols:
            seq = f"__ai_{td.name}_{cname}"
            if seq not in seqs._defs:
                seqs.create(seq, start=1)
            if values.get(cname) is None:
                values[cname] = seqs.nextval(seq)
            else:
                # explicit value advances the counter (MySQL semantics)
                try:
                    seqs.advance_past(seq, int(values[cname]))
                except (TypeError, ValueError):
                    pass

    # ------------------------------------------------------------------
    # parallel DML (≙ src/sql/engine/pdml: partition-aware parallel
    # insert/update/delete DFOs under ONE transaction)
    # ------------------------------------------------------------------
    def _pdml_eligible(self, n_rows: int) -> bool:
        return (int(self.db.config["pdml_dop"]) > 1
                and n_rows >= int(self.db.config["pdml_min_rows"]))

    def _pdml_write(self, tx, table: str, tablet, keyed: list, kind: str):
        """Fan the write phase of one statement out over tenant workers.

        keyed: [(key, values)] — host values, read back from the device
        before the fan-out (device work stays on the session's thread).
        Rows group by target partition so each worker owns whole
        partitions (no cross-worker tablet contention; ≙ the PDML
        repartition by PKEY); an unpartitioned tablet takes round-robin
        chunks (its memtable writes serialize on the tablet lock, index
        maintenance and redo encoding still parallelize)."""
        dop = int(self.db.config["pdml_dop"])
        groups: dict[int, list] = {}
        if hasattr(tablet, "route_partition_index"):
            for key, values in keyed:
                groups.setdefault(
                    tablet.route_partition_index(values), []).append(
                        (key, values))
        else:
            for i, kv_ in enumerate(keyed):
                groups.setdefault(i % dop, []).append(kv_)

        def worker(batch):
            for key, values in batch:
                self._txsvc.write(tx, table, tablet, key, kind, values)

        futures = [self.tenant.submit(worker, batch)
                   for batch in groups.values()]
        errs = []
        for f in futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — surface first error
                errs.append(e)
        if errs:
            raise errs[0]

    # ------------------------------------------------------------------
    # SAVEPOINT and XA (with a Database)
    # ------------------------------------------------------------------
    def _savepoint(self, stmt: ast.SavepointStmt) -> Result:
        """SAVEPOINT name / ROLLBACK TO name / RELEASE name: a savepoint
        records the tx's statement counter + per-table write counts;
        rollback-to aborts every write with a later statement seq
        (statement-granular undo, ≙ savepoint rollback over
        ObPartTransCtx's stmt-scoped callbacks)."""
        if self.db is None:
            raise _needs_db("SAVEPOINT")
        if self._tx is None:
            raise RuntimeError("no active transaction for SAVEPOINT")
        tx = self._tx
        if not hasattr(tx, "savepoints"):
            tx.savepoints = {}
        if stmt.op == "create":
            tx.savepoints[stmt.name] = (
                tx.stmt_seq,
                {t: len(p.keys) for t, p in tx.participants.items()})
            return _ok()
        sp = tx.savepoints.get(stmt.name)
        if sp is None:
            raise KeyError(f"savepoint {stmt.name} does not exist")
        if stmt.op == "release":
            del tx.savepoints[stmt.name]
            return _ok()
        # rollback to: undo everything written after the savepoint
        sp_seq, counts = sp
        stmt_writes = {}
        for t, p in tx.participants.items():
            new = p.keys[counts.get(t, 0):]
            if new:
                stmt_writes[t] = new
        self._txsvc.rollback_statement(tx, sp_seq + 1, stmt_writes)
        for t, p in tx.participants.items():
            del p.keys[counts.get(t, 0):]
        # savepoints created after this one are destroyed (MySQL)
        tx.savepoints = {n: v for n, v in tx.savepoints.items()
                         if v[0] <= sp_seq}
        for t in stmt_writes:
            self.catalog.invalidate(t)
        return _ok()

    def _xa(self, stmt: ast.XaStmt) -> Result:
        """XA START/END/PREPARE/COMMIT [ONE PHASE]/ROLLBACK/RECOVER
        (externally coordinated 2PC, ≙ ObXAService); the branch store
        lives on the tenant's TransService."""
        if self.db is None:
            raise _needs_db("XA")
        store = self._txsvc.xa_transactions
        if stmt.op == "start":
            if self._tx is not None:
                raise RuntimeError("a transaction is already active")
            if stmt.xid in store:
                raise ValueError(f"XA xid {stmt.xid!r} exists")
            self._tx = self._txsvc.begin()
            self._tx.xid = stmt.xid
            store[stmt.xid] = self._tx
            return _ok()
        if stmt.op == "recover":
            # the service's locked view (live-prepared AND crash-
            # recovered branches — durable XA)
            xids = self._txsvc.recoverable_xids()
            return Result(["xid"], {"xid": _strings(xids)}, {},
                          {"xid": SqlType.string()}, rowcount=len(xids))
        tx = store.get(stmt.xid)
        if tx is None:
            raise KeyError(f"unknown XA xid {stmt.xid!r}")
        if stmt.op == "end":
            # detach from this session; the xid keeps the tx reachable
            if self._tx is tx:
                self._tx = None
            return _ok()
        if stmt.op == "prepare":
            self._txsvc.xa_prepare(tx)
            if self._tx is tx:
                # a PREPARE-state tx takes no more statements; keeping it
                # attached would wedge every later DML in this session
                self._tx = None
            return _ok()
        if self._tx is tx:
            self._tx = None
        if stmt.op == "commit":
            if tx.state == TxState.ACTIVE:  # XA ... ONE PHASE path
                self._txsvc.commit(tx)
            else:
                self._txsvc.xa_commit_prepared(tx)
        else:
            self._txsvc.xa_rollback_prepared(tx)
        store.pop(stmt.xid, None)
        for t in list(tx.participants):
            self.catalog.invalidate(t)
        return _ok()

    # ------------------------------------------------------------------
    # LOAD DATA (with a Database)
    # ------------------------------------------------------------------
    def _load_data(self, stmt: ast.LoadDataStmt) -> Result:
        """LOAD DATA INFILE: CSV -> direct-load baseline segment
        (≙ src/storage/direct_load bypassing the memtable), one segment
        per partition of a partitioned table.  The hot path tokenizes and
        parses numerics in the native library; the python csv module is
        the fallback (and the quoting-semantics oracle).  ``\\N`` and
        empty fields are NULL; a malformed numeric cell aborts the load
        with its row number."""
        if self.db is None:
            raise _needs_db("LOAD DATA")
        td = self.catalog.table_def(stmt.table)
        with open(stmt.path, "rb") as f:
            data = f.read()
        fast = self._load_data_native(stmt, td, data)
        if fast is not None:
            arrays, valids, n = fast
            self.last_load = {"route": "native", "rows": n,
                              "bytes": len(data)}
            return self._finish_load(stmt, td, arrays, valids, n)
        arrays, valids, n = _load_data_csv(stmt, td)
        self.last_load = {"route": "python", "rows": n, "bytes": len(data)}
        return self._finish_load(stmt, td, arrays, valids, n)

    @staticmethod
    def _load_data_native(stmt, td, data: bytes):
        """Native CSV fast path -> (arrays, valids, n) or None to fall
        back (no native lib / ragged file / exotic types).  DATE, float
        and string cells are read through a fixed-width byte view
        (``native.field_bytes``) in numpy; the arrays are the
        reference's, which parses them one Python string at a time."""
        n_cols = len(td.columns)
        tok = native.csv_tokenize(data, n_cols, stmt.delimiter)
        if tok is None:
            return None
        buf, offsets, lengths, n_rows = tok
        if n_rows <= stmt.skip_lines:
            return {}, {}, 0
        start = stmt.skip_lines * n_cols
        offsets = offsets[start:]
        lengths = lengths[start:]
        n = n_rows - stmt.skip_lines
        arrays, valids = {}, {}

        def _check_numeric(valid, offs, lens, colname):
            # python-oracle semantics: garbage (non-empty, non-\N)
            # numeric cells ABORT the load instead of nulling silently
            empty = (lens & 0x7FFFFFFF) == 0
            suspicious = ~valid & ~empty
            if suspicious.any():
                idx = np.nonzero(suspicious)[0]
                cells = native.field_strings(
                    data, np.ascontiguousarray(offs[idx]),
                    np.ascontiguousarray(lens[idx]))
                for row_i, cell in zip(idx, cells):
                    if cell.upper() != "\\N":
                        raise ValueError(
                            f"row {int(row_i) + 1 + stmt.skip_lines}: "
                            f"invalid value {cell!r} for column "
                            f"{colname!r}")
            return valid

        for j, cdef in enumerate(td.columns):
            offs = np.ascontiguousarray(offsets[j::n_cols])
            lens = np.ascontiguousarray(lengths[j::n_cols])
            k = cdef.dtype.kind
            if k in (TypeKind.INT, TypeKind.DECIMAL):
                out, valid = native.parse_int64_fields(
                    buf, offs, lens,
                    cdef.dtype.scale if k == TypeKind.DECIMAL else 0)
                valid = _check_numeric(valid, offs, lens, cdef.name)
                arrays[cdef.name] = out
            elif k == TypeKind.DATE:
                cells = _cells(data, offs, lens)
                valid = _not_null(cells, fold_case=True)
                days = np.zeros(n, dtype=np.int32)
                if valid.any():
                    d64 = np.where(valid, cells, b"1970-01-01"
                                   if cells.dtype.kind == "S"
                                   else "1970-01-01").astype(
                                       "datetime64[D]")
                    days = (d64 - DATE_EPOCH).astype(np.int32)
                arrays[cdef.name] = days
            elif k in (TypeKind.FLOAT, TypeKind.DOUBLE):
                cells = _cells(data, offs, lens)
                valid = _not_null(cells, fold_case=True)
                vals = np.zeros(n, dtype=cdef.dtype.np_dtype)
                try:
                    vals[valid] = cells[valid].astype(np.float64)
                except ValueError:
                    # the reference's per-cell parse names the bad row
                    for i in np.nonzero(valid)[0]:
                        sv = _cell_str(cells[i])
                        try:
                            float(sv)
                        except ValueError:
                            raise ValueError(
                                f"row {int(i) + 1 + stmt.skip_lines}: "
                                f"invalid value {sv!r} for column "
                                f"{cdef.name!r}") from None
                    raise
                arrays[cdef.name] = vals
            elif cdef.dtype.is_string:
                strs = native.field_strings(data, offs, lens)
                valid = (lens & 0x7FFFFFFF) != 0
                valid &= strs != "\\N"
                arrays[cdef.name] = strs
            else:
                return None  # exotic type: python fallback handles it
            if not valid.all():
                valids[cdef.name] = valid
        return arrays, valids, n

    def _finish_load(self, stmt, td, arrays, valids, n) -> Result:
        if n:
            self._engine.bulk_load(stmt.table, arrays, valids or None,
                                   version=self._txsvc.gts.get_ts())
        self.catalog.invalidate(stmt.table)
        td.row_count = self._engine.tables[stmt.table] \
            .tablet.row_count_estimate()
        return _ok(rowcount=n)

    def _alter_system(self, stmt: ast.AlterSystemStmt) -> Result:
        if self.db is None:
            raise _needs_db("ALTER SYSTEM")
        if stmt.action == "set":
            self.db.config.set(stmt.name, stmt.value)
            return _ok()
        if stmt.action == "calibrate":
            return self._calibrate()
        # MINOR/MAJOR FREEZE, CHECKPOINT: flush every table at the
        # horizon, not gts-now (versions newer than a live transaction's
        # snapshot must stay in the memtables)
        eng = self._engine
        snap = self._txsvc.flush_snapshot()
        for name in list(eng.tables):
            eng.freeze_and_flush(name, snapshot=snap)
            if stmt.action == "major_freeze":
                eng.major_compact(name)
            self.catalog.invalidate(name)
        return _ok()

    def _calibrate(self) -> Result:
        """ALTER SYSTEM CALIBRATE: re-run the roofline probe suite on the
        database's device (the "full" ladder) and persist the refreshed
        machine constants, which the optimizer prices plans with from
        the next bind on."""
        if not bool(self.db.config["enable_calibration"]):
            raise ValueError(
                "enable_calibration is off (ALTER SYSTEM SET "
                "enable_calibration = true first)")
        units = qcalibrate.ensure_units(self.db.root, preset="full",
                                        force=True, device=self.device)
        self.db.cost_units = units
        names = ["backend", "peak_gflops", "peak_gbps", "eff_gbps",
                 "launch_overhead_us", "rpc_s_per_byte", "probe_s"]
        vals = [units.backend,
                f"{units.peak_flops_s / 1e9:.3f}",
                f"{units.peak_bytes_s / 1e9:.3f}",
                f"{units.eff_bytes_s / 1e9:.3f}",
                f"{units.launch_overhead_s * 1e6:.2f}",
                f"{units.rpc_s_per_byte:.3e}",
                f"{units.probe_s:.3f}"]
        return Result(["constant", "value"],
                      {"constant": _strings(names),
                       "value": _strings(vals)},
                      {}, {}, rowcount=len(names))

    # ------------------------------------------------------------------
    # KILL, SHOW PROCESSLIST (with a Database)
    # ------------------------------------------------------------------
    def _kill(self, stmt: ast.KillStmt) -> Result:
        """KILL [QUERY] <session_id>: flag the target's running (or
        queued) statement; the victim unwinds with typed QueryKilled at
        its next host-side checkpoint (plan entry or close, spill batch,
        retry ladder).  Plain KILL also evicts the session."""
        if self.db is None:
            raise _needs_db("KILL")
        # existence first (MySQL: ER_NO_SUCH_THREAD): plain KILL must
        # not plant eviction flags for ids that were never sessions
        known = stmt.session_id in self.db.ash.sessions() or \
            stmt.session_id == self.session_id
        if not known:
            raise KeyError(f"unknown session id {stmt.session_id}")
        found = self.db.admission.kill(stmt.session_id,
                                       query_only=(stmt.kind == "query"))
        return _ok(rowcount=1 if found else 0)

    def _show_processlist(self) -> Result:
        """One row per live session of the database: QUEUED (waiting for
        an admission slot), RUNNING, KILLED (flagged, still unwinding)
        or IDLE, with its current or last statement."""
        disp = {"executing": "RUNNING", "queued": "QUEUED",
                "killed": "KILLED", "idle": "IDLE"}
        rows = []
        if self.db is not None:
            for sid, st in self.db.ash.sessions().items():
                raw = st.get("state", "idle")
                rows.append((sid, disp.get(raw, raw.upper()),
                             st.get("sql", "")[:120]))
        rows.sort()
        return Result(
            ["id", "state", "info"],
            {"id": np.array([r[0] for r in rows], np.int64),
             "state": _strings(r[1] for r in rows),
             "info": _strings(r[2] for r in rows)},
            {}, {}, rowcount=len(rows))

    # ------------------------------------------------------------------
    # stored procedures (interpreted PL subset; ≙ src/pl — DECLARE/SET/
    # IF/WHILE over the shared expression engine, SQL via the session)
    # ------------------------------------------------------------------
    def _proc_store(self) -> dict:
        """The database's procedures (loaded from ``procedures.json``
        at first use), or this catalog-only session's own."""
        if self.db is not None:
            if self.db.procedures is None:
                self.db.procedures = {}
                self._load_procs()
            return self.db.procedures
        if not hasattr(self, "_procs"):
            self._procs = {}
        return self._procs

    def _procs_path(self):
        return (os.path.join(self.db.root, "procedures.json")
                if self.db is not None and self.db.root else None)

    def _load_procs(self):
        p = self._procs_path()
        if p and os.path.exists(p):
            with open(p) as fh:
                for name, src in json.load(fh).items():
                    stmt = parse_sql(src)
                    stmt.source = src
                    self.db.procedures[name] = stmt

    def _persist_procs(self):
        p = self._procs_path()
        if not p:
            return
        store = self._proc_store()
        tmp = p + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({n: s.source for n, s in store.items()}, fh)
        os.replace(tmp, p)

    def _procedure_ddl(self, stmt: ast.ProcedureStmt) -> Result:
        store = self._proc_store()
        if stmt.op == "drop":
            if store.pop(stmt.name, None) is None:
                raise KeyError(f"unknown procedure {stmt.name}")
        else:
            if stmt.name in store:
                raise ValueError(f"procedure {stmt.name} exists")
            if not stmt.source:
                raise ValueError(
                    "procedure definition lost its source text")
            store[stmt.name] = stmt
        self._persist_procs()
        return _ok()

    def _call_procedure(self, stmt: ast.CallStmt, params) -> Result:
        proc = self._proc_store().get(stmt.name)
        if proc is None:
            raise KeyError(f"unknown procedure {stmt.name}")
        if len(stmt.args) != len(proc.params):
            raise ValueError(
                f"{stmt.name} expects {len(proc.params)} arguments")
        env: dict = {}
        for (pname, ptype), arg in zip(proc.params, stmt.args):
            v, t = literal_value(_as_literal(arg, params, None))
            env[pname] = _coerce_value(v, t, ptype)
        out = [None]
        self._pl_exec(proc.body, env, out, depth=0)
        return out[0] if out[0] is not None else _ok()

    _PL_MAX_ITERS = 100_000

    def _pl_eval(self, expr, env: dict):
        """Evaluate a PL expression over the variable environment with
        the shared expression engine (a 1-row relation of the variables
        on the session's device)."""
        arrays, valids = {}, {}
        for k, v in env.items():
            if v is None:
                arrays[k] = np.zeros(1, np.int64)
                valids[k] = np.zeros(1, bool)
            elif isinstance(v, str):
                arrays[k] = np.array([v], dtype=object)
            elif isinstance(v, float):
                arrays[k] = np.array([v], np.float64)
            else:
                arrays[k] = np.array([int(v)], np.int64)
        arrays.setdefault("__one__", np.ones(1, np.int64))
        rel = from_numpy(arrays, valids=valids or None, device=self.device)
        c = eval_expr(expr, rel)
        raw = to_numpy(Relation(columns={"r": c}, mask=rel.mask))
        x = raw["r"][0]
        vmask = raw.get("__valid__r")
        if vmask is not None and not vmask[0]:
            return None
        return x.item() if hasattr(x, "item") else x

    def _pl_subst(self, node, env: dict):
        """Deep-substitute PL variables (bare ColumnRefs matching env
        names) with literals inside a statement AST."""
        def sub_expr(e):
            if isinstance(e, ir.ColumnRef) and e.name in env:
                return ir.Literal(env[e.name])
            if isinstance(e, ir.Expr):
                e2 = copy.copy(e)
                for f, v in vars(e).items():
                    setattr(e2, f, sub_any(v))
                return e2
            return e

        def sub_any(v):
            if isinstance(v, ir.Expr):
                return sub_expr(v)
            if isinstance(v, list):
                return [sub_any(x) for x in v]
            if isinstance(v, tuple):
                return tuple(sub_any(x) for x in v)
            if hasattr(v, "__dataclass_fields__"):
                if v.__dataclass_params__.frozen:
                    # a value type (a literal's SqlType) holds no PL
                    # variable; the reference's setattr on it raises
                    # FrozenInstanceError (ROADMAP Queue 3 #18)
                    return v
                v2 = copy.copy(v)
                for f in v.__dataclass_fields__:
                    setattr(v2, f, sub_any(getattr(v, f)))
                return v2
            return v

        return sub_any(node)

    def _pl_exec(self, body: list, env: dict, out: list, depth: int):
        if depth > 64:
            raise RecursionError("PL nesting too deep")
        for item in body:
            if isinstance(item, ast.PlDeclare):
                env[item.name] = (self._pl_eval(item.default, env)
                                  if item.default is not None else None)
            elif isinstance(item, ast.PlSet):
                env[item.name] = self._pl_eval(item.expr, env)
            elif isinstance(item, ast.PlIf):
                done = False
                for cond, blk in item.branches:
                    if bool(self._pl_eval(cond, env)):
                        self._pl_exec(blk, env, out, depth + 1)
                        done = True
                        break
                if not done and item.else_:
                    self._pl_exec(item.else_, env, out, depth + 1)
            elif isinstance(item, ast.PlWhile):
                iters = 0
                while bool(self._pl_eval(item.cond, env)):
                    self._pl_exec(item.body, env, out, depth + 1)
                    iters += 1
                    if iters > self._PL_MAX_ITERS:
                        raise RuntimeError("PL WHILE iteration limit")
            else:
                # body statements must NOT hit the plan cache under the
                # CALL statement's text (its key would collide across
                # different or iterating SELECTs): blank the key text
                saved = self._ash_state.get("sql", "")
                self._ash_state["sql"] = ""
                try:
                    res = self.execute_stmt(self._pl_subst(item, env),
                                            None)
                finally:
                    self._ash_state["sql"] = saved
                if res is not None and res.names:
                    out[0] = res


def _with_feedback(plan, corrections: dict):
    """``apply_feedback`` memoized on the bound plan for its corrections:
    a cached plan with a standing correction would otherwise build, and
    fingerprint, a fresh corrected tree on every execution."""
    key = tuple(sorted(corrections.items()))
    hit = plan.__dict__.get("_with_feedback")
    if hit is None or hit[0] != key:
        hit = plan.__dict__["_with_feedback"] = (
            key, *apply_feedback(plan, corrections))
    return hit[1], hit[2]


def _py(x):
    """A numpy scalar as its Python value (strings stay strings; a
    VECTOR cell, a float32 row, becomes a list of floats)."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x.item() if hasattr(x, "item") else x


def _row_values(matched: dict, columns, i: int) -> dict:
    """Row ``i`` of a ``to_numpy`` result as {column: Python value or
    None}, over the tablet's columns present in it."""
    out = {}
    for c in columns:
        if c in matched:
            vd = matched.get("__valid__" + c)
            out[c] = None if vd is not None and not vd[i] \
                else _py(matched[c][i])
    return out


def materialize_host(arrays: dict, valids: dict, dtypes: dict,
                     outputs: list) -> Result:
    """Host columns (the spill tier's result) -> a ``Result`` over the
    statement's ``outputs`` ([(column id, name)]), the reference
    session's ``_materialize_host``: ``Result.rows()`` descales the raw
    scaled DECIMAL ints with the returned dtypes."""
    names, out_a, out_v, out_t = [], {}, {}, {}
    n = len(next(iter(arrays.values()))) if arrays else 0
    for cid, name in outputs:
        out_name = name
        k = 2
        while out_name in out_a:
            out_name = f"{name}_{k}"
            k += 1
        names.append(out_name)
        a = arrays.get(cid)
        if a is None:
            if n:
                raise KeyError(f"spill result missing output column {cid} "
                               f"({name})")
            a = np.zeros(0, dtype=np.int64)  # no batch survived
        out_a[out_name] = a
        out_v[out_name] = valids.get(cid)
        t = dtypes.get(cid)
        if t is None:
            if a.dtype == object or a.dtype.kind in "US":
                t = SqlType.string()
            elif a.dtype.kind == "f":
                t = SqlType.double()
            elif a.dtype.kind == "b":
                t = SqlType.bool_()
            else:
                t = SqlType.int_()
        out_t[out_name] = t
    return Result(names, out_a, out_v, out_t, rowcount=n)


def _as_literal(e, params, sequences=None) -> ir.Literal:
    if isinstance(e, ir.Literal):
        return e
    if isinstance(e, ast.Param):
        return ir.Literal(params[e.index])
    if isinstance(e, ir.FuncCall) and e.name == "nextval" and \
            sequences is not None:
        return ir.Literal(sequences.nextval(e.args[0].value))
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
    if target.kind == TypeKind.DATETIME:
        # stored as int64 microseconds: a string or a date literal is
        # converted here, what does not parse is refused before the
        # write (the reference stores the string, and every later read
        # and checkpoint of the table then fails; ROADMAP Queue 3 #12)
        if t.kind == TypeKind.DATE:
            return int(v) * US_PER_DAY
        if isinstance(v, str):
            return _datetime_us(v)
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"invalid DATETIME value {v!r}")
        return v
    if target.kind == TypeKind.BOOL:
        return bool(v)
    if target.kind == TypeKind.VECTOR and isinstance(v, str):
        vec = parse_vector_text(v)
        if len(vec) != target.precision:
            raise ValueError(
                f"vector literal has dim {len(vec)}, column wants "
                f"{target.precision}")
        return [float(x) for x in vec]
    return v


def _datetime_us(text: str) -> int:
    """'YYYY-MM-DD[ hh:mm:ss[.ffffff]]' -> int64 microseconds since the
    epoch (the values ``expr/compile.py`` compares DATETIME literals
    in); ValueError when it does not parse."""
    try:
        d = np.datetime64(text.strip().replace(" ", "T", 1), "us")
    except ValueError:
        d = np.datetime64("NaT")
    if np.isnat(d):
        raise ValueError(f"invalid DATETIME value {text!r}")
    return int(d.astype(np.int64))


class _PeekSequences:
    """Sequence view that never advances (EXPLAIN planning)."""

    def __init__(self, seqs):
        self._seqs = seqs

    def nextval(self, name: str) -> int:
        return self._seqs.peek(name)


def _refuse_live_keys(tablet, keys: list, tx):
    """Primary-key enforcement for an INSERT: refuse a key that already
    holds a live version at the statement's snapshot in the memtables
    OR the segments, checked once for the whole statement
    (``storage/lookup.py::live_keys``).  The memtable write only sees
    its own memtable (and still catches duplicates inside the
    statement); without this a flushed or bulk-loaded row is silently
    overwritten (ROADMAP Queue 3 #13)."""
    if tablet.key_cols == ["__rowid__"]:
        return  # hidden rowids are freshly allocated
    live = live_keys(tablet, keys, tx.snapshot, tx.tx_id)
    for key in keys:
        if key in live:
            raise DuplicateKey(f"duplicate key {key}")


def _cells(data: bytes, offs, lens) -> np.ndarray:
    """Tokenized cells as a fixed-width bytes array (or as strings when
    a cell needs unescaping or is not ASCII)."""
    fixed = native.field_bytes(data, offs, lens)
    return fixed if fixed is not None else \
        native.field_strings(data, offs, lens)


def _not_null(cells: np.ndarray, fold_case: bool) -> np.ndarray:
    """Cells that are neither empty nor ``\\N`` (``\\n`` too when
    ``fold_case``, as the reference's ``s.upper() != "\\N"``)."""
    nulls = ("", "\\N", "\\n") if fold_case else ("", "\\N")
    if cells.dtype.kind == "S":
        nulls = tuple(x.encode() for x in nulls)
    valid = np.ones(len(cells), dtype=bool)
    for x in nulls:
        valid &= cells != x
    return valid


def _cell_str(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


def _load_data_csv(stmt, td):
    """LOAD DATA through the python csv module (ragged files, types the
    tokenizer does not take, no native library) -> (arrays, valids,
    n)."""
    cols = [[] for _ in td.columns]
    with open(stmt.path, newline="") as f:
        reader = csv.reader(f, delimiter=stmt.delimiter)
        for i, row in enumerate(reader):
            if i < stmt.skip_lines:
                continue
            if len(row) != len(td.columns):
                raise ValueError(
                    f"row {i + 1}: {len(row)} fields, expected "
                    f"{len(td.columns)}")
            for j, cell in enumerate(row):
                cols[j].append(cell)
    n = len(cols[0]) if cols else 0
    arrays, valids = {}, {}
    for cdef, raw in zip(td.columns, cols):
        vals = []
        valid = np.ones(n, dtype=bool)
        for i, cell in enumerate(raw):
            if cell == "" or cell.upper() == "\\N":
                valid[i] = False
                vals.append("" if cdef.dtype.is_string else 0)
                continue
            if cdef.dtype.is_string:
                vals.append(cell)
            elif cdef.dtype.kind == TypeKind.DECIMAL:
                v, t = literal_value(ir.Literal(cell, SqlType.decimal()))
                vals.append(_rescale(v, t.scale, cdef.dtype.scale))
            elif cdef.dtype.kind == TypeKind.DATE:
                vals.append(date_to_days(cell))
            elif cdef.dtype.kind in (TypeKind.FLOAT, TypeKind.DOUBLE):
                vals.append(float(cell))
            elif cdef.dtype.kind == TypeKind.DATETIME and \
                    not cell.lstrip("+-").isdigit():
                # a raw integer is microseconds, as in the reference
                vals.append(_datetime_us(cell))
            else:
                vals.append(int(cell))
        arrays[cdef.name] = (np.array(vals, dtype=object)
                             if cdef.dtype.is_string
                             else np.asarray(vals, dtype=cdef.dtype.np_dtype))
        if not valid.all():
            valids[cdef.name] = valid
    return arrays, valids, n


def _rescale(v: int, from_scale: int, to_scale: int) -> int:
    if to_scale >= from_scale:
        return v * _POW10[to_scale - from_scale]
    d = _POW10[from_scale - to_scale]
    half = d // 2
    return (v + half) // d if v >= 0 else -((-v + half) // d)


def _ok(rowcount: int = 0) -> Result:
    return Result([], {}, {}, {}, rowcount=rowcount)


def format_plan(node, indent: int = 0,
                row_counts: dict | None = None) -> str:
    """EXPLAIN [ANALYZE] text: one line per operator with its attributes,
    children indented below it; ANALYZE adds the estimate-vs-actual
    ledger per operator (``[est=… act=… q=…]``)."""
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
    if row_counts is not None and id(node) in row_counts:
        r = row_counts[id(node)]
        est = r["est"] if r.get("est") is not None else "?"
        line += (f"  [est={est} act={r['rows']} "
                 f"q={r.get('q_error', 0.0):.2f}]")
    return "\n".join([line] + [format_plan(c, indent + 1, row_counts)
                               for c in node.children()])


__all__ = ["Result", "Session", "format_plan", "materialize_host"]
