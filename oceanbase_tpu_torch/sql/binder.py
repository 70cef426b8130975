"""Binder: AST -> physical plan fragments + join graph.

The port's own copy of ``oceanbase_tpu/sql/binder.py``, kept line for line
so both bind a statement to the same plan.  Only the bind-time execution
differs: uncorrelated scalar subqueries fold through the port's
``execute_plan`` on the catalog's device tables.

Combines the reference's resolver (src/sql/resolver — name/type binding),
rewriter (src/sql/rewrite — subquery unnesting/decorrelation) and the
front half of the optimizer (src/sql/optimizer — predicate classification
into the join graph) in one pass.  The output QueryBlock is handed to the
join-order optimizer (sql/optimizer.py) and code generator (sql/codegen.py).

Subquery rewrites implemented (≙ ObTransformerImpl rules):
- EXISTS / NOT EXISTS     -> semi / anti join (+ residual non-equality
  correlated predicates, ≙ ob_transform_semi_to_inner / unnest)
- x IN (subq)             -> semi join; NOT IN -> anti join
- uncorrelated scalar     -> single-row fragment cross-joined in
- correlated scalar agg   -> "magic set" decorrelation: inner agg grouped
  by correlation keys joined back on them (≙ ob_transform_aggr_subquery)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from oceanbase_tpu_torch.catalog import Catalog
from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.exec.ops import AggSpec
from oceanbase_tpu_torch.exec import plan as pp
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.sql import ast
from oceanbase_tpu_torch.sql.parser import Interval


class BindError(ValueError):
    pass


_uid = itertools.count()


def fresh(prefix: str) -> str:
    return f"{prefix}_{next(_uid)}"


@dataclass
class Scope:
    """name -> column id visible to expressions.

    entries: 'col' and 'alias.col' both map to the unique column id.
    """

    entries: dict[str, str] = field(default_factory=dict)
    parent: Optional["Scope"] = None

    def add(self, name: str, colid: str, alias: str | None = None):
        if name in self.entries:
            self.entries[name] = AMBIGUOUS
        else:
            self.entries[name] = colid
        if alias:
            self.entries[f"{alias}.{name}"] = colid

    def lookup(self, name: str):
        """-> (colid, depth) or (None, 0)."""
        s, depth = self, 0
        while s is not None:
            cid = s.entries.get(name)
            if cid is AMBIGUOUS:
                raise BindError(f"ambiguous column {name!r}")
            if cid is not None:
                return cid, depth
            s, depth = s.parent, depth + 1
        return None, 0


AMBIGUOUS = object()

# defaults MySQL clients commonly probe on connect
# (≙ src/share/system_variable seed values)
_SYSVAR_DEFAULTS = {
    "version_comment": "oceanbase-tpu",
    "version": "5.7.0-oceanbase-tpu",
    "sql_mode": "STRICT_TRANS_TABLES",
    "autocommit": 1,
    "tx_isolation": "READ-COMMITTED",
    "transaction_isolation": "READ-COMMITTED",
    "max_allowed_packet": 16 << 20,
    "character_set_client": "utf8mb4",
    "character_set_results": "utf8mb4",
    "character_set_connection": "utf8mb4",
    "collation_connection": "utf8mb4_general_ci",
    "wait_timeout": 28800,
    "interactive_timeout": 28800,
    "lower_case_table_names": 1,
}


@dataclass
class Fragment:
    """One join-graph vertex: a physical subtree + its output columns.

    ``colids`` is the authoritative ownership set (predicate/home checks);
    ``cols`` maps *unqualified* visible names and can collide across
    fragments, so it is never used for ownership."""

    plan: pp.PlanNode
    cols: dict[str, str]  # visible name -> colid (display/debug only)
    est_rows: int
    unique_cols: frozenset = frozenset()  # colids known unique (PK)
    colids: frozenset = frozenset()       # every colid this subtree produces
    ndv: dict = field(default_factory=dict)  # colid -> distinct-value est
    # colid -> (equi-height edges, null_frac, SqlType) from ANALYZE
    hist: dict = field(default_factory=dict)
    # colid -> (mcv values, frequency fractions) from ANALYZE (strings)
    mcv: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.colids:
            self.colids = frozenset(self.cols.values())


@dataclass
class SemiEdge:
    """A deferred semi/anti (EXISTS / IN / quantified) subquery edge.

    The binder used to fuse these onto the home fragment immediately;
    deferring the attachment lets the optimizer PLACE the semi join by
    cost — on the home fragment (filter early) or above the whole join
    tree, where the probe side has already been reduced by the other
    joins (TPC-H Q21's equality expansion shrinks by the full join
    selectivity up there)."""

    home: int            # home fragment index in QueryBlock.fragments
    plan: "pp.PlanNode"  # bound inner (build-side) plan
    lhs: list            # probe-side key exprs (home fragment colids)
    rkeys: list          # build-side key exprs (inner plan colids)
    residual: list       # non-equality correlated predicates
    anti: bool
    build_est: int       # inner plan's cardinality estimate


@dataclass
class QueryBlock:
    fragments: list = field(default_factory=list)
    join_edges: list = field(default_factory=list)   # (fi, fj, lexpr, rexpr)
    post_preds: list = field(default_factory=list)   # applied after joins
    semi_edges: list = field(default_factory=list)   # list[SemiEdge]
    # set by finishing phases:
    output: list = field(default_factory=list)       # [(colid, out_name)]
    est_rows: int = 0


class Binder:
    def __init__(self, catalog: Catalog, ctes: dict | None = None,
                 params: list | None = None, sequences=None,
                 sysvars: dict | None = None):
        self.catalog = catalog
        self.ctes = dict(ctes or {})
        self.params = params or []
        self.sequences = sequences  # SequenceManager for nextval()
        self.sysvars = sysvars      # session variables for @@refs
        # True when the bound plan embeds values computed AT BIND TIME
        # (nextval, eagerly-executed scalar subqueries): such plans must
        # never be cached — re-binding is what re-evaluates them
        self.folded_volatile = False
        # cost model for build_join_tree (None -> optimizer default);
        # the session injects its calibrated units + corrections here
        self.cost_model = None
        # per-block CBO choice records (chosen pred_s vs runner-up) —
        # the session feeds these into the gv$plan_choice ledger
        self.cbo_choices: list = []
        # cycle guards: CTE / view names currently being expanded
        self._cte_stack: set[str] = set()
        self._view_stack: set[str] = set()

    # ------------------------------------------------------------------
    def bind_select(self, stmt: ast.SelectStmt,
                    outer: Scope | None = None) -> tuple[pp.PlanNode, list, int]:
        """-> (plan, [(colid, name)], est_rows)."""
        for name, sub in stmt.ctes:
            self.ctes[name] = sub

        plan, outputs, est = self._bind_core(stmt, outer)

        for op, all_, rhs in stmt.setops:
            # branches bind through bind_select so a branch's own
            # ORDER BY / LIMIT (from a parenthesized select) stays inside it
            rplan, routs, rest = self.bind_select(rhs, outer)
            if len(routs) != len(outputs):
                raise BindError("set operation column count mismatch")
            plan, outputs, est = self._apply_setop(
                op, all_, plan, outputs, est, rplan, routs, rest
            )

        if stmt.post_order_by:
            keys, asc = [], []
            for item in stmt.post_order_by:
                e = item.expr
                cid = self._output_ref(e, outputs)
                if cid is None:
                    raise BindError(
                        "ORDER BY after a set operation must reference "
                        "output columns")
                keys.append(ir.col(cid))
                asc.append(item.ascending)
            plan = pp.Sort(plan, keys, asc)
        if stmt.post_limit is not None:
            plan = pp.Limit(plan, stmt.post_limit, stmt.post_offset)
            est = min(est, stmt.post_limit)
        if outer is None:
            # top-level bind: fill est_rows on every node the binder did
            # not annotate directly, so each gv$sql_plan_monitor row has
            # an estimate to q-error against (est_rows is metadata —
            # repr/compare-excluded, so fingerprints are unaffected)
            plan = pp.propagate_estimates(plan)
        return plan, outputs, est

    @staticmethod
    def _output_ref(e: ir.Expr, outputs) -> str | None:
        """Resolve an ORDER BY item against the output list: ordinal or
        output name/alias."""
        if isinstance(e, ir.Literal) and isinstance(e.value, int):
            k = e.value
            if not 1 <= k <= len(outputs):
                raise BindError(f"ORDER BY position {k} out of range")
            return outputs[k - 1][0]
        if isinstance(e, ir.ColumnRef):
            base = e.name.split(".")[-1]
            for cid, name in outputs:
                if name == base:
                    return cid
        return None

    # ------------------------------------------------------------------
    def _bind_core(self, stmt: ast.SelectStmt, outer: Scope | None):
        qb = QueryBlock()
        scope = Scope(parent=outer)

        # FROM
        for tref in stmt.from_:
            self._bind_table_expr(tref, qb, scope)
        if not qb.fragments:
            # SELECT without FROM: single-row dual
            import numpy as np

            if not self.catalog.has_table("__dual__"):
                self.catalog.load_numpy("__dual__", {"one": np.array([1])})
            qb.fragments.append(Fragment(
                pp.TableScan("__dual__", columns=["one"],
                             rename={"one": fresh("one")}),
                {}, 1))

        # WHERE: classify conjuncts
        if stmt.where is not None:
            self._bind_where(stmt.where, qb, scope)

        # assemble join tree (order optimization + capacities in optimizer)
        from oceanbase_tpu_torch.sql.optimizer import build_join_tree

        plan, est, colid_frag = build_join_tree(qb, self.catalog,
                                                cost=self.cost_model)
        if getattr(qb, "cbo_choice", None):
            self.cbo_choices.append(qb.cbo_choice)

        # residual predicates after joins
        for pred in qb.post_preds:
            plan = pp.Filter(plan, pred)
            est = max(1, est // 3)

        # SELECT list: expand stars, bind items
        items: list[tuple[ir.Expr, str]] = []
        for e, alias in stmt.items:
            if isinstance(e, ast.Star):
                for name, cid in scope.entries.items():
                    if cid is AMBIGUOUS or "." in name:
                        continue
                    if e.table is not None and \
                            scope.entries.get(f"{e.table}.{name}") != cid:
                        continue
                    items.append((ir.col(cid), name))
                continue
            bound = self.bind_expr(e, scope, allow_agg=True, qb_plan=[plan])
            plan = self._maybe_updated_plan(plan)
            items.append((bound, alias or self._auto_name(e)))

        # aggregate detection
        agg_calls: list[ir.AggCall] = []

        def collect_aggs(x):
            for node in ir.walk(x):
                if isinstance(node, ir.AggCall):
                    agg_calls.append(node)

        for bound, _ in items:
            collect_aggs(bound)
        having_bound = None
        if stmt.having is not None:
            having_ast = self._fold_scalar_subqueries(stmt.having)
            having_bound = self.bind_expr(having_ast, scope, allow_agg=True,
                                          qb_plan=[plan])
            plan = self._maybe_updated_plan(plan)
            collect_aggs(having_bound)
        is_agg = bool(stmt.group_by or agg_calls)
        replace_fn = None
        if is_agg:
            plan, items, having_bound, est, replace_fn = self._bind_aggregate(
                stmt, qb, scope, plan, items, having_bound, agg_calls, est,
            )
            if having_bound is not None:
                plan = pp.Filter(plan, having_bound)
                est = max(1, est // 3)

        # window functions: strip WindowCalls out of the items into a
        # Window operator (runs after WHERE/GROUP BY/HAVING, before
        # ORDER BY — SQL evaluation order)
        win_specs: list = []

        def strip_windows(e):
            if isinstance(e, ir.WindowCall):
                wcid = fresh("w")
                win_specs.append((wcid, e))
                return ir.col(wcid)
            return _map_children(e, strip_windows)

        items = [(strip_windows(b), name) for b, name in items]
        if win_specs:
            plan = pp.Window(plan, win_specs)
        # project outputs to stable names
        outputs = []
        proj = {}
        for bound, name in items:
            cid = fresh("o")
            proj[cid] = bound
            outputs.append((cid, name))

        # ORDER BY binds here: output alias/ordinal first, then arbitrary
        # expressions (over the agg output when aggregated) as hidden
        # projection columns
        sort_keys, sort_asc = [], []
        for item in stmt.order_by:
            cid = self._output_ref(item.expr, outputs)
            if cid is None:
                b = self.bind_expr(item.expr, scope, allow_agg=is_agg)
                if replace_fn is not None:
                    b = replace_fn(b)
                cid = fresh("h")
                proj[cid] = b  # hidden: projected but not in outputs
            sort_keys.append(ir.col(cid))
            sort_asc.append(item.ascending)

        plan = pp.Project(plan, proj)

        if stmt.distinct:
            if any(k.name not in {c for c, _ in outputs} for k in sort_keys):
                raise BindError(
                    "ORDER BY with DISTINCT must use select-list columns")
            plan = pp.GroupBy(plan, {cid: ir.col(cid) for cid, _ in outputs},
                              [], out_capacity=None)
            est = max(1, est // 2)
        if sort_keys:
            plan = pp.Sort(plan, sort_keys, sort_asc)
        if stmt.limit is not None:
            plan = pp.Limit(plan, stmt.limit, stmt.offset)
            est = min(est, stmt.limit)
        return plan, outputs, est

    def _fold_scalar_subqueries(self, e: ir.Expr) -> ir.Expr:
        """Replace uncorrelated scalar subqueries with their value, computed
        eagerly at bind time (plans are re-bound per execution, so this is a
        constant for the statement — ≙ the reference's pre-calculated
        "init plan" subqueries, onetime exprs in ObLogPlan).

        Used where the subquery sits above an aggregation (HAVING), where
        the cross-join rewrite would have to thread through the agg."""
        if isinstance(e, ast.Subquery) and e.kind == "scalar":
            self.folded_volatile = True  # value depends on current data
            plan, outs, _ = self.bind_select(e.select)
            from oceanbase_tpu_torch.exec.plan import (
                execute_plan, prepare_index_probes, referenced_tables)

            # the port's executor, on the catalog's device tables
            tables = {t: self.catalog.table_data(t)
                      for t in referenced_tables(plan)}
            prepare_index_probes(self.catalog, plan, tables)
            rel = execute_plan(plan, tables)
            from oceanbase_tpu_torch.vector import to_numpy

            raw = to_numpy(rel, limit=1)
            cid = outs[0][0]
            col = rel.columns[cid]
            if len(raw[cid]) == 0 or (raw.get("__valid__" + cid) is not None
                                      and not raw["__valid__" + cid][0]):
                return ir.Literal(None)
            v = raw[cid][0]
            if col.dtype.kind == TypeKind.DECIMAL:
                return ir.Literal(int(v), col.dtype)
            if col.dtype.kind == TypeKind.STRING:
                return ir.Literal(str(v))
            if col.dtype.kind in (TypeKind.FLOAT, TypeKind.DOUBLE):
                return ir.Literal(float(v))
            return ir.Literal(int(v), col.dtype)
        return _map_children(e, self._fold_scalar_subqueries)

    def _maybe_updated_plan(self, plan):
        # scalar-subquery binding can wrap the plan (cross join); the
        # updated plan is left in self._plan_override by bind_expr
        ov = getattr(self, "_plan_override", None)
        self._plan_override = None
        return ov if ov is not None else plan

    @staticmethod
    def _auto_name(e: ir.Expr) -> str:
        if isinstance(e, ir.ColumnRef):
            return e.name.split(".")[-1]
        return fresh("expr")

    # ------------------------------------------------------------------
    def _bind_table_expr(self, tref, qb: QueryBlock, scope: Scope):
        if isinstance(tref, ast.TableRef):
            self._bind_base_table(tref, qb, scope)
        elif isinstance(tref, ast.SubqueryRef):
            sub_plan, sub_outs, sub_est = self.bind_select(tref.select,
                                                           outer=None)
            cols = {}
            for cid, name in sub_outs:
                scope.add(name, cid, alias=tref.alias)
                cols[name] = cid
            qb.fragments.append(Fragment(sub_plan, cols, max(sub_est, 1)))
        elif isinstance(tref, ast.JoinRef):
            self._bind_join(tref, qb, scope)
        else:  # pragma: no cover
            raise BindError(f"unsupported FROM item {tref}")

    def _bind_base_table(self, tref: ast.TableRef, qb, scope):
        name = tref.name
        if name in self.ctes:
            sub = self.ctes[name]
            if name in self._cte_stack:
                raise BindError(
                    f"CTE {name!r} references itself; WITH RECURSIVE "
                    "is not supported")
            self._cte_stack.add(name)
            try:
                sub_plan, sub_outs, sub_est = self.bind_select(
                    sub, outer=None)
            finally:
                self._cte_stack.discard(name)
            aliases = getattr(sub, "cte_cols", None)
            if aliases:
                if len(aliases) != len(sub_outs):
                    raise BindError(
                        f"CTE {name} declares {len(aliases)} columns but "
                        f"its body produces {len(sub_outs)}")
                sub_outs = [(cid, a) for (cid, _), a in
                            zip(sub_outs, aliases)]
            cols = {}
            for cid, oname in sub_outs:
                scope.add(oname, cid, alias=tref.alias or name)
                cols[oname] = cid
            qb.fragments.append(Fragment(sub_plan, cols, max(sub_est, 1)))
            return
        vdef = self.catalog.view_def(name)
        if vdef is not None:
            self._bind_view(name, vdef, tref, qb, scope)
            return
        tdef = self.catalog.table_def(name)
        alias = tref.alias or name
        rename = {}
        cols = {}
        unique = []
        ndv = {}
        hist = {}
        mcv = {}
        for c in tdef.columns:
            cid = fresh(f"{alias}_{c.name}")
            rename[c.name] = cid
            scope.add(c.name, cid, alias=alias)
            cols[c.name] = cid
            if c.name in tdef.ndv:
                ndv[cid] = tdef.ndv[c.name]
            if c.name in getattr(tdef, "histograms", {}):
                edges, nf = tdef.histograms[c.name]
                hist[cid] = (edges, nf, c.dtype)
            if c.name in getattr(tdef, "mcv", {}):
                mcv[cid] = tdef.mcv[c.name]
        if len(tdef.primary_key) == 1:
            unique.append(rename[tdef.primary_key[0]])
            ndv[rename[tdef.primary_key[0]]] = max(tdef.row_count, 1)
        qb.fragments.append(Fragment(
            pp.TableScan(name, rename=rename,
                         est_rows=max(tdef.row_count, 1)),
            cols, max(tdef.row_count, 1), frozenset(unique), ndv=ndv,
            hist=hist, mcv=mcv,
        ))

    def _bind_view(self, name: str, vdef: dict, tref, qb, scope):
        """Expand a view body inline as a derived table (≙ view merge /
        ObCreateViewResolver storing text, the transformer expanding it).
        The body binds in a CLEAN CTE environment — a view must not see
        the referencing query's CTEs — and re-parses per schema version
        (cached on the vdef dict)."""
        if name in self._view_stack:
            raise BindError(f"view {name} recursively references itself")
        # parsed-body cache lives on the catalog (NOT on vdef: that dict
        # round-trips through the JSON manifest), keyed by schema version
        cache = getattr(self.catalog, "_view_ast_cache", None)
        if cache is None:
            cache = self.catalog._view_ast_cache = {}
        cached = cache.get(name)
        if cached is None or cached[0] != self.catalog.schema_version:
            from oceanbase_tpu_torch.sql.parser import Parser

            body = Parser(vdef["sql"]).parse()
            if not isinstance(body, ast.SelectStmt):
                raise BindError(f"view {name} body is not a SELECT")
            cached = (self.catalog.schema_version, body)
            cache[name] = cached
        cached = cached[1]
        self._view_stack.add(name)
        saved_ctes = self.ctes
        self.ctes = {}
        try:
            sub_plan, sub_outs, sub_est = self.bind_select(
                cached, outer=None)
        finally:
            self.ctes = saved_ctes
            self._view_stack.discard(name)
        aliases = vdef.get("cols") or []
        if aliases:
            if len(aliases) != len(sub_outs):
                raise BindError(
                    f"view {name} declares {len(aliases)} columns but its "
                    f"body produces {len(sub_outs)}")
            sub_outs = [(cid, a) for (cid, _), a in zip(sub_outs, aliases)]
        cols = {}
        for cid, oname in sub_outs:
            scope.add(oname, cid, alias=tref.alias or name)
            cols[oname] = cid
        qb.fragments.append(Fragment(sub_plan, cols, max(sub_est, 1)))

    def _bind_join(self, j: ast.JoinRef, qb: QueryBlock, scope: Scope):
        if j.kind in ("inner", "cross"):
            # inner joins melt into the join graph
            n_before = len(qb.fragments)
            self._bind_table_expr(j.left, qb, scope)
            n_mid = len(qb.fragments)
            self._bind_table_expr(j.right, qb, scope)
            if isinstance(j.on, tuple) and j.on and j.on[0] == "using":
                self._bind_using_edges(j.on[1], qb, n_before, n_mid)
            elif j.on is not None:
                self._bind_where(j.on, qb, scope)
            return
        if j.kind == "right":
            j = ast.JoinRef(j.right, j.left, "left", j.on)
        # LEFT/FULL join binds eagerly.  Each side binds into its OWN
        # QueryBlock so inner-join edges inside a side stay locally
        # indexed, then the side collapses to one fragment via the
        # join-tree builder.
        how = "full" if j.kind == "full" else "left"
        lf = self._bind_side(j.left, scope)
        rf = self._bind_side(j.right, scope)
        on = j.on
        if isinstance(on, tuple) and on and on[0] == "using":
            eqs = [(ir.col(self._col_in(lf, c)), ir.col(self._col_in(rf, c)))
                   for c in on[1]]
            lpreds = rpreds = residual = []
        else:
            eqs, lpreds, rpreds, residual = self._split_on(on, lf, rf, scope)
        if how == "full" and (lpreds or rpreds or residual):
            # a one-sided/residual ON pred of a FULL join only nullifies
            # matches — it cannot filter either side; no sound lowering
            # exists in this plan shape yet (≙ non-equi full outer)
            raise BindError(
                "FULL OUTER JOIN supports equi-join ON conditions only")
        for p in rpreds:
            rf = Fragment(pp.Filter(rf.plan, p,
                                    est_rows=max(1, rf.est_rows // 3)),
                          rf.cols,
                          max(1, rf.est_rows // 3), rf.unique_cols,
                          colids=rf.colids, ndv=rf.ndv,
                          hist=rf.hist, mcv=rf.mcv)
        lkeys = [e[0] for e in eqs]
        rkeys = [e[1] for e in eqs]
        cap = _pow2(int((lf.est_rows + (rf.est_rows
                                        if how == "full" else 0))
                        * 1.5) + 16)
        plan = pp.HashJoin(lf.plan, rf.plan, lkeys, rkeys, how=how,
                           out_capacity=cap,
                           est_rows=max(1, lf.est_rows + (
                               rf.est_rows if how == "full" else 0)))
        for p in lpreds + residual:
            # ON predicates on the left side of a LEFT JOIN semantically
            # only nullify matches; approximate by post-filtering matched
            # rows is wrong, so keep as residual on the join output for
            # matched rows only — round-1: treat as join residual filter
            plan = pp.Filter(plan, p)
        merged_cols = {**lf.cols, **rf.cols}
        # FULL emits unmatched build rows too, and NULL-extends the left
        # PKs on them (no longer unique downstream)
        out_est = lf.est_rows + (rf.est_rows if how == "full" else 0)
        qb.fragments.append(Fragment(
            plan, merged_cols, out_est,
            frozenset() if how == "full" else lf.unique_cols,
            colids=lf.colids | rf.colids,
            ndv={**lf.ndv, **rf.ndv},
            hist={**lf.hist, **rf.hist},
            mcv={**lf.mcv, **rf.mcv}))

    def _bind_side(self, tref, scope: Scope) -> Fragment:
        """Bind one side of an eager (outer) join into a single fragment."""
        sub_qb = QueryBlock()
        self._bind_table_expr(tref, sub_qb, scope)
        if len(sub_qb.fragments) == 1 and not sub_qb.post_preds and \
                not sub_qb.semi_edges:
            return sub_qb.fragments[0]
        from oceanbase_tpu_torch.sql.optimizer import build_join_tree

        plan, est, _ = build_join_tree(sub_qb, self.catalog,
                                       cost=self.cost_model)
        for pred in sub_qb.post_preds:
            plan = pp.Filter(plan, pred)
            est = max(1, est // 3)
        cols = {}
        colids = frozenset()
        unique = frozenset()
        ndv = {}
        hist = {}
        mcv = {}
        for f in sub_qb.fragments:
            cols.update(f.cols)
            colids |= f.colids
            unique |= f.unique_cols
            ndv.update(f.ndv)
            hist.update(f.hist)
            mcv.update(f.mcv)
        return Fragment(plan, cols, est, unique, colids=colids, ndv=ndv,
                        hist=hist, mcv=mcv)

    @staticmethod
    def _col_in(frag: Fragment, name: str) -> str:
        cid = frag.cols.get(name)
        if cid is None:
            raise BindError(f"USING column {name!r} missing on one side")
        return cid

    def _bind_using_edges(self, cols, qb: QueryBlock, n_before: int,
                          n_mid: int):
        """USING (c1, ...): equality edges between the two just-bound
        sides, resolved per side (the flat scope would see the shared
        names as ambiguous)."""
        left_frags = qb.fragments[n_before:n_mid]
        right_frags = qb.fragments[n_mid:]
        for c in cols:
            li = next((i for i, f in enumerate(left_frags, n_before)
                       if c in f.cols), None)
            ri = next((i for i, f in enumerate(right_frags, n_mid)
                       if c in f.cols), None)
            if li is None or ri is None:
                raise BindError(f"USING column {c!r} missing on one side")
            qb.join_edges.append((
                li, ri,
                ir.col(qb.fragments[li].cols[c]),
                ir.col(qb.fragments[ri].cols[c])))

    def _split_on(self, on, lf: Fragment, rf: Fragment, scope: Scope):
        """Split a bound ON condition into equi keys / side preds / residual."""
        eqs, lpreds, rpreds, residual = [], [], [], []
        if on is None:
            return eqs, lpreds, rpreds, residual
        lcols = set(lf.colids)
        rcols = set(rf.colids)
        for conj in _conjuncts(on):
            b = self.bind_expr(conj, scope)
            used = {n.name for n in ir.walk(b) if isinstance(n, ir.ColumnRef)}
            if isinstance(b, ir.Cmp) and b.op == "=":
                lu = {n.name for n in ir.walk(b.left)
                      if isinstance(n, ir.ColumnRef)}
                ru = {n.name for n in ir.walk(b.right)
                      if isinstance(n, ir.ColumnRef)}
                if lu <= lcols and ru <= rcols:
                    eqs.append((b.left, b.right))
                    continue
                if lu <= rcols and ru <= lcols:
                    eqs.append((b.right, b.left))
                    continue
            if used <= lcols:
                lpreds.append(b)
            elif used <= rcols:
                rpreds.append(b)
            else:
                residual.append(b)
        return eqs, lpreds, rpreds, residual

    # ------------------------------------------------------------------
    def _bind_where(self, where: ir.Expr, qb: QueryBlock, scope: Scope):
        for conj in _conjuncts(factor_or_common(where)):
            self._bind_conjunct(conj, qb, scope)

    def _bind_conjunct(self, conj, qb: QueryBlock, scope: Scope):
        # subquery predicates get rewritten structurally
        sub = _find_subquery(conj)
        if sub is not None:
            self._rewrite_subquery_pred(conj, sub, qb, scope)
            return
        bound = self.bind_expr(conj, scope)
        used = {n.name for n in ir.walk(bound) if isinstance(n, ir.ColumnRef)}
        homes = [i for i, f in enumerate(qb.fragments)
                 if used & f.colids]
        if isinstance(bound, ir.Cmp) and bound.op == "=" and len(homes) == 2:
            lu = {n.name for n in ir.walk(bound.left)
                  if isinstance(n, ir.ColumnRef)}
            ru = {n.name for n in ir.walk(bound.right)
                  if isinstance(n, ir.ColumnRef)}
            fi, fj = homes
            ci = set(qb.fragments[fi].colids)
            if lu <= ci and ru.isdisjoint(ci):
                qb.join_edges.append((fi, fj, bound.left, bound.right))
                return
            if ru <= ci and lu.isdisjoint(ci):
                qb.join_edges.append((fj, fi, bound.left, bound.right))
                return
        if len(homes) <= 1:
            if homes:
                i = homes[0]
                f = qb.fragments[i]
                new_est = max(1, int(f.est_rows * _selectivity(
                    bound, f.hist, f.mcv, f.ndv)))
                qb.fragments[i] = Fragment(
                    pp.Filter(f.plan, bound, est_rows=new_est), f.cols,
                    new_est,
                    f.unique_cols, colids=f.colids, ndv=f.ndv,
                    hist=f.hist, mcv=f.mcv,
                )
            else:
                qb.post_preds.append(bound)  # constant predicate
            return
        qb.post_preds.append(bound)

    # ------------------------------------------------------------------
    # subquery rewrites
    # ------------------------------------------------------------------
    def _rewrite_subquery_pred(self, conj, sub: ast.Subquery, qb, scope):
        if sub.kind == "exists" or (sub.kind in ("in", "quant")):
            if conj is sub:
                return self._rewrite_semi(sub, qb, scope,
                                          anti=sub.negated)
            if isinstance(conj, ir.Not) and conj.arg is sub:
                return self._rewrite_semi(sub, qb, scope,
                                          anti=not sub.negated)
        # comparison against scalar subquery
        if isinstance(conj, ir.Cmp):
            # sub_on_left: (subq) op other -> val op other
            #  otherwise:  other op (subq) -> other op val
            for side, other, sub_on_left in ((conj.left, conj.right, True),
                                             (conj.right, conj.left, False)):
                if isinstance(side, ast.Subquery) and side.kind == "scalar":
                    return self._rewrite_scalar_cmp(conj, side, other,
                                                    sub_on_left, qb, scope)
        raise BindError(f"unsupported subquery predicate {type(conj).__name__}")

    def _rewrite_semi(self, sub: ast.Subquery, qb, scope, anti: bool):
        """EXISTS / IN / quantified -> a deferred SemiEdge on the home
        fragment; the optimizer attaches it (fragment vs above the join
        tree) by cost at build_join_tree time."""
        inner = sub.select
        corr = _CorrelationCollector(self, scope)
        in_plan, eq_outer, eq_inner_cids, residual, in_outs, in_est = \
            corr.bind_inner(inner, outer_qb=qb)

        lhs_exprs = []
        rhs_cids = []
        if sub.kind in ("in", "quant"):
            lhs = self.bind_expr(sub.lhs, scope)
            lhs_exprs.append(lhs)
            rhs_cids.append(in_outs[0][0])
        lhs_exprs += eq_outer
        rhs_cids += eq_inner_cids

        if not lhs_exprs and not residual:
            raise BindError("EXISTS without correlation unsupported (round 1)")

        used = set()
        for e in lhs_exprs:
            used |= {n.name for n in ir.walk(e) if isinstance(n, ir.ColumnRef)}
        for e in residual:
            used |= {n.name for n in ir.walk(e) if isinstance(n, ir.ColumnRef)}
        homes = [i for i, f in enumerate(qb.fragments)
                 if used & f.colids]
        if len(homes) != 1:
            raise BindError("correlated subquery spans multiple tables "
                            "(unsupported in round 1)")
        rkeys = [ir.col(c) for c in rhs_cids]
        qb.semi_edges.append(SemiEdge(
            home=homes[0], plan=in_plan, lhs=lhs_exprs, rkeys=rkeys,
            residual=list(residual), anti=anti,
            build_est=max(int(in_est), 1)))

    def _rewrite_scalar_cmp(self, conj, sub, other_side, sub_on_left, qb,
                            scope):
        inner = sub.select
        corr = _CorrelationCollector(self, scope)
        in_plan, eq_outer, eq_inner_cids, residual, in_outs, in_est = \
            corr.bind_inner(inner, outer_qb=qb)
        if residual:
            raise BindError("non-equality correlation in scalar subquery")
        val_cid = in_outs[0][0]
        if not eq_outer:
            # uncorrelated: single-row fragment cross-joined into the block
            frag = Fragment(in_plan, {}, 1)
            qb.fragments.append(frag)
        else:
            frag = Fragment(in_plan, {}, max(in_est, 1))
            qb.fragments.append(frag)
            j = len(qb.fragments) - 1
            for oexpr, icid in zip(eq_outer, eq_inner_cids):
                used = {n.name for n in ir.walk(oexpr)
                        if isinstance(n, ir.ColumnRef)}
                homes = [i for i, f in enumerate(qb.fragments[:-1])
                         if used & f.colids]
                if len(homes) != 1:
                    raise BindError("correlation spans fragments")
                qb.join_edges.append((homes[0], j, oexpr, ir.col(icid)))
        other_bound = self.bind_expr(other_side, scope)
        lhs, rhs = (ir.col(val_cid), other_bound) if sub_on_left else \
            (other_bound, ir.col(val_cid))
        qb.post_preds.append(ir.Cmp(conj.op, lhs, rhs))

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def _bind_aggregate(self, stmt, qb, scope, plan, items, having_bound,
                        agg_calls, est):
        # group keys
        key_map: dict[str, ir.Expr] = {}
        key_repr: dict[str, str] = {}
        alias_map = {name: bound for bound, name in items}
        for g in stmt.group_by:
            try:
                b = self.bind_expr(g, scope)
            except BindError:
                if isinstance(g, ir.ColumnRef) and g.name in alias_map:
                    b = alias_map[g.name]
                else:
                    raise
            cid = fresh("g")
            key_map[cid] = b
            key_repr[_erepr(b)] = cid

        # aggregate specs (dedup by structure)
        agg_specs: list[AggSpec] = []
        agg_ids: dict[str, str] = {}

        def agg_cid(a: ir.AggCall) -> str:
            k = f"{a.fn}|{_erepr(a.arg) if a.arg is not None else ''}"
            if k not in agg_ids:
                cid = fresh("a")
                agg_ids[k] = cid
                agg_specs.append(AggSpec(cid, a.fn, a.arg))
            return agg_ids[k]

        def replace(e: ir.Expr) -> ir.Expr:
            if isinstance(e, ir.AggCall):
                return ir.col(agg_cid(e))
            r = key_repr.get(_erepr(e))
            if r is not None:
                return ir.col(r)
            return _map_children(e, replace)

        new_items = [(replace(b), name) for b, name in items]
        if having_bound is not None:
            having_bound = replace(having_bound)

        # NDV-driven key-cardinality estimate (≙ ObOptEstCost group-by
        # cardinality from basic stats): a plain column key with known
        # NDV contributes its NDV; derived keys fall back to 32
        ndv_by_cid = {}
        for f in qb.fragments:
            ndv_by_cid.update(f.ndv)
        n_keys_est = 1
        for b in key_map.values():
            if isinstance(b, ir.ColumnRef) and b.name in ndv_by_cid:
                n_keys_est *= max(1, ndv_by_cid[b.name])
            else:
                n_keys_est *= 32
            n_keys_est = min(n_keys_est, 1 << 40)  # overflow guard
        out_cap = _pow2(min(est, max(64, min(n_keys_est, est))))
        if key_map:
            plan = pp.GroupBy(plan, key_map, agg_specs, out_capacity=out_cap,
                              est_rows=max(1, min(n_keys_est, est)))
            est = min(est, out_cap)
        else:
            plan = pp.ScalarAgg(plan, agg_specs, est_rows=1)
            est = 1
        return plan, new_items, having_bound, est, replace

    # ------------------------------------------------------------------
    # expression binding
    # ------------------------------------------------------------------
    def bind_expr(self, e: ir.Expr, scope: Scope, allow_agg=False,
                  qb_plan=None) -> ir.Expr:
        if isinstance(e, ir.ColumnRef):
            cid, depth = scope.lookup(e.name)
            if cid is None:
                raise BindError(f"unknown column {e.name!r}")
            return ir.col(cid)
        if isinstance(e, ast.Param):
            if e.index >= len(self.params):
                raise BindError(f"missing parameter {e.index}")
            return ir.Literal(self.params[e.index])
        if isinstance(e, ast.SysVar):
            v = (self.sysvars or {}).get(e.name, _SYSVAR_DEFAULTS.get(e.name))
            if v is None:
                raise BindError(f"unknown system variable @@{e.name}")
            self.folded_volatile = True  # value is session state
            return ir.Literal(v)
        if isinstance(e, ast.Subquery):
            raise BindError("subquery only supported in WHERE/HAVING "
                            "comparisons (round 1)")
        if isinstance(e, Interval):
            raise BindError("INTERVAL outside date arithmetic")
        if isinstance(e, ir.FuncCall) and e.name == "nextval":
            # volatile: folded once per statement (per-row allocation only
            # on the INSERT VALUES path)
            if self.sequences is None:
                raise BindError("nextval() requires a database session")
            if len(e.args) != 1 or not isinstance(e.args[0], ir.Literal) or \
                    not isinstance(e.args[0].value, str):
                raise BindError("nextval() takes one sequence name literal")
            self.folded_volatile = True
            return ir.Literal(self.sequences.nextval(e.args[0].value))
        if isinstance(e, ir.FuncCall) and e.name in ("date_add", "date_sub"):
            base = self.bind_expr(e.args[0], scope, allow_agg)
            n = e.args[1].value
            unit = e.args[2].value
            return _fold_date_arith(e.name, base, n, unit)
        if isinstance(e, ir.AggCall):
            if not allow_agg:
                raise BindError("aggregate not allowed here")
            arg = self.bind_expr(e.arg, scope) if e.arg is not None else None
            return ir.AggCall(e.fn, arg, e.distinct)
        if isinstance(e, ir.WindowCall):
            return ir.WindowCall(
                e.fn,
                self.bind_expr(e.arg, scope, allow_agg)
                if e.arg is not None else None,
                [self.bind_expr(p, scope, allow_agg)
                 for p in (e.partition_by or [])],
                [(self.bind_expr(o, scope, allow_agg), asc)
                 for o, asc in (e.order_by or [])],
                frame=e.frame,
                extra=[self.bind_expr(x, scope, allow_agg)
                       for x in (e.extra or [])] or None)
        return _map_children(
            e, lambda c: self.bind_expr(c, scope, allow_agg, qb_plan)
        )

    # ------------------------------------------------------------------
    def _apply_setop(self, op, all_, plan, outputs, est, rplan, routs, rest):
        # align rhs output names to lhs colids positionally
        proj = {}
        for (lcid, _), (rcid, _) in zip(outputs, routs):
            proj[lcid] = ir.col(rcid)
        rplan = pp.Project(rplan, proj)
        if op == "union":
            plan = pp.Union([plan, rplan])
            est = est + rest
            if not all_:
                plan = pp.GroupBy(plan,
                                  {cid: ir.col(cid) for cid, _ in outputs},
                                  [], out_capacity=None)
        elif op == "intersect":
            plan = pp.GroupBy(plan, {cid: ir.col(cid) for cid, _ in outputs},
                              [], out_capacity=None)
            plan = pp.HashJoin(plan, rplan,
                               [ir.col(c) for c, _ in outputs],
                               [ir.col(c) for c, _ in outputs], how="semi")
        elif op == "except":
            plan = pp.GroupBy(plan, {cid: ir.col(cid) for cid, _ in outputs},
                              [], out_capacity=None)
            plan = pp.HashJoin(plan, rplan,
                               [ir.col(c) for c, _ in outputs],
                               [ir.col(c) for c, _ in outputs], how="anti")
        return plan, outputs, est


class _CorrelationCollector:
    """Bind an inner (sub)query, splitting out correlated equality
    predicates; for aggregate subqueries, decorrelate by grouping on the
    inner correlation columns (magic-set rewrite)."""

    def __init__(self, binder: Binder, outer_scope: Scope):
        self.binder = binder
        self.outer = outer_scope

    def bind_inner(self, inner: ast.SelectStmt, outer_qb=None):
        b = self.binder
        qb = QueryBlock()
        scope = Scope(parent=self.outer)
        for name, sub in inner.ctes:
            b.ctes[name] = sub
        for tref in inner.from_:
            b._bind_table_expr(tref, qb, scope)
        inner_cols = set()
        for f in qb.fragments:
            inner_cols |= f.colids

        eq_outer: list[ir.Expr] = []
        eq_inner: list[ir.Expr] = []
        residual: list[ir.Expr] = []
        if inner.where is not None:
            for conj in _conjuncts(inner.where):
                sub = _find_subquery(conj)
                if sub is not None:
                    b._rewrite_subquery_pred(conj, sub, qb, scope)
                    continue
                bound = b.bind_expr(conj, scope)
                used = {n.name for n in ir.walk(bound)
                        if isinstance(n, ir.ColumnRef)}
                outer_used = used - inner_cols
                if not outer_used:
                    b._bind_conjunct_bound(bound, qb)
                    continue
                if isinstance(bound, ir.Cmp) and bound.op == "=":
                    lu = {n.name for n in ir.walk(bound.left)
                          if isinstance(n, ir.ColumnRef)}
                    ru = {n.name for n in ir.walk(bound.right)
                          if isinstance(n, ir.ColumnRef)}
                    if lu and lu <= inner_cols and ru.isdisjoint(inner_cols):
                        eq_inner.append(bound.left)
                        eq_outer.append(bound.right)
                        continue
                    if ru and ru <= inner_cols and lu.isdisjoint(inner_cols):
                        eq_inner.append(bound.right)
                        eq_outer.append(bound.left)
                        continue
                residual.append(bound)

        from oceanbase_tpu_torch.sql.optimizer import build_join_tree

        plan, est, _ = build_join_tree(qb, b.catalog,
                                       cost=b.cost_model)
        if getattr(qb, "cbo_choice", None):
            b.cbo_choices.append(qb.cbo_choice)
        # predicates nested rewrites parked on the block (a correlated
        # scalar comparison becomes a post-join filter) MUST apply here —
        # dropping them silently widens the subquery (TPC-H Q20's
        # availqty > 0.5*sum filter lives exactly here)
        for pred in qb.post_preds:
            plan = pp.Filter(plan, pred)
            est = max(1, est // 3)

        # bind select items (inner scope)
        items = []
        agg_found = False
        for e, alias in inner.items:
            if isinstance(e, ast.Star):
                items.append((ir.lit(1), alias or "one"))
                continue
            bound = b.bind_expr(e, scope, allow_agg=True)
            if any(isinstance(nn, ir.AggCall) for nn in ir.walk(bound)):
                agg_found = True
            items.append((bound, alias or b._auto_name(e)))

        eq_inner_cids = []
        if agg_found or inner.group_by:
            # decorrelated aggregate: group by correlation cols + explicit
            key_map = {}
            for ie in eq_inner:
                cid = fresh("ck")
                key_map[cid] = ie
                eq_inner_cids.append(cid)
            for g in inner.group_by:
                cid = fresh("g")
                key_map[cid] = b.bind_expr(g, scope)
                # IN-subqueries select their group key; map via repr below
            agg_specs = []
            agg_ids = {}

            def agg_cid(a: ir.AggCall) -> str:
                k = f"{a.fn}|{_erepr(a.arg) if a.arg is not None else ''}"
                if k not in agg_ids:
                    cid = fresh("a")
                    agg_ids[k] = cid
                    agg_specs.append(AggSpec(cid, a.fn, a.arg))
                return agg_ids[k]

            key_repr = {_erepr(kexpr): kcid for kcid, kexpr in key_map.items()}

            def replace(x):
                if isinstance(x, ir.AggCall):
                    return ir.col(agg_cid(x))
                r = key_repr.get(_erepr(x))
                if r is not None:
                    return ir.col(r)
                return _map_children(x, replace)

            new_items = [(replace(bound), name) for bound, name in items]
            plan, est = self._seed_magic_set(
                plan, est, eq_outer, eq_inner, qb, outer_qb, b)
            if key_map:
                cap = _pow2(max(64, min(est, 1 << 22)))
                plan = pp.GroupBy(plan, key_map, agg_specs, out_capacity=cap,
                                  est_rows=max(1, min(est, cap)))
                est = min(est, cap)
            else:
                plan = pp.ScalarAgg(plan, agg_specs, est_rows=1)
                est = 1
            if inner.having is not None:
                hb = replace(b.bind_expr(inner.having, scope, allow_agg=True))
                plan = pp.Filter(plan, hb)
            # project the select outputs
            outs = []
            proj = {c: ir.col(c) for c in eq_inner_cids}
            for bound, name in new_items:
                cid = fresh("so")
                proj[cid] = bound
                outs.append((cid, name))
            plan = pp.Project(plan, proj)
            return plan, eq_outer, eq_inner_cids, residual, outs, est

        # non-aggregate subquery (EXISTS / IN): project value + join cols
        outs = []
        proj = {}
        _ = outer_qb  # magic-set seeding applies to the aggregate path
        for bound, name in items:
            cid = fresh("so")
            proj[cid] = bound
            outs.append((cid, name))
        for ie in eq_inner:
            cid = fresh("ck")
            proj[cid] = ie
            eq_inner_cids.append(cid)
        # residual predicates reference inner cols directly: keep them
        # visible through the projection
        for r in residual:
            for nn in ir.walk(r):
                if isinstance(nn, ir.ColumnRef) and nn.name in inner_cols:
                    proj.setdefault(nn.name, ir.col(nn.name))
        plan = pp.Project(plan, proj)
        return plan, eq_outer, eq_inner_cids, residual, outs, est

    @staticmethod
    def _seed_magic_set(plan, est, eq_outer, eq_inner, qb, outer_qb, b):
        """Seed a decorrelated aggregate with the outer key domain.

        q17/q20-style correlated aggregates re-scan the whole inner
        table and group it over EVERY key, even though the outer block
        only probes a handful of them.  When the outer home fragment is
        selective, semi-join the inner rows against it BEFORE grouping
        (exact single-key semi joins are mask-only, so this costs two
        searchsorteds), then compact so the GroupBy hashes thousands of
        rows instead of millions.  The outer fragment snapshot here may
        miss later-bound filters, which only widens the kept key set —
        a superset seed is always sound for both semi and anti
        consumers.
        """
        if (outer_qb is None or len(eq_inner) != 1 or len(eq_outer) != 1
                or not getattr(outer_qb, "fragments", None)):
            return plan, est
        oused = {n.name for n in ir.walk(eq_outer[0])
                 if isinstance(n, ir.ColumnRef)}
        if not oused:
            return plan, est
        homes = [f for f in outer_qb.fragments if oused <= f.colids]
        if len(homes) != 1:
            return plan, est
        fo = homes[0]
        if fo.est_rows * 4 > est:
            return plan, est  # outer side not selective: seeding buys nothing
        key_ndv = 0
        ik = eq_inner[0]
        if isinstance(ik, ir.ColumnRef):
            for f in qb.fragments:
                if ik.name in f.ndv:
                    key_ndv = int(f.ndv[ik.name])
                    break
        if key_ndv > 0:
            matched = max(1, int(est) * max(int(fo.est_rows), 1)
                          // max(key_ndv, 1))
        else:
            matched = max(int(fo.est_rows) * 4, 1024)
        matched = min(matched, int(est))
        # exact int-key semi joins take the mask-only fast path; the
        # capacity only backs the inexact-key verification expansion and
        # the retry ladder can still scale it on overflow
        plan = pp.HashJoin(plan, fo.plan, [ik], [eq_outer[0]],
                           how="semi",
                           out_capacity=_pow2(int(est) * 2 + 16),
                           est_rows=matched)
        # strict: silent truncation here would DROP inner rows and yield
        # wrong aggregates — overflow must surface and trigger a retry
        plan = pp.Compact(plan, capacity=_pow2(matched * 4 + 1024),
                          strict=True, est_rows=matched)
        return plan, matched


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _conjuncts(e: ir.Expr):
    if isinstance(e, ir.Logic) and e.op == "and":
        for a in e.args:
            yield from _conjuncts(a)
    else:
        yield e


def _expr_key(e):
    """Structural identity key for unbound predicate trees (ir nodes use
    identity equality).  Unknown node kinds key on object identity so
    factoring never produces a false positive."""
    if isinstance(e, ir.ColumnRef):
        return ("col", e.name)
    if isinstance(e, ir.Literal):
        return ("lit", repr(e.value), repr(e.dtype))
    if isinstance(e, (ir.Cmp, ir.Arith)):
        return (type(e).__name__, e.op, _expr_key(e.left),
                _expr_key(e.right))
    if isinstance(e, ir.Logic):
        return ("logic", e.op, tuple(_expr_key(a) for a in e.args))
    if isinstance(e, ir.Not):
        return ("not", _expr_key(e.arg))
    if isinstance(e, ir.InList):
        return ("in", e.negated, _expr_key(e.arg),
                tuple(_expr_key(v) for v in e.values))
    return ("id", id(e))


def _and_of(conjs: list):
    return conjs[0] if len(conjs) == 1 else ir.Logic("and", conjs)


def factor_or_common(e):
    """(A and X) or (A and Y)  ->  A and (X or Y).

    Hoists conjuncts common to EVERY branch of a disjunction, so
    equi-join keys buried inside OR branches (TPC-H Q19's
    p_partkey = l_partkey) still become join edges instead of forcing a
    cross join.  ≙ common-predicate extraction in the rewriter
    (src/sql/rewrite/ob_transform_predicate_move_around.h).
    """
    if isinstance(e, ir.Not):
        return ir.Not(factor_or_common(e.arg))
    if not isinstance(e, ir.Logic):
        return e
    args = [factor_or_common(a) for a in e.args]
    if e.op != "or" or len(args) < 2:
        return ir.Logic(e.op, args)
    branches = [list(_conjuncts(a)) for a in args]
    keysets = [{_expr_key(c) for c in bs} for bs in branches]
    common_keys = set.intersection(*keysets)
    if not common_keys:
        return ir.Logic("or", args)
    common, seen = [], set()
    for c in branches[0]:
        k = _expr_key(c)
        if k in common_keys and k not in seen:
            seen.add(k)
            common.append(c)
    rests = []
    for bs in branches:
        rest = [c for c in bs if _expr_key(c) not in common_keys]
        if not rest:
            # a branch reduced to exactly the common part:
            # (A) or (A and X) == A
            return _and_of(common)
        rests.append(_and_of(rest))
    return _and_of(common + [ir.Logic("or", rests)])


def _find_subquery(e: ir.Expr):
    if isinstance(e, ast.Subquery):
        return e
    for c in e.children():
        s = _find_subquery(c)
        if s is not None:
            return s
    if isinstance(e, ir.Not):
        return _find_subquery(e.arg)
    if isinstance(e, ir.Cmp):
        for side in (e.left, e.right):
            if isinstance(side, ast.Subquery):
                return side
    return None


def _map_children(e: ir.Expr, fn):
    """Rebuild an expression node with fn applied to child expressions."""
    if isinstance(e, ir.Literal) or isinstance(e, ir.ColumnRef):
        return e
    if isinstance(e, ir.Arith):
        return ir.Arith(e.op, fn(e.left), fn(e.right))
    if isinstance(e, ir.Cmp):
        return ir.Cmp(e.op, fn(e.left), fn(e.right))
    if isinstance(e, ir.Logic):
        return ir.Logic(e.op, [fn(a) for a in e.args])
    if isinstance(e, ir.Not):
        return ir.Not(fn(e.arg))
    if isinstance(e, ir.InList):
        return ir.InList(fn(e.arg), e.values, e.negated)
    if isinstance(e, ir.Like):
        return ir.Like(fn(e.arg), e.pattern, e.negated)
    if isinstance(e, ir.IsNull):
        return ir.IsNull(fn(e.arg), e.negated)
    if isinstance(e, ir.Case):
        return ir.Case([(fn(c), fn(v)) for c, v in e.whens],
                       fn(e.else_) if e.else_ is not None else None)
    if isinstance(e, ir.Cast):
        return ir.Cast(fn(e.arg), e.dtype)
    if isinstance(e, ir.FuncCall):
        return ir.FuncCall(e.name, [fn(a) for a in e.args])
    if isinstance(e, ir.AggCall):
        return ir.AggCall(e.fn, fn(e.arg) if e.arg is not None else None,
                          e.distinct)
    if isinstance(e, ir.WindowCall):
        return ir.WindowCall(
            e.fn, fn(e.arg) if e.arg is not None else None,
            [fn(p) for p in (e.partition_by or [])],
            [(fn(o), asc) for o, asc in (e.order_by or [])],
            frame=e.frame,
            extra=[fn(x) for x in (e.extra or [])] or None)
    return e


def _erepr(e) -> str:
    if e is None:
        return ""
    if isinstance(e, ir.ColumnRef):
        return f"C({e.name})"
    if isinstance(e, ir.Literal):
        return f"L({e.value!r},{e.dtype})"
    parts = [type(e).__name__]
    for f_ in vars(e).values():
        if isinstance(f_, ir.Expr):
            parts.append(_erepr(f_))
        elif isinstance(f_, list):
            for x in f_:
                if isinstance(x, ir.Expr):
                    parts.append(_erepr(x))
                elif isinstance(x, tuple):
                    parts.append(",".join(_erepr(y) for y in x
                                          if isinstance(y, ir.Expr)))
                else:
                    parts.append(repr(x))
        else:
            parts.append(repr(f_))
    return "(" + "|".join(parts) + ")"


def _hist_selectivity(pred: ir.Cmp, hist: dict):
    """Range selectivity from an equi-height histogram, or None when
    the predicate/column has no histogram (≙ ObOptSelectivity range
    selectivity over ObOptColumnStat buckets)."""
    import numpy as np

    l, r, op = pred.left, pred.right, pred.op
    if isinstance(l, ir.Literal) and isinstance(r, ir.ColumnRef):
        l, r = r, l
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
    if not (isinstance(l, ir.ColumnRef) and isinstance(r, ir.Literal)):
        return None
    if op not in ("<", "<=", ">", ">="):
        return None  # =, != keep the NDV-based defaults
    entry = (hist or {}).get(l.name)
    if entry is None:
        return None
    edges, null_frac, coltype = entry
    try:
        from oceanbase_tpu_torch.expr.compile import literal_value
        from oceanbase_tpu_torch.sql.session import _coerce_value

        v, t = literal_value(r)
        v = _coerce_value(v, t, coltype)
    except Exception:
        return None
    if v is None or isinstance(v, str):
        return None
    k = len(edges) - 1
    frac = float(np.searchsorted(
        edges, v, side="right" if op in ("<=", ">") else "left")) / k
    if op in (">", ">="):
        frac = 1.0 - frac
    return float(min(max(frac * (1.0 - null_frac), 0.001), 1.0))


def _mcv_selectivity(col: str, value, op: str, mcv: dict,
                     ndv: dict) -> float | None:
    """Equality/inequality selectivity for a string literal from the
    ANALYZE-built most-common-values list (≙ ObOptSelectivity frequency
    histogram).  None when the column has no MCV entry."""
    entry = (mcv or {}).get(col)
    if entry is None or not isinstance(value, str):
        return None
    values, freqs = entry
    covered = sum(freqs)
    try:
        f = freqs[values.index(value)]
    except ValueError:
        # not a common value: spread the residual mass over the
        # distinct values the MCV list does not cover
        n = (ndv or {}).get(col)
        rest = max((n or len(values) * 10) - len(values), 1)
        f = max(0.0, 1.0 - covered) / rest
    if op == "!=":
        f = 1.0 - f
    return float(min(max(f, 0.0001), 1.0))


def _selectivity(pred: ir.Expr, hist: dict | None = None,
                 mcv: dict | None = None,
                 ndv: dict | None = None) -> float:
    if isinstance(pred, ir.Cmp):
        hs = _hist_selectivity(pred, hist)
        if hs is not None:
            return hs
        if pred.op in ("=", "!="):
            l, r = pred.left, pred.right
            if isinstance(l, ir.Literal) and isinstance(r, ir.ColumnRef):
                l, r = r, l
            if isinstance(l, ir.ColumnRef) and isinstance(r, ir.Literal):
                ms = _mcv_selectivity(l.name, r.value, pred.op, mcv, ndv)
                if ms is not None:
                    return ms
        return 0.1 if pred.op == "=" else 0.4
    if isinstance(pred, ir.InList):
        if isinstance(pred.arg, ir.ColumnRef) and not pred.negated:
            per = [_mcv_selectivity(pred.arg.name, v.value, "=", mcv, ndv)
                   for v in pred.values if isinstance(v, ir.Literal)]
            if per and all(p is not None for p in per):
                return min(0.9, sum(per))
        return min(0.9, 0.1 * max(len(pred.values), 1))
    if isinstance(pred, ir.Like):
        return 0.1
    if isinstance(pred, ir.Logic):
        s = 1.0
        if pred.op == "and":
            for a in pred.args:
                s *= _selectivity(a, hist, mcv, ndv)
        else:
            s = min(1.0, sum(_selectivity(a, hist, mcv, ndv)
                             for a in pred.args))
        return s
    return 0.5


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _fold_date_arith(fn: str, base: ir.Expr, n: int, unit: str) -> ir.Expr:
    sign = 1 if fn == "date_add" else -1
    if isinstance(base, ir.Literal) and base.dtype is not None and \
            base.dtype.kind == TypeKind.DATE:
        import numpy as np

        from oceanbase_tpu_torch.datatypes import DATE_EPOCH, date_to_days

        d = np.datetime64(base.value, "D")
        if unit == "day":
            d2 = d + np.timedelta64(sign * n, "D")
        elif unit == "month":
            m = d.astype("datetime64[M]") + np.timedelta64(sign * n, "M")
            day = (d - d.astype("datetime64[M]")).astype(int)
            d2 = m.astype("datetime64[D]") + np.timedelta64(int(day), "D")
        elif unit == "year":
            y = d.astype("datetime64[Y]") + np.timedelta64(sign * n, "Y")
            rest = (d - d.astype("datetime64[Y]").astype("datetime64[D]"))
            d2 = y.astype("datetime64[D]") + rest
        else:
            raise BindError(f"unsupported interval unit {unit}")
        return ir.Literal(str(d2), SqlType.date())
    if unit == "day":
        return ir.Arith("+" if sign > 0 else "-", base, ir.lit(n))
    return ir.FuncCall("add_months", [base, ir.lit(sign * n)])


# late-bound helper used by _CorrelationCollector
def _bind_conjunct_bound(self: Binder, bound: ir.Expr, qb: QueryBlock):
    used = {n.name for n in ir.walk(bound) if isinstance(n, ir.ColumnRef)}
    homes = [i for i, f in enumerate(qb.fragments)
             if used & f.colids]
    if isinstance(bound, ir.Cmp) and bound.op == "=" and len(homes) == 2:
        lu = {n.name for n in ir.walk(bound.left)
              if isinstance(n, ir.ColumnRef)}
        fi, fj = homes
        ci = set(qb.fragments[fi].colids)
        ru = {n.name for n in ir.walk(bound.right)
              if isinstance(n, ir.ColumnRef)}
        if lu <= ci and ru.isdisjoint(ci):
            qb.join_edges.append((fi, fj, bound.left, bound.right))
            return
        if ru <= ci and lu.isdisjoint(ci):
            qb.join_edges.append((fj, fi, bound.left, bound.right))
            return
    if len(homes) == 1:
        i = homes[0]
        f = qb.fragments[i]
        new_est = max(1, int(f.est_rows * _selectivity(
            bound, f.hist, f.mcv, f.ndv)))
        qb.fragments[i] = Fragment(
            pp.Filter(f.plan, bound, est_rows=new_est), f.cols,
            new_est,
            f.unique_cols, colids=f.colids, ndv=f.ndv, hist=f.hist,
            mcv=f.mcv,
        )
    else:
        qb.post_preds.append(bound)


Binder._bind_conjunct_bound = _bind_conjunct_bound
