"""Virtual tables: observability served through SQL.

Port of ``oceanbase_tpu/server/virtual_tables.py`` (≙ the
__all_virtual_* tables + GV$ views, src/observer/virtual_table,
generated schemas src/share/inner_table): each provider returns
{column -> numpy array} with the reference's column names and dtypes,
and the session materializes the views a statement references as
transient catalog tables, so

    SELECT * FROM gv$sql_audit ORDER BY elapsed_s DESC LIMIT 5

works like any query.  The views read the stores of the port's
``Database`` (the measurement plane of ``server/monitor.py``,
``server/trace.py``, ``server/metrics.py``, ``server/profiler.py``,
``server/calibrate.py`` and ``exec/plan.py``) and its storage, WAL,
admission and job modules, and the durability plane's: each tenant's
disk manager (``gv$disk``) and memstore throttle
(``gv$tenant_resource``), the scrub event log (``gv$scrub``), the ERRSIM
points (``v$errsim``) and the workload repository
(``gv$workload_snapshot``/``gv$workload_report``).  On a cluster node
(``net/node.py::NodeDatabase``) ``gv$px_exchange`` reads the DTL
exchange's ring, ``gv$cluster_health`` the failure detector, and
``gv$sysstat``/``gv$sysstat_histogram`` merge every reachable peer's
``metrics.scrape``; a single-node database has neither subsystem nor
peers, so the first two return no rows, as the reference's do.
"""

from __future__ import annotations

import time

import numpy as np

from oceanbase_tpu_torch.server.errsim import ERRSIM


def _obj(xs):
    return np.array(list(xs), dtype=object)


class VirtualTables:
    def __init__(self, database):
        self.db = database

    def names(self):
        return {
            "gv$sql_audit": self.sql_audit,
            "gv$plan_monitor": self.plan_monitor,
            # canonical name for the estimate-vs-actual ledger (the
            # reference's view name); gv$plan_monitor stays as an alias
            "gv$sql_plan_monitor": self.plan_monitor,
            "gv$plan_feedback": self.plan_feedback,
            "gv$plan_history": self.plan_history,
            "gv$plan_choice": self.plan_choice,
            "gv$plan_cache": self.plan_cache,
            "gv$cost_units": self.cost_units,
            "gv$time_calibration": self.time_calibration,
            "gv$device_profile": self.device_profile,
            "gv$backend": self.backend,
            "gv$px_exchange": self.px_exchange,
            "gv$cluster_health": self.cluster_health,
            "gv$recovery": self.recovery,
            "gv$scrub": self.scrub,
            "gv$trace": self.trace,
            "gv$active_session_history": self.active_session_history,
            "gv$system_event": self.wait_events,
            "gv$sysstat": self.sysstat,
            "gv$sysstat_histogram": self.sysstat_histogram,
            "gv$time_model": self.time_model,
            "gv$workload_snapshot": self.workload_snapshot,
            "gv$workload_report": self.workload_report,
            "gv$memory": self.memory,
            "gv$tenant_resource": self.tenant_resource,
            "gv$disk": self.disk,
            "v$session_history": self.session_history,
            "v$parameters": self.parameters,
            "v$tenants": self.tenants,
            "v$tables": self.tables,
            "v$palf": self.palf,
            "v$wait_events": self.wait_events,
            "v$sql_workarea": self.sql_workarea,
            "v$errsim": self.errsim,
            "v$dbms_jobs": self.dbms_jobs,
            "v$kvcache": self.kvcache,
            "information_schema.tables": self.is_tables,
            "information_schema.columns": self.is_columns,
        }

    def provide(self, name: str):
        fn = self.names().get(name)
        return None if fn is None else fn()

    # ------------------------------------------------------------------
    def sql_audit(self):
        recs = self.db.audit.recent(None)  # the whole ring
        return {
            "sql": _obj(r.sql[:200] for r in recs),
            "session_id": np.array([r.session_id for r in recs], np.int64),
            "tenant": _obj(r.tenant for r in recs),
            "start_ts": np.array([r.start_ts for r in recs], np.float64),
            "elapsed_s": np.array([r.elapsed_s for r in recs], np.float64),
            "compile_s": np.array([r.compile_s for r in recs], np.float64),
            "rows_returned": np.array([r.rows for r in recs], np.int64),
            "error": _obj(r.error for r in recs),
            "trace_id": _obj(r.trace_id for r in recs),
            # admission queue wait (overload plane): how long the
            # statement sat QUEUED before its slot was granted
            "queue_s": np.array([getattr(r, "queue_s", 0.0)
                                 for r in recs], np.float64),
            # host/device split (enable_profiling): host time vs the
            # device event-pair time, separable in slow-statement triage
            "host_s": np.array([getattr(r, "host_s", 0.0)
                                for r in recs], np.float64),
            "device_s": np.array([getattr(r, "device_s", 0.0)
                                  for r in recs], np.float64),
            # the host-phase decomposition (gv$time_model's per-
            # statement face); ``xla_compile_s`` keeps the reference's
            # schema and is 0.0 (eager torch compiles nothing), and the
            # legacy ``compile_s`` column above is the bind window
            "bind_s": np.array([getattr(r, "bind_s", 0.0)
                                for r in recs], np.float64),
            "sidecar_build_s": np.array(
                [getattr(r, "sidecar_build_s", 0.0) for r in recs],
                np.float64),
            "lower_s": np.array([getattr(r, "lower_s", 0.0)
                                 for r in recs], np.float64),
            "xla_compile_s": np.array(
                [getattr(r, "xla_compile_s", 0.0) for r in recs],
                np.float64),
            "dispatch_s": np.array([getattr(r, "dispatch_s", 0.0)
                                    for r in recs], np.float64),
            "merge_s": np.array([getattr(r, "merge_s", 0.0)
                                 for r in recs], np.float64),
        }

    def time_model(self):
        """Per-tenant accumulated time decomposition (≙ v$sys_time_model
        rows): one row per (tenant, phase), with the phase's share of
        the tenant's measured statement wall — 'where did the wall
        clock go' as a GROUP BY."""
        tm = getattr(self.db, "time_model", None)
        rows = tm.rows() if tm is not None else []
        return {
            "tenant": _obj(r["tenant"] for r in rows),
            "phase": _obj(r["phase"] for r in rows),
            "seconds": np.array([r["seconds"] for r in rows],
                                np.float64),
            "pct_of_elapsed": np.array(
                [r["pct_of_elapsed"] for r in rows], np.float64),
            "statements": np.array([r["statements"] for r in rows],
                                   np.int64),
        }

    def workload_snapshot(self):
        """Catalog of persisted workload snapshots (server/workload.py):
        id, capture time, merged node set, crc — the ids ANALYZE
        WORKLOAD REPORT FROM <id> TO <id> accepts."""
        repo = getattr(self.db, "workload", None)
        rows = []
        for sid in (repo.snapshot_ids() if repo is not None else []):
            try:
                s = repo.load(sid)
            except Exception:  # noqa: BLE001 — a quarantined snapshot
                # is absent from the catalog, not an error in SELECT
                continue
            rows.append((s["id"], s["ts"], len(s.get("nodes", [])),
                         ",".join(str(n) for n in s.get("nodes", [])),
                         int(s["crc"])))
        return {
            "snapshot_id": np.array([r[0] for r in rows], np.int64),
            "ts": np.array([r[1] for r in rows], np.float64),
            "node_count": np.array([r[2] for r in rows], np.int64),
            "nodes": _obj(r[3] for r in rows),
            "crc64": np.array([r[4] for r in rows], np.uint64),
        }

    def workload_report(self):
        """The LAST built workload report's structured rows (ANALYZE
        WORKLOAD REPORT populates; SHOW WORKLOAD REPORT renders the
        same report as a text tree)."""
        repo = getattr(self.db, "workload", None)
        rep = repo.last_report if repo is not None else None
        rows = rep["rows"] if rep else []
        fid = rep["from_id"] if rep else 0
        tid = rep["to_id"] if rep else 0
        return {
            "from_id": np.array([fid] * len(rows), np.int64),
            "to_id": np.array([tid] * len(rows), np.int64),
            "section": _obj(r["section"] for r in rows),
            "item": _obj(r["item"] for r in rows),
            "value": np.array([r["value"] for r in rows], np.float64),
            "detail": _obj(r["detail"] for r in rows),
        }

    def disk(self):
        """Disk-pressure plane per tenant surface (≙ the log-disk half
        of gv$ob_units + __all_virtual_disk_stat): budgets, fresh
        utilization, degradation state, plus one ``spill_stmt`` row per
        statement actively spilling."""
        rows = []
        tenants = getattr(self.db, "tenants", {}) or {}
        for name in sorted(tenants):
            dm = getattr(tenants[name], "diskmgr", None)
            if dm is not None:
                rows.extend(dm.stats(tenant=name))
        return {
            "tenant": _obj(r["tenant"] for r in rows),
            "surface": _obj(r["surface"] for r in rows),
            "used_bytes": np.array([r["used_bytes"] for r in rows],
                                   np.int64),
            "limit_bytes": np.array([r["limit_bytes"] for r in rows],
                                    np.int64),
            "utilization_pct": np.array(
                [r["utilization_pct"] for r in rows], np.float64),
            "state": _obj(r["state"] for r in rows),
            "detail": _obj(r["detail"] for r in rows),
        }

    def tenant_resource(self):
        """Overload-plane snapshot per tenant (≙ gv$ob_units /
        __all_virtual_tenant_resource): admission slots + queue depth,
        the large-query lane, and memstore backpressure state."""
        adm = getattr(self.db, "admission", None)
        rows = adm.stats() if adm is not None else []
        by_tenant = {r["tenant"]: r for r in rows}
        tenants = getattr(self.db, "tenants", {}) or {}
        # tenants that exist but have not run a statement yet still
        # get a row (their throttle state matters before first query)
        for name in tenants:
            by_tenant.setdefault(name, {"tenant": name})
        out = []
        for name in sorted(by_tenant):
            r = dict(by_tenant[name])
            thr = getattr(tenants.get(name), "throttle", None)
            ts = thr.stats() if thr is not None else {}
            out.append({
                "tenant": name,
                "slots_in_use": r.get("slots_in_use", 0),
                "slots_total": r.get("slots_total", 0),
                "queue_depth": r.get("queue_depth", 0),
                "queue_limit": r.get("queue_limit", 0),
                "weight": r.get("weight", 1),
                "admitted": r.get("admitted", 0),
                "queued": r.get("queued", 0),
                "rejected": r.get("rejected", 0),
                "kills": r.get("kills", 0),
                "timeouts": r.get("timeouts", 0),
                "large_in_use": r.get("large_in_use", 0),
                "large_slots": r.get("large_slots", 0),
                "memstore_bytes": ts.get("memstore_bytes", 0),
                "memstore_limit_bytes":
                    ts.get("memstore_limit_bytes", 0),
                "throttle_state": ts.get("throttle_state", "off"),
                "throttle_sleeps": ts.get("throttle_sleeps", 0),
                "memstore_full_rejections":
                    ts.get("memstore_full_rejections", 0),
            })
        return {
            "tenant": _obj(r["tenant"] for r in out),
            "slots_in_use": np.array([r["slots_in_use"] for r in out],
                                     np.int64),
            "slots_total": np.array([r["slots_total"] for r in out],
                                    np.int64),
            "queue_depth": np.array([r["queue_depth"] for r in out],
                                    np.int64),
            "queue_limit": np.array([r["queue_limit"] for r in out],
                                    np.int64),
            "weight": np.array([r["weight"] for r in out], np.int64),
            "admitted": np.array([r["admitted"] for r in out],
                                 np.int64),
            "queued": np.array([r["queued"] for r in out], np.int64),
            "rejected": np.array([r["rejected"] for r in out],
                                 np.int64),
            "kills": np.array([r["kills"] for r in out], np.int64),
            "timeouts": np.array([r["timeouts"] for r in out],
                                 np.int64),
            "large_in_use": np.array([r["large_in_use"] for r in out],
                                     np.int64),
            "large_slots": np.array([r["large_slots"] for r in out],
                                    np.int64),
            "memstore_bytes": np.array(
                [r["memstore_bytes"] for r in out], np.int64),
            "memstore_limit_bytes": np.array(
                [r["memstore_limit_bytes"] for r in out], np.int64),
            "throttle_state": _obj(r["throttle_state"] for r in out),
            "throttle_sleeps": np.array(
                [r["throttle_sleeps"] for r in out], np.int64),
            "memstore_full_rejections": np.array(
                [r["memstore_full_rejections"] for r in out], np.int64),
        }

    def trace(self):
        """Completed trace spans (server/trace.py ring): one row per
        span, the full-link tree joinable to gv$sql_audit by trace_id
        (≙ gv$ob_trace / SHOW TRACE's backing store)."""
        import json as _json

        reg = getattr(self.db, "trace_registry", None)
        spans = reg.recent() if reg is not None else []
        return {
            "trace_id": _obj(s.trace_id for s in spans),
            "span_id": np.array([s.span_id for s in spans], np.int64),
            "parent_span_id": np.array([s.parent_id for s in spans],
                                       np.int64),
            "node": np.array([s.node for s in spans], np.int64),
            "span_name": _obj(s.name for s in spans),
            "start_ts": np.array([s.start_ts for s in spans], np.float64),
            "elapsed_s": np.array([s.elapsed_s for s in spans],
                                  np.float64),
            "tags": _obj(_json.dumps(s.tags, sort_keys=True, default=str)
                         if s.tags else "" for s in spans),
        }

    def active_session_history(self):
        """ASH samples with the statement's trace_id, so session history
        joins against gv$trace (≙ gv$active_session_history)."""
        ash = getattr(self.db, "ash", None)
        h = ash.history(None) if ash is not None else []
        return {
            "sample_ts": np.array([x[0] for x in h], np.float64),
            "session_id": np.array([x[1] for x in h], np.int64),
            "sql": _obj(x[2][:200] for x in h),
            "state": _obj(x[3] for x in h),
            "trace_id": _obj(x[4] if len(x) > 4 else "" for x in h),
        }

    def plan_monitor(self):
        """Estimate-vs-actual cardinality ledger (≙ gv$sql_plan_monitor):
        one row per operator per monitored execution — the optimizer's
        est_rows beside the measured output rows, their q-error, and the
        execution's capacity retries / spill bytes / path."""
        rows = []
        for rec in self.db.plan_monitor.recent(200):
            for r in rec.op_stats:
                rows.append((rec.ts, rec.plan_hash, rec.logical_hash,
                             r.get("pos", 0), r["op"],
                             -1 if r.get("est") is None else r["est"],
                             r["rows"], r.get("q_error", 0.0),
                             r.get("elapsed_s", 0.0), rec.retries,
                             r.get("spill_bytes", rec.spill_bytes),
                             rec.path, rec.total_s,
                             getattr(rec, "host_s", 0.0),
                             getattr(rec, "device_s", 0.0),
                             getattr(rec, "pred_s", 0.0),
                             getattr(rec, "time_q", 0.0)))
        return {
            "ts": np.array([r[0] for r in rows], np.float64),
            "plan_hash": _obj(r[1] for r in rows),
            "logical_hash": _obj(r[2] for r in rows),
            "op_pos": np.array([r[3] for r in rows], np.int64),
            "operator": _obj(r[4] for r in rows),
            # -1 = the binder had no estimate for this operator
            "est_rows": np.array([r[5] for r in rows], np.int64),
            "output_rows": np.array([r[6] for r in rows], np.int64),
            "q_error": np.array([r[7] for r in rows], np.float64),
            "op_elapsed_s": np.array([r[8] for r in rows], np.float64),
            "capacity_retries": np.array([r[9] for r in rows], np.int64),
            "spill_bytes": np.array([r[10] for r in rows], np.int64),
            "path": _obj(r[11] for r in rows),
            "plan_elapsed_s": np.array([r[12] for r in rows],
                                       np.float64),
            # host/device split + roofline (the TIME q-error beside the
            # cardinality one; whole-statement values repeated per op
            # row like plan_elapsed_s)
            "host_s": np.array([r[13] for r in rows], np.float64),
            "device_s": np.array([r[14] for r in rows], np.float64),
            "pred_s": np.array([r[15] for r in rows], np.float64),
            "time_q_error": np.array([r[16] for r in rows],
                                     np.float64),
        }

    def plan_feedback(self):
        """Cardinality-feedback store (server/monitor.py::PlanFeedback)
        plus ANALYZE's string-column MCV lists in the same joinable
        shape: ``kind='card'`` rows key on (logical_hash, op_pos) like
        gv$sql_plan_monitor; ``kind='mcv'`` rows key on table.column in
        the operator column (detail carries the top values/fractions the
        binder's equality selectivity reads)."""
        import json as _json

        rows = []
        fb = getattr(self.db, "plan_feedback", None)
        for r in (fb.rows() if fb is not None else []):
            rows.append(("card", r["logical_hash"], r["pos"], r["op"],
                         -1 if r.get("est") is None else r["est"],
                         r["rows"], r.get("q_error", 0.0),
                         r.get("hits", 0), r.get("last_ts", 0.0), ""))
        for tname, tenant in self.db.tenants.items():
            for name, ts in tenant.engine.tables.items():
                for col, (vals, freqs) in sorted(
                        getattr(ts.tdef, "mcv", {}).items()):
                    rows.append((
                        "mcv", "", -1, f"{name}.{col}",
                        ts.tdef.ndv.get(col, -1), len(vals),
                        0.0, 0, 0.0,
                        _json.dumps({"values": vals,
                                     "fractions": [round(f, 6)
                                                   for f in freqs]})))
        return {
            "kind": _obj(r[0] for r in rows),
            "logical_hash": _obj(r[1] for r in rows),
            "op_pos": np.array([r[2] for r in rows], np.int64),
            "operator": _obj(r[3] for r in rows),
            "est_rows": np.array([r[4] for r in rows], np.int64),
            "observed_rows": np.array([r[5] for r in rows], np.int64),
            "q_error": np.array([r[6] for r in rows], np.float64),
            "hits": np.array([r[7] for r in rows], np.int64),
            "last_ts": np.array([r[8] for r in rows], np.float64),
            "detail": _obj(r[9] for r in rows),
        }

    def plan_history(self):
        """Plan-regression watchdog (server/monitor.py::PlanHistory):
        per logical plan hash, the latency distribution + EWMA against
        the frozen warmup baseline, flagged when the EWMA exceeds
        baseline * plan_regress_threshold."""
        ph = getattr(self.db, "plan_history", None)
        rows = ph.rows() if ph is not None else []
        return {
            "logical_hash": _obj(r["logical_hash"] for r in rows),
            "executions": np.array([r["executions"] for r in rows],
                                   np.int64),
            "ewma_s": np.array([r["ewma_s"] for r in rows], np.float64),
            "baseline_s": np.array([r["baseline_s"] for r in rows],
                                   np.float64),
            "last_s": np.array([r["last_s"] for r in rows], np.float64),
            "last_ts": np.array([r["last_ts"] for r in rows],
                                np.float64),
            "min_s": np.array([r["min_s"] for r in rows], np.float64),
            "max_s": np.array([r["max_s"] for r in rows], np.float64),
            "p50_s": np.array([r["p50_s"] for r in rows], np.float64),
            "p95_s": np.array([r["p95_s"] for r in rows], np.float64),
            "p99_s": np.array([r["p99_s"] for r in rows], np.float64),
            "regressed": np.array([bool(r["regressed"]) for r in rows]),
            "regress_count": np.array([r["regress_count"] for r in rows],
                                      np.int64),
        }

    def plan_choice(self):
        """CBO self-validation ledger (server/monitor.py::
        PlanChoiceLedger): per logical plan hash, the chosen plan's
        predicted seconds vs the runner-up's, the enumeration method,
        how many access paths were priced, and the prediction q-error
        against the measured device seconds."""
        pc = getattr(self.db, "plan_choice", None)
        rows = pc.rows() if pc is not None else []
        return {
            "logical_hash": _obj(r["logical_hash"] for r in rows),
            "pred_s": np.array([r["pred_s"] for r in rows], np.float64),
            "runner_up_s": np.array([r["runner_up_s"] for r in rows],
                                    np.float64),
            "margin": np.array([r["margin"] for r in rows], np.float64),
            "enumerated": np.array([r["enumerated"] for r in rows],
                                   np.int64),
            "method": _obj(r["method"] for r in rows),
            "n_rels": np.array([r["n_rels"] for r in rows], np.int64),
            "index_probes": np.array([r["index_probes"] for r in rows],
                                     np.int64),
            "binds": np.array([r["binds"] for r in rows], np.int64),
            "executions": np.array([r["executions"] for r in rows],
                                   np.int64),
            "device_s_mean": np.array([r["device_s_mean"] for r in rows],
                                      np.float64),
            "pred_q": np.array([r["pred_q"] for r in rows], np.float64),
            "last_ts": np.array([r["last_ts"] for r in rows],
                                np.float64),
        }

    def plan_cache(self):
        """Plan execution counters (≙ ObPlanCache stat view,
        gv$plan_cache): per plan fingerprint, how often it executed and
        how many capacity signatures it met (``xla_trace_count``, the
        reference's column name: first executions per signature, which
        stay flat while a table grows inside one bucket).

        Entries are PROCESS-wide (exec/plan.py::plan_cache_stats) — in a
        multi-tenant process the view spans tenants, like the gv$
        prefix advertises."""
        from oceanbase_tpu_torch.exec.plan import plan_cache_stats

        entries = sorted(plan_cache_stats(),
                         key=lambda e: -e.executions)
        return {
            "plan_hash": _obj(e.plan_hash for e in entries),
            "plan_text": _obj(e.plan_text for e in entries),
            "executions": np.array([e.executions for e in entries],
                                   np.int64),
            "hit_count": np.array([e.hit_count for e in entries],
                                  np.int64),
            "xla_trace_count": np.array([e.xla_traces for e in entries],
                                        np.int64),
            "last_compile_s": np.array([e.last_compile_s
                                        for e in entries], np.float64),
            # index-probe sidecar rebuilds (sort + pad) charged to
            # this fingerprint
            "sidecar_builds": np.array([e.sidecar_builds
                                        for e in entries], np.int64),
            "sidecar_build_s": np.array([e.sidecar_build_s
                                         for e in entries], np.float64),
            # the analytic flops/bytes of the last new signature and
            # its allocator peak (exec/plan.py's definitions)
            "flops": np.array([e.flops for e in entries], np.float64),
            "bytes_accessed": np.array([e.bytes_accessed
                                        for e in entries], np.float64),
            "peak_memory": np.array([e.peak_memory for e in entries],
                                    np.int64),
            # host/device split accumulated over timed executions
            # (enable_profiling): measured flops per measured device
            # second — the roofline numbers, not datasheet ones
            "host_s_total": np.array([e.host_s_total for e in entries],
                                     np.float64),
            "device_s_total": np.array([e.device_s_total
                                        for e in entries], np.float64),
            "device_executions": np.array(
                [e.device_executions for e in entries], np.int64),
            "achieved_gflops": np.array([e.achieved_gflops
                                         for e in entries], np.float64),
            "achieved_gbps": np.array([e.achieved_gbps
                                       for e in entries], np.float64),
            "created_ts": np.array([e.created_ts for e in entries],
                                   np.float64),
        }

    def cost_units(self):
        """Calibrated machine constants + the probe measurements behind
        them (server/calibrate.py; checksummed on disk): kind='constant'
        rows are the roofline inputs
        (peak flops/s, bytes/s, launch overhead, rpc per-byte);
        kind='probe' rows are the per-kernel-per-rung measurements."""
        units = getattr(self.db, "cost_units", None)
        rows = []
        if units is not None:
            base = (units.backend, units.device_kind,
                    units.calibrated_ts, units.preset)
            for name, value, unit in (
                    ("peak_flops_s", units.peak_flops_s, "flops/s"),
                    ("peak_bytes_s", units.peak_bytes_s, "bytes/s"),
                    ("eff_bytes_s", units.eff_bytes_s, "bytes/s"),
                    ("launch_overhead_s", units.launch_overhead_s, "s"),
                    ("rpc_s_per_byte", units.rpc_s_per_byte, "s/byte")):
                rows.append((*base, "constant", name, 0, 0.0, 0.0, 0.0,
                             float(value), unit))
            for m in units.measurements:
                if "error" in m:
                    continue
                rows.append((*base, "probe", m["kernel"],
                             int(m["rows"]), float(m["flops"]),
                             float(m["bytes"]), float(m["device_s"]),
                             float(m["gflops"]), "gflops"))
        return {
            "backend": _obj(r[0] for r in rows),
            "device_kind": _obj(r[1] for r in rows),
            "calibrated_ts": np.array([r[2] for r in rows], np.float64),
            "preset": _obj(r[3] for r in rows),
            "kind": _obj(r[4] for r in rows),
            "name": _obj(r[5] for r in rows),
            "rows": np.array([r[6] for r in rows], np.int64),
            "flops": np.array([r[7] for r in rows], np.float64),
            "bytes": np.array([r[8] for r in rows], np.float64),
            "device_s": np.array([r[9] for r in rows], np.float64),
            "value": np.array([r[10] for r in rows], np.float64),
            "unit": _obj(r[11] for r in rows),
        }

    def time_calibration(self):
        """Per-operator-type roofline accounting (the calibration table
        the CBO arc reads): predicted vs measured device seconds and
        the time-q-error distribution per plan root operator."""
        tc = getattr(self.db, "time_calibration", None)
        rows = tc.rows() if tc is not None else []
        return {
            "operator": _obj(r["op"] for r in rows),
            "executions": np.array([r["count"] for r in rows],
                                   np.int64),
            "pred_s_sum": np.array([r["pred_s_sum"] for r in rows],
                                   np.float64),
            "device_s_sum": np.array([r["dev_s_sum"] for r in rows],
                                     np.float64),
            "host_s_sum": np.array([r["host_s_sum"] for r in rows],
                                   np.float64),
            # measured/predicted ratio: the correction factor a CBO
            # multiplies its roofline price by for this operator shape
            "correction": np.array([r["correction"] for r in rows],
                                   np.float64),
            "time_q_p50": np.array([r["tq_p50"] for r in rows],
                                   np.float64),
            "time_q_p95": np.array([r["tq_p95"] for r in rows],
                                   np.float64),
            "worst_time_q": np.array([r["worst_tq"] for r in rows],
                                     np.float64),
            "last_ts": np.array([r["last_ts"] for r in rows],
                                np.float64),
        }

    def device_profile(self):
        """Per-kernel rows of every PROFILE capture (server/profiler.py)
        joined to the statement by trace_id (≙ the SQL plan monitor's
        per-operator timing, taken down to real device kernels)."""
        store = getattr(self.db, "device_profiles", None)
        profs = store.recent() if store is not None else []
        rows = []
        for p in profs:
            for r in p.rows:
                rows.append((p.trace_id, p.ts, p.backend, p.sql,
                             r["device"], r["kernel"], r["kind"],
                             r["occurrences"], r["total_s"], r["avg_s"],
                             r["pct"]))
        return {
            "trace_id": _obj(r[0] for r in rows),
            "ts": np.array([r[1] for r in rows], np.float64),
            "backend": _obj(r[2] for r in rows),
            "sql": _obj(r[3] for r in rows),
            "device": _obj(r[4] for r in rows),
            "kernel": _obj(r[5] for r in rows),
            "kind": _obj(r[6] for r in rows),
            "occurrences": np.array([r[7] for r in rows], np.int64),
            "total_s": np.array([r[8] for r in rows], np.float64),
            "avg_s": np.array([r[9] for r in rows], np.float64),
            "pct_device": np.array([r[10] for r in rows], np.float64),
        }

    def backend(self):
        """The resolved backend this database runs on, beside its
        calibration age.  The port has no TPU probe: its two columns
        stay empty."""
        from oceanbase_tpu_torch.server.backend_info import resolve_backend

        b = resolve_backend(self.db.device)
        units = getattr(self.db, "cost_units", None)
        age = units.age_s() if units is not None else -1.0
        return {
            "platform": _obj([b["platform"]]),
            "device_kind": _obj([b["device_kind"]]),
            "device_count": np.array([b["device_count"]], np.int64),
            "cpu_fallback": np.array([bool(b["cpu_fallback"])]),
            # -1.0 = never calibrated in this process
            "calibration_age_s": np.array([age], np.float64),
            "calibration_preset": _obj(
                [units.preset if units is not None else ""]),
            "tpu_probe_log": _obj([""]),
            "tpu_probe_verdict": _obj([""]),
        }

    def px_exchange(self):
        """DTL exchange activity: plan-pushdown vs snapshot-pull events
        with their wire cost and per-slice row/byte/elapsed attribution
        (≙ gv$px_dtl traffic stats; px/dtl.py)."""
        import json as _json

        m = getattr(self.db, "dtl_metrics", None)
        recs = m.recent(1000) if m is not None else []
        return {
            "ts": np.array([r.ts for r in recs], np.float64),
            "table_name": _obj(r.table for r in recs),
            "mode": _obj(r.mode for r in recs),
            "parts": np.array([r.parts for r in recs], np.int64),
            "pushdown_hit": np.array(
                [1 if r.pushdown_hit else 0 for r in recs], np.int64),
            "bytes_shipped": np.array([r.bytes_shipped for r in recs],
                                      np.int64),
            "rows_shipped": np.array([r.rows_shipped for r in recs],
                                     np.int64),
            "fallback_parts": np.array([r.fallback_parts for r in recs],
                                       np.int64),
            "avoided_parts": np.array(
                [getattr(r, "avoided_parts", 0) for r in recs],
                np.int64),
            "elapsed_s": np.array([r.elapsed_s for r in recs],
                                  np.float64),
            # device_s the remote fragments shipped back beside their
            # monitor rows (the cluster half of the host/device split)
            "remote_device_s": np.array(
                [getattr(r, "remote_device_s", 0.0) for r in recs],
                np.float64),
            # per-slice attribution: output-row balance across the
            # exchange's slices (skew = max/mean; 0.0 = no slice data)
            "max_slice_rows": np.array(
                [max(r.slice_rows) if getattr(r, "slice_rows", None)
                 else 0 for r in recs], np.int64),
            "mean_slice_rows": np.array(
                [(sum(r.slice_rows) / len(r.slice_rows))
                 if getattr(r, "slice_rows", None) else 0.0
                 for r in recs], np.float64),
            "slice_skew": np.array(
                [getattr(r, "slice_skew", 0.0) for r in recs],
                np.float64),
            "slices": _obj(_json.dumps(
                {"rows": r.slice_rows, "bytes": r.slice_bytes,
                 "elapsed_s": r.slice_elapsed})
                if getattr(r, "slice_rows", None) else ""
                for r in recs),
        }

    def cluster_health(self):
        """Failure-detector state per peer (net/health.py): the breaker
        (up / suspect / down), RTT EWMA, and the retry/deadline counters
        the per-verb rpc policy table accumulates (≙ the server
        blacklist view, __all_virtual_server_blacklist_info)."""
        h = getattr(self.db, "health", None)
        rows = h.snapshot() if h is not None else []
        return {
            "peer": np.array([r["peer"] for r in rows], np.int64),
            "state": _obj(r["state"] for r in rows),
            "rtt_ewma_ms": np.array([r["rtt_ewma_ms"] for r in rows],
                                    np.float64),
            "consecutive_failures": np.array(
                [r["consecutive_failures"] for r in rows], np.int64),
            "breaker_opens": np.array([r["breaker_opens"] for r in rows],
                                      np.int64),
            "successes": np.array([r["successes"] for r in rows],
                                  np.int64),
            "failures": np.array([r["failures"] for r in rows],
                                 np.int64),
            "retries": np.array([r["retries"] for r in rows], np.int64),
            "deadline_exceeded": np.array(
                [r["deadline_exceeded"] for r in rows], np.int64),
            "last_transition_ts": np.array(
                [r.get("last_transition_ts", 0.0) for r in rows],
                np.float64),
        }

    def recovery(self):
        """Crash-recovery progress (storage/recovery.py): one row per
        boot_replay / restore_prepared / rebuild / checkpoint event,
        plus a live 'catchup' row (local WAL apply point vs the group
        commit point) and the prepared XA branches still recoverable —
        ≙ __all_virtual_ls_restore_progress + DBA_OB_XA_TRANSACTIONS."""
        rows = []
        for name, t in sorted(self.db.tenants.items()):
            rec = getattr(t, "recovery", None)
            if rec is not None:
                rows.extend(rec.rows())
            xids = t.tx.recoverable_xids()
            if xids:
                rows.append({"ts": time.time(), "tenant": name,
                             "phase": "prepared_xa",
                             "prepared": len(xids),
                             "xids": ",".join(xids)})
        node = getattr(self.db, "_node", None)
        if node is not None:
            r = node.palf.replica
            rows.append({
                "ts": time.time(), "tenant": "sys", "phase": "catchup",
                "wal_start_lsn": r.applied_lsn,
                "wal_end_lsn": r.committed_lsn,
                "entries": max(r.committed_lsn - r.applied_lsn, 0),
                "note": f"replay_point="
                        f"{node.engine.meta.get('wal_lsn', 0)}"})
        return {
            "ts": np.array([r.get("ts", 0.0) for r in rows], np.float64),
            "tenant": _obj(r.get("tenant", "sys") for r in rows),
            "phase": _obj(r.get("phase", "") for r in rows),
            "peer": np.array([r.get("peer", -1) for r in rows],
                             np.int64),
            "wal_start_lsn": np.array(
                [r.get("wal_start_lsn", 0) for r in rows], np.int64),
            "wal_end_lsn": np.array(
                [r.get("wal_end_lsn", 0) for r in rows], np.int64),
            "entries": np.array([r.get("entries", 0) for r in rows],
                                np.int64),
            "bytes": np.array([r.get("bytes", 0) for r in rows],
                              np.int64),
            "prepared": np.array([r.get("prepared", 0) for r in rows],
                                 np.int64),
            "xids": _obj(r.get("xids", "") for r in rows),
            "elapsed_s": np.array(
                [r.get("elapsed_s", 0.0) for r in rows], np.float64),
            "note": _obj(r.get("note", "") for r in rows),
        }

    def scrub(self):
        """Scrub-plane activity (storage/scrub.py): one row per event —
        verify rounds (segments/bytes re-checked), quarantines,
        cross-replica digest mismatches, repairs with their peer/bytes,
        and post-repair parity checks (≙ the replica-checksum
        verification surfaced by __all_virtual_tablet_checksum)."""
        st = getattr(self.db, "scrub", None)
        rows = st.rows() if st is not None else []
        return {
            "ts": np.array([r["ts"] for r in rows], np.float64),
            "node_id": np.array([r["node_id"] for r in rows], np.int64),
            "table_name": _obj(r["table"] for r in rows),
            "phase": _obj(r["phase"] for r in rows),
            "segments": np.array([r["segments"] for r in rows],
                                 np.int64),
            "bytes": np.array([r["bytes"] for r in rows], np.int64),
            "peer": np.array([r["peer"] for r in rows], np.int64),
            "mismatches": np.array([r["mismatches"] for r in rows],
                                   np.int64),
            "elapsed_s": np.array([r["elapsed_s"] for r in rows],
                                  np.float64),
            "note": _obj(r["note"] for r in rows),
        }

    def session_history(self):
        ash = getattr(self.db, "ash", None)
        h = ash.history(10000) if ash is not None else []
        return {
            "sample_ts": np.array([x[0] for x in h], np.float64),
            "session_id": np.array([x[1] for x in h], np.int64),
            "sql": _obj(x[2][:200] for x in h),
            "state": _obj(x[3] for x in h),
        }

    def sql_workarea(self):
        """Spill activity per query (≙ GV$SQL_WORKAREA: the work-area
        profile rows the SQL memory manager publishes)."""
        recs = list(getattr(self.db, "workarea_history", []))[-1000:]
        return {
            "ts": np.array([r["ts"] for r in recs], np.float64),
            "sql": _obj(r["sql"][:200] for r in recs),
            "plan_hash": _obj(r.get("plan_hash", "") for r in recs),
            "operation": _obj(r["kind"] for r in recs),
            "spill_runs": np.array([r["runs"] for r in recs], np.int64),
            "spill_bytes": np.array([r["bytes"] for r in recs], np.int64),
            "spilled_rows": np.array([r["spilled_rows"] for r in recs],
                                     np.int64),
            "batches": np.array([r["batches"] for r in recs], np.int64),
            "elapsed_s": np.array([r["elapsed_s"] for r in recs],
                                  np.float64),
        }

    def parameters(self):
        snap = self.db.config.snapshot()
        defs = self.db.config.defs()
        return {
            "name": _obj(snap.keys()),
            "value": _obj(str(v) for v in snap.values()),
            "default_value": _obj(str(defs[k].default) for k in snap),
            "type": _obj(defs[k].ptype for k in snap),
            "info": _obj(defs[k].doc for k in snap),
        }

    def tenants(self):
        ts = self.db.tenants
        return {
            "tenant": _obj(ts.keys()),
            "tables": np.array([len(t.engine.tables) for t in ts.values()],
                               np.int64),
            "gts": np.array([t.tx.gts.current() for t in ts.values()],
                            np.int64),
            "wal_committed_lsn": np.array(
                [t.wal.committed_lsn() for t in ts.values()], np.int64),
        }

    def tables(self):
        rows = []
        for tname, tenant in self.db.tenants.items():
            for name, ts in tenant.engine.tables.items():
                tab = ts.tablet
                rows.append((tname, name, tab.row_count_estimate(),
                             len(tab.segments),
                             sum(s.nbytes() for s in tab.segments),
                             len(tab.active) + sum(len(m)
                                                   for m in tab.frozen)))
        return {
            "tenant": _obj(r[0] for r in rows),
            "table_name": _obj(r[1] for r in rows),
            "row_count": np.array([r[2] for r in rows], np.int64),
            "segment_count": np.array([r[3] for r in rows], np.int64),
            "segment_bytes": np.array([r[4] for r in rows], np.int64),
            "memtable_rows": np.array([r[5] for r in rows], np.int64),
        }

    def palf(self):
        rows = []
        for tname, tenant in self.db.tenants.items():
            wal = tenant.wal
            if hasattr(wal, "replicas"):
                # in-process PalfCluster: every replica is visible
                for rid, r in wal.replicas.items():
                    rows.append((tname, rid, r.role, r.current_term,
                                 r.last_lsn(), r.committed_lsn,
                                 rid in wal.down))
            elif hasattr(wal, "replica"):
                # NetPalf: one local replica per process (peers are
                # remote; query their v$palf for their state)
                r = wal.replica
                rows.append((tname, r.replica_id, r.role,
                             r.current_term, r.last_lsn(),
                             r.committed_lsn, False))
        return {
            "tenant": _obj(r[0] for r in rows),
            "replica_id": np.array([r[1] for r in rows], np.int64),
            "role": _obj(r[2] for r in rows),
            "term": np.array([r[3] for r in rows], np.int64),
            "last_lsn": np.array([r[4] for r in rows], np.int64),
            "committed_lsn": np.array([r[5] for r in rows], np.int64),
            "is_down": np.array([bool(r[6]) for r in rows]),
        }

    def is_tables(self):
        rows = []
        for tname, tenant in self.db.tenants.items():
            for name, ts in tenant.engine.tables.items():
                rows.append((tname, name, ts.tablet.row_count_estimate()))
        return {
            "table_schema": _obj(r[0] for r in rows),
            "table_name": _obj(r[1] for r in rows),
            "table_rows": np.array([r[2] for r in rows], np.int64),
        }

    def is_columns(self):
        rows = []
        for tname, tenant in self.db.tenants.items():
            for name, ts in tenant.engine.tables.items():
                for pos, c in enumerate(ts.tdef.columns, 1):
                    rows.append((tname, name, c.name, pos, str(c.dtype),
                                 "YES" if c.nullable else "NO",
                                 "PRI" if c.name in ts.tdef.primary_key
                                 else ""))
        return {
            "table_schema": _obj(r[0] for r in rows),
            "table_name": _obj(r[1] for r in rows),
            "column_name": _obj(r[2] for r in rows),
            "ordinal_position": np.array([r[3] for r in rows], np.int64),
            "data_type": _obj(r[4] for r in rows),
            "is_nullable": _obj(r[5] for r in rows),
            "column_key": _obj(r[6] for r in rows),
        }

    def wait_events(self):
        """Wait-event distributions (≙ gv$system_event): the legacy
        total_waits/time_waited_s columns stay wire-compatible; the
        histogram upgrade adds min/max/p95/p99 per event."""
        we = getattr(self.db, "wait_events", None)
        stats = we.stats() if we is not None \
            and hasattr(we, "stats") else {}
        events = sorted(stats)
        return {
            "event": _obj(events),
            "total_waits": np.array([stats[e]["count"] for e in events],
                                    np.int64),
            "time_waited_s": np.array([stats[e]["sum"] for e in events],
                                      np.float64),
            "min_wait_s": np.array([stats[e]["min"] for e in events],
                                   np.float64),
            "max_wait_s": np.array([stats[e]["max"] for e in events],
                                   np.float64),
            "p50_s": np.array([stats[e]["p50"] for e in events],
                              np.float64),
            "p95_s": np.array([stats[e]["p95"] for e in events],
                              np.float64),
            "p99_s": np.array([stats[e]["p99"] for e in events],
                              np.float64),
        }

    # ------------------------------------------------------------------
    # metrics plane (server/metrics.py): cluster-wide scrape + surfaces
    # ------------------------------------------------------------------
    def scrape_cluster(self) -> dict:
        """Cluster-merged scrape body: this process's registry plus every
        reachable peer's over the idempotent ``metrics.scrape`` verb
        (unreachable peers degrade the view, never the query) — the gv$
        prefix's promise."""
        from oceanbase_tpu_torch.server import metrics as qmetrics

        wire = qmetrics.wire_snapshot()
        node = getattr(self.db, "_node", None)
        peers = getattr(node, "peers", None) if node is not None else None
        if peers:
            health = getattr(node, "health", None)
            for pid in sorted(peers):
                # a peer the failure detector already declared DOWN
                # would stall the read for the verb deadline — skip it
                # (the same pre-emptive avoidance DTL routing applies)
                if health is not None and health.state(pid) == "down":
                    continue
                try:
                    r = peers[pid].call("metrics.scrape",
                                        _deadline_s=2.0)
                    wire = qmetrics.merge_wire(wire, r["wire"])
                except Exception:  # noqa: BLE001 — degraded view
                    continue
        return wire

    def sysstat(self):
        """Cluster-wide counters + gauges (≙ gv$sysstat): one row per
        series, labels rendered into the stat name
        (``rpc.bytes{verb=dtl.execute}``) and as a JSON column."""
        import json as _json

        from oceanbase_tpu_torch.server import metrics as qmetrics

        wire = self.scrape_cluster()
        rows = []
        for kind in ("counters", "gauges"):
            for n, lbl, v in wire.get(kind, []):
                rows.append((qmetrics.series_id(n, lbl), n,
                             _json.dumps(lbl, sort_keys=True)
                             if lbl else "", kind[:-1], float(v)))
        return {
            "stat_name": _obj(r[0] for r in rows),
            "name": _obj(r[1] for r in rows),
            "labels": _obj(r[2] for r in rows),
            "stat_type": _obj(r[3] for r in rows),
            "value": np.array([r[4] for r in rows], np.float64),
        }

    def sysstat_histogram(self):
        """Cluster-wide latency distributions (≙ the sysstat histogram
        views): p50/p95/p99 computed from merged log-bucket counts —
        never from stored samples."""
        import json as _json

        from oceanbase_tpu_torch.server import metrics as qmetrics

        wire = self.scrape_cluster()
        rows = []
        for n, lbl, hw in wire.get("hists", []):
            h = qmetrics.Histogram.from_wire(hw)
            st = qmetrics.hist_stats(h)
            rows.append((qmetrics.series_id(n, lbl), n,
                         _json.dumps(lbl, sort_keys=True) if lbl else "",
                         st))
        return {
            "stat_name": _obj(r[0] for r in rows),
            "name": _obj(r[1] for r in rows),
            "labels": _obj(r[2] for r in rows),
            "count": np.array([r[3]["count"] for r in rows], np.int64),
            "sum_s": np.array([r[3]["sum"] for r in rows], np.float64),
            "min_s": np.array([r[3]["min"] for r in rows], np.float64),
            "max_s": np.array([r[3]["max"] for r in rows], np.float64),
            "p50_s": np.array([r[3]["p50"] for r in rows], np.float64),
            "p95_s": np.array([r[3]["p95"] for r in rows], np.float64),
            "p99_s": np.array([r[3]["p99"] for r in rows], np.float64),
        }

    def memory(self):
        """Device-memory attribution per table (≙ gv$memory): the
        bucket-padded buffer footprint vs the live-row footprint, and
        the pad-waste the shape-bucket ladder is paying for executable
        reuse.  Capacity mirrors the materialization policy
        (StorageCatalog._bucket_policy), so ALTER SYSTEM SET
        shape_bucket_growth moves the ratio immediately."""
        from oceanbase_tpu_torch.datatypes import TypeKind
        from oceanbase_tpu_torch.vector.column import bucket_capacity

        rows = []
        for tname, tenant in self.db.tenants.items():
            cat = tenant.catalog
            enabled, floor, growth = cat._bucket_policy()
            for name, ts in tenant.engine.tables.items():
                live = int(ts.tablet.row_count_estimate())
                cap = (bucket_capacity(max(live, 1), floor, growth)
                       if enabled else max(live, 1))
                # per-row device bytes: payload width (string columns
                # carry int32 dictionary codes) + validity + mask lanes
                row_bytes = 1  # the relation mask
                for c in ts.tdef.columns:
                    w = np.dtype(c.dtype.np_dtype).itemsize
                    if c.dtype.kind == TypeKind.VECTOR:
                        w *= max(int(c.dtype.precision or 1), 1)
                    row_bytes += int(w)
                    if c.nullable:
                        row_bytes += 1
                live_b = live * row_bytes
                buf_b = cap * row_bytes
                waste = 1.0 - (live / cap) if cap else 0.0
                rows.append((tname, name, live, cap, row_bytes,
                             live_b, buf_b, waste))
        return {
            "tenant": _obj(r[0] for r in rows),
            "table_name": _obj(r[1] for r in rows),
            "live_rows": np.array([r[2] for r in rows], np.int64),
            "buffer_capacity": np.array([r[3] for r in rows], np.int64),
            "row_bytes": np.array([r[4] for r in rows], np.int64),
            "live_bytes": np.array([r[5] for r in rows], np.int64),
            "buffer_bytes": np.array([r[6] for r in rows], np.int64),
            "pad_waste_ratio": np.array([r[7] for r in rows],
                                        np.float64),
        }

    def kvcache(self):
        """Per-tenant device-relation cache stats
        (≙ __all_virtual_kvcache_info)."""
        rows = []
        for tname, t in self.db.tenants.items():
            st = t.catalog._cache.stats()
            st["tenant"] = tname
            rows.append(st)
        return {
            "tenant": _obj(r["tenant"] for r in rows),
            "cache_name": _obj(r["name"] for r in rows),
            "entries": np.array([r["entries"] for r in rows], np.int64),
            "bytes": np.array([r["bytes"] for r in rows], np.int64),
            "limit_bytes": np.array([r["limit_bytes"] for r in rows],
                                    np.int64),
            "hits": np.array([r["hits"] for r in rows], np.int64),
            "misses": np.array([r["misses"] for r in rows], np.int64),
            "evictions": np.array([r["evictions"] for r in rows],
                                  np.int64),
        }

    def dbms_jobs(self):
        """Scheduled-job registry + run history
        (≙ DBA_SCHEDULER_JOBS / __all_virtual_dbms_job)."""
        sched = getattr(self.db, "jobs", None)
        jobs = sched.jobs if sched is not None else {}
        names = sorted(jobs)
        return {
            "job_name": _obj(names),
            "interval_s": np.array([jobs[n]["interval"] for n in names],
                                   np.float64),
            "runs": np.array([jobs[n]["runs"] for n in names], np.int64),
            "failures": np.array([jobs[n]["failures"] for n in names],
                                 np.int64),
            "last_run_s": np.array([jobs[n]["last_s"] for n in names],
                                   np.float64),
        }

    def errsim(self):
        """ERRSIM tracepoints (server/errsim.py): every registered point
        with its hits and fires, and whether a rule is armed."""
        stats = ERRSIM.stats()
        names = sorted(ERRSIM.registered | set(stats))
        return {
            "tracepoint": _obj(names),
            "hits": np.array([stats.get(n, (0, 0))[0] for n in names],
                             np.int64),
            "fired": np.array([stats.get(n, (0, 0))[1] for n in names],
                              np.int64),
            "armed": np.array([n in stats for n in names]),
        }


__all__ = ["VirtualTables"]
