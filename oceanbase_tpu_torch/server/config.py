"""Declarative configuration registry.

Port of ``oceanbase_tpu/server/config.py`` (≙ the parameter seed file,
src/share/parameter/ob_parameter_seed.ipp, runtime-settable via ALTER
SYSTEM SET, persisted, with per-tenant overlays): the same ``Config``
(typed, validated, persisted to ``config.json``, ``watch`` hooks, tenant
overlays) over only the knobs the ported modules read, the measurement,
durability and cluster planes' among them.  Every other knob of the
reference (``tenant_memory_limit``, ...) raises the reference's
``KeyError("unknown parameter ...")`` on get, set and load: a knob of a
plane that is not ported is refused, never accepted and ignored.  So
are the knobs the reference declares and no module of either package
reads: ``px_exchange_capacity_per_dest`` (the PX planner sizes every
exchange budget from its input's capacity), ``palf_lease_ms`` (a node
takes its lease from ``--lease-ms``) and ``wal_replica_count`` (a tenant
takes ``wal_replicas``).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class ParamDef:
    name: str
    default: Any
    ptype: str             # int | bool | str | float | cap
    doc: str
    validator: Optional[Callable[[Any], bool]] = None


_DEFS: dict[str, ParamDef] = {}


def DEF(name, default, ptype, doc, validator=None):
    _DEFS[name] = ParamDef(name, default, ptype, doc, validator)
    return name


def _pos(v):
    return v > 0


def _nonneg(v):
    return v >= 0


def _frac(v):
    return 0.0 <= v <= 1.0


# ---------------------------------------------------------------------------
# parameter seed: the knobs the port reads, with the reference's defaults
# ---------------------------------------------------------------------------

# SQL engine (sql/session.py: the spill route)
DEF("sql_work_area_rows", 1 << 22, "int",
    "per-query work-area row budget; inputs estimated above it stream "
    "through the disk spill tier (≙ ObTenantSqlMemoryManager work areas)",
    _pos)
DEF("enable_sql_spill", True, "bool",
    "route over-budget sorts/joins/group-bys through the temp-file "
    "spill tier instead of failing on CapacityOverflow")
# storage materialization (storage/engine.py::StorageCatalog._bucketed)
DEF("enable_shape_buckets", True, "bool",
    "pad device relations materialized from storage to geometric "
    "capacity buckets (dead lanes masked)")
DEF("shape_bucket_growth", 2.0, "float",
    "geometric growth factor of the storage-materialization bucket "
    "ladder", lambda v: v >= 1.125)
DEF("shape_bucket_floor", 64, "int",
    "smallest capacity bucket (tables below it pad up to the floor)",
    _pos)
# storage (sql/session.py::_maybe_freeze)
DEF("memstore_limit_rows", 1_000_000, "int",
    "freeze threshold per tablet (rows in active memtable)", _pos)
DEF("minor_compact_trigger", 4, "int",
    "L0 segment count triggering minor compaction (≙ minor_compact_trigger)",
    _pos)
# parallel DML (sql/session.py::_pdml_write) on the tenant worker pool
DEF("pdml_min_rows", 8192, "int",
    "parallel-DML threshold: statements writing at least this many rows "
    "fan the write phase out over tenant workers (≙ enable_parallel_dml "
    "+ the PDML DFO split, src/sql/engine/pdml)", _pos)
DEF("pdml_dop", 4, "int", "parallel-DML worker count", _pos)
DEF("tenant_cpu_quota", 4, "int", "worker threads per tenant unit", _pos)
# PX intra-query parallelism (sql/session.py::_px_dop, server/tenant.py)
DEF("px_default_dop", 0, "int",
    "degree of parallelism (0 or 1 = serial; capped at the mesh size)",
    _nonneg)
DEF("px_workers_per_tenant", 64, "int",
    "PX admission quota (≙ px_workers_per_cpu_quota)", _pos)
# table locks (tx/tablelock.py)
DEF("lock_wait_timeout_s", 5.0, "float",
    "implicit DML table-lock wait budget (≙ lock_wait_timeout)", _pos)
# device-relation cache (server/tenant.py)
DEF("kv_cache_limit_bytes", 2 << 30, "cap",
    "device-relation (block) cache budget per tenant "
    "(≙ ObKVGlobalCache memory limit)", _pos)
# the session plan cache (sql/session.py::_plan_select_cached)
DEF("enable_plan_cache", True, "bool",
    "cache bound physical plans keyed by parameterized SQL text")
DEF("plan_cache_mem_limit", 512 << 20, "cap",
    "plan cache memory budget in bytes", _pos)
# statement deadlines and admission (server/admission.py)
DEF("query_timeout_s", 3600, "int",
    "per-statement deadline seconds (settable per session via SET "
    "query_timeout_s); checked host-side at result-boundary "
    "checkpoints — plan entry and operator close, spill batch, the "
    "capacity-retry ladder — raising typed QueryTimeout", _pos)
DEF("enable_admission", True, "bool",
    "statement admission control: queries/DML check a per-tenant slot "
    "out before binding; over-limit statements wait in a bounded "
    "per-tenant FIFO granted by weighted round-robin across tenants, "
    "full queues reject fast with typed ServerBusy (≙ the tenant "
    "worker quota + large query queue)")
DEF("admission_slots", 32, "int",
    "process-wide concurrent admitted statements (0 disables "
    "admission)", _nonneg)
DEF("admission_tenant_slots", 16, "int",
    "per-tenant cap on concurrently admitted statements", _pos)
DEF("admission_queue_limit", 64, "int",
    "bounded per-tenant admission FIFO depth; statements beyond it "
    "reject immediately with ServerBusy", _nonneg)
DEF("admission_queue_timeout_s", 10.0, "float",
    "queue-wait budget before a queued statement gives up with "
    "ServerBusy (also clamped to the statement's own deadline)", _pos)
DEF("admission_tenant_weight", 1, "int",
    "weighted-round-robin share of this tenant's queue when admission "
    "slots free up (set on the tenant's config overlay)", _pos)
DEF("large_query_threshold_s", 5.0, "float",
    "observed runtime past which a statement yields its normal "
    "admission slot to the low-priority large-query lane at its next "
    "checkpoint (point queries stop starving behind scans)", _pos)
DEF("admission_large_slots", 2, "int",
    "concurrent statements of the low-priority large-query lane", _pos)
# memstore write backpressure (server/admission.py::MemstoreThrottle)
DEF("enable_rate_limit", True, "bool",
    "memstore write backpressure (server/admission.py::"
    "MemstoreThrottle): account unflushed bytes per write, ramp writer "
    "sleeps past writing_throttle_trigger_pct of "
    "memstore_limit_bytes, raise MemstoreFull at the hard limit "
    "(≙ write throttling)")
DEF("memstore_limit_bytes", 256 << 20, "cap",
    "per-tenant unflushed memstore byte budget; writes at the limit "
    "raise typed MemstoreFull until the freeze/flush catches up", _pos)
DEF("writing_throttle_trigger_pct", 60, "int",
    "percentage of memstore_limit_bytes past which writers pay a "
    "ramped sleep before each append (≙ "
    "writing_throttling_trigger_percentage)",
    lambda v: 1 <= v <= 100)
DEF("writing_throttle_max_sleep_s", 0.05, "float",
    "per-write sleep ceiling of the memstore throttle ramp", _pos)
# disk-pressure plane: per-surface byte budgets (0 = unlimited) +
# read-only degradation (server/diskmgr.py)
DEF("log_disk_limit_bytes", 0, "cap",
    "per-tenant PALF WAL directory budget; crossing the utilization "
    "threshold kicks checkpoint + WAL recycle, reaching the limit "
    "drops the tenant to read-only (typed TenantReadOnly on writes, "
    "reads keep serving) — ≙ log_disk_utilization_limit_threshold",
    _nonneg)
DEF("data_disk_limit_bytes", 0, "cap",
    "per-tenant data directory (segments + manifest + slog) budget; "
    "at the limit the tenant enters read-only until space frees",
    _nonneg)
DEF("spill_disk_limit_bytes", 0, "cap",
    "per-tenant temp-file (spill) byte budget; exhaustion kills only "
    "the spilling statement (typed SpillBudgetExceeded) — ≙ the "
    "tmp-file quota", _nonneg)
DEF("log_disk_utilization_threshold", 80, "int",
    "percentage of log_disk_limit_bytes past which the tenant "
    "reclaims aggressively (checkpoint + WAL recycle) before "
    "degrading, and back under which read-only auto-exits",
    lambda v: 1 <= v <= 100)
# data integrity / scrub (storage/scrub.py) and the disk-fault plane
# (net/faults.py; Database.arm_disk_faults)
DEF("enable_scrub", True, "bool",
    "background scrubber: periodically re-read + checksum-verify every "
    "persisted segment, compare per-table logical digests across "
    "replicas (scrub.checksum verb, majority wins), and auto-repair "
    "corrupt/minority tables from a healthy peer over the chunked "
    "rebuild.fetch_* verbs (≙ replica checksum verification at major "
    "freeze) — surfaced as gv$scrub")
DEF("scrub_interval_s", 300.0, "float",
    "scrub round cadence; each round re-reads local segment files and "
    "exchanges per-table digests with peers — hot-reloadable (the loop "
    "re-reads it every wait)", _pos)
DEF("enable_disk_faults", False, "bool",
    "allow disk fault rules (seeded enospc/eio/partial writes and "
    "bitflip/truncate of just-persisted segment/manifest/slog/wal "
    "files) to arm on this database — the deterministic media-rot "
    "half of the chaos plane")
# the cluster plane (net/, palf/netcluster.py, px/dtl.py): DTL
# pushdown, fault injection and failure detection, the rpc pools,
# the node's checkpoint loop and the rebuild tier
DEF("enable_dtl_pushdown", True, "bool",
    "ship qualifying single-table partial plans to cluster nodes over "
    "the DTL exchange instead of scanning everything on the "
    "coordinator (≙ PX DFO scheduling onto data-owning servers)")
DEF("dtl_min_rows", 4096, "int",
    "minimum estimated base-table rows before a plan is considered for "
    "DTL pushdown (below it, per-node RPC overhead dominates)", _nonneg)

DEF("enable_fault_injection", False, "bool",
    "allow the fault.inject/fault.clear admin RPC verbs to arm rules on "
    "this node's FaultPlane (≙ errsim tracepoints scoped to the rpc "
    "frame; scripts/chaos_bench.py nemesis schedules)")
DEF("fault_seed", 0, "int",
    "seed of the per-node FaultPlane rng — a failing nemesis schedule "
    "replays frame-for-frame", _nonneg)
DEF("health_ping_interval_s", 0.5, "float",
    "failure-detector heartbeat period per peer; detection latency is "
    "O(interval * health_down_threshold)", _pos)
DEF("health_suspect_threshold", 2, "int",
    "consecutive failures before a peer turns 'suspect' (PX slices "
    "pre-emptively route away from it)", _pos)
DEF("health_down_threshold", 4, "int",
    "consecutive failures before a peer turns 'down' (a dead leader "
    "triggers immediate re-election instead of lease expiry)", _pos)
DEF("rpc_conn_pool_size", 4, "int",
    "idle connections kept per RpcClient; calls beyond it dial extra "
    "sockets so control-plane pings never queue behind bulk transfers "
    "(LRU extras close on checkin)", _pos)
DEF("rpc_max_conns_per_peer", 16, "int",
    "hard cap on live sockets (idle + in-flight) per RpcClient; "
    "checkout past it waits for a checkin inside the call deadline and "
    "then fails with typed ConnPoolExhausted instead of growing "
    "without bound under fan-out load", _pos)
DEF("log_checkpoint_interval_s", 60, "int",
    "periodic checkpoint cadence advancing the WAL replay point so "
    "restart replay cost is O(tail), not O(history)", _pos)
DEF("checkpoint_lag_entries", 256, "int",
    "minimum applied WAL entries past the persisted replay point "
    "before a periodic checkpoint bothers flushing", _nonneg)

DEF("enable_auto_rebuild", True, "bool",
    "a node booting with NO local recovery sources (no manifest, slog "
    "or WAL) bootstraps from a peer's checkpoint + segments + WAL via "
    "the rebuild.fetch_* verbs (≙ replica rebuild ha_dag)")
DEF("rebuild_chunk_bytes", 4 << 20, "cap",
    "byte budget per rebuild.fetch_segments chunk", _pos)
# DBMS jobs (server/jobs.py)
DEF("enable_dbms_jobs", False, "bool",
    "start the DBMS job scheduler thread at boot (stats auto-gather, "
    "auto compaction — ≙ dbms_scheduler maintenance windows)")
DEF("stats_gather_interval_s", 600.0, "float",
    "auto stats gather period", _pos)
DEF("auto_compact_interval_s", 3600.0, "float",
    "auto major-compaction period", _pos)

# the measurement plane: plan monitor and plan quality (exec/plan.py,
# sql/session.py, server/monitor.py)
DEF("enable_sql_plan_monitor", True, "bool",
    "collect per-operator row counts/timings (≙ sql_plan_monitor); an "
    "explicit EXPLAIN ANALYZE forces collection for its own statement "
    "regardless")
DEF("plan_monitor_sample_every", 16, "int",
    "per-plan ledger sampling: the first executions of a logical plan "
    "always collect per-operator rows, then every Nth (1 = collect "
    "every execution); unsampled executions push no monitor lanes and "
    "skip the ledger record — hot-reloadable via ALTER SYSTEM SET", _pos)
DEF("enable_plan_feedback", True, "bool",
    "cardinality feedback (gv$plan_feedback): monitored executions "
    "record observed per-operator rows per logical plan hash; binds "
    "consult the store to correct out_capacity, and CapacityOverflow "
    "retries jump straight to the reported budget instead of riding "
    "the blind 4x ladder — hot-reloadable via ALTER SYSTEM SET")
DEF("plan_regress_threshold", 2.0, "float",
    "plan-regression watchdog: a plan whose latency EWMA exceeds its "
    "frozen warmup baseline by this factor is flagged regressed in "
    "gv$plan_history — hot-reloadable via ALTER SYSTEM SET (each "
    "execution re-reads it)", lambda v: v >= 1.0)
DEF("plan_feedback_entries", 2048, "int",
    "bounded gv$plan_feedback store: logical plan hashes kept (LRU); "
    "takes effect for new Database instances (ring size is bound at "
    "boot)", _pos)
DEF("plan_history_entries", 1024, "int",
    "bounded gv$plan_history store: logical plan hashes kept (LRU); "
    "takes effect for new Database instances (ring size is bound at "
    "boot)", _pos)
# device-time split, profiling and roofline calibration (exec/plan.py,
# server/calibrate.py, server/profiler.py)
DEF("enable_profiling", True, "bool",
    "host/device time split: execute_plan records a CUDA event pair "
    "around its launches and reads it after the result boundary's one "
    "sync, so every execution records host_s and device_s separately "
    "— feeds gv$sql_audit host_s/device_s, gv$plan_cache "
    "achieved_gflops/achieved_gbps, the time q-error ledger, and the "
    "PROFILE capture; hot-reloadable via ALTER SYSTEM SET")
DEF("enable_calibration", True, "bool",
    "roofline cost calibration (server/calibrate.py): run the "
    "canonical probe suite at first boot (constants persisted "
    "checksummed as cost_units.json, surfaced as gv$cost_units) and "
    "allow ALTER SYSTEM CALIBRATE re-probes; off = no machine "
    "constants, roofline predictions and time q-errors degrade to 0")
# diagnostics (server/metrics.py, server/trace.py, server/monitor.py)
DEF("enable_metrics", True, "bool",
    "metrics plane (server/metrics.py): named counters, gauges and "
    "log-bucketed latency histograms updated host-side at result and "
    "span-close boundaries, surfaced as gv$sysstat / "
    "gv$sysstat_histogram / SHOW METRICS (≙ ob_diagnose_info sysstat "
    "counters)")
DEF("enable_query_trace", True, "bool",
    "full-link statement tracing (server/trace.py): a root span per "
    "statement, children across bind/execute/operators/spill "
    "(≙ ObTrace/flt -> gv$ob_trace)")
DEF("trace_sample_rate", 1.0, "float",
    "fraction of statements whose trace tree is RETAINED in gv$trace "
    "(collection stays on; slow/failed statements always retain)", _frac)
DEF("trace_slow_threshold_s", 1.0, "float",
    "statements at least this slow keep their trace tree even when the "
    "sample draw said no (tail attribution must never be sampled away)",
    _nonneg)
DEF("trace_ring_spans", 20000, "int",
    "bounded per-node span ring capacity behind gv$trace", _pos)
DEF("enable_ash", True, "bool",
    "active-session-history sampling (≙ ASH)")
DEF("ash_sample_interval_ms", 1000, "int", "ASH sampling period", _pos)
DEF("sql_audit_queue_size", 10000, "int",
    "ring-buffer capacity of gv$sql_audit", _pos)
# workload diagnostics repository (server/workload.py) — persistent
# crc64-stamped snapshots of the observability surfaces, the substrate
# of ANALYZE WORKLOAD REPORT (≙ AWR-style workload repository).  All
# four knobs hot-reload: the snapshot loop re-reads them every round.
DEF("enable_workload_repo", False, "bool",
    "background workload-snapshot thread: periodically persist "
    "gv$sysstat + histograms, gv$time_model, plan-cache/plan-history "
    "summaries, ASH rollups and disk state to <data_dir>/workload/ "
    "(crc64-verified on load, quarantined on mismatch)")
DEF("workload_snapshot_interval_s", 60.0, "float",
    "cadence of automatic workload snapshots", _pos)
DEF("workload_retention_keep", 64, "int",
    "newest snapshots retained per node; older ones are pruned "
    "(count cap, mirrors integrity.prune_quarantine)", _pos)
DEF("workload_retention_max_age_s", 7 * 24 * 3600.0, "float",
    "snapshots older than this are pruned regardless of count", _pos)


def _unknown(name: str) -> KeyError:
    return KeyError(f"unknown parameter {name!r}")


class Config:
    """One configuration instance (cluster-level or tenant overlay)."""

    def __init__(self, persist_path: str | None = None,
                 parent: "Config | None" = None):
        self._values: dict[str, Any] = {}
        self._parent = parent
        self._persist_path = persist_path
        self._lock = threading.RLock()
        self._watchers: list[Callable[[str, Any], None]] = []
        if persist_path and os.path.exists(persist_path):
            with open(persist_path) as f:
                stored = json.load(f)
            for k, v in stored.items():
                if k not in _DEFS:
                    raise _unknown(k)
                self._values[k] = v

    # ------------------------------------------------------------------
    def get(self, name: str):
        if name not in _DEFS:
            raise _unknown(name)
        with self._lock:
            if name in self._values:
                return self._values[name]
        if self._parent is not None:
            return self._parent.get(name)
        return _DEFS[name].default

    def __getitem__(self, name):
        return self.get(name)

    def set(self, name: str, value):
        """Runtime update with type coercion + validation
        (≙ ALTER SYSTEM SET)."""
        d = _DEFS.get(name)
        if d is None:
            raise _unknown(name)
        value = _coerce(d.ptype, value)
        if d.validator is not None and not d.validator(value):
            raise ValueError(f"invalid value {value!r} for {name}")
        with self._lock:
            self._values[name] = value
            if self._persist_path:
                tmp = self._persist_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(self._values, f, indent=1)
                os.replace(tmp, self._persist_path)
            watchers = list(self._watchers)
        for w in watchers:
            w(name, value)

    def watch(self, fn: Callable[[str, Any], None]):
        self._watchers.append(fn)

    def snapshot(self) -> dict:
        return {name: self.get(name) for name in sorted(_DEFS)}

    @staticmethod
    def defs() -> dict[str, ParamDef]:
        return dict(_DEFS)


_CAP_UNITS = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def _coerce(ptype: str, v):
    if ptype == "int":
        return int(v)
    if ptype == "float":
        return float(v)
    if ptype == "bool":
        if isinstance(v, str):
            return v.lower() in ("1", "true", "on", "yes")
        return bool(v)
    if ptype == "cap":
        if isinstance(v, str) and v and v[-1].lower() in _CAP_UNITS:
            return int(float(v[:-1]) * _CAP_UNITS[v[-1].lower()])
        return int(v)
    return str(v)


__all__ = ["Config", "ParamDef"]
