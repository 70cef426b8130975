"""Declarative configuration registry.

Port of ``oceanbase_tpu/server/config.py`` (≙ the parameter seed file,
src/share/parameter/ob_parameter_seed.ipp, runtime-settable via ALTER
SYSTEM SET, persisted, with per-tenant overlays): the same ``Config``
(typed, validated, persisted to ``config.json``, ``watch`` hooks, tenant
overlays) over only the knobs the ported modules read.  Every other
knob of the reference (metrics, profiling, calibration, ASH, throttling,
disk budgets, ...) raises the reference's
``KeyError("unknown parameter ...")`` on get, set and load: a knob of a
plane that is not ported is refused, never accepted and ignored.
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
# DBMS jobs (server/jobs.py)
DEF("enable_dbms_jobs", False, "bool",
    "start the DBMS job scheduler thread at boot (stats auto-gather, "
    "auto compaction — ≙ dbms_scheduler maintenance windows)")
DEF("stats_gather_interval_s", 600.0, "float",
    "auto stats gather period", _pos)
DEF("auto_compact_interval_s", 3600.0, "float",
    "auto major-compaction period", _pos)


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
