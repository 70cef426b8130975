"""Observability stores: SQL audit, plan monitor, plan feedback and
history, the time ledgers, wait events, the time model and ASH.

Port of ``oceanbase_tpu/server/monitor.py``, pure host code kept line
for line with the reference so each gv$ view reads the same rows:

- per-operator plan monitor  ≙ op_monitor_info_ + sql_plan_monitor
  (src/sql/engine/ob_operator.cpp:1534,
  src/share/diagnosis/ob_sql_plan_monitor_node_list.h)
- SQL audit ring buffer      ≙ ObMySQLRequestManager -> gv$sql_audit
  (src/observer/mysql/ob_mysql_request_manager.h:66)
- ASH                        ≙ active session history sampling
  (src/share/ash/ob_active_sess_hist_task.h); the live session
  registry SHOW PROCESSLIST and KILL read, and a sampling thread that
  starts only with ``start()`` (``Database(start_ash=True)``)
- wait-event counters        ≙ deps/oblib/src/lib/stat

The times these stores hold come from ``exec/plan.py``'s host/device
split: on the card ``device_s`` is a CUDA event pair around an
execution's launches, not an XLA program's wait.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


def _tail(ring: collections.deque, n: int | None) -> list:
    """Last ``n`` entries (``None`` = all) without materializing the
    whole ring under the caller's lock (a 10k-deep audit ring copied
    per gv$ read is pure waste)."""
    k = len(ring)
    if n is None or n >= k:
        return list(ring)
    return list(itertools.islice(ring, k - n, k))


@dataclass
class AuditRecord:
    """One executed request (≙ one gv$sql_audit row)."""

    sql: str
    session_id: int
    tenant: str
    start_ts: float            # wall clock (record timestamp)
    elapsed_s: float           # monotonic delta (step-proof)
    rows: int
    plan_hash: str = ""
    error: str = ""
    compile_s: float = 0.0
    trace_id: str = ""         # joins gv$trace / SHOW TRACE
    queue_s: float = 0.0       # admission queue wait (overload plane)
    # host/device split (exec/plan.py, enable_profiling): host time vs
    # device work, separable in slow-statement triage
    host_s: float = 0.0
    device_s: float = 0.0
    # named host-phase decomposition (exec/plan.py::ExecTimes.PHASES):
    # where the host half of the wall clock went for THIS statement
    bind_s: float = 0.0
    sidecar_build_s: float = 0.0
    lower_s: float = 0.0
    xla_compile_s: float = 0.0   # ExecTimes.compile_s (0.0 in the port:
    #                            # eager torch compiles nothing; the
    #                            # column keeps the reference's schema)
    dispatch_s: float = 0.0
    merge_s: float = 0.0


class SqlAudit:
    """Fixed-capacity ring of recent requests."""

    def __init__(self, capacity: int = 10000):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, rec: AuditRecord):
        with self._lock:
            self._ring.append(rec)

    def recent(self, n: int | None = 100) -> list:
        with self._lock:
            return _tail(self._ring, n)

    def __len__(self):
        with self._lock:
            return len(self._ring)


@dataclass
class PlanMonitorRecord:
    """One monitored execution (≙ a gv$sql_plan_monitor row group).

    ``op_stats`` is the estimate-vs-actual ledger: one dict per operator
    in executor postorder with op / pos / est / rows / q_error /
    elapsed_s (exec/plan.py builds them at the result boundary) plus
    optional per-path extras (spill_bytes on the spill tier).
    ``logical_hash`` is the capacity-insensitive plan digest
    (exec/plan.py::logical_hash) joining gv$plan_feedback and
    gv$plan_history; ``retries`` counts the CapacityOverflow re-plans
    this execution paid.
    """

    ts: float                  # wall clock (record timestamp)
    plan_hash: str             # fingerprint digest (capacity-sensitive)
    op_stats: list             # [{op, pos, est, rows, q_error, ...}]
    total_s: float             # monotonic delta (step-proof)
    logical_hash: str = ""     # gv$plan_feedback / gv$plan_history key
    retries: int = 0           # CapacityOverflow re-plans before success
    spill_bytes: int = 0       # temp-file bytes when the spill tier ran
    path: str = "serial"       # serial | spill | px | dtl
    # host/device split + roofline prediction (the time q-error beside
    # the cardinality one; exec/plan.py split, server/calibrate.py
    # model).  0.0 = split off / uncalibrated.
    host_s: float = 0.0        # bind + dispatch (summed over calls)
    device_s: float = 0.0      # CUDA event-pair time (summed)
    pred_s: float = 0.0        # roofline max(flops/F, bytes/B) + L*calls
    time_q: float = 0.0        # max(pred/dev, dev/pred), >= 1.0


class PlanMonitor:
    """Plan-level + per-operator stats for recent executions.

    ``record`` stamps wall time as the row's record timestamp; the
    ``total_s`` the caller passes must be a ``time.monotonic()`` delta.

    Collection is per-plan SAMPLED (``should_record``): the first
    ``SAMPLE_WARMUP`` executions of a logical plan always collect, then
    every ``plan_monitor_sample_every``-th — identical executions of one
    plan carry redundant ledger rows.  An unsampled execution pushes no
    monitor lanes and records no ledger row, so steady-state hot loops
    pay the monitoring overhead a handful of times, not per query.
    EXPLAIN ANALYZE bypasses sampling (it builds its own monitor
    list).
    """

    SAMPLE_WARMUP = 8      # first executions of a plan always collect
    _SEEN_MAX = 16384      # counter-map bound (coarse reset, not LRU)

    def __init__(self, capacity: int = 1000):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seen: dict[str, int] = {}
        self._lock = threading.Lock()

    def should_record(self, logical_hash: str, every: int) -> bool:
        """Count one execution of ``logical_hash``; -> collect this one?
        ``every`` <= 1 disables sampling (always collect)."""
        if every <= 1 or not logical_hash:
            return True
        with self._lock:
            if len(self._seen) >= self._SEEN_MAX:
                self._seen.clear()  # plans re-enter warmup; bounded
            c = self._seen.get(logical_hash, 0) + 1
            self._seen[logical_hash] = c
        return c <= self.SAMPLE_WARMUP or c % every == 0

    def record(self, plan_hash: str, op_stats: list, total_s: float,
               logical_hash: str = "", retries: int = 0,
               spill_bytes: int = 0, path: str = "serial",
               host_s: float = 0.0, device_s: float = 0.0,
               pred_s: float = 0.0, time_q: float = 0.0):
        rec = PlanMonitorRecord(time.time(), plan_hash, op_stats,
                                total_s, logical_hash, retries,
                                spill_bytes, path, host_s, device_s,
                                pred_s, time_q)
        with self._lock:
            self._ring.append(rec)

    def recent(self, n: int = 50):
        with self._lock:
            return _tail(self._ring, n)


class PlanFeedback:
    """Cardinality-feedback store (≙ the SPM/feedback loop OceanBase
    runs through plan evolution): per (logical plan hash x operator
    postorder position), the MAX observed output rows beside the
    estimate that was in force — the session consults it at bind time
    (sql/optimizer.py::apply_feedback) so a known-underestimated
    operator starts at the observed capacity bucket instead of riding
    the CapacityOverflow retry ladder again.

    Bounded: an LRU over logical hashes (``capacity`` entries); a hash
    evicted under pressure simply re-learns on its next misestimate.

    Only UNDERESTIMATES at or beyond ``MIN_Q`` are stored: a correction
    exists to raise a too-small out_capacity, so well-estimated (or
    over-estimated) operators teach nothing — and keeping them out means
    a healthy plan's bind never pays the corrections walk at all.
    """

    MIN_Q = 2.0   # observed/est factor before a row is worth storing

    def __init__(self, capacity: int = 2048):
        self.capacity = int(capacity)
        #: lhash -> {pos: {"op", "est", "rows", "q_error", "hits",
        #:                 "last_ts"}}
        self._store: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def observe(self, logical_hash: str, op_rows: list):
        """Fold one monitored execution's ledger rows in (move-to-front
        LRU touch); only underestimated rows teach anything."""
        if not logical_hash or not op_rows:
            return
        teach = [r for r in op_rows
                 if r.get("pos") is not None
                 and r.get("est") is not None
                 and r["rows"] > r["est"]
                 and float(r.get("q_error", 0.0)) >= self.MIN_Q]
        if not teach:
            return
        with self._lock:
            ent = self._store.get(logical_hash)
            if ent is None:
                while len(self._store) >= max(self.capacity, 1):
                    self._store.popitem(last=False)
                ent = self._store[logical_hash] = {}
            else:
                self._store.move_to_end(logical_hash)
            now = time.time()
            for r in teach:
                pos = r.get("pos")
                cur = ent.get(pos)
                if cur is None:
                    cur = ent[pos] = {
                        "op": r["op"], "est": r.get("est"),
                        "rows": int(r["rows"]),
                        "q_error": float(r.get("q_error", 0.0)),
                        "hits": 0, "last_ts": now}
                else:
                    # MAX observed rows: capacity corrections must cover
                    # the worst run seen, not chase the latest one — and
                    # est/q_error stay the pair from THAT run, so the
                    # stored (est, rows, q_error) triple is one coherent
                    # observation, not a mix of three executions
                    if int(r["rows"]) > cur["rows"]:
                        cur["rows"] = int(r["rows"])
                        cur["est"] = r.get("est")
                        cur["q_error"] = float(r.get("q_error", 0.0))
                    cur["last_ts"] = now

    def corrections(self, logical_hash: str) -> dict:
        """-> {postorder position: (op_name, max observed rows)} for
        apply_feedback; {} when the hash has never been observed."""
        with self._lock:
            ent = self._store.get(logical_hash)
            if not ent:
                return {}
            self._store.move_to_end(logical_hash)
            out = {}
            for pos, cur in ent.items():
                cur["hits"] += 1
                out[pos] = (cur["op"], cur["rows"])
            return out

    def rows(self) -> list:
        """Flat gv$plan_feedback rows."""
        with self._lock:
            out = []
            for lhash, ent in self._store.items():
                for pos, cur in sorted(ent.items()):
                    out.append({"logical_hash": lhash, "pos": pos,
                                **cur})
            return out

    def __len__(self):
        with self._lock:
            return len(self._store)


class PlanHistory:
    """Plan-regression watchdog (≙ spm plan baselines + the SQL
    performance-regression checks): per logical plan hash, a log-bucket
    latency histogram plus an EWMA; the first ``WARMUP`` executions
    freeze a baseline, after which an EWMA beyond
    ``baseline * threshold`` flags the plan ``regressed`` in
    gv$plan_history (the flag clears when latency recovers)."""

    WARMUP = 5         # executions before the baseline freezes
    ALPHA = 0.3        # EWMA weight of the newest sample

    def __init__(self, capacity: int = 1024):
        from oceanbase_tpu_torch.server.metrics import Histogram

        self._hist_cls = Histogram
        self.capacity = int(capacity)
        #: lhash -> {"hist", "ewma", "baseline_s", "executions",
        #:           "regressed", "regress_count", "last_ts", "last_s"}
        self._store: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def record(self, logical_hash: str, elapsed_s: float,
               threshold: float) -> bool:
        """Fold one execution in; -> True when this sample TRANSITIONED
        the plan into the regressed state (the caller counts it)."""
        if not logical_hash:
            return False
        elapsed_s = float(elapsed_s)
        with self._lock:
            ent = self._store.get(logical_hash)
            if ent is None:
                while len(self._store) >= max(self.capacity, 1):
                    self._store.popitem(last=False)
                ent = self._store[logical_hash] = {
                    "hist": self._hist_cls(), "ewma": elapsed_s,
                    "baseline_s": 0.0, "executions": 0,
                    "regressed": False, "regress_count": 0,
                    "last_ts": 0.0, "last_s": 0.0}
            else:
                self._store.move_to_end(logical_hash)
            ent["hist"].observe(elapsed_s)
            ent["executions"] += 1
            ent["ewma"] = (self.ALPHA * elapsed_s
                           + (1.0 - self.ALPHA) * ent["ewma"])
            ent["last_ts"] = time.time()
            ent["last_s"] = elapsed_s
            if ent["executions"] == self.WARMUP:
                # freeze the baseline at the warmup EWMA (p95-adjacent
                # for a stable plan; a plan that regresses DURING warmup
                # simply bakes the slow latency in and stays unflagged —
                # the histogram still shows the shift)
                ent["baseline_s"] = ent["ewma"]
            transitioned = False
            if ent["executions"] > self.WARMUP and ent["baseline_s"] > 0:
                now_regressed = (
                    ent["ewma"] > ent["baseline_s"] * float(threshold))
                if now_regressed and not ent["regressed"]:
                    ent["regress_count"] += 1
                    transitioned = True
                ent["regressed"] = now_regressed
            return transitioned

    def rows(self) -> list:
        """Flat gv$plan_history rows (percentiles from the bucket
        counts, never stored samples)."""
        from oceanbase_tpu_torch.server.metrics import hist_stats

        with self._lock:
            out = []
            for lhash, ent in self._store.items():
                st = hist_stats(ent["hist"])
                out.append({
                    "logical_hash": lhash,
                    "executions": ent["executions"],
                    "ewma_s": ent["ewma"],
                    "baseline_s": ent["baseline_s"],
                    "last_s": ent["last_s"],
                    "last_ts": ent["last_ts"],
                    "min_s": st["min"], "max_s": st["max"],
                    "p50_s": st["p50"], "p95_s": st["p95"],
                    "p99_s": st["p99"],
                    "regressed": ent["regressed"],
                    "regress_count": ent["regress_count"]})
            return out


class TimeCalibration:
    """Per-operator-type roofline accounting (the calibration table the
    CBO arc will read): for every monitored execution, the plan's ROOT
    operator type accumulates predicted vs measured device seconds and
    a time-q-error distribution.  Where the q-error sits near 1, the
    roofline already prices that plan shape in seconds; where it
    doesn't, the gap is a named, queryable correction factor
    (dev_s_sum / pred_s_sum) rather than folklore."""

    def __init__(self, capacity: int = 256):
        from oceanbase_tpu_torch.server.metrics import Histogram

        self._hist_cls = Histogram
        self.capacity = int(capacity)
        #: op -> {count, pred_s_sum, dev_s_sum, host_s_sum, tq_hist,
        #:        worst_tq, last_ts}
        self._store: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def observe(self, op: str, pred_s: float, device_s: float,
                host_s: float = 0.0):
        if not op or pred_s <= 0.0 or device_s <= 0.0:
            return  # uncalibrated / split off: nothing to learn
        tq = max(pred_s / device_s, device_s / pred_s)
        with self._lock:
            ent = self._store.get(op)
            if ent is None:
                while len(self._store) >= max(self.capacity, 1):
                    self._store.popitem(last=False)
                ent = self._store[op] = {
                    "count": 0, "pred_s_sum": 0.0, "dev_s_sum": 0.0,
                    "host_s_sum": 0.0, "tq_hist": self._hist_cls(),
                    "worst_tq": 0.0, "last_ts": 0.0}
            else:
                self._store.move_to_end(op)
            ent["count"] += 1
            ent["pred_s_sum"] += float(pred_s)
            ent["dev_s_sum"] += float(device_s)
            ent["host_s_sum"] += float(host_s)
            ent["tq_hist"].observe(tq)
            if tq > ent["worst_tq"]:
                ent["worst_tq"] = tq
            ent["last_ts"] = time.time()

    def rows(self) -> list:
        """Flat gv$time_calibration rows (percentiles from bucket
        counts, never stored samples)."""
        from oceanbase_tpu_torch.server.metrics import hist_stats

        with self._lock:
            out = []
            for op, ent in self._store.items():
                st = hist_stats(ent["tq_hist"])
                correction = (ent["dev_s_sum"] / ent["pred_s_sum"]
                              if ent["pred_s_sum"] > 0 else 0.0)
                out.append({
                    "op": op, "count": ent["count"],
                    "pred_s_sum": ent["pred_s_sum"],
                    "dev_s_sum": ent["dev_s_sum"],
                    "host_s_sum": ent["host_s_sum"],
                    "correction": correction,
                    "tq_p50": st["p50"], "tq_p95": st["p95"],
                    "worst_tq": ent["worst_tq"],
                    "last_ts": ent["last_ts"]})
            return out


class PlanChoiceLedger:
    """Every CBO plan choice, self-validated (gv$plan_choice).

    ``record`` captures what the optimizer believed at bind time — the
    chosen plan's predicted seconds, the runner-up's, the enumeration
    method and the access paths taken; ``observe`` folds in what the
    device actually measured for that logical plan.  The pair makes
    cost-model lies visible per plan: ``pred_q`` is the usual max-ratio
    q-error of pred_s vs device_s, and a choice whose margin over the
    runner-up is smaller than its own q-error was effectively a coin
    flip."""

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        #: lhash -> {"pred_s", "runner_up_s", "enumerated", "method",
        #:           "n_rels", "index_probes", "binds", "executions",
        #:           "device_s_sum", "pred_q", "last_ts"}
        self._store: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def record(self, logical_hash: str, choices: list):
        """Fold the binder's per-query-block choices for one statement
        (outer block + subquery blocks); predicted seconds add up,
        methods concatenate."""
        if not logical_hash or not choices:
            return
        pred_s = sum(float(c.get("pred_s", 0.0)) for c in choices)
        runner = sum(float(c.get("runner_up_s") or 0.0) for c in choices
                     if c.get("runner_up_s") is not None)
        enumerated = sum(int(c.get("enumerated", 0)) for c in choices)
        probes = sum(int(c.get("index_probes", 0)) for c in choices)
        methods = "+".join(sorted({str(c.get("method", "?"))
                                   for c in choices}))
        n_rels = max(int(c.get("n_rels", 1)) for c in choices)
        with self._lock:
            ent = self._store.get(logical_hash)
            if ent is None:
                while len(self._store) >= max(self.capacity, 1):
                    self._store.popitem(last=False)
                ent = self._store[logical_hash] = {
                    "pred_s": 0.0, "runner_up_s": 0.0, "enumerated": 0,
                    "method": "", "n_rels": 0, "index_probes": 0,
                    "binds": 0, "executions": 0, "device_s_sum": 0.0,
                    "pred_q": 0.0, "last_ts": 0.0}
            else:
                self._store.move_to_end(logical_hash)
            ent["pred_s"] = pred_s
            ent["runner_up_s"] = runner
            ent["enumerated"] = enumerated
            ent["method"] = methods
            ent["n_rels"] = n_rels
            ent["index_probes"] = probes
            ent["binds"] += 1
            ent["last_ts"] = time.time()

    def observe(self, logical_hash: str, device_s: float):
        """Measured device seconds for one execution of the chosen
        plan; refreshes the validation q-error."""
        if not logical_hash or device_s <= 0.0:
            return
        with self._lock:
            ent = self._store.get(logical_hash)
            if ent is None:
                return  # choice evicted (or plan from a cold cache)
            ent["executions"] += 1
            ent["device_s_sum"] += float(device_s)
            mean_dev = ent["device_s_sum"] / ent["executions"]
            if ent["pred_s"] > 0.0 and mean_dev > 0.0:
                ent["pred_q"] = max(ent["pred_s"] / mean_dev,
                                    mean_dev / ent["pred_s"])

    def rows(self) -> list:
        with self._lock:
            out = []
            for lhash, ent in self._store.items():
                mean_dev = (ent["device_s_sum"] / ent["executions"]
                            if ent["executions"] else 0.0)
                margin = (ent["runner_up_s"] / ent["pred_s"]
                          if ent["pred_s"] > 0 and ent["runner_up_s"] > 0
                          else 0.0)
                out.append({
                    "logical_hash": lhash,
                    "pred_s": ent["pred_s"],
                    "runner_up_s": ent["runner_up_s"],
                    "margin": margin,
                    "enumerated": ent["enumerated"],
                    "method": ent["method"],
                    "n_rels": ent["n_rels"],
                    "index_probes": ent["index_probes"],
                    "binds": ent["binds"],
                    "executions": ent["executions"],
                    "device_s_mean": mean_dev,
                    "pred_q": ent["pred_q"],
                    "last_ts": ent["last_ts"]})
            return out


class WaitEvents:
    """Named wait-event timers (≙ wait-event instrumentation).

    Backed by the shared log-bucketed histogram type
    (server/metrics.py::Histogram) instead of bare count+sum, so
    gv$system_event serves min/max/p95/p99 per event.  ``snapshot()``
    keeps the legacy (count, total_seconds) tuple shape wire-compatible;
    ``stats()`` is the full distribution."""

    def __init__(self):
        from oceanbase_tpu_torch.server.metrics import Histogram

        self._hist_cls = Histogram
        self._hists: dict = {}
        self._lock = threading.Lock()

    def add(self, event: str, seconds: float = 0.0):
        with self._lock:
            h = self._hists.get(event)
            if h is None:
                h = self._hists[event] = self._hist_cls()
            h.observe(seconds)

    def snapshot(self) -> dict:
        """Legacy shape: {event: (count, total_seconds)}."""
        with self._lock:
            return {e: (h.count, h.sum) for e, h in self._hists.items()}

    def stats(self) -> dict:
        """{event: {count, sum, min, max, p50, p95, p99}} — the
        gv$system_event row shape."""
        from oceanbase_tpu_torch.server.metrics import hist_stats

        with self._lock:
            return {e: hist_stats(h) for e, h in self._hists.items()}


class TimeModel:
    """Per-tenant accumulated time decomposition (≙ gv$time_model).

    Every statement folds its ExecTimes host-phase split (exec/plan.py:
    bind / sidecar build / lower / compile / dispatch / merge) plus the
    device half, queue wait and measured wall into one running account
    per tenant, so "where did the wall clock go" is answerable by SQL
    without replaying the audit ring.  ``rows()`` is the virtual-table
    shape; ``snapshot()`` is the workload-repository payload shape.
    """

    #: pipeline-ordered phase names; ``elapsed_s`` is appended as its
    #: own row so phase-sum-vs-wall reconciliation is a single query
    PHASES = ("queue_s", "bind_s", "sidecar_build_s", "lower_s",
              "compile_s", "dispatch_s", "merge_s", "device_s")

    def __init__(self):
        self._tenants: dict[str, dict] = {}
        self._lock = threading.Lock()

    def observe(self, tenant: str, times, elapsed_s: float = 0.0,
                queue_s: float = 0.0):
        """Fold one statement's ExecTimes into the tenant account."""
        with self._lock:
            acc = self._tenants.get(tenant)
            if acc is None:
                acc = self._tenants[tenant] = {p: 0.0 for p in self.PHASES}
                acc["elapsed_s"] = 0.0
                acc["statements"] = 0
            for phase in self.PHASES:
                if phase == "queue_s":
                    continue
                acc[phase] += float(getattr(times, phase, 0.0) or 0.0)
            acc["queue_s"] += float(queue_s)
            acc["elapsed_s"] += float(elapsed_s)
            acc["statements"] += 1

    def rows(self) -> list:
        """gv$time_model rows: one per (tenant, phase)."""
        out = []
        with self._lock:
            for tenant in sorted(self._tenants):
                acc = self._tenants[tenant]
                wall = acc["elapsed_s"]
                for phase in self.PHASES + ("elapsed_s",):
                    sec = acc[phase]
                    out.append({
                        "tenant": tenant,
                        "phase": phase,
                        "seconds": round(sec, 6),
                        "pct_of_elapsed": (round(100.0 * sec / wall, 2)
                                           if wall > 0 else 0.0),
                        "statements": acc["statements"],
                    })
        return out

    def snapshot(self) -> dict:
        """{tenant: {phase sums, elapsed_s, statements}} for the
        workload repository (delta-friendly: all values monotonic)."""
        with self._lock:
            return {t: dict(acc) for t, acc in self._tenants.items()}


class AshSampler:
    """Periodic sampler of live session states (≙ ASH task).

    Sessions register a mutable state slot; the sampler snapshots every
    interval into a bounded history.
    """

    def __init__(self, interval_s: float = 1.0, capacity: int = 36000):
        self.interval_s = interval_s
        self._sessions: dict[int, dict] = {}
        self._history: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def register(self, session_id: int, state: dict):
        with self._lock:
            self._sessions[session_id] = state

    def unregister(self, session_id: int):
        with self._lock:
            self._sessions.pop(session_id, None)

    def sessions(self):
        """Snapshot of registered session states (SHOW PROCESSLIST)."""
        with self._lock:
            return {sid: dict(st) for sid, st in self._sessions.items()}

    def sample_once(self):
        # wall time is the sample's RECORD timestamp (interval pacing
        # rides the monotonic Event.wait in the sampler loop)
        now = time.time()
        with self._lock:
            for sid, st in self._sessions.items():
                if st.get("active"):
                    self._history.append(
                        (now, sid, st.get("sql", ""), st.get("state", ""),
                         st.get("trace_id", "")))

    def history(self, n: int | None = 100):
        with self._lock:
            return _tail(self._history, n)

    def start(self):
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval_s):
                self.sample_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ash-sampler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


__all__ = ["AshSampler", "AuditRecord", "PlanChoiceLedger", "PlanFeedback",
           "PlanHistory", "PlanMonitor", "PlanMonitorRecord", "SqlAudit",
           "TimeCalibration", "TimeModel", "WaitEvents"]
