"""Workload diagnostics repository (≙ the AWR-style workload repo).

Reference analog: OceanBase's periodic sysstat snapshots + workload
reports (the `gv$sysstat` history the diagnostic tooling diffs).  The
in-memory observability surfaces (gv$sysstat, gv$time_model, plan
cache/history, ASH, wait events, disk/health state) die at restart, so
before/after comparisons across perf work were impossible; this module
persists them.

Three responsibilities:

- **Snapshots.**  ``snapshot()`` collects every diagnostic surface into
  one JSON payload, optionally cluster-merged over the idempotent
  ``workload.snapshot`` verb (each peer returns its LOCAL payload plus
  a crc64 digest; a digest mismatch degrades the merge, never poisons
  it), stamps the whole payload with ``integrity.bytes_crc`` and
  persists it tmp-staged under ``<root>/workload/``.  Snapshots are
  verified on load and quarantined (``*.corrupt`` rename +
  ``CorruptionError``) on mismatch, as every persisted artifact is.

- **Retention.**  ``prune()`` caps the snapshot directory by count and
  age (the ``integrity.prune_quarantine`` pattern), and prunes the
  quarantined files with the same shared helper.

- **Reports.**  ``build_report(from_id, to_id)`` computes the delta
  between two snapshots — time-model breakdown, top SQL, wait events,
  plan-cache compile churn, plan-history regression callouts, sysstat
  counter movement — shaped both as gv$workload_report rows and as the
  SHOW WORKLOAD REPORT indented text tree (SHOW TRACE's style).

A background thread (knobs ``enable_workload_repo`` /
``workload_snapshot_interval_s``, both hot-reloadable: the loop re-reads
them every round like the scrub loop) takes automatic snapshots;
``ANALYZE WORKLOAD REPORT`` without ids takes one on demand, so reports
work even with the thread off.

Port of ``oceanbase_tpu/server/workload.py``.  The plan-cache section
reads the port's counterparts of XLA's counts (``exec/plan.py``'s
docstring defines them: ``xla_traces`` are first executions per
capacity signature, ``last_compile_s`` is 0.0 since eager torch
compiles nothing), and top SQL reads the audit's ``xla_compile_s`` and
``dispatch_s``.  On a cluster node a snapshot merges every reachable
peer's ``workload.snapshot`` reply, each checked against its digest.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server.diskmgr import wrap_disk_error
from oceanbase_tpu_torch.storage.integrity import (
    CorruptionError,
    bytes_crc,
    prune_quarantine,
)

qmetrics.declare("workload.snapshots", "counter",
                 "workload snapshots persisted (the repo heartbeat; "
                 "labels: cluster=0/1 for merged vs local-only)")
qmetrics.declare("workload.snapshot_corrupt", "counter",
                 "snapshots that failed crc64 verification on load and "
                 "were quarantined to *.corrupt")

_SNAP_RE = re.compile(r"^snap_(\d+)\.json$")

#: payload sections whose delta is "replace with the TO side" (point-in-
#: time state, not monotonic counters)
_STATE_SECTIONS = ("disk", "health", "ash", "top_sql")


def canonical_bytes(payload: dict) -> bytes:
    """The byte string the crc64 digest covers — key-sorted compact
    JSON, so coordinator and peers agree byte-for-byte."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":"), default=str).encode()


def _merge_value(a, b):
    """Cluster merge: counters add, dicts union recursively, lists
    concatenate, anything else keeps the first non-empty side."""
    if isinstance(a, bool) or isinstance(b, bool):
        return a or b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a + b
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _merge_value(a[k], v) if k in a else v
        return out
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    return a if a not in (None, "") else b


def _delta_value(a, b):
    """Snapshot delta: numbers subtract (missing FROM side = 0), dicts
    recurse over the TO side's keys, state sections take the TO side."""
    if isinstance(b, bool):
        return b
    if isinstance(b, (int, float)):
        base = a if isinstance(a, (int, float)) \
            and not isinstance(a, bool) else 0
        return b - base
    if isinstance(b, dict):
        src = a if isinstance(a, dict) else {}
        return {k: _delta_value(src.get(k), v) for k, v in b.items()}
    return b


class WorkloadRepository:
    """One node's workload-snapshot store + report builder."""

    def __init__(self, db, root: str | None = None):
        self.db = db
        self.dir = os.path.join(root, "workload") if root else None
        self._mem: dict[int, dict] = {}   # in-memory store (root=None)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # the last built report, served by gv$workload_report and
        # SHOW WORKLOAD REPORT until the next ANALYZE WORKLOAD REPORT
        self.last_report: dict | None = None
        self._next_id = (max(self.snapshot_ids()) + 1
                         if self.snapshot_ids() else 1)

    # ------------------------------------------------------------------
    # collection
    # ------------------------------------------------------------------
    def collect(self) -> dict:
        """This node's LOCAL diagnostic payload (no RPC) — what the
        ``workload.snapshot`` verb serves to a merging coordinator."""
        from oceanbase_tpu_torch.exec.plan import plan_cache_stats

        db = self.db
        payload: dict = {"sysstat": qmetrics.sysstat_dict()}
        hists = {}
        for n, lbl, hw in qmetrics.wire_snapshot().get("hists", []):
            st = qmetrics.hist_stats(qmetrics.Histogram.from_wire(hw))
            hists[qmetrics.series_id(n, lbl)] = {
                "count": st["count"], "sum": round(st["sum"], 6),
                "p50": st["p50"], "p95": st["p95"], "p99": st["p99"]}
        payload["sysstat_hist"] = hists
        tm = getattr(db, "time_model", None)
        payload["time_model"] = tm.snapshot() if tm is not None else {}
        entries = plan_cache_stats()
        churn = sorted(entries, key=lambda e: -(e.xla_traces
                                                + e.sidecar_builds))[:10]
        payload["plan_cache"] = {
            "entries": len(entries),
            "executions": sum(e.executions for e in entries),
            "xla_traces": sum(e.xla_traces for e in entries),
            "sidecar_builds": sum(e.sidecar_builds for e in entries),
            "sidecar_build_s": round(
                sum(e.sidecar_build_s for e in entries), 6),
            "compile_s": round(
                sum(e.last_compile_s for e in entries), 6),
            "top": [{"plan_hash": e.plan_hash,
                     "executions": e.executions,
                     "xla_traces": e.xla_traces,
                     "sidecar_builds": e.sidecar_builds}
                    for e in churn],
        }
        ph = getattr(db, "plan_history", None)
        rows = ph.rows() if ph is not None else []
        payload["plan_history"] = {
            "plans": len(rows),
            "regress_count": sum(r["regress_count"] for r in rows),
            "regressed": sorted(r["logical_hash"] for r in rows
                                if r["regressed"]),
        }
        we = getattr(db, "wait_events", None)
        payload["wait_events"] = {
            e: {"count": int(c), "sum": round(float(s), 6)}
            for e, (c, s) in
            (we.snapshot() if we is not None else {}).items()}
        ash = getattr(db, "ash", None)
        roll: dict[str, int] = {}
        for smp in (ash.history(None) if ash is not None else []):
            roll[smp[3]] = roll.get(smp[3], 0) + 1
        payload["ash"] = roll
        payload["top_sql"] = self._top_sql()
        disk = []
        for tname in sorted(getattr(db, "tenants", {}) or {}):
            dm = getattr(db.tenants[tname], "diskmgr", None)
            for r in (dm.stats(tenant=tname) if dm is not None else []):
                disk.append({k: r[k] for k in
                             ("tenant", "surface", "used_bytes",
                              "limit_bytes", "state")})
        payload["disk"] = disk
        h = getattr(db, "health", None)
        payload["health"] = [
            {"peer": r["peer"], "state": r["state"],
             "failures": r["failures"]}
            for r in (h.snapshot() if h is not None else [])]
        return payload

    def _top_sql(self, n: int = 10) -> list:
        """Audit-ring rollup keyed by statement text: calls + elapsed/
        device plus the host-phase decomposition, top-n by elapsed."""
        audit = getattr(self.db, "audit", None)
        agg: dict[str, dict] = {}
        for r in (audit.recent(None) if audit is not None else []):
            a = agg.setdefault(r.sql[:200], {
                "sql": r.sql[:200], "calls": 0, "elapsed_s": 0.0,
                "device_s": 0.0, "bind_s": 0.0, "sidecar_build_s": 0.0,
                "lower_s": 0.0, "compile_s": 0.0, "dispatch_s": 0.0,
                "merge_s": 0.0})
            a["calls"] += 1
            a["elapsed_s"] += float(r.elapsed_s)
            a["device_s"] += float(getattr(r, "device_s", 0.0))
            a["bind_s"] += float(getattr(r, "bind_s", 0.0))
            a["sidecar_build_s"] += float(
                getattr(r, "sidecar_build_s", 0.0))
            a["lower_s"] += float(getattr(r, "lower_s", 0.0))
            a["compile_s"] += float(getattr(r, "xla_compile_s", 0.0))
            a["dispatch_s"] += float(getattr(r, "dispatch_s", 0.0))
            a["merge_s"] += float(getattr(r, "merge_s", 0.0))
        out = sorted(agg.values(), key=lambda a: -a["elapsed_s"])[:n]
        for a in out:
            for k, v in a.items():
                if isinstance(v, float):
                    a[k] = round(v, 6)
        return out

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def snapshot(self, cluster: bool = True) -> dict:
        """Take one snapshot (cluster-merged when peers exist), persist
        it, prune retention; -> the snapshot record."""
        payload = self.collect()
        nodes = [int(getattr(self.db, "node_id", 0))]
        if cluster:
            payload, nodes = self._merge_peers(payload, nodes)
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        snap = {
            "id": sid,
            "ts": time.time(),
            "node_id": int(getattr(self.db, "node_id", 0)),
            "nodes": sorted(nodes),
            "crc": bytes_crc(canonical_bytes(payload)),
            "payload": payload,
        }
        self._persist(snap)
        qmetrics.inc("workload.snapshots", cluster=int(bool(cluster)))
        self.prune()
        return snap

    def _merge_peers(self, payload: dict, nodes: list) -> tuple:
        """Fold every reachable peer's local payload in over the
        idempotent workload.snapshot verb; unreachable or digest-
        mismatching peers degrade the merge (gv$ semantics)."""
        node = getattr(self.db, "_node", None)
        peers = getattr(node, "peers", None) if node is not None else None
        if not peers:
            return payload, nodes
        health = getattr(node, "health", None)
        for pid in sorted(peers):
            if health is not None and health.state(pid) == "down":
                continue
            try:
                r = peers[pid].call("workload.snapshot", _deadline_s=5.0)
                # the bulk reply carries its own digest: a merge must
                # never fold in bytes the peer did not mean to send
                if bytes_crc(canonical_bytes(r["payload"])) != r["crc"]:
                    continue
                payload = _merge_value(payload, r["payload"])
                nodes.append(int(r.get("node_id", pid)))
            except Exception:  # noqa: BLE001 — degraded merge
                continue
        return payload, nodes

    def _path(self, sid: int) -> str:
        return os.path.join(self.dir, f"snap_{sid:08d}.json")

    def _persist(self, snap: dict):
        if self.dir is None:
            with self._lock:
                self._mem[snap["id"]] = snap
            return
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(snap["id"])
        data = json.dumps(snap, sort_keys=True, default=str)
        faults = getattr(self.db, "faults", None)
        tmp = path + ".tmp"
        try:
            if faults is not None:
                faults.check_write("workload", path, nbytes=len(data))
            with open(tmp, "w") as fh:
                fh.write(data)
            os.replace(tmp, path)
        except OSError as exc:
            # a snapshot is a durable artifact: no torn tmp is left and
            # the failure is the disk manager's typed error (the
            # reference raises the bare OSError; ROADMAP Queue 3 #21)
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise wrap_disk_error(exc, "workload snapshot") from exc
        if faults is not None:
            # armed disk-rot rules corrupt the just-persisted snapshot
            # in place — load() must catch it via the crc
            faults.act_disk("workload", path)

    def snapshot_ids(self) -> list[int]:
        if self.dir is None:
            with self._lock:
                return sorted(self._mem)
        if not os.path.isdir(self.dir):
            return []
        ids = []
        for name in os.listdir(self.dir):
            m = _SNAP_RE.match(name)
            if m:
                ids.append(int(m.group(1)))
        return sorted(ids)

    def load(self, sid: int) -> dict:
        """Load + crc-verify one snapshot.  A corrupt file is renamed
        to ``*.corrupt`` (quarantine) and raises CorruptionError — the
        caller re-snapshots instead of serving rotten diagnostics."""
        if self.dir is None:
            with self._lock:
                snap = self._mem.get(int(sid))
            if snap is None:
                raise KeyError(f"no workload snapshot {sid}")
            return snap
        path = self._path(int(sid))
        if not os.path.exists(path):
            raise KeyError(f"no workload snapshot {sid}")
        try:
            with open(path) as fh:
                snap = json.load(fh)
            ok = (bytes_crc(canonical_bytes(snap["payload"]))
                  == int(snap["crc"]))
        except (ValueError, KeyError, TypeError):
            snap, ok = None, False
        if not ok:
            qpath = path + ".corrupt"
            os.replace(path, qpath)
            qmetrics.inc("workload.snapshot_corrupt")
            raise CorruptionError(
                f"workload snapshot {sid} failed crc64 verification",
                kind="workload", path=qpath)
        return snap

    def delta(self, from_id: int, to_id: int) -> dict:
        """Counter movement between two snapshots: monotonic sections
        subtract, point-in-time sections take the TO side."""
        a, b = self.load(from_id), self.load(to_id)
        out = {}
        for k, v in b["payload"].items():
            if k in _STATE_SECTIONS:
                out[k] = v
            else:
                out[k] = _delta_value(a["payload"].get(k), v)
        return {"from_id": a["id"], "to_id": b["id"],
                "span_s": max(b["ts"] - a["ts"], 0.0),
                "nodes": sorted(set(a.get("nodes", []))
                                | set(b.get("nodes", []))),
                "payload": out}

    # ------------------------------------------------------------------
    # retention
    # ------------------------------------------------------------------
    def prune(self) -> int:
        """Cap the snapshot store by count and age (newest-first, the
        prune_quarantine pattern); also prune quarantined files."""
        keep = int(self.db.config["workload_retention_keep"])
        max_age = float(self.db.config["workload_retention_max_age_s"])
        removed = 0
        if self.dir is None:
            with self._lock:
                for sid in sorted(self._mem)[:-keep or None]:
                    del self._mem[sid]
                    removed += 1
            return removed
        if not os.path.isdir(self.dir):
            return 0
        now = time.time()
        for rank, sid in enumerate(sorted(self.snapshot_ids(),
                                          reverse=True)):
            path = self._path(sid)
            try:
                too_old = now - os.path.getmtime(path) > max_age
                if rank >= keep or too_old:
                    os.remove(path)
                    removed += 1
            except OSError:
                continue
        prune_quarantine(self.dir)
        return removed

    # ------------------------------------------------------------------
    # reports
    # ------------------------------------------------------------------
    def build_report(self, from_id: int = -1, to_id: int = -1) -> dict:
        """ANALYZE WORKLOAD REPORT: resolve ids (to=-1 takes a FRESH
        cluster-merged snapshot; from=-1 picks the newest one before
        ``to``, or an empty baseline when this is the first), compute
        the delta, shape it as rows + text tree, remember it."""
        if to_id == -1:
            to_id = self.snapshot(cluster=True)["id"]
        if from_id == -1:
            older = [i for i in self.snapshot_ids() if i < to_id]
            from_id = max(older) if older else 0
        if from_id == 0:
            # synthetic empty baseline: the delta IS the to-snapshot
            b = self.load(to_id)
            d = {"from_id": 0, "to_id": b["id"], "span_s": 0.0,
                 "nodes": b.get("nodes", []), "payload": b["payload"]}
        else:
            d = self.delta(from_id, to_id)
        rows = self._report_rows(d)
        report = {
            "from_id": d["from_id"], "to_id": d["to_id"],
            "span_s": round(d["span_s"], 3), "nodes": d["nodes"],
            "built_ts": time.time(),
            "rows": rows,
            "text": self._report_text(d, rows),
        }
        self.last_report = report
        return report

    def _report_rows(self, d: dict) -> list:
        """gv$workload_report rows: (section, item, value, detail)."""
        p = d["payload"]
        rows = [{"section": "report", "item": "span_s",
                 "value": float(d["span_s"]),
                 "detail": f"from={d['from_id']} to={d['to_id']} "
                           f"nodes={','.join(str(n) for n in d['nodes'])}"}]
        for tenant in sorted(p.get("time_model", {})):
            acc = p["time_model"][tenant]
            for phase in sorted(acc):
                if phase == "statements":
                    continue
                rows.append({"section": "time_model",
                             "item": f"{tenant}.{phase}",
                             "value": float(acc[phase]),
                             "detail": f"statements="
                                       f"{int(acc.get('statements', 0))}"})
        for a in p.get("top_sql", []):
            worst = max(("bind_s", "sidecar_build_s", "lower_s",
                         "compile_s", "dispatch_s", "merge_s"),
                        key=lambda k: a.get(k, 0.0))
            rows.append({"section": "top_sql", "item": a["sql"],
                         "value": float(a["elapsed_s"]),
                         "detail": f"calls={a['calls']} "
                                   f"device_s={a['device_s']} "
                                   f"worst_phase={worst}:"
                                   f"{a.get(worst, 0.0)}"})
        for event in sorted(p.get("wait_events", {})):
            w = p["wait_events"][event]
            rows.append({"section": "wait_events", "item": event,
                         "value": float(w.get("sum", 0.0)),
                         "detail": f"waits={int(w.get('count', 0))}"})
        pc = p.get("plan_cache", {})
        for item in ("executions", "xla_traces", "sidecar_builds",
                     "sidecar_build_s", "compile_s"):
            rows.append({"section": "plan_cache", "item": item,
                         "value": float(pc.get(item, 0)), "detail": ""})
        for e in pc.get("top", [])[:10]:
            rows.append({"section": "plan_cache",
                         "item": f"churn:{e['plan_hash'][:16]}",
                         "value": float(e["xla_traces"]),
                         "detail": f"executions={e['executions']} "
                                   f"sidecar_builds="
                                   f"{e['sidecar_builds']}"})
        ph = p.get("plan_history", {})
        for lhash in ph.get("regressed", []):
            rows.append({"section": "regressions", "item": lhash,
                         "value": 1.0, "detail": "gv$plan_history "
                         "EWMA above baseline threshold"})
        rows.append({"section": "regressions", "item": "regress_count",
                     "value": float(ph.get("regress_count", 0)),
                     "detail": ""})
        for name in sorted(p.get("sysstat", {})):
            v = p["sysstat"][name]
            if isinstance(v, (int, float)) and v != 0:
                rows.append({"section": "sysstat", "item": name,
                             "value": float(v), "detail": ""})
        for r in p.get("disk", []):
            rows.append({"section": "disk",
                         "item": f"{r['tenant']}.{r['surface']}",
                         "value": float(r["used_bytes"]),
                         "detail": f"limit={r['limit_bytes']} "
                                   f"state={r['state']}"})
        for r in p.get("health", []):
            rows.append({"section": "health", "item": str(r["peer"]),
                         "value": float(r.get("failures", 0)),
                         "detail": f"state={r['state']}"})
        return rows

    def _report_text(self, d: dict, rows: list) -> str:
        """The SHOW WORKLOAD REPORT tree: section headers at depth 0,
        items indented beneath (SHOW TRACE's two-space style)."""
        lines = [f"workload report from={d['from_id']} to={d['to_id']} "
                 f"span_s={d['span_s']:.3f} "
                 f"nodes={','.join(str(n) for n in d['nodes'])}"]
        section = None
        for r in rows:
            if r["section"] == "report":
                continue
            if r["section"] != section:
                section = r["section"]
                lines.append(f"  {section}")
            detail = f"  [{r['detail']}]" if r["detail"] else ""
            lines.append(f"    {r['item']} = {r['value']:.6g}{detail}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # background snapshot thread (scrub-loop pattern: 1s-granular wait
    # re-reading both knobs every round, so hot reloads apply live)
    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="workload-repo")
        self._thread.start()

    def _loop(self):
        last = time.monotonic()
        while not self._stop.wait(min(float(
                self.db.config["workload_snapshot_interval_s"]), 1.0)):
            if not bool(self.db.config["enable_workload_repo"]):
                last = time.monotonic()
                continue
            interval = float(
                self.db.config["workload_snapshot_interval_s"])
            if time.monotonic() - last < interval:
                continue
            last = time.monotonic()
            try:
                self.snapshot(cluster=True)
            except Exception:  # noqa: BLE001 — diagnostics must never
                # take the node down; the next round retries
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
