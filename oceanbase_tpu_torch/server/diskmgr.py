"""Disk-pressure plane: per-surface budgets + read-only degradation.

Reference analog: the log-disk guard in the reference system —
``log_disk_utilization_threshold`` / ``log_disk_utilization_limit``
stop log writes when the tenant's log disk fills, dropping the tenant
to read-only while reads keep serving (LogIOWorker is the single choke
point feeding Paxos, so a full log disk must fail WRITES typed, never
hang them), plus the tmp-file quota walling spill from the durable
surface.

Three surfaces per tenant, each with its own byte budget:

- ``log``   — the PALF WAL directory.  Crossing the utilization
  threshold first kicks an aggressive checkpoint + WAL recycle
  (reclaim); if utilization still reaches the limit the tenant enters
  READ-ONLY: writes fail fast with typed :class:`TenantReadOnly`,
  reads/scrub/metrics keep serving, and (on a cluster node) PALF
  leadership is relinquished to a peer with headroom.  The tenant
  auto-exits read-only once utilization drops back under the
  threshold.
- ``data``  — segments + manifest + slog.  Reaching the limit enters
  read-only the same way (no reclaim callback: flushing makes MORE
  data), and auto-exits when compaction/drops free space.
- ``spill`` — the temp-file store.  Exhaustion kills only the spilling
  statement (typed :class:`SpillBudgetExceeded`), never the durable
  surface.

Typed errors for the whole plane live here: the durable writers
(palf/log.py, storage/engine.py, server/backup.py, storage/tmpfile.py)
normalize any ``OSError`` escaping a durable write into
:class:`DiskFull` / :class:`DiskIOError` via :func:`wrap_disk_error` —
a bare OSError never propagates out of the append or flush path.

All limits default to 0 (= unlimited): the plane costs one
``time.monotonic()`` read per write until a budget is configured.

Port of ``oceanbase_tpu/server/diskmgr.py``; each tenant of the port's
``Database`` owns one, wired into ``TransService.write``, its temp-file
stores and ``gv$disk``.  A single node has no PALF leadership to hand
over.
"""

from __future__ import annotations

import errno
import os
import threading
import time

from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import trace as qtrace

SURFACES = ("log", "data", "spill")

qmetrics.declare("disk.used_bytes", "gauge",
                 "per-surface disk utilization at the last poll "
                 "(labels: surface)", unit="B")
qmetrics.declare("disk.reclaims", "counter",
                 "log-disk pressure reclaim rounds (aggressive "
                 "checkpoint + WAL recycle)")
qmetrics.declare("disk.reclaimed_bytes", "counter",
                 "bytes a reclaim round freed on the log surface",
                 unit="B")
qmetrics.declare("disk.readonly_entries", "counter",
                 "tenant transitions INTO read-only mode (labels: "
                 "surface that filled)")
qmetrics.declare("disk.readonly_exits", "counter",
                 "tenant transitions OUT of read-only mode")
qmetrics.declare("disk.write_rejections", "counter",
                 "writes failed fast with TenantReadOnly")
qmetrics.declare("disk.spill_rejections", "counter",
                 "statements killed by the spill budget "
                 "(SpillBudgetExceeded)")
qmetrics.declare("disk.errors", "counter",
                 "typed disk errors raised at durable-write boundaries "
                 "(labels: kind = full|io)")


# ---------------------------------------------------------------------------
# typed disk errors (the degradation contract: never a bare OSError,
# never a hang)
# ---------------------------------------------------------------------------


class DiskFull(RuntimeError):
    """A durable write hit ENOSPC.  The write did not happen (or was
    unwound); the caller sheds or degrades, it never retries blind."""


class DiskIOError(RuntimeError):
    """A durable write failed with a non-ENOSPC IO error (EIO — media
    trouble).  The write was unwound; the artifact is not torn."""


class TenantReadOnly(RuntimeError):
    """The tenant is in read-only mode (log or data disk at its
    budget): writes fail fast, reads keep serving.  Auto-exits once
    utilization drops under the threshold."""


class SpillBudgetExceeded(RuntimeError):
    """The statement's spill would exceed spill_disk_limit_bytes.
    Only this statement dies; the durable surface is untouched."""


def wrap_disk_error(exc: OSError, what: str) -> RuntimeError:
    """Normalize an OSError escaping a durable write into the typed
    plane error (call sites ``raise wrap_disk_error(exc, ...) from
    exc``)."""
    if isinstance(exc, (DiskFull, DiskIOError)):
        return exc  # already typed (nested boundary)
    if getattr(exc, "errno", None) == errno.ENOSPC:
        qmetrics.inc("disk.errors", kind="full")
        return DiskFull(f"{what}: disk full ({exc})")
    qmetrics.inc("disk.errors", kind="io")
    return DiskIOError(f"{what}: io error ({exc})")


def _du(paths: list[str]) -> int:
    """Bytes under ``paths`` (files may vanish mid-walk — compaction,
    checkpoint, spill cleanup — so every stat is best-effort)."""
    total = 0
    for root in paths:
        if root is None:
            continue
        if os.path.isfile(root):
            try:
                total += os.path.getsize(root)
            except OSError:
                pass
            continue
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, f))
                except OSError:
                    pass
    return total


class DiskManager:
    """Per-tenant surface accounting + the pressure state machine.

    ``paths``: surface -> list of dirs/files to account.
    ``reclaim_cb``: called (lock-free) when the log surface crosses the
    utilization threshold — the tenant's aggressive checkpoint + WAL
    recycle.  ``on_readonly``/``on_exit_readonly``: node hooks
    (leadership relinquish / resume)."""

    def __init__(self, config, paths: dict[str, list[str]],
                 reclaim_cb=None, on_readonly=None,
                 on_exit_readonly=None, poll_interval_s: float = 0.2,
                 reclaim_backoff_s: float = 1.0):
        self.config = config
        self.paths = {s: list(paths.get(s) or []) for s in SURFACES}
        self.reclaim_cb = reclaim_cb
        self.on_readonly = on_readonly
        self.on_exit_readonly = on_exit_readonly
        self.poll_interval_s = float(poll_interval_s)
        self.reclaim_backoff_s = float(reclaim_backoff_s)
        self._lock = threading.Lock()
        # only one thread runs the (walk + reclaim) poll at a time; the
        # write hot path skips when a poll is already in flight
        self._poll_mutex = threading.Lock()
        self._last_poll = -1e9       # monotonic
        self._last_reclaim = -1e9    # monotonic
        self._used = {s: 0 for s in SURFACES}
        self.read_only = False
        self.readonly_surface = ""
        self.readonly_entries = 0
        self.readonly_exits = 0
        self.reclaims = 0
        self.write_rejections = 0
        self.spill_rejections = 0
        #: active spill stores: id(store) -> {"bytes", "label"}
        self._spill: dict[int, dict] = {}

    # -- knobs ---------------------------------------------------------
    def limit(self, surface: str) -> int:
        return int(self.config[f"{surface}_disk_limit_bytes"])

    def threshold_pct(self) -> int:
        return int(self.config["log_disk_utilization_threshold"])

    def enabled(self) -> bool:
        return any(self.limit(s) > 0 for s in SURFACES)

    # -- accounting ----------------------------------------------------
    def usage(self, surface: str) -> int:
        with self._lock:
            if surface == "spill":
                return sum(e["bytes"] for e in self._spill.values())
            return self._used[surface]

    def _walk_surface(self, surface: str) -> int:
        used = _du(self.paths[surface])
        with self._lock:
            self._used[surface] = used
        qmetrics.set_gauge("disk.used_bytes", used, surface=surface)
        return used

    def state(self, surface: str) -> str:
        limit = self.limit(surface)
        if self.read_only and self.readonly_surface == surface:
            return "readonly"
        if limit <= 0:
            return "ok"
        used = self.usage(surface)
        if surface == "log":
            thr = limit * self.threshold_pct() // 100
            if used >= thr:
                return "pressure"
        return "full" if used >= limit else "ok"

    # -- the write-path gate (TransService.write choke point) ----------
    def admit_write(self):
        """Fail fast with TenantReadOnly while the tenant is degraded.
        Interval-gated polling on the write path notices budget
        crossings AND drives auto-exit without a node loop — one
        ``time.monotonic()`` read per write when nothing is armed."""
        now = time.monotonic()
        if now - self._last_poll >= self.poll_interval_s:
            self.poll(now=now)
        if self.read_only:
            self.write_rejections += 1
            qmetrics.inc("disk.write_rejections")
            raise TenantReadOnly(
                f"tenant is read-only: {self.readonly_surface} disk at "
                f"{self.usage(self.readonly_surface)}/"
                f"{self.limit(self.readonly_surface)} bytes "
                f"(writes shed, reads keep serving)")

    # -- the poll / state machine --------------------------------------
    def poll(self, now: float | None = None, force: bool = False):
        """Recompute utilization and drive ok -> pressure(reclaim) ->
        read-only -> auto-exit.  Reentrant-safe: a second caller skips
        while a poll is in flight (unless ``force``)."""
        if not self._poll_mutex.acquire(blocking=force):
            return
        try:
            self._last_poll = time.monotonic() if now is None else now
            if not self.enabled():
                if self.read_only:
                    self._exit_readonly()
                return
            log_limit = self.limit("log")
            if log_limit > 0:
                used = self._walk_surface("log")
                thr = max(1, log_limit * self.threshold_pct() // 100)
                if used >= thr and self.reclaim_cb is not None and \
                        time.monotonic() - self._last_reclaim >= \
                        self.reclaim_backoff_s:
                    self._last_reclaim = time.monotonic()
                    with qtrace.span("disk.reclaim", surface="log",
                                     used=used, limit=log_limit) as sp:
                        try:
                            self.reclaim_cb()
                        except Exception:
                            pass  # reclaim is best effort; state below
                        after = self._walk_surface("log")
                        sp.tags["reclaimed"] = max(0, used - after)
                    self.reclaims += 1
                    qmetrics.inc("disk.reclaims")
                    qmetrics.inc("disk.reclaimed_bytes",
                                 max(0, used - after))
                    used = after
                if used >= log_limit:
                    self._enter_readonly("log")
                elif self.read_only and \
                        self.readonly_surface == "log" and used < thr:
                    self._exit_readonly()
            data_limit = self.limit("data")
            if data_limit > 0:
                used = self._walk_surface("data")
                if used >= data_limit:
                    self._enter_readonly("data")
                elif self.read_only and \
                        self.readonly_surface == "data" and \
                        used < data_limit:
                    self._exit_readonly()
            if self.limit("spill") > 0 and self.paths["spill"]:
                qmetrics.set_gauge("disk.used_bytes",
                                   self.usage("spill"), surface="spill")
        finally:
            self._poll_mutex.release()

    def _enter_readonly(self, surface: str):
        if self.read_only:
            return
        self.read_only = True
        self.readonly_surface = surface
        self.readonly_entries += 1
        qmetrics.inc("disk.readonly_entries", surface=surface)
        if self.on_readonly is not None:
            try:
                self.on_readonly(surface)
            except Exception:
                pass  # the hook must never wedge the state machine

    def _exit_readonly(self):
        if not self.read_only:
            return
        self.read_only = False
        self.readonly_surface = ""
        self.readonly_exits += 1
        qmetrics.inc("disk.readonly_exits")
        if self.on_exit_readonly is not None:
            try:
                self.on_exit_readonly()
            except Exception:
                pass

    # -- spill budget (storage/tmpfile.py choke point) -----------------
    def admit_spill(self, nbytes: int, store=None, label: str = ""):
        """Account ``nbytes`` of spill; raises SpillBudgetExceeded when
        the tenant-wide spill budget would be crossed — killing only
        the spilling statement, never the durable surface."""
        limit = self.limit("spill")
        with self._lock:
            live = sum(e["bytes"] for e in self._spill.values())
            if limit > 0 and live + int(nbytes) > limit:
                self.spill_rejections += 1
                pass_total = live + int(nbytes)
            else:
                key = id(store) if store is not None else 0
                e = self._spill.setdefault(
                    key, {"bytes": 0, "label": label})
                e["bytes"] += int(nbytes)
                if label:
                    e["label"] = label
                return
        qmetrics.inc("disk.spill_rejections")
        raise SpillBudgetExceeded(
            f"statement spill would reach {pass_total} bytes "
            f"(spill_disk_limit_bytes={limit}); statement killed, "
            f"durable surface untouched")

    def release_spill(self, store=None, nbytes: int | None = None):
        """Give spill bytes back (run deletion / store close)."""
        key = id(store) if store is not None else 0
        with self._lock:
            e = self._spill.get(key)
            if e is None:
                return
            if nbytes is None or e["bytes"] <= int(nbytes):
                self._spill.pop(key, None)
            else:
                e["bytes"] -= int(nbytes)

    # -- surfaces (gv$disk) --------------------------------------------
    def stats(self, tenant: str = "sys") -> list[dict]:
        rows = []
        for s in SURFACES:
            if s != "spill" and self.paths[s]:
                self._walk_surface(s)  # fresh bytes for gv$disk
            used = self.usage(s)
            limit = self.limit(s)
            rows.append({
                "tenant": tenant, "surface": s, "used_bytes": used,
                "limit_bytes": limit,
                "utilization_pct": (100.0 * used / limit
                                    if limit > 0 else 0.0),
                "state": self.state(s), "detail": "",
            })
        with self._lock:
            spills = [(e["label"], e["bytes"])
                      for e in self._spill.values()]
        for label, nbytes in spills:
            rows.append({
                "tenant": tenant, "surface": "spill_stmt",
                "used_bytes": nbytes, "limit_bytes": self.limit("spill"),
                "utilization_pct": 0.0, "state": "active",
                "detail": label or "",
            })
        return rows
