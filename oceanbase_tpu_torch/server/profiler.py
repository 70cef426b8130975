"""Deep device profiling: PROFILE <statement> -> per-kernel rows.

Port of ``oceanbase_tpu/server/profiler.py`` (the SQL plan monitor's
per-operator timing made kernel-real).  ``PROFILE <query>`` runs one
statement under ``torch.profiler.profile`` (CPU activity, plus CUDA
through CUPTI on the card), turns ``key_averages()`` into per-kernel rows
(name, occurrences, total and average time, share of device time) and
stores them keyed by the statement's trace_id, so ``gv$device_profile``
joins against gv$sql_audit and gv$trace.  ``SHOW PROFILE`` renders the
session's most recent capture.  Events are classified as

- ``kernel``  — events timed on the device: CUDA kernels and
  memcpy/memset (their device time is the row's time);
- ``runtime`` — ``cuda*`` API calls, the allocator and ``aten::``
  dispatch with no device time of its own (host self time);
- ``host``    — everything else (python frames, user ranges): dropped,
  gv$trace already covers the host.

On the CPU every operator is ``aten::`` dispatch without device time, so
a capture holds runtime rows only.  The field holding an event's device
time is named differently across torch releases (``device_time_total``/
``self_device_time_total`` from 2.4 on, ``cuda_time_total`` before):
``_device_us`` reads whichever exists.

A capture on the card keeps CUPTI attached after it ends
(``TEARDOWN_CUPTI=0``, torch's own switch, unless the caller set it):
torch's default detaches CUPTI at the end of every capture, and a later
capture in the same process then lost its first kernels, or all of
them (on an H100, ``scripts/torch_profile_repeat.py``).

The statement always executes: a profiler that cannot start yields a
note instead of rows.  One capture per process at a time: concurrent
PROFILEs serialize on a non-blocking lock — the loser runs unprofiled
with a note, it never deadlocks a session.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from dataclasses import dataclass, field

_PROFILE_LOCK = threading.Lock()

#: host-side event names that are runtime machinery, not kernels
_RUNTIME_PREFIXES = ("cuda", "cu", "aten::", "[memory]", "Memcpy",
                     "Memset", "Activity Buffer", "Lazy Function")

MAX_ROWS_PER_PROFILE = 256


@dataclass
class DeviceProfile:
    """One PROFILE capture (joined to the statement by trace_id)."""

    trace_id: str
    sql: str
    backend: str
    ts: float                  # wall clock (record timestamp)
    rows: list = field(default_factory=list)
    note: str = ""


class DeviceProfileStore:
    """Bounded ring of PROFILE captures (the gv$device_profile store)."""

    def __init__(self, capacity: int = 64):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, prof: DeviceProfile):
        with self._lock:
            self._ring.append(prof)

    def recent(self, n: int | None = None) -> list:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-n:]

    def get(self, trace_id: str) -> DeviceProfile | None:
        with self._lock:
            for p in reversed(self._ring):
                if p.trace_id == trace_id:
                    return p
        return None


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def profile_statement(run, cuda: bool = False):
    """Execute ``run()`` under a torch.profiler capture (CUDA activity
    too when ``cuda``).  -> (result, rows, note).

    The statement's own exception always propagates; profiler failures
    never do.  When the profiler cannot even start (another capture in
    flight, no profiler), the statement runs unprofiled."""
    if not _PROFILE_LOCK.acquire(blocking=False):
        return run(), [], "profiler busy (another PROFILE in flight)"
    try:
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
                # read when the capture stops: CUPTI stays attached, so
                # the next capture sees the statement's first kernels
                os.environ.setdefault("TEARDOWN_CUPTI", "0")
            prof = profile(activities=acts)
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 — no profiler here: the
            # statement still runs
            return run(), [], (f"profiler unavailable: "
                               f"{type(e).__name__}: {e}"[:200])
        note = ""
        try:
            out = run()
        finally:
            try:
                prof.__exit__(None, None, None)
            except Exception as e:  # noqa: BLE001
                note = (f"profiler stop failed: "
                        f"{type(e).__name__}: {e}"[:200])
        rows = [] if note else parse_events(prof.key_averages())
        if not rows and not note:
            note = "profiler produced no events"
        return out, rows, note
    finally:
        _PROFILE_LOCK.release()


# ---------------------------------------------------------------------------
# parse
# ---------------------------------------------------------------------------


def _device_us(evt, self_time: bool) -> float:
    """An event's device time in µs under whichever name this torch
    release uses."""
    names = (("self_device_time_total", "self_cuda_time_total")
             if self_time else ("device_time_total", "cuda_time_total"))
    for n in names:
        v = getattr(evt, n, None)
        if v is not None:
            return float(v)
    return 0.0


def _on_device(evt) -> bool:
    dt = getattr(evt, "device_type", None)
    return dt is not None and "CUDA" in str(dt)


def classify(name: str, on_device: bool) -> str:
    if on_device:
        return "kernel"
    if any(name.startswith(p) for p in _RUNTIME_PREFIXES):
        return "runtime"
    return "host"


def parse_events(averages) -> list:
    """``key_averages()`` -> aggregated rows (sorted by total time,
    bounded).  Kernel rows carry device time, runtime rows host self
    time; ``pct`` is a kernel row's share of the capture's kernel
    time."""
    agg: dict[tuple, list] = {}
    for e in averages:
        name = getattr(e, "key", "") or ""
        if not name:
            continue
        dev = _on_device(e)
        kind = classify(name, dev)
        if kind == "host":
            continue
        if kind == "kernel":
            total_s = _device_us(e, self_time=True) * 1e-6
            if total_s <= 0.0:
                total_s = _device_us(e, self_time=False) * 1e-6
            plane = "cuda"
        else:
            total_s = float(getattr(e, "self_cpu_time_total", 0.0)) * 1e-6
            plane = "cpu"
        occ = int(getattr(e, "count", 1) or 1)
        k = (plane, name, kind)
        cur = agg.get(k)
        if cur is None:
            agg[k] = [occ, total_s]
        else:
            cur[0] += occ
            cur[1] += total_s
    kernel_total = sum(v[1] for (_pl, _n, kind), v in agg.items()
                       if kind == "kernel") or 0.0
    rows = []
    for (plane, name, kind), (occ, total) in agg.items():
        rows.append({
            "device": plane, "kernel": name, "kind": kind,
            "occurrences": int(occ), "total_s": total,
            "avg_s": total / occ if occ else 0.0,
            "pct": (100.0 * total / kernel_total
                    if kind == "kernel" and kernel_total > 0 else 0.0)})
    rows.sort(key=lambda r: -r["total_s"])
    return rows[:MAX_ROWS_PER_PROFILE]


def kernel_seconds(rows: list) -> float:
    """Summed device time of a capture's kernel rows."""
    return sum(r["total_s"] for r in rows if r["kind"] == "kernel")


def make_profile(trace_id: str, sql: str, rows: list, note: str = "",
                 backend: str = "cpu") -> DeviceProfile:
    return DeviceProfile(trace_id=trace_id, sql=sql[:200],
                         backend=backend, ts=time.time(), rows=rows,
                         note=note)


__all__ = ["DeviceProfile", "DeviceProfileStore", "classify",
           "kernel_seconds", "make_profile", "parse_events",
           "profile_statement"]
