"""Execution diagnostics lane: overflow accounting without host syncs.

Port of ``oceanbase_tpu/exec/diag.py``.  Operators with a static capacity
(join expansion, group-by output, strict compaction) push the number of
rows they had to drop as a DEVICE scalar into the active collector; the
executor sums the lanes into one device scalar and reads it once at the
result boundary, raising ``CapacityOverflow`` instead of returning a
truncated result.  The per-operator monitor lane (``monitor_push``)
collects each monitored operator's live-row count the same way, as a
device scalar the executor stacks with the overflow lanes.  Nothing here
reads a tensor on the host.
"""

from __future__ import annotations

import contextlib
import contextvars

_collector: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "ob_torch_diag", default=None
)


@contextlib.contextmanager
def collect():
    """Activate a collector; yields the list the pushed lanes land in."""
    entries: list[tuple[str, object, int | None]] = []
    tok = _collector.set(entries)
    try:
        yield entries
    finally:
        _collector.reset(tok)


def push(name: str, scalar, capacity: int | None = None) -> None:
    """Record an overflow device scalar (no-op outside a collector).

    ``capacity`` is the operator's static budget, reported beside the
    dropped count so a retry can jump straight to a sufficient budget."""
    entries = _collector.get()
    if entries is not None:
        entries.append((name, scalar, capacity))


class CapacityOverflow(RuntimeError):
    """Raised by the executor when an operator exceeded its static
    capacity; callers re-plan with a larger budget.

    ``drops`` holds ``(lane_name, static_capacity_or_None, rows_dropped)``
    per overflowing lane, as in the JAX package."""

    def __init__(self, msg: str, drops: list | None = None):
        super().__init__(msg)
        self.drops = drops or []


# ---------------------------------------------------------------------------
# per-operator monitor lane (≙ op_monitor_info_ row counts,
# src/sql/engine/ob_operator.cpp:1534): operators report their live-row
# output as device scalars the executor reads with the overflow lanes.
# ---------------------------------------------------------------------------

_monitor: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "ob_torch_monitor", default=None
)


@contextlib.contextmanager
def monitor_collect():
    entries: list[tuple[str, object, object]] = []
    tok = _monitor.set(entries)
    try:
        yield entries
    finally:
        _monitor.reset(tok)


def monitor_collecting() -> bool:
    """Is a monitor collector active (so a lane would be kept)?"""
    return _monitor.get() is not None


def monitor_push(op_name: str, count_scalar, est: int | None = None) -> None:
    """Record one operator's live-row output device scalar plus the
    optimizer's static cardinality estimate for it (None = unknown)."""
    entries = _monitor.get()
    if entries is not None:
        entries.append((op_name, est, count_scalar))
