"""Execution diagnostics lane: overflow accounting without host syncs.

Port of ``oceanbase_tpu/exec/diag.py``.  Operators with a static capacity
(join expansion, group-by output, strict compaction) push the number of
rows they had to drop as a DEVICE scalar into the active collector; the
executor sums the lanes into one device scalar and reads it once at the
result boundary, raising ``CapacityOverflow`` instead of returning a
truncated result.  Nothing here reads a tensor on the host.
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
