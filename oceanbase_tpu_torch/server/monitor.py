"""Live session registry.

Port of the session registry of ``oceanbase_tpu/server/monitor.py``'s
``AshSampler`` (≙ the ASH task's view of live sessions): every session
of a ``Database`` registers a mutable state slot (``active``, ``sql``,
``state``) that its statements update and SHOW PROCESSLIST and KILL
read.  The reference's sampling thread and its bounded history, and the
rest of that module (SQL audit, plan monitor, wait events, the time
model), wait for ROADMAP Queue 1 item 9, the measurement plane.
"""

from __future__ import annotations

import threading


class AshSampler:
    """Registered session states (the reference's sampler without its
    sampling thread)."""

    def __init__(self):
        self._sessions: dict[int, dict] = {}
        self._lock = threading.Lock()

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


__all__ = ["AshSampler"]
