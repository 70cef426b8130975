"""Global timestamp service (GTS).

A copy of ``oceanbase_tpu/tx/gts.py``: a counter, so a single-threaded
script draws the same timestamps in both packages.

Reference analog: the per-tenant centralized timestamp service with local
caching (src/storage/tx/ob_gts_source.h, ob_timestamp_service.h).  The
reference persists GTS epochs through Paxos; here the monotonic source can
be seeded from the replicated log's recovery point so timestamps never go
backwards across restarts.
"""

from __future__ import annotations

import threading


class GTS:
    def __init__(self, start: int = 1):
        self._ts = start
        self._lock = threading.Lock()

    def get_ts(self) -> int:
        """Strictly monotonic timestamp (≙ gts acquisition for snapshots
        and commit versions)."""
        with self._lock:
            self._ts += 1
            return self._ts

    def current(self) -> int:
        with self._lock:
            return self._ts

    def advance_to(self, ts: int):
        """Never-go-back seeding on recovery."""
        with self._lock:
            self._ts = max(self._ts, ts)
