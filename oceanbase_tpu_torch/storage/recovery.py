"""Recovery bookkeeping: what a node did to come back.

Port of ``oceanbase_tpu/storage/recovery.py`` with its ``recovery.*``
metrics; ``gv$recovery`` serves ``Tenant.recovery.rows()``.  The port
records ``boot_replay``, ``restore_prepared``, ``checkpoint`` and
``quarantine``; ``rebuild`` and ``catchup`` belong to the multi-node
plane (``net/rebuild.py``).

Reference analog: the HA dag-net progress the reference surfaces for
replica rebuild/migration (src/storage/high_availability/
ob_storage_ha_dag.h, __all_virtual_ls_restore_progress) — here one
bounded event log per tenant/node feeding the ``gv$recovery`` virtual
table.

Phases recorded:

- ``boot_replay``    slog/checkpoint restore + palf WAL tail replay at
                     process start (wal_start_lsn..wal_end_lsn, entry /
                     commit counters);
- ``restore_prepared`` XA branches reconstructed into PREPARE state
                     (durable XA — the branches XA RECOVER reports);
- ``rebuild``        wiped-replica bootstrap over ``rebuild.fetch_meta``
                     / ``rebuild.fetch_segments`` (peer, files, bytes);
- ``checkpoint``     periodic replay-point advance (the O(tail) bound);
- ``catchup``        live row: local apply point vs the group commit
                     point (appended by the gv$recovery provider);
- ``quarantine``     corrupt persisted artifacts moved aside (bad-magic
                     WAL files in palf/log.py — retention-capped by
                     count/age — and digest-failing manifest/slog pairs
                     in net/rebuild.py::quarantine_corrupt_baseline).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from oceanbase_tpu_torch.server import metrics as qmetrics

MAX_EVENTS = 256

qmetrics.declare("recovery.events", "counter",
                 "recovery-plane events (label: phase)")
qmetrics.declare("recovery.entries", "counter",
                 "WAL entries replayed/shipped by recovery events")
qmetrics.declare("recovery.bytes", "counter",
                 "bytes moved by recovery events (rebuild fetches)")


class RecoveryState:
    """Bounded per-node/tenant recovery event log (thread-safe)."""

    def __init__(self, node_id: int = 0, max_events: int = MAX_EVENTS):
        self.node_id = node_id
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()

    def record(self, phase: str, *, tenant: str = "sys", peer: int = -1,
               wal_start_lsn: int = 0, wal_end_lsn: int = 0,
               entries: int = 0, nbytes: int = 0, prepared: int = 0,
               xids: str = "", elapsed_s: float = 0.0, note: str = ""):
        ev = {"ts": time.time(), "node_id": self.node_id,
              "tenant": tenant, "phase": phase, "peer": peer,
              "wal_start_lsn": int(wal_start_lsn),
              "wal_end_lsn": int(wal_end_lsn),
              "entries": int(entries), "bytes": int(nbytes),
              "prepared": int(prepared), "xids": xids,
              "elapsed_s": float(elapsed_s), "note": note}
        with self._lock:
            self._events.append(ev)
        qmetrics.inc("recovery.events", phase=phase)
        if entries:
            qmetrics.inc("recovery.entries", int(entries), phase=phase)
        if nbytes:
            qmetrics.inc("recovery.bytes", int(nbytes), phase=phase)
        return ev

    def rows(self) -> list[dict]:
        with self._lock:
            return list(self._events)
