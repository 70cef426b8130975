"""CDC: change-data-capture over the replicated WAL.

Reference analog: libobcdc (src/logservice/libobcdc) + cdcservice — a
pull-based pipeline turning committed log entries into ordered row-change
events.  Here the consumer polls the PALF leader's committed range,
buffers redo per transaction, and emits events at each commit record in
commit order (aborted transactions never surface).

Port of ``oceanbase_tpu/cdc.py``, line for line (host code over the
in-process WAL's committed range).
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass
class ChangeEvent:
    table: str
    op: str                 # insert | update | delete
    key: tuple
    values: dict
    commit_version: int
    tx_id: int
    lsn: int                # commit record's LSN


class CdcPump:
    """One consumer's cursor over a tenant's WAL (≙ obcdc instance)."""

    def __init__(self, tenant):
        self.tenant = tenant
        self.next_lsn = 0
        self._pending: dict[int, list] = {}

    def poll(self, max_events: int | None = None) -> list[ChangeEvent]:
        wal = self.tenant.wal
        ldr = wal.replicas[wal.leader_id]
        committed = ldr.committed_lsn
        out: list[ChangeEvent] = []
        if self.next_lsn < ldr.base_lsn:
            # WAL recycle dropped entries this cursor never consumed:
            # they were applied + checkpointed long ago — a consumer
            # this stale resumes at the recycle point (≙ obcdc falling
            # back to the archive when the online log is recycled)
            self.next_lsn = ldr.base_lsn
        while self.next_lsn < committed:
            e = ldr.entries[self.next_lsn - ldr.base_lsn]
            self.next_lsn += 1
            try:
                rec = json.loads(e.payload.decode())
            except Exception:
                continue
            op = rec.get("op")
            if op == "redo":
                self._pending.setdefault(rec["tx"], []).append(rec)
            elif op == "commit":
                for r in self._pending.pop(rec["tx"], []):
                    out.append(ChangeEvent(
                        table=r["table"], op=r["kind"],
                        key=tuple(r["key"]), values=r["values"],
                        commit_version=rec["version"], tx_id=rec["tx"],
                        lsn=e.lsn))
            elif op == "abort":
                self._pending.pop(rec["tx"], None)
            if max_events is not None and len(out) >= max_events:
                break
        return out
