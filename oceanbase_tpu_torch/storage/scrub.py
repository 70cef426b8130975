"""Background scrub plane: continuous local re-verification plus
cross-replica logical checksums, with automatic quarantine + repair.

Reference analog: the medium compaction checker re-reading macro blocks
against their checksums plus the replica-checksum verification at major
freeze (src/storage/ob_sstable_struct.h ObSSTableColumnChecksum — all
replicas of a tablet must agree on column checksums before a major
version is published).  Here:

1. **Local pass** — every persisted segment file is re-read FROM DISK
   and its chunk/footer crc64s verified (`StorageEngine.
   scrub_verify_table`).  The resident copy may be healthy while the
   disk bytes rot; a corrupt file quarantines (moved aside, recorded)
   while the resident segment keeps serving — no missing-row window.
2. **Cross-replica pass** — every replica hashes each table's rows at
   one common snapshot into an order/layout-independent digest
   (`integrity.table_digest`; replicas flush on their own schedules, so
   their segment FILES legitimately differ) over the idempotent
   ``scrub.checksum`` verb.  Majority wins: a local minority digest
   marks the table for repair; a split vote only reports.
3. **Repair** — a quarantined-at-boot, scrub-detected, or
   minority-mismatch table refetches a freshly checkpointed peer
   baseline over the chunked ``rebuild.fetch_meta`` /
   ``rebuild.fetch_segments`` verbs (every chunk + file crc-verified,
   staged, `Segment.load`-verified) and swaps atomically
   (`StorageEngine.repair_table_segments`), then re-verifies digest
   parity against the peer — detect → quarantine → repair → parity
   with no operator in the loop.  Single-node fallback: rewrite from
   the healthy resident copy.

Surfaces: ``gv$scrub`` rows per event, ``scrub.*`` metrics,
``scrub.verify`` trace spans.  Knobs: ``enable_scrub`` /
``scrub_interval_s`` (a cluster node runs the loop).

Port of ``oceanbase_tpu/storage/scrub.py`` for the single node: the
local pass, quarantine and the peer-less repair (rewrite from the
engine's resident host segment arrays) run as in the reference, over a
node-shaped object (``.engine``, ``.node_id``, optional ``.peers``;
``local_node`` makes one of a tenant).  The cross-replica pass, the
peer refetch and the parity check need the rpc plane and raise
``NotImplementedError`` naming ROADMAP Queue 1 item 10 when peers are
given.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.storage.integrity import CorruptionError

log = logging.getLogger(__name__)

MAX_EVENTS = 512
#: bounded repair attempts per table per scrub round
REPAIR_RETRIES = 2

qmetrics.declare("scrub.runs", "counter", "scrub rounds completed")
qmetrics.declare("scrub.segments_verified", "counter",
                 "persisted segments re-read + checksum-verified")
qmetrics.declare("scrub.bytes_verified", "counter",
                 "persisted bytes re-read by the local pass")
qmetrics.declare("scrub.corruptions", "counter",
                 "local checksum failures detected (label: kind)")
qmetrics.declare("scrub.digest_mismatches", "counter",
                 "tables where this replica's logical digest lost the "
                 "cross-replica majority vote")
qmetrics.declare("scrub.repairs", "counter",
                 "table segment-set repairs completed (label: source)")
qmetrics.declare("scrub.repair_bytes", "counter",
                 "bytes fetched from peers by scrub repairs")
qmetrics.declare("scrub.repair_failures", "counter",
                 "repair attempts that exhausted their retry budget")
qmetrics.declare("scrub.verify_s", "histogram",
                 "whole scrub-round wall time", unit="s")


_PEERS = "ROADMAP Queue 1 item 10 (the rpc plane: net/rpc, net/rebuild)"


@dataclass
class LocalNode:
    """The node-shaped view of one tenant the single-node scrubber
    drives: its engine and catalog, no peers."""

    engine: object
    catalog: object
    node_id: int = 0
    peers: dict | None = None


def local_node(tenant, node_id: int = 0) -> LocalNode:
    return LocalNode(tenant.engine, tenant.catalog, node_id)


#: tables whose content is NODE-LOCAL by design (materialized lazily by
#: a session, never WAL-replicated) — replicas legitimately disagree on
#: them, so the cross-replica vote must not compare them
SCRUB_SKIP = {"__dual__"}


class ScrubState:
    """Bounded per-node scrub event log feeding gv$scrub."""

    def __init__(self, node_id: int = 0, max_events: int = MAX_EVENTS):
        self.node_id = node_id
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()

    def record(self, phase: str, *, table: str = "", segments: int = 0,
               nbytes: int = 0, peer: int = -1, mismatches: int = 0,
               elapsed_s: float = 0.0, note: str = ""):
        ev = {"ts": time.time(), "node_id": self.node_id, "table": table,
              "phase": phase, "segments": int(segments),
              "bytes": int(nbytes), "peer": int(peer),
              "mismatches": int(mismatches),
              "elapsed_s": float(elapsed_s), "note": note}
        with self._lock:
            self._events.append(ev)
        return ev

    def rows(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def last(self, phase: str) -> dict | None:
        with self._lock:
            for ev in reversed(self._events):
                if ev["phase"] == phase:
                    return ev
        return None


class Scrubber:
    """One node's scrub runner (``Database.scrubber()`` makes one over a
    tenant; a cluster node's ``scrub.run`` verb and periodic loop both
    funnel into ``run_once``)."""

    def __init__(self, node, state: ScrubState | None = None):
        self.node = node
        self.state = state if state is not None \
            else ScrubState(node.node_id)
        # one scrub round at a time: the loop, the scrub.run verb and a
        # test may race — later callers skip instead of stacking
        self._run_lock = threading.Lock()

    # ------------------------------------------------------------------
    # one scrub round
    # ------------------------------------------------------------------
    def run_once(self) -> dict:
        if not self._run_lock.acquire(blocking=False):
            return {"skipped": "scrub already running"}
        try:
            return self._run_locked()
        finally:
            self._run_lock.release()

    def _run_locked(self) -> dict:
        node = self.node
        m0 = time.monotonic()
        summary = {"node_id": node.node_id, "tables": 0, "segments": 0,
                   "bytes": 0, "corrupt": [], "mismatch": [],
                   "repaired": [], "failed": [], "discarded": False}
        with qtrace.span("scrub.verify", node=node.node_id) as sp:
            need_repair: dict[str, str] = {}  # table -> reason
            # segments quarantined at boot wait for the first round
            for q in list(node.engine.quarantined):
                need_repair.setdefault(q["table"], "boot_quarantine")
            # ---- local pass: re-read + verify every persisted segment
            for name in sorted(node.engine.tables):
                r = node.engine.scrub_verify_table(name)
                summary["tables"] += 1
                summary["segments"] += r["checked"]
                summary["bytes"] += r["bytes"]
                for seg_id in r["corrupt"]:
                    summary["corrupt"].append([name, seg_id])
                    need_repair.setdefault(name, "checksum")
                    qmetrics.inc("scrub.corruptions", kind="segment")
                    self.state.record("quarantine", table=name,
                                      segments=1,
                                      note=f"segment {seg_id} checksum")
            qmetrics.inc("scrub.segments_verified", summary["segments"])
            qmetrics.inc("scrub.bytes_verified", summary["bytes"])
            # ---- cross-replica pass: logical digests, majority wins
            mism = self._cross_replica_pass(summary)
            for name in mism:
                need_repair.setdefault(name, "digest_minority")
            # ---- repair: quarantined / corrupt / minority tables
            for name, reason in sorted(need_repair.items()):
                qadmission.checkpoint()  # KILL/deadline between repairs
                ok = False
                for _attempt in range(REPAIR_RETRIES):
                    if self._repair_table(name, reason):
                        ok = True
                        break
                if ok:
                    summary["repaired"].append(name)
                else:
                    summary["failed"].append(name)
                    qmetrics.inc("scrub.repair_failures")
                    self.state.record("error", table=name,
                                      note=f"repair failed ({reason})")
            elapsed = time.monotonic() - m0
            sp.tags.update(tables=summary["tables"],
                           segments=summary["segments"],
                           corrupt=len(summary["corrupt"]),
                           repaired=len(summary["repaired"]))
            self.state.record(
                "verify", segments=summary["segments"],
                nbytes=summary["bytes"],
                mismatches=len(summary["corrupt"])
                + len(summary["mismatch"]),
                elapsed_s=elapsed,
                note=(f"tables={summary['tables']}"
                      + (" discarded" if summary["discarded"] else "")))
        qmetrics.inc("scrub.runs")
        qmetrics.observe("scrub.verify_s", elapsed)
        summary["elapsed_s"] = elapsed
        return summary

    def _cross_replica_pass(self, summary: dict) -> list[str]:
        """Compare per-table logical digests across replicas; -> tables
        where the LOCAL digest lost the majority vote.  A single node
        has no replicas to vote with."""
        if not getattr(self.node, "peers", None):
            return []
        raise NotImplementedError(
            f"the cross-replica scrub vote waits for {_PEERS}")

    # ------------------------------------------------------------------
    # repair
    # ------------------------------------------------------------------
    def _repair_table(self, table: str, reason: str) -> bool:
        node = self.node
        peers = getattr(node, "peers", None) or {}
        if table in SCRUB_SKIP:
            peers = {}  # node-local content: peers are no authority
        if peers:
            try:
                return self._repair_from_peer(table, reason)
            except (OSError, CorruptionError, KeyError, ValueError) as e:
                log.warning("scrub: peer repair of %s failed: %s",
                            table, e)
                return False
        # single node: no peer to refetch from — rewrite quarantined
        # segments from their healthy resident copies when possible
        fixed = 0
        for q in [q for q in list(node.engine.quarantined)
                  if q["table"] == table]:
            if node.engine.rewrite_segment_from_memory(
                    table, q["segment_id"]):
                fixed += 1
        if fixed:
            qmetrics.inc("scrub.repairs", source="local-memory")
            self.state.record("repair", table=table, segments=fixed,
                              note="rewritten from resident copy")
        return fixed > 0 or not any(
            q["table"] == table for q in node.engine.quarantined)

    def _repair_from_peer(self, table: str, reason: str) -> bool:
        """Refetch ``table``'s baseline from a healthy peer over the
        chunked, crc-verified rebuild verbs, swap it in
        (``StorageEngine.repair_table_segments``) and re-check digest
        parity with the peer."""
        raise NotImplementedError(
            f"scrub repair from a peer waits for {_PEERS}")
