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
``scrub_interval_s`` (net/node.py runs the loop).

Port of ``oceanbase_tpu/storage/scrub.py``, whole: the local pass,
quarantine, the cross-replica digest vote over ``scrub.checksum``, the
repair from a peer over the chunked rebuild verbs with its parity gate,
and the peer-less repair (rewrite from the engine's resident host
segment arrays).  It drives a node-shaped object (``.engine``,
``.node_id``, ``.peers``; a cluster node's ``NodeServer``, or the
``LocalNode`` that ``local_node`` makes of a single database's tenant).
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from collections import deque
from dataclasses import dataclass

from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.storage.integrity import CorruptionError, table_digest

log = logging.getLogger(__name__)

MAX_EVENTS = 512
#: bounded repair attempts per table per scrub round
REPAIR_RETRIES = 2
#: quiet rounds (local digests unchanged) skip the cross-replica RPC
#: fan-out; a full vote still runs at least every this-many rounds
VOTE_EVERY = 10

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


class ScrubLagging(RuntimeError):
    """Replica has not applied up to the requested point — its digest
    would compare a stale row set (the caller skips it this round)."""


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
    """One node's scrub driver (NodeServer owns it; the ``scrub.run``
    verb and the periodic loop both funnel into ``run_once``)."""

    def __init__(self, node, state: ScrubState | None = None):
        self.node = node
        self.state = state if state is not None \
            else ScrubState(node.node_id)
        # one scrub round at a time: the loop, the scrub.run verb and a
        # test driver may race — later callers skip instead of stacking
        self._run_lock = threading.Lock()
        # logical-digest cache keyed on the tablet's data_version: a
        # quiet table's digest cannot change (every commit / segment
        # swap bumps the version), so steady-state rounds skip the
        # snapshot + hash entirely.  Deliberate trade: rot reaching the
        # RESIDENT arrays without any code path bumping data_version
        # re-hashes only when the table next changes; the disk pass
        # (scrub_verify_table) re-checks files every round regardless.
        self._digest_cache: dict[str, tuple[int, dict]] = {}
        self._cache_lock = threading.Lock()
        # cross-replica vote damping: when the LOCAL digests are
        # byte-identical to the last completed vote, peers can only
        # disagree if THEY rotted — which their own rounds detect — so
        # quiet rounds skip the RPC fan-out and a full vote still runs
        # every VOTE_EVERY rounds as a backstop
        self._last_vote: dict | None = None
        self._rounds_since_vote = 0

    # ------------------------------------------------------------------
    # the scrub.checksum verb (server side — pure read, idempotent)
    # ------------------------------------------------------------------
    def checksum_handler(self, snapshot=None, applied_lsn: int = 0,
                         tables=None):
        """Per-table logical digests of the local replica at
        ``snapshot``.  ``applied_lsn`` is the coordinator's WAL apply
        point when it chose the snapshot: a replica behind it may be
        missing rows visible at the snapshot and must refuse (the
        coordinator skips it this round; a replica AHEAD is fine — the
        MVCC snapshot filter hides newer versions)."""
        node = self.node
        local_lsn = node.palf.replica.applied_lsn
        if local_lsn < int(applied_lsn):
            raise ScrubLagging(
                f"node {node.node_id} applied lsn {local_lsn} < "
                f"{applied_lsn}")
        snap = int(snapshot) if snapshot else node.tx.gts.current()
        names = (list(tables) if tables
                 else sorted(node.engine.tables))
        out = {}
        for name in names:
            if name in SCRUB_SKIP:
                continue
            ts = node.engine.tables.get(name)
            if ts is None:
                continue
            tab = ts.tablet
            ver = tab.data_version
            with self._cache_lock:
                hit = self._digest_cache.get(name)
            # cache validity: nothing changed since compute AND both
            # snapshots cover every commit — visibility is identical
            if hit is not None and hit[0] == ver \
                    and snap >= tab.max_commit_version():
                out[name] = hit[1]
                continue
            arrays, valids = tab.snapshot_arrays(snap)
            d = table_digest(arrays, valids)
            out[name] = d
            if snap >= tab.max_commit_version() \
                    and tab.data_version == ver:
                with self._cache_lock:
                    self._digest_cache[name] = (ver, d)
        return {"node_id": node.node_id, "snapshot": snap,
                "applied_lsn": local_lsn, "tables": out}

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
        where the LOCAL digest lost the majority vote."""
        node = self.node
        peers = getattr(node, "peers", None)
        if not peers:
            return []
        from oceanbase_tpu_torch.net.rpc import RpcError

        lsn = node.palf.replica.applied_lsn
        local = self.checksum_handler()
        self._rounds_since_vote += 1
        if self._last_vote == local["tables"] and \
                self._rounds_since_vote < VOTE_EVERY:
            return []  # quiet: nothing changed since the last vote
        snap = local["snapshot"]
        votes: dict[int, dict] = {node.node_id: local["tables"]}
        health = getattr(node, "health", None)
        for pid in sorted(peers):
            qadmission.checkpoint()  # KILL/deadline between peer votes
            if health is not None and health.state(pid) != "up":
                continue
            try:
                r = peers[pid].call("scrub.checksum", snapshot=snap,
                                    applied_lsn=lsn)
                votes[pid] = r["tables"]
            except (OSError, RpcError):
                continue  # lagging or unreachable: skip this round
        if len(votes) < 2:
            return []
        if node.palf.replica.applied_lsn != lsn:
            # a commit landed mid-round: its entry postdates the lag
            # guard, so replicas could legitimately disagree on its
            # visibility — discard the round (same tear-guard as the
            # DTL exchange) instead of chasing a phantom mismatch
            summary["discarded"] = True
            return []
        self._last_vote = local["tables"]
        self._rounds_since_vote = 0
        minority: list[str] = []
        for name, mine in sorted(local["tables"].items()):
            tally: dict[tuple, int] = {}
            for tabs in votes.values():
                d = tabs.get(name)
                if d is not None:
                    key = (d["rows"], d["crc"])
                    tally[key] = tally.get(key, 0) + 1
            if not tally:
                continue
            best, n_best = max(tally.items(), key=lambda kv: kv[1])
            my_key = (mine["rows"], mine["crc"])
            if my_key == best:
                continue
            summary["mismatch"].append(name)
            if n_best * 2 > sum(tally.values()):
                # a real majority disagrees with us: we are the rot
                minority.append(name)
                qmetrics.inc("scrub.digest_mismatches")
                self.state.record(
                    "mismatch", table=name,
                    mismatches=sum(tally.values()) - n_best,
                    note=f"local={my_key} majority={best}")
            else:
                self.state.record("mismatch", table=name,
                                  note=f"split vote {tally}")
        return minority

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
        """Refetch ``table``'s baseline from a healthy peer: the peer
        checkpoints (rebuild.fetch_meta — its manifest then covers
        every version our segments could hold; any version flushed
        locally was committed, hence replicated, hence below the fresh
        checkpoint's flush horizon), its segment files stream over
        chunked crc-verified rebuild.fetch_segments into a staging dir,
        verify, swap, then digest parity re-checks the result."""
        from oceanbase_tpu_torch.net import rebuild as _rebuild
        from oceanbase_tpu_torch.net.rpc import RpcError
        from oceanbase_tpu_torch.storage.engine import load_manifest

        node = self.node
        health = getattr(node, "health", None)
        t0 = time.monotonic()
        last_err: Exception | None = None
        for pid in sorted(node.peers):
            qadmission.checkpoint()  # KILL/deadline between candidates
            if health is not None and health.state(pid) != "up":
                continue
            cli = node.peers[pid]
            staging = os.path.join(node.root, ".scrub_tmp")
            try:
                with qtrace.span("scrub.repair", table=table, peer=pid):
                    # a peer that is BEHIND us would ship a baseline
                    # missing rows we hold — the post-swap parity gate
                    # below catches that and the retry budget re-runs
                    # against the next candidate
                    meta = cli.call("rebuild.fetch_meta")
                    shutil.rmtree(staging, ignore_errors=True)
                    os.makedirs(staging, exist_ok=True)
                    mpath = os.path.join(staging, "manifest.json")
                    with open(mpath, "wb") as f:
                        f.write(meta.get("manifest", b""))
                    m = load_manifest(mpath)
                    t = m.get("tables", {}).get(table)
                    if t is None:
                        last_err = KeyError(
                            f"peer {pid} has no table {table}")
                        continue
                    crcs = {f["name"]: f.get("crc")
                            for f in meta.get("files", [])}
                    nbytes = 0
                    installed = []
                    for ent in t.get("segments", []):
                        seg_id, level = int(ent[0]), int(ent[1])
                        part = ent[2] if len(ent) > 2 else None
                        rel = os.path.join(
                            "data", "segments", f"{table}_{seg_id}.npz")
                        dst = os.path.join(staging, f"{table}_{seg_id}")
                        nbytes += _rebuild.fetch_file(
                            cli, rel, dst,
                            expect_crc=crcs.get(rel))
                        # chunk/footer crcs verify inside
                        # repair_table_segments' load — no second
                        # decode here (fetch_file already checked the
                        # transfer against the whole-file digest)
                        installed.append({"segment_id": seg_id,
                                          "level": level, "part": part,
                                          "src": dst})
                    node.engine.repair_table_segments(table, installed)
                    node.catalog.invalidate(table)
                    qmetrics.inc("scrub.repairs", source="peer")
                    qmetrics.inc("scrub.repair_bytes", nbytes)
                    # parity gate: repair is only done when the mended
                    # replica agrees with the source again
                    parity = self._parity_with(pid)
                    self.state.record(
                        "repair", table=table, peer=pid,
                        segments=len(installed), nbytes=nbytes,
                        elapsed_s=time.monotonic() - t0,
                        note=f"{reason}; parity={parity}")
                    return parity
            except (OSError, RpcError, CorruptionError) as e:
                last_err = e
                continue
            finally:
                shutil.rmtree(staging, ignore_errors=True)
        if last_err is not None:
            log.warning("scrub: no peer could repair %s: %s",
                        table, last_err)
        return False

    def _parity_with(self, pid: int) -> bool:
        """Post-repair digest comparison against one peer at a fresh
        common snapshot (best-effort: unreachable peer -> False, the
        retry budget re-runs the repair)."""
        from oceanbase_tpu_torch.net.rpc import RpcError

        node = self.node
        local = self.checksum_handler()
        try:
            r = node.peers[pid].call(
                "scrub.checksum", snapshot=local["snapshot"],
                applied_lsn=node.palf.replica.applied_lsn)
        except (OSError, RpcError):
            return False
        theirs = r["tables"]
        ok = all(theirs.get(n) == d for n, d in local["tables"].items()
                 if n in theirs)
        self.state.record("parity", peer=pid,
                          mismatches=0 if ok else 1,
                          note="ok" if ok else "post-repair divergence")
        return ok
