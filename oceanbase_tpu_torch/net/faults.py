"""Deterministic fault-injection plane for the host RPC layer.

Reference analog: the errsim tracepoint system scoped to the rpc frame
(deps/oblib/src/lib/utility/ob_tracepoint.h) plus the net error
simulation mittest uses to script nemesis schedules (packet loss, delay,
network partition) against a live cluster.  `server/errsim.py` already
covers *local* tracepoints; this plane covers the WIRE: every frame the
rpc client sends and every frame the server receives/replies consults
it, so tests and `scripts/chaos_bench.py` can inject message loss,
latency, partitions, frame corruption, and process crashes — seeded, so
a failing nemesis schedule replays exactly.

One `FaultPlane` instance per node process (NodeServer owns it and
shares it between its `RpcServer` and every peer `RpcClient`); the
`fault.inject` / `fault.clear` admin RPC verbs arm rules remotely.

Rule vocabulary (the actions the consult sites understand):

    drop    send: raise FaultDrop before the frame leaves (the caller
            KNOWS the handler never ran — retry-safe).
            recv: the server silently swallows the request (the caller
            cannot know; it rides its deadline — the lost-request case).
            reply: the handler RAN but the response is swallowed (the
            lost-reply case non-idempotent verbs must never resend).
    reset   like drop, but the connection closes instead of going
            silent — the fast-failure flavor of the same three cases.
    delay   sleep delay_ms before proceeding (slow network / GC pause).
    garble  flip bits in the frame payload (codec-level corruption; the
            receiver must close the desynchronized connection).
    crash   os._exit(137) — a process failure mid-protocol.
    bitflip/truncate (where="disk" only): corrupt a just-persisted file
            in place — ``verb`` names the artifact kind (segment,
            manifest, slog, wal, spill, backup).  The persistence
            boundaries (StorageEngine / PalfReplica) consult
            ``act_disk`` after every durable write, so seeded disk-rot
            schedules replay deterministically against the checksum +
            scrub plane.
    enospc/eio/partial (where="disk" only): write-ERROR injection,
            consulted via ``check_write`` BEFORE/INSIDE the durable
            writers (not after them like the rot rules).  enospc and
            eio raise ``OSError(errno.ENOSPC/EIO)`` with no bytes
            written; partial directs the writer to persist a seeded
            fraction of the batch and THEN fail with ENOSPC — the
            torn-write case the unwind paths (WAL truncate-back,
            tmp+rename) must clean up.  The boundaries normalize the
            OSError into typed DiskFull/DiskIOError
            (server/diskmgr.py).

Matching: verb (None = any), peer node id (None = any; on the client
side the destination, on the server side the sender's ``src`` field),
``where`` in {send, recv, reply}, then prob / nth / count gates.  Each
rule draws from its own `random.Random` seeded off the plane seed and
the rule id, so schedules are reproducible frame-for-frame.

Port of ``oceanbase_tpu/net/faults.py``, whole.  The port's single-node
database consults its disk half (``check_write``, ``act_disk``) at every
persistence boundary — slog, manifest, segments, WAL, temp files,
backup, workload snapshots — once ``Database.arm_disk_faults`` wires a
plane in; the rpc half has no caller until the rpc plane (ROADMAP
Queue 1 item 10) is ported.
"""

from __future__ import annotations

import errno as _errno
import itertools
import os
import random
import threading
import time
from dataclasses import dataclass, field

WHERES = ("send", "recv", "reply", "disk")
ACTIONS = ("drop", "reset", "delay", "garble", "crash",
           "bitflip", "truncate", "enospc", "eio", "partial")

#: post-write rot actions vs pre-write errno actions — both pair only
#: with where="disk" but consult at different boundaries (act_disk
#: after a durable write, check_write before/inside it), so each
#: consult site filters to its own family and the nth/count gates of
#: one family never tick on the other's matches
DISK_ROT_ACTIONS = ("bitflip", "truncate")
DISK_ERRNO_ACTIONS = ("enospc", "eio", "partial")

#: artifact kinds the persistence boundaries report to ``act_disk`` /
#: ``check_write`` (rule.verb matches against these; None = any)
DISK_KINDS = ("segment", "manifest", "slog", "wal", "spill", "backup",
              "workload")


class FaultDrop(ConnectionError):
    """A send-side injected drop: the frame never left the process."""


class FaultReset(ConnectionError):
    """An injected connection reset."""


@dataclass
class FaultRule:
    rule_id: int
    where: str
    action: str
    verb: str | None = None
    peer: int | None = None
    prob: float = 1.0
    nth: int | None = None        # fire on exactly the nth match (1-based)
    count: int = -1               # remaining fire budget (-1 = unlimited)
    delay_ms: float = 0.0
    matched: int = 0
    fired: int = 0
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def to_dict(self) -> dict:
        return {"rule_id": self.rule_id, "where": self.where,
                "action": self.action, "verb": self.verb,
                "peer": self.peer, "prob": self.prob, "nth": self.nth,
                "count": self.count, "delay_ms": self.delay_ms,
                "matched": self.matched, "fired": self.fired}


class FaultPlane:
    """Seeded, process-local rule table consulted on every RPC frame."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: list[FaultRule] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # arming (the nemesis side)
    # ------------------------------------------------------------------
    def inject(self, where: str, action: str, verb: str | None = None,
               peer: int | None = None, prob: float = 1.0,
               nth: int | None = None, count: int = -1,
               delay_ms: float = 0.0, seed: int | None = None) -> int:
        """Install one rule; -> rule id (pass to ``clear``)."""
        if where not in WHERES:
            raise ValueError(f"where must be one of {WHERES}: {where!r}")
        if action not in ACTIONS:
            raise ValueError(
                f"action must be one of {ACTIONS}: {action!r}")
        if action == "garble" and where == "recv":
            # the server consults the plane only after decoding the
            # request, so recv-garble could never corrupt anything —
            # reject instead of silently arming a no-op; corrupt the
            # request with where="send" (client-side) instead
            raise ValueError(
                "garble is not applicable to where='recv'; use "
                "where='send' to corrupt requests")
        disk_only = DISK_ROT_ACTIONS + DISK_ERRNO_ACTIONS
        if (action in disk_only) != (where == "disk"):
            raise ValueError(
                f"{'/'.join(disk_only)} pair only with where='disk' "
                "(persisted-file faults; verb names the artifact kind)")
        if where == "disk" and verb is not None and \
                verb not in DISK_KINDS:
            raise ValueError(
                f"disk fault kind must be one of {DISK_KINDS}: {verb!r}")
        with self._lock:
            rid = next(self._ids)
            rule = FaultRule(
                rule_id=rid, where=where, action=action, verb=verb,
                peer=None if peer is None else int(peer),
                prob=float(prob),
                nth=None if nth is None else int(nth), count=int(count),
                delay_ms=float(delay_ms),
                rng=random.Random(self.seed * 1000003 + rid
                                  if seed is None else int(seed)))
            self._rules.append(rule)
            return rid

    # convenience spellings matching the nemesis vocabulary ------------
    def drop(self, verb: str | None = None, peer: int | None = None,
             prob: float = 1.0, nth: int | None = None,
             where: str = "send", count: int = -1) -> int:
        return self.inject(where, "drop", verb=verb, peer=peer,
                           prob=prob, nth=nth, count=count)

    def delay(self, ms: float, verb: str | None = None,
              peer: int | None = None, prob: float = 1.0,
              where: str = "send") -> int:
        return self.inject(where, "delay", verb=verb, peer=peer,
                           prob=prob, delay_ms=ms)

    def partition(self, peer: int) -> list[int]:
        """Cut all traffic with ``peer`` as seen from THIS node: frames
        to it never leave, frames from it are swallowed on receipt.
        (Install on both sides for a symmetric partition.)"""
        return [self.inject("send", "drop", peer=peer),
                self.inject("recv", "drop", peer=peer)]

    def crash_after(self, n_calls: int, verb: str | None = None,
                    where: str = "recv") -> int:
        """os._exit the process on the (n_calls+1)-th matching frame."""
        return self.inject(where, "crash", verb=verb,
                           nth=int(n_calls) + 1)

    def garble_frame(self, verb: str | None = None, prob: float = 1.0,
                     where: str = "reply", nth: int | None = None) -> int:
        return self.inject(where, "garble", verb=verb, prob=prob,
                           nth=nth)

    def disk(self, action: str, kind: str | None = None,
             nth: int | None = None, count: int = 1,
             prob: float = 1.0, seed: int | None = None) -> int:
        """Arm one persisted-file fault: ``action`` in
        {bitflip, truncate} (post-write rot) or {enospc, eio, partial}
        (pre-write errno), ``kind`` in DISK_KINDS (None = any).
        Defaults to a one-shot (count=1) — media rot, not a firehose."""
        return self.inject("disk", action, verb=kind, nth=nth,
                           count=count, prob=prob, seed=seed)

    def clear(self, rule_id: int | None = None) -> int:
        """Remove one rule (or all when ``rule_id`` is None);
        -> rules removed."""
        with self._lock:
            before = len(self._rules)
            if rule_id is None:
                self._rules.clear()
            else:
                self._rules = [r for r in self._rules
                               if r.rule_id != int(rule_id)]
            return before - len(self._rules)

    def rules(self) -> list[dict]:
        with self._lock:
            return [r.to_dict() for r in self._rules]

    # ------------------------------------------------------------------
    # the consult site (rpc hot path)
    # ------------------------------------------------------------------
    def act(self, where: str, verb: str | None,
            peer: int | None = None,
            payload: bytes | None = None) -> bytes | None:
        """Consult the plane for one frame.  Raises FaultDrop/FaultReset,
        sleeps, crashes, or returns the (possibly garbled) payload.
        The no-rules fast path is one attribute read."""
        if not self._rules:
            return payload
        delays = 0.0
        verdict: str | None = None
        with self._lock:
            for r in self._rules:
                if r.where != where:
                    continue
                if r.verb is not None and r.verb != verb:
                    continue
                if r.peer is not None and r.peer != peer:
                    continue
                r.matched += 1
                if r.nth is not None and r.matched != r.nth:
                    continue
                if r.count == 0:
                    continue
                if r.prob < 1.0 and r.rng.random() >= r.prob:
                    continue
                if r.count > 0:
                    r.count -= 1
                r.fired += 1
                if r.action == "delay":
                    delays += r.delay_ms / 1000.0
                elif verdict is None:
                    verdict = r.action
        if delays > 0.0:
            time.sleep(delays)
        if verdict == "crash":
            os._exit(137)
        if verdict == "drop":
            raise FaultDrop(f"fault: dropped {where} {verb!r}")
        if verdict == "reset":
            raise FaultReset(f"fault: reset {where} {verb!r}")
        if verdict == "garble" and payload is not None:
            return _garble(payload)
        return payload


    # ------------------------------------------------------------------
    # the disk consult site (persistence boundaries: StorageEngine
    # segment/slog/manifest writes, PalfReplica WAL appends)
    # ------------------------------------------------------------------
    def act_disk(self, kind: str, path: str):
        """Consult the plane after ``path`` (an artifact of ``kind``)
        was durably written.  Armed bitflip/truncate rules corrupt the
        just-persisted bytes in place — the deterministic stand-in for
        media rot that the checksum plane must catch on the next read.
        The no-rules fast path is one attribute read."""
        if not self._rules:
            return
        actions: list[tuple[str, random.Random]] = []
        with self._lock:
            for r in self._rules:
                if r.where != "disk" or r.action not in DISK_ROT_ACTIONS:
                    continue
                if r.verb is not None and r.verb != kind:
                    continue
                r.matched += 1
                if r.nth is not None and r.matched != r.nth:
                    continue
                if r.count == 0:
                    continue
                if r.prob < 1.0 and r.rng.random() >= r.prob:
                    continue
                if r.count > 0:
                    r.count -= 1
                r.fired += 1
                actions.append((r.action, r.rng))
        for action, rng in actions:
            if action == "bitflip":
                bitflip_file(path, rng=rng)
            elif action == "truncate":
                truncate_file(path, rng=rng)

    def check_write(self, kind: str, path: str | None = None,
                    nbytes: int | None = None) -> int | None:
        """Consult the plane BEFORE durably writing an artifact of
        ``kind`` (the errno half of the disk plane; the rot half is
        ``act_disk`` after the write).

        - an armed ``enospc``/``eio`` rule raises
          ``OSError(errno.ENOSPC/EIO)`` — no bytes were written;
        - an armed ``partial`` rule returns how many of the batch's
          ``nbytes`` the writer must persist before failing with
          ENOSPC (a seeded fraction in (0, 1) of the batch) — the
          torn-write case; writers that cannot do partial writes (or
          pass no ``nbytes``) get a plain ENOSPC raise instead;
        - no matching rule -> None (proceed).

        The no-rules fast path is one attribute read."""
        if not self._rules:
            return None
        verdict: tuple[str, random.Random] | None = None
        with self._lock:
            for r in self._rules:
                if r.where != "disk" or \
                        r.action not in DISK_ERRNO_ACTIONS:
                    continue
                if r.verb is not None and r.verb != kind:
                    continue
                r.matched += 1
                if r.nth is not None and r.matched != r.nth:
                    continue
                if r.count == 0:
                    continue
                if r.prob < 1.0 and r.rng.random() >= r.prob:
                    continue
                if r.count > 0:
                    r.count -= 1
                r.fired += 1
                if verdict is None:
                    verdict = (r.action, r.rng)
        if verdict is None:
            return None
        action, rng = verdict
        if action == "eio":
            raise OSError(_errno.EIO,
                          f"fault: injected EIO on {kind} write", path)
        if action == "partial" and nbytes is not None and nbytes > 1:
            return max(1, min(nbytes - 1,
                              int(nbytes * rng.uniform(0.1, 0.9))))
        raise OSError(_errno.ENOSPC,
                      f"fault: injected ENOSPC on {kind} write", path)


def bitflip_file(path: str, rng: random.Random | None = None,
                 seed: int = 0) -> int:
    """Flip ONE seeded bit of ``path`` in place; -> the byte offset.
    Offsets draw from the middle 80% of the file so the flip lands in
    payload, not in the first magic bytes (whose corruption is a
    different, already-covered failure mode)."""
    rng = rng if rng is not None else random.Random(seed)
    size = os.path.getsize(path)
    if size == 0:
        return -1
    lo, hi = size // 10, max(size // 10 + 1, size - size // 10)
    off = rng.randrange(lo, hi)
    bit = 1 << rng.randrange(8)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ bit]))
    return off


def truncate_file(path: str, rng: random.Random | None = None,
                  seed: int = 0) -> int:
    """Cut a seeded fraction (5–50%) off the file's tail; -> new size."""
    rng = rng if rng is not None else random.Random(seed)
    size = os.path.getsize(path)
    if size == 0:
        return 0
    keep = max(1, size - max(1, int(size * rng.uniform(0.05, 0.5))))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def _garble(payload: bytes) -> bytes:
    """Deterministically corrupt a frame body: invert a byte span in the
    middle (keeps length, so the length-prefixed framing stays intact —
    the DECODER must notice, exactly like single-bit wire corruption)."""
    if not payload:
        return payload
    b = bytearray(payload)
    lo = len(b) // 3
    hi = min(len(b), lo + 16) or 1
    for i in range(lo, hi):
        b[i] ^= 0xFF
    return bytes(b)
