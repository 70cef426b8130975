"""Length-prefixed TCP RPC: threaded server + pooled client.

Reference analog: the rpc frame (deps/oblib/src/rpc/frame,
ObReqTransport + macro-generated ObRpcProxy stubs).  Here: a small
per-client connection pool, u32-framed codec messages, a method-name
dispatch table on the server, synchronous request/response.

Request body:  {"method": str, "params": {...}, "rid": int, "src": int?}
Response body: {"rid": int, "ok": bool, "result": ... | "error": str}

Robustness plane (≙ ObRpcProxy timeout/retry discipline + the
ObReqTransport error path):

- every verb carries a **policy** (`POLICIES`): a deadline, an
  idempotence bit, and a retry budget.  Idempotent verbs (reads, state
  probes, the prev-lsn/term-checked PALF protocol) get jittered
  exponential backoff inside the deadline; non-idempotent verbs are
  NEVER resent once the request hit the wire — they fail fast at the
  deadline instead of riding a socket timeout.
- calls check out a pooled connection for the round-trip, so a slow bulk
  transfer cannot queue control-plane pings behind it.
- any mid-frame failure (including oversized/garbled frames) closes the
  connection instead of leaving unread bytes to desynchronize the next
  call.
- a `FaultPlane` (net/faults.py), when installed, is consulted on every
  frame in and out — the deterministic chaos hook.

Port of ``oceanbase_tpu/net/rpc.py``, line for line (host code): the
same verbs, policies, frames and metrics.
"""

from __future__ import annotations

import itertools
import random
import select
import socket
import socketserver
import struct
import threading
import time
from dataclasses import dataclass

from oceanbase_tpu_torch.net.codec import decode_msg, encode_msg
from oceanbase_tpu_torch.net.faults import FaultDrop, FaultReset
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import trace as qtrace

_U32 = struct.Struct("<I")
MAX_MSG = 1 << 30

# per-verb wire accounting (host side, recorded at the call/reply
# boundary — the cluster half of gv$sysstat; scripts/metrics_bench.py
# reconciles rpc.bytes against gv$px_exchange)
qmetrics.declare("rpc.calls", "counter",
                 "client calls that returned a decoded reply", )
qmetrics.declare("rpc.failures", "counter",
                 "client calls that terminally failed")
qmetrics.declare("rpc.bytes", "counter",
                 "wire bytes (request+reply frames) of successful calls")
qmetrics.declare("rpc.retries", "counter",
                 "resend attempts (idempotent verbs only)")
qmetrics.declare("rpc.deadline_exceeded", "counter",
                 "calls that died at the verb policy's deadline")
qmetrics.declare("rpc.call_s", "histogram",
                 "per-attempt round-trip latency of successful calls",
                 unit="s")
qmetrics.declare("rpc.served", "counter",
                 "server-side handler invocations")


class RpcError(RuntimeError):
    """Remote handler raised; .kind carries the remote exception type."""

    def __init__(self, kind: str, msg: str):
        super().__init__(f"{kind}: {msg}")
        self.kind = kind


class ProtocolError(RpcError):
    """Frame-level corruption (oversized header, undecodable body).
    The connection is desynchronized and must be closed."""

    def __init__(self, msg: str):
        super().__init__("Protocol", msg)


class DeadlineExceeded(TimeoutError):
    """The verb's deadline elapsed before a reply arrived.  Subclasses
    TimeoutError (hence OSError) so every existing ``except OSError``
    failure path treats it as the network fault it is."""


class ConnPoolExhausted(DeadlineExceeded):
    """Checkout hit the per-peer connection cap (rpc_max_conns_per_peer)
    and no socket freed inside the call's remaining deadline — the
    typed fail-fast for fan-out overload, instead of dialing without
    bound."""


# ---------------------------------------------------------------------------
# per-verb deadline / retry policy table (≙ the proxy stubs' timeout +
# OB_RPC_NEED_RETRY discipline, declared per verb instead of per call site)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VerbPolicy:
    deadline_s: float          # end-to-end budget for the call
    idempotent: bool           # may the request be RESENT after it was sent?
    max_retries: int = 0       # resend budget (idempotent only)
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0


#: Verbs absent from this table get DEFAULT_POLICY: non-idempotent,
#: never resent, 10 s deadline.  Idempotence notes:
#: - reads / state probes are trivially idempotent;
#: - palf.vote: the acceptor grants at most one vote per term and
#:   re-answers the same candidate identically — re-ask is safe;
#: - palf.accept/commit: prev-lsn/term-checked appends and commit-point
#:   advances are idempotent (re-applying is a no-op), the Raft property;
#: - sql.execute carries DML — never resent, the session retries at the
#:   statement layer where NotLeader routing decides.
POLICIES: dict[str, VerbPolicy] = {
    "ping":         VerbPolicy(1.0, True, 2, 0.02, 0.10),
    "node.state":   VerbPolicy(2.0, True, 2, 0.02, 0.20),
    "palf.state":   VerbPolicy(2.0, True, 2, 0.02, 0.20),
    "palf.vote":    VerbPolicy(2.0, True, 1, 0.02, 0.20),
    "palf.accept":  VerbPolicy(10.0, True, 1, 0.05, 0.50),
    "palf.commit":  VerbPolicy(5.0, True, 1, 0.02, 0.20),
    "das.scan":     VerbPolicy(30.0, True, 3, 0.05, 1.00),
    "das.pull":     VerbPolicy(120.0, True, 2, 0.05, 1.00),
    "dtl.execute":  VerbPolicy(120.0, True, 2, 0.10, 2.00),
    # fault.inject MUTATES plane state and mints a fresh rule id per
    # call — a lost-reply resend would double-arm the rule, so it is
    # non-idempotent; clear (remove by id / remove all) re-applies
    # harmlessly
    "fault.inject": VerbPolicy(5.0, False),
    "fault.clear":  VerbPolicy(5.0, True, 2, 0.02, 0.20),
    "cluster.health": VerbPolicy(2.0, True, 2, 0.02, 0.20),
    "recovery.state": VerbPolicy(2.0, True, 2, 0.02, 0.20),
    # rebuild plane (net/rebuild.py): fetch_meta re-checkpoints on
    # resend (harmless — checkpoints are idempotent w.r.t. state) and
    # fetch_segments is a pure ranged read; both carry a retry budget
    # so a wiped node's bootstrap survives transient drops
    "rebuild.fetch_meta":     VerbPolicy(120.0, True, 2, 0.10, 1.00),
    "rebuild.fetch_segments": VerbPolicy(60.0, True, 3, 0.05, 1.00),
    # metrics.scrape is a pure read of monotonic counters — re-asking
    # returns a superset-or-equal snapshot, trivially idempotent
    "metrics.scrape": VerbPolicy(5.0, True, 2, 0.02, 0.20),
    # scrub plane (storage/scrub.py): checksum is a pure snapshot read;
    # run triggers a verify/repair round that CONVERGES — re-running
    # after a lost reply re-verifies already-repaired state, a no-op —
    # so both carry bounded retry budgets
    "scrub.checksum": VerbPolicy(60.0, True, 2, 0.05, 0.50),
    "scrub.run":      VerbPolicy(300.0, True, 1, 0.10, 1.00),
    # disk.takeover asks a peer with log-disk headroom to campaign:
    # elections are idempotent (a re-ask of the winner is a no-op, of a
    # loser another bounded campaign), so a lost reply may retry once
    "disk.takeover":  VerbPolicy(10.0, True, 1, 0.05, 0.50),
    # config.set writes one knob on the SERVING node (≙ ALTER SYSTEM
    # SET ... SERVER=...): re-setting the same value is a no-op, so a
    # lost reply may retry once; the deadline is generous because a
    # disk-budget change force-polls the disk manager, which can run a
    # full reclaim round (checkpoint + WAL recycle) synchronously
    "config.set":     VerbPolicy(30.0, True, 1, 0.05, 0.50),
    # dtl.cancel sets a cancel flag keyed by statement token — setting
    # an already-set flag is a no-op, trivially idempotent; it must
    # fail FAST (the canceller is usually unwinding a kill/timeout)
    "dtl.cancel":   VerbPolicy(2.0, True, 2, 0.02, 0.20),
    # workload.snapshot is a pure read of the node's diagnostic
    # surfaces (monotonic counters + point-in-time state) — re-asking
    # returns a superset-or-equal payload, trivially idempotent like
    # metrics.scrape; the deadline is wider because the payload spans
    # every surface, not one registry
    "workload.snapshot": VerbPolicy(10.0, True, 2, 0.05, 0.50),
    "sql.execute":  VerbPolicy(600.0, False),
}

DEFAULT_POLICY = VerbPolicy(10.0, False)


def verb_policy(method: str) -> VerbPolicy:
    return POLICIES.get(method, DEFAULT_POLICY)


def _recv_exact(sock: socket.socket, n: int,
                deadline: float | None = None) -> bytes | None:
    """``deadline`` (monotonic) makes the read END-TO-END bounded: the
    socket timeout is re-armed with the REMAINING budget before every
    chunk, so a peer trickling bytes cannot keep the call alive by
    resetting a fixed per-recv window each burst."""
    chunks = []
    while n > 0:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("deadline exceeded mid-frame")
            sock.settimeout(remaining)
        b = sock.recv(min(n, 1 << 20))
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _send_frame(sock: socket.socket, payload: bytes):
    sock.sendall(_U32.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket,
                deadline: float | None = None) -> bytes | None:
    hdr = _recv_exact(sock, 4, deadline)
    if hdr is None:
        return None
    (n,) = _U32.unpack(hdr)
    if n > MAX_MSG:
        # unread bytes follow a bogus header — the stream is
        # desynchronized; both consult sites close the connection on
        # ProtocolError so the next call starts on a clean socket
        raise ProtocolError(f"frame too large: {n}")
    return _recv_exact(sock, n, deadline)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                frame = _recv_frame(self.request)
            except ProtocolError:
                return  # desynchronized stream: drop the connection
            except (ConnectionError, OSError):
                return
            if frame is None:
                return
            try:
                msg = decode_msg(frame)
            except Exception:  # noqa: BLE001 — any codec failure
                return  # garbled frame: close, the client reconnects
            rid = msg.get("rid", 0)
            verb = msg.get("method")
            src = msg.get("src")
            faults = self.server.faults
            if faults is not None:
                try:
                    faults.act("recv", verb, src)
                except FaultDrop:
                    continue  # request lost in the network: no reply
                except FaultReset:
                    return
            fn = self.server.handlers.get(verb)
            # full-link trace continuation: a request carrying a trace
            # context runs its handler under a local TraceCtx parented
            # to the caller's rpc span; the spans ship back with the
            # reply (success AND error — a failed handler's timing is
            # exactly what the coordinator wants to attribute)
            tr = msg.get("trace")
            tctx = None
            tsid = 0
            if tr is not None and fn is not None:
                try:
                    tctx = qtrace.TraceCtx(str(tr["tid"]),
                                           node=self.server.node_id)
                    tsid = int(tr.get("sid", 0))
                except (KeyError, TypeError, ValueError):
                    tctx = None  # malformed context degrades tracing,
                    #              never the request itself
            if fn is None:
                resp = {"rid": rid, "ok": False,
                        "error_kind": "NoSuchMethod",
                        "error": str(verb)}
            else:
                try:
                    with qtrace.activate(tctx, tsid):
                        with qtrace.span(str(verb), src=src):
                            result = fn(**(msg.get("params") or {}))
                    resp = {"rid": rid, "ok": True, "result": result}
                    qmetrics.inc("rpc.served", verb=str(verb), ok=1)
                except Exception as e:  # noqa: BLE001 — ship to caller
                    # a handler that FORWARDED (sql.execute routing)
                    # re-raises an RpcError: preserve the original
                    # remote kind across the extra hop instead of
                    # collapsing every typed error to "RpcError"
                    kind = e.kind if isinstance(e, RpcError) \
                        else type(e).__name__
                    resp = {"rid": rid, "ok": False,
                            "error_kind": kind,
                            "error": str(e)}
                    qmetrics.inc("rpc.served", verb=str(verb), ok=0)
                if tctx is not None and tctx.spans:
                    resp["spans"] = [s.to_wire()
                                     for s in tctx.snapshot()]
            payload = encode_msg(resp)
            if faults is not None:
                # the handler RAN by now — a reply fault is the
                # lost-response case non-idempotent verbs must surface
                try:
                    payload = faults.act("reply", verb, src, payload)
                except FaultDrop:
                    continue
                except FaultReset:
                    return
            try:
                _send_frame(self.request, payload)
            except (ConnectionError, OSError):
                return


class RpcServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str, port: int, handlers: dict,
                 faults=None, node_id: int = 0):
        super().__init__((host, port), _Handler)
        self.handlers = dict(handlers)
        self.faults = faults
        self.node_id = node_id  # stamps remote trace spans
        self._thread: threading.Thread | None = None

    def register(self, name: str, fn):
        self.handlers[name] = fn

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.shutdown()
        self.server_close()


class RpcClient:
    """Pooled connections to one peer, checkout/checkin per call.

    Each call owns a connection for exactly its round-trip, so a slow or
    hung bulk transfer (a long ``dtl.execute`` fragment) cannot queue
    control-plane pings or PALF heartbeats behind it.  Failed
    connections are closed, never returned to the pool.

    ``observer`` (optional) receives per-call outcomes — the failure
    detector's signal source: record_success(rtt_s) / record_failure() /
    record_retry() / record_deadline().
    """

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 peer_id: int | None = None, local_id: int | None = None,
                 faults=None, observer=None, pool_size: int = 4,
                 max_conns: int = 16):
        self.addr = (host, port)
        self.timeout_s = timeout_s  # connect timeout + policy fallback
        self.peer_id = peer_id
        self.local_id = local_id
        self.faults = faults
        self.observer = observer
        self._pool: list[socket.socket] = []   # idle; MRU at the end
        self._pool_size = pool_size            # idle cap (LRU closes)
        self._max_conns = max(max_conns, 1)    # live cap (idle+in-use)
        self._conns = 0                        # live sockets accounted
        self._rid = itertools.count(1)
        # guards pool list + live-socket count; waiters park on it when
        # checkout hits the live cap
        self._lock = threading.Condition()

    # -- pool ----------------------------------------------------------
    def _discard(self, s: socket.socket):
        """Close a socket this client accounted for (failure paths, LRU
        eviction) and wake a capped-out checkout waiter."""
        try:
            s.close()
        except OSError:
            pass
        with self._lock:
            self._conns = max(self._conns - 1, 0)
            self._lock.notify()

    def _checkout(self, timeout: float) -> socket.socket:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                s = self._pool.pop() if self._pool else None
                if s is None:
                    if self._conns < self._max_conns:
                        # reserve the live-cap seat before the (slow,
                        # unlocked) dial; released on dial failure
                        self._conns += 1
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ConnPoolExhausted(
                            f"{self.addr}: {self._max_conns} "
                            f"connections busy, none freed inside "
                            f"{timeout:.3f}s")
                    self._lock.wait(timeout=min(remaining, 0.05))
                    continue
            # an idle request/response socket should never be readable;
            # readable means the peer closed it (or sent garbage) while
            # pooled — discard instead of letting a doomed send turn
            # into a spurious "may have executed" on non-idempotent work
            r, _, _ = select.select([s], [], [], 0)
            if not r:
                s.settimeout(timeout)
                return s
            self._discard(s)
        try:
            s = socket.create_connection(
                self.addr, timeout=min(timeout, self.timeout_s))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except BaseException:
            with self._lock:
                self._conns = max(self._conns - 1, 0)
                self._lock.notify()
            raise
        s.settimeout(timeout)
        return s

    def _checkin(self, s: socket.socket):
        extras: list[socket.socket] = []
        with self._lock:
            self._pool.append(s)
            # idle cap: close the LEAST-recently-used extras (index 0),
            # keeping the warm end of the pool
            while len(self._pool) > max(self._pool_size, 0):
                extras.append(self._pool.pop(0))
                self._conns = max(self._conns - 1, 0)
            self._lock.notify()
        for e in extras:
            try:
                e.close()
            except OSError:
                pass

    # -- calls ---------------------------------------------------------
    def call(self, method: str, _deadline_s: float | None = None,
             **params):
        return self.call_with_size(method, _deadline_s=_deadline_s,
                                   **params)[0]

    def call_with_size(self, method: str,
                       _deadline_s: float | None = None, **params):
        """Like call(), but also returns the wire cost:
        -> (result, sent_bytes, recv_bytes).

        ``_deadline_s`` overrides the verb policy's deadline (the
        heartbeat loop probes with a budget tied to its own period)."""
        pol = verb_policy(method)
        deadline_s = pol.deadline_s if _deadline_s is None \
            else float(_deadline_s)
        t0 = time.monotonic()
        deadline = t0 + deadline_s
        body = {"method": method, "params": params,
                "rid": next(self._rid)}
        if self.local_id is not None:
            body["src"] = self.local_id
        # full-link tracing: one client span covers the whole call
        # (retries included — the backoff IS the latency being traced);
        # the context rides the frame so the peer continues the tree
        tctx = qtrace.current()
        tspan = None
        if tctx is not None:
            tspan = qtrace.begin_span(
                tctx, "rpc." + str(method), qtrace.current_span_id(),
                peer=self.peer_id if self.peer_id is not None else -1)
            body["trace"] = {"tid": tctx.trace_id, "sid": tspan.span_id}
        req = encode_msg(body)
        obs = self.observer
        try:
            return self._call_loop(method, req, pol, deadline,
                                   deadline_s, obs, tctx, tspan)
        except BaseException as e:
            if tspan is not None:
                tspan.tags["error"] = type(e).__name__
            raise
        finally:
            if tspan is not None:
                qtrace.end_span(tctx, tspan)

    def _call_loop(self, method, req, pol, deadline, deadline_s,
                   obs, tctx, tspan):
        attempt = 0
        while True:
            sent_ok = False
            conn: socket.socket | None = None
            a0 = time.monotonic()  # per-ATTEMPT rtt (a success after
            #                        retries must not fold the failed
            #                        attempts' backoff into the ewma)
            try:
                payload = req
                if self.faults is not None:
                    # consult BEFORE computing the remaining budget: an
                    # injected delay must burn the deadline like real
                    # network latency would
                    payload = self.faults.act(
                        "send", method, self.peer_id, payload) or req
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise DeadlineExceeded(
                        f"{method} to {self.addr}: deadline "
                        f"{deadline_s:.3f}s exceeded")
                conn = self._checkout(remaining)
                _send_frame(conn, payload)
                sent_ok = True
                frame = _recv_frame(conn, deadline)
                if frame is None:
                    raise ConnectionError(f"peer {self.addr} closed")
                try:
                    resp = decode_msg(frame)
                except Exception as e:  # noqa: BLE001 — codec failure
                    raise ProtocolError(f"undecodable reply: {e}") from e
                self._checkin(conn)
                conn = None
                rtt = time.monotonic() - a0
                if obs is not None:
                    obs.record_success(rtt)
                sent = len(req) + 4
                recv = len(frame) + 4
                qmetrics.inc("rpc.calls", verb=method)
                qmetrics.inc("rpc.bytes", sent + recv, verb=method)
                qmetrics.observe("rpc.call_s", rtt, verb=method)
                if tspan is not None:
                    tspan.tags["retries"] = attempt
                    tspan.tags["bytes"] = sent + recv
                    rspans = resp.get("spans")
                    if rspans:
                        # the remote half of the tree (parented under
                        # this span via the sid we sent)
                        qtrace.absorb(tctx, rspans)
                if not resp.get("ok"):
                    # the handler ran and raised — a remote APPLICATION
                    # error, deterministic on resend: never retried here
                    raise RpcError(resp.get("error_kind", "Remote"),
                                   resp.get("error", ""))
                return resp.get("result"), sent, recv
            except (ConnectionError, OSError, ProtocolError) as e:
                # any mid-frame failure leaves the stream unusable:
                # close it (never back to the pool) so the next attempt
                # reconnects cleanly
                if conn is not None:
                    self._discard(conn)
                now = time.monotonic()
                if tspan is not None:
                    # failed attempts must still attribute their retry
                    # count — a terminal raise skips the success-path
                    # tagging (the last failing attempt is `attempt`)
                    tspan.tags["retries"] = attempt
                timed_out = isinstance(e, (socket.timeout,
                                           DeadlineExceeded)) \
                    or now >= deadline
                if obs is not None:
                    obs.record_failure()
                    if timed_out:
                        obs.record_deadline()
                # a request that never hit the wire is always safe to
                # retry; once SENT, only policy-declared idempotent
                # verbs may be resent (the reply may be the lost frame)
                may_retry = (not sent_ok) or pol.idempotent
                if not may_retry or attempt >= max(pol.max_retries, 1):
                    self._count_terminal(method, e, now, deadline)
                    err = self._at_deadline(e, method, now, deadline,
                                            deadline_s)
                    # whether the request hit the wire before dying:
                    # callers with their own retry ladders must not
                    # resend a non-idempotent verb once this is True
                    err.request_sent = sent_ok
                    raise err
                backoff = min(pol.backoff_base_s * (2 ** attempt),
                              pol.backoff_cap_s)
                backoff *= 0.5 + random.random()  # full jitter
                if now + backoff >= deadline:
                    self._count_terminal(method, e, now, deadline)
                    err = self._at_deadline(e, method, now, deadline,
                                            deadline_s)
                    err.request_sent = sent_ok
                    raise err
                time.sleep(backoff)
                attempt += 1
                qmetrics.inc("rpc.retries", verb=method)
                if obs is not None:
                    obs.record_retry()

    @staticmethod
    def _count_terminal(method: str, e: Exception, now: float,
                        deadline: float):
        qmetrics.inc("rpc.failures", verb=method)
        if isinstance(e, (socket.timeout, DeadlineExceeded)) \
                or now >= deadline:
            qmetrics.inc("rpc.deadline_exceeded", verb=method)

    def _at_deadline(self, e: Exception, method: str, now: float,
                     deadline: float, deadline_s: float) -> Exception:
        """Normalize a terminal failure: past the deadline every error
        becomes DeadlineExceeded (fail fast, one kind to handle)."""
        if isinstance(e, DeadlineExceeded):
            return e
        if now >= deadline or isinstance(e, socket.timeout):
            exc = DeadlineExceeded(
                f"{method} to {self.addr}: deadline "
                f"{deadline_s:.3f}s exceeded ({e})")
            exc.__cause__ = e
            return exc
        return e

    def ping(self, _deadline_s: float | None = None) -> bool:
        try:
            return self.call("ping", _deadline_s=_deadline_s) == "pong"
        except (OSError, RpcError):
            return False

    def close(self):
        """Drop every pooled connection (the client stays usable — the
        next call dials fresh, matching the old reconnect semantics)."""
        with self._lock:
            pool, self._pool = self._pool, []
            self._conns = max(self._conns - len(pool), 0)
            self._lock.notify_all()
        for s in pool:
            try:
                s.close()
            except OSError:
                pass
