"""Full-link query tracing: one trace tree per statement.

Port of ``oceanbase_tpu/server/trace.py`` (≙ the full-link trace,
ObTrace/FLTSpanMgr in deps/oblib/src/lib/trace/ob_trace.h, surfaced as
``SHOW TRACE`` and gv$ob_trace).  A statement opens a ROOT span; every
layer underneath (bind, execute, per-operator rows, spill, recovery)
attaches children.  Completed traces land in a bounded ring served as
``gv$trace`` (+ ``SHOW TRACE`` for the last statement, and a trace_id
column joined into gv$sql_audit).  On a cluster the rpc frame carries
the context: a remote handler continues the caller's tree on its node
under the caller's rpc span, and ``absorb`` merges the spans shipped
back in the reply.

Design constraints:

- spans are HOST-side only and close at the result boundary — nothing
  here reads a tensor or forces a device sync;
- the inactive path (no current trace) is one thread-local read;
- collection is always cheap enough to run at sample_rate=1.0, so the
  ``trace_sample_rate`` / ``trace_slow_threshold_s`` knob pair decides
  RETENTION at statement end, not collection — which is how a query
  that only turned out slow (or failed) still has its full tree.

Timing hygiene: ``start_ts`` is a wall-clock record timestamp,
``elapsed_s`` is always a ``time.monotonic()`` delta (step-proof).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import uuid
from dataclasses import dataclass, field

__all__ = [
    "Span", "TraceCtx", "TraceRegistry", "span", "activate", "current",
    "current_span_id", "start_trace", "finish_trace", "add_span",
    "begin_span", "end_span", "absorb", "add_spans", "add_spans_to",
]

#: process-wide span sequence: combined with the node id this makes span
#: ids unique across every context a node ever creates, so remote spans
#: merged into a coordinator tree can never collide
_SEQ = itertools.count(1)

_tls = threading.local()


@dataclass
class Span:
    """One timed operation (≙ one ObTrace span / gv$ob_trace row)."""

    trace_id: str
    span_id: int
    parent_id: int
    node: int
    name: str
    start_ts: float            # wall clock (record timestamp)
    elapsed_s: float
    tags: dict = field(default_factory=dict)

    def to_wire(self) -> dict:
        """JSON-able shape riding the rpc codec unchanged."""
        return {"t": self.trace_id, "s": self.span_id, "p": self.parent_id,
                "n": self.node, "nm": self.name, "st": self.start_ts,
                "el": self.elapsed_s, "tg": self.tags or None}

    @staticmethod
    def from_wire(d: dict) -> "Span":
        return Span(d["t"], int(d["s"]), int(d["p"]), int(d["n"]),
                    d["nm"], float(d["st"]), float(d["el"]),
                    dict(d["tg"]) if d.get("tg") else {})


class TraceCtx:
    """Per-statement collection context (one per trace per node).

    Thread-safe append: the DTL fan-out collects slice spans from worker
    threads into the coordinator's context.
    """

    __slots__ = ("trace_id", "node", "sampled", "slow_s", "spans",
                 "_lock")

    def __init__(self, trace_id: str, node: int = 0, sampled: bool = True,
                 slow_s: float = float("inf")):
        self.trace_id = trace_id
        self.node = node
        self.sampled = sampled
        self.slow_s = slow_s
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def next_id(self) -> int:
        return (self.node << 32) | next(_SEQ)

    def add(self, sp: Span):
        with self._lock:
            self.spans.append(sp)

    def add_many(self, sps: list[Span]):
        with self._lock:
            self.spans.extend(sps)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.spans)


class TraceRegistry:
    """Bounded per-node ring of completed spans (the gv$trace store)."""

    def __init__(self, max_spans: int = 20000):
        self._ring: collections.deque = collections.deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self.traces_kept = 0
        self.traces_dropped = 0

    def add(self, spans: list[Span]):
        with self._lock:
            self._ring.extend(spans)
            self.traces_kept += 1

    def note_dropped(self):
        with self._lock:
            self.traces_dropped += 1

    def recent(self, n: int | None = None) -> list[Span]:
        """Last ``n`` spans (``None`` = the whole ring)."""
        from oceanbase_tpu_torch.server.monitor import _tail

        with self._lock:
            return _tail(self._ring, n)

    def trace(self, trace_id: str) -> list[Span]:
        with self._lock:
            return [s for s in self._ring if s.trace_id == trace_id]


# ---------------------------------------------------------------------------
# thread-local current context (+ explicit hand-off for worker threads)
# ---------------------------------------------------------------------------


def current() -> TraceCtx | None:
    return getattr(_tls, "ctx", None)


def current_span_id() -> int:
    return getattr(_tls, "parent", 0)


class _Activate:
    """Install ``ctx`` (and a parent span id) as this thread's current
    trace; ``activate(None)`` is a no-op context manager so call sites
    need no branching."""

    __slots__ = ("_ctx", "_parent", "_saved")

    def __init__(self, ctx: TraceCtx | None, parent: int = 0):
        self._ctx = ctx
        self._parent = parent

    def __enter__(self):
        self._saved = (getattr(_tls, "ctx", None),
                       getattr(_tls, "parent", 0))
        if self._ctx is not None:
            _tls.ctx = self._ctx
            _tls.parent = self._parent
        return self._ctx

    def __exit__(self, et, ev, tb):
        _tls.ctx, _tls.parent = self._saved
        return False


def activate(ctx: TraceCtx | None, parent: int = 0) -> _Activate:
    return _Activate(ctx, parent)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _NoopSpan:
    """Returned when no trace is active; absorbs tag writes for free."""

    __slots__ = ()

    @property
    def tags(self) -> dict:
        return {}  # fresh throwaway: writes are discarded

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


_NOOP = _NoopSpan()


class _SpanCM:
    """Class-based context manager (cheaper than @contextmanager): the
    span closes at ``with`` exit — by construction on the host, never
    per device lane."""

    __slots__ = ("_ctx", "name", "tags", "span_id", "_parent", "_t0",
                 "_start")

    def __init__(self, ctx: TraceCtx, name: str, tags: dict):
        self._ctx = ctx
        self.name = name
        self.tags = tags

    def __enter__(self):
        self._parent = getattr(_tls, "parent", 0)
        self.span_id = self._ctx.next_id()
        _tls.parent = self.span_id
        self._start = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, et, ev, tb):
        elapsed = time.monotonic() - self._t0
        _tls.parent = self._parent
        if et is not None:
            self.tags.setdefault("error", et.__name__)
        self._ctx.add(Span(self._ctx.trace_id, self.span_id,
                           self._parent, self._ctx.node, self.name,
                           self._start, elapsed, self.tags))
        return False


def span(name: str, **tags):
    """``with span("dtl.slice", part=3) as sp:`` — tags may be extended
    through ``sp.tags`` before close.  No-op when no trace is active."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return _NOOP
    return _SpanCM(ctx, name, tags)


def add_span(name: str, elapsed_s: float, **tags):
    """Record a synthetic (already-measured) point span under the current
    parent — per-operator rows, compile time, etc."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return
    ctx.add(Span(ctx.trace_id, ctx.next_id(), getattr(_tls, "parent", 0),
                 ctx.node, name, time.time(), float(elapsed_s), tags))


def add_spans(items: list):
    """Bulk add_span: ``items`` is ``[(name, elapsed_s, tags_dict)]``.
    One wall-clock read and one context lock for the whole batch — the
    per-operator ledger emits its spans through here so a monitored
    execution pays O(1) locking, not O(operators)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or not items:
        return
    parent = getattr(_tls, "parent", 0)
    now = time.time()
    ctx.add_many([
        Span(ctx.trace_id, ctx.next_id(), parent, ctx.node, nm, now,
             float(el), tg) for nm, el, tg in items])


def add_spans_to(ctx: TraceCtx | None, parent: int, items: list):
    """``add_spans`` into an explicit context under an explicit parent:
    for spans whose values are read after their parent closed (the
    per-operator rows of a plan execution whose counts arrive at the
    statement's result boundary)."""
    if ctx is None or not items:
        return
    now = time.time()
    ctx.add_many([
        Span(ctx.trace_id, ctx.next_id(), parent, ctx.node, nm, now,
             float(el), tg) for nm, el, tg in items])


# -- manual begin/end (rpc client wraps a retry loop, not a with-block) ----


class _OpenSpan:
    __slots__ = ("name", "tags", "span_id", "parent_id", "_t0", "_start")


def begin_span(ctx: TraceCtx, name: str, parent: int, **tags) -> _OpenSpan:
    sp = _OpenSpan()
    sp.name = name
    sp.tags = tags
    sp.parent_id = parent
    sp.span_id = ctx.next_id()
    sp._start = time.time()
    sp._t0 = time.monotonic()
    return sp


def end_span(ctx: TraceCtx, sp: _OpenSpan):
    ctx.add(Span(ctx.trace_id, sp.span_id, sp.parent_id, ctx.node,
                 sp.name, sp._start, time.monotonic() - sp._t0, sp.tags))


def absorb(ctx: TraceCtx, wire_spans: list) -> None:
    """Merge spans shipped back in an rpc reply into this context."""
    for d in wire_spans:
        try:
            ctx.add(Span.from_wire(d))
        except (KeyError, TypeError, ValueError):
            continue  # a malformed remote span must not fail the query


# ---------------------------------------------------------------------------
# statement lifecycle (the session's entry points)
# ---------------------------------------------------------------------------


def start_trace(db) -> TraceCtx | None:
    """-> a fresh per-statement context, or None when tracing is off /
    the session has no server behind it."""
    if db is None:
        return None
    cfg = getattr(db, "config", None)
    if cfg is None or getattr(db, "trace_registry", None) is None:
        return None
    try:
        if not bool(cfg["enable_query_trace"]):
            return None
        rate = float(cfg["trace_sample_rate"])
        slow = float(cfg["trace_slow_threshold_s"])
    except KeyError:
        return None
    if rate >= 1.0:
        sampled = True
    else:
        import random

        sampled = random.random() < rate
    return TraceCtx(uuid.uuid4().hex[:16], node=getattr(db, "node_id", 0),
                    sampled=sampled, slow_s=slow)


def finish_trace(db, ctx: TraceCtx, elapsed_s: float,
                 error: str = "") -> bool:
    """Retention decision at statement end: sampled-in traces keep, and a
    slow or failed statement keeps its tree regardless of the sample
    draw (the 'slow queries always traced' contract).  -> kept?"""
    keep = ctx.sampled or elapsed_s >= ctx.slow_s or bool(error)
    reg = db.trace_registry
    if keep and ctx.spans:
        reg.add(ctx.snapshot())
    else:
        reg.note_dropped()
        keep = False
    return keep
