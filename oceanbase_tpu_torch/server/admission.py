"""Statement admission, fair queuing, deadlines and KILL.

Port of ``oceanbase_tpu/server/admission.py`` (≙ the tenant resource
manager + ObPxAdmission statement quotas, the large-query queue —
ObThWorker's lq_token — and query timeout / QUERY KILL observed by
ObSQLSessionInfo::check_session_status at operator boundaries):

- ``AdmissionController``: every admitted statement checks out a
  per-tenant SLOT before binding.  Over-limit statements wait in a
  bounded per-tenant FIFO; freed slots are granted by weighted
  round-robin ACROSS tenants.  A full queue, or a queue wait past its
  budget, rejects fast with typed ``ServerBusy``, never a hang.
- the large-query lane: a statement observed running past
  ``large_query_threshold_s`` yields its normal slot at the next
  checkpoint and continues under the separate large-lane budget.
- ``StmtCtx`` + the thread-local ``checkpoint()``: the per-statement
  deadline (``query_timeout_s``) and the KILL flag, observed on the
  HOST at result boundaries only — ``exec/plan.py::execute_plan`` entry
  and close, each host batch of the spill tier, each rung of the
  session's capacity-retry ladder.  A checkpoint reads a flag and a
  clock; it never synchronizes the device, so a kill lands when the
  host reaches its next boundary, which on an in-memory plan can be
  before the card has finished the work already queued.

The reference's module also holds ``RemoteCtx`` (a DTL fragment's
cancel context; ROADMAP Queue 1 item 10), ``MemstoreThrottle`` and
``MemstoreFull`` (memstore write backpressure; item 5b, sub-item 10)
and the ``admission.*`` metrics family (item 9); none is ported here.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional


# ---------------------------------------------------------------------------
# typed overload errors (the degradation contract: never a hang)
# ---------------------------------------------------------------------------


class ServerBusy(RuntimeError):
    """Admission rejected the statement: the tenant's queue is full or
    the queue wait exceeded its budget.  Retry later / shed load."""


class QueryTimeout(TimeoutError):
    """The statement blew past its query_timeout_s deadline; observed
    host-side at a result-boundary checkpoint."""


class QueryKilled(RuntimeError):
    """The statement was cancelled via KILL [QUERY] <session_id>."""


# ---------------------------------------------------------------------------
# per-statement context + the thread-local checkpoint hook
# ---------------------------------------------------------------------------


class StmtCtx:
    """One admitted statement's cancel/deadline/lane state.

    The cancel flag and deadline are checked by ``checkpoint()`` at
    host-side result boundaries; ``ash_state`` (when provided) is the
    session's SHOW PROCESSLIST slot, flipped to ``killed`` by KILL so
    the state is visible while the victim unwinds."""

    __slots__ = ("session_id", "tenant", "sql", "deadline", "started",
                 "cancel", "kill_reason", "lane", "controller",
                 "ash_state", "checkpoints", "queue_s",
                 "demoted", "demote_at", "slot")

    def __init__(self, session_id: int = 0, tenant: str = "sys",
                 sql: str = "", timeout_s: float | None = None,
                 controller: "AdmissionController | None" = None,
                 ash_state: dict | None = None):
        self.session_id = session_id
        self.tenant = tenant
        self.sql = sql
        self.started = time.monotonic()
        self.deadline = (self.started + float(timeout_s)
                         if timeout_s else None)
        self.cancel = threading.Event()
        self.kill_reason = ""
        self.lane = "normal"
        self.controller = controller
        self.ash_state = ash_state
        self.checkpoints = 0
        self.queue_s = 0.0
        self.demoted = False
        # what this ctx actually HOLDS — None (nothing: rejected,
        # queued, or demotion-denied), "normal", "large", or
        # "disabled" (admission off at acquire time).  release() acts
        # on THIS, never on the live knobs: a rejected acquire must
        # not free someone else's slot, and toggling admission
        # mid-statement must not leak the one this ctx took.
        self.slot: str | None = None
        # the large-query threshold is read ONCE per statement: the
        # checkpoint hot path (every operator close) must not pay a
        # config-lock round trip
        self.demote_at = (
            self.started + controller.large_threshold_s()
            if controller is not None else None)

    def kill(self, reason: str = "killed"):
        self.kill_reason = reason or "killed"
        self.cancel.set()
        if self.ash_state is not None:
            self.ash_state["state"] = "killed"

    def check(self):
        """Raise QueryKilled / QueryTimeout when flagged; demote a
        long-running statement to the large-query lane.  Called from
        result-boundary checkpoints only (host side) — this is a HOT
        path (every operator close), so the happy case is one Event
        probe + one clock read."""
        self.checkpoints += 1
        if self.cancel.is_set():
            # the lane's kill counter covers statements killed while
            # RUNNING, not only those killed in the queue
            if self.controller is not None:
                with self.controller._lock:
                    self.controller._lane(self.tenant).kills += 1
            raise QueryKilled(
                f"statement killed ({self.kill_reason}): "
                f"session {self.session_id}")
        if self.deadline is None and self.demote_at is None:
            return
        now = time.monotonic()
        if self.deadline is not None and now > self.deadline:
            if self.controller is not None:
                with self.controller._lock:
                    self.controller._lane(self.tenant).timeouts += 1
            raise QueryTimeout(
                f"query timeout after {now - self.started:.3f}s "
                f"(session {self.session_id})")
        if not self.demoted and self.demote_at is not None and \
                now > self.demote_at and self.controller is not None:
            self.controller.demote(self)

    def remaining_s(self) -> float | None:
        if self.deadline is None:
            return None
        return max(self.deadline - time.monotonic(), 0.0)


_tls = threading.local()


@contextmanager
def activate(ctx: Optional[StmtCtx]):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def checkpoint():
    """The host-side cancel/deadline observation point.  A no-op off
    the statement path (no active ctx), so library code can call it
    unconditionally at its result boundaries."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.check()


# ---------------------------------------------------------------------------
# statement admission + weighted-round-robin fair queuing
# ---------------------------------------------------------------------------


class _Waiter:
    __slots__ = ("ctx", "event", "granted", "lane")

    def __init__(self, ctx: StmtCtx, lane: str = "normal"):
        self.ctx = ctx
        self.event = threading.Event()
        self.granted = False
        self.lane = lane


class _TenantLane:
    """Per-tenant admission state: active slot count + bounded FIFO."""

    __slots__ = ("name", "active", "large_active", "queue", "admitted",
                 "rejected", "queued", "kills", "timeouts")

    def __init__(self, name: str):
        self.name = name
        self.active = 0
        self.large_active = 0   # this tenant's share of the large lane
        self.queue: collections.deque[_Waiter] = collections.deque()
        self.admitted = 0
        self.rejected = 0
        self.queued = 0
        self.kills = 0
        self.timeouts = 0


class AdmissionController:
    """Process-wide statement admission (≙ the tenant worker quota +
    large query queue).  One instance per Database/NodeDatabase.

    Invariants:
    - total normal slots in use <= admission_slots;
    - per tenant, normal slots in use <= admission_tenant_slots;
    - per tenant, queued waiters <= admission_queue_limit (beyond it:
      typed ServerBusy immediately);
    - a freed slot is granted to the longest-waiting statement of the
      next tenant in weighted round-robin order — each tenant gets up
      to ``weight`` consecutive grants per rotation;
    - a queued statement never waits past min(queue budget, its own
      deadline): it fails typed, the queue slot frees.
    """

    def __init__(self, config, weight_of: Callable[[str], int]
                 | None = None):
        self.config = config
        self._weight_of = weight_of
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantLane] = {}
        self._rr: list[str] = []      # round-robin rotation order
        self._rr_pos = 0
        self._rr_credits = 0          # grants left for the rr head
        self._large_active = 0
        self._large_queue: collections.deque[_Waiter] = \
            collections.deque()
        #: session_id -> StmtCtx of the statement it is running NOW
        self._running: dict[int, StmtCtx] = {}
        #: sessions evicted by plain KILL <id>: every later statement
        #: on them fails typed (the client reconnects, MySQL-style);
        #: bounded — ancient ids age out once the set grows past cap
        self._killed_sessions: "collections.OrderedDict[int, bool]" = \
            collections.OrderedDict()
        self._KILLED_MAX = 4096
        self.demotions = 0

    # -- knobs (read live: ALTER SYSTEM SET retunes a running server) --
    def _slots(self) -> int:
        return int(self.config["admission_slots"])

    def _tenant_slots(self) -> int:
        return int(self.config["admission_tenant_slots"])

    def _queue_limit(self) -> int:
        return int(self.config["admission_queue_limit"])

    def _queue_timeout_s(self) -> float:
        return float(self.config["admission_queue_timeout_s"])

    def large_threshold_s(self) -> float:
        return float(self.config["large_query_threshold_s"])

    def _large_slots(self) -> int:
        return int(self.config["admission_large_slots"])

    def enabled(self) -> bool:
        return bool(self.config["enable_admission"]) and self._slots() > 0

    def _weight(self, tenant: str) -> int:
        if self._weight_of is None:
            return 1
        try:
            return max(int(self._weight_of(tenant)), 1)
        except Exception:  # noqa: BLE001 — a dropped tenant mid-read
            return 1

    def _lane(self, tenant: str) -> _TenantLane:
        lane = self._tenants.get(tenant)
        if lane is None:
            lane = self._tenants[tenant] = _TenantLane(tenant)
            self._rr.append(tenant)
        return lane

    # -- acquire / release ---------------------------------------------
    def acquire(self, ctx: StmtCtx):
        """Check a normal slot out for ``ctx``; blocks in the bounded
        per-tenant FIFO when over limit.  Raises ServerBusy (full queue
        or wait budget exceeded), QueryKilled (killed while queued) or
        QueryTimeout (statement deadline passed while queued).  Always
        returns or raises inside a bounded wait — never a hang."""
        # the ctx registers as this session's statement IMMEDIATELY —
        # KILL must reach a statement that is still QUEUED, not only
        # one that already holds a slot (the waiter loop below polls
        # the cancel flag); a failed acquire deregisters itself so a
        # dead ctx never lingers as the session's "running" statement
        with self._lock:
            self._running[ctx.session_id] = ctx
        try:
            self._acquire_inner(ctx)
        except BaseException:
            with self._lock:
                if self._running.get(ctx.session_id) is ctx:
                    del self._running[ctx.session_id]
            raise

    def _acquire_inner(self, ctx: StmtCtx):
        if not self.enabled():
            ctx.slot = "disabled"
            return
        t0 = time.monotonic()
        with self._lock:
            lane = self._lane(ctx.tenant)
            total = sum(x.active for x in self._tenants.values())
            if not lane.queue and total < self._slots() and \
                    lane.active < self._tenant_slots():
                lane.active += 1
                lane.admitted += 1
                ctx.slot = "normal"
                return
            if len(lane.queue) >= max(self._queue_limit(), 0):
                lane.rejected += 1
                raise ServerBusy(
                    f"tenant {ctx.tenant}: admission queue full "
                    f"({len(lane.queue)} waiting, "
                    f"{lane.active} running)")
            w = _Waiter(ctx)
            lane.queue.append(w)
            lane.queued += 1
        budget = self._queue_timeout_s()
        rem = ctx.remaining_s()
        if rem is not None:
            budget = min(budget, rem)
        deadline = t0 + budget
        while True:
            # poll in short slices so KILL lands while queued too
            if w.event.wait(timeout=min(
                    max(deadline - time.monotonic(), 0.0), 0.05)):
                break
            if ctx.cancel.is_set() or time.monotonic() >= deadline:
                with self._lock:
                    if w.granted:
                        break  # granted in the race window: keep it
                    try:
                        self._lane(ctx.tenant).queue.remove(w)
                    except ValueError:
                        pass
                if ctx.cancel.is_set():
                    with self._lock:
                        lane.kills += 1
                    raise QueryKilled(
                        f"statement killed while queued "
                        f"(session {ctx.session_id})")
                rem = ctx.remaining_s()
                if rem is not None and rem <= 0:
                    with self._lock:
                        lane.timeouts += 1
                    raise QueryTimeout(
                        f"query timeout while queued "
                        f"(session {ctx.session_id})")
                with self._lock:
                    lane.rejected += 1
                raise ServerBusy(
                    f"tenant {ctx.tenant}: admission queue wait "
                    f"exceeded {budget:.3f}s")
        ctx.slot = "normal"  # _grant_locked counted us into lane.active
        ctx.queue_s = time.monotonic() - t0

    def release(self, ctx: StmtCtx):
        """Return whatever ``ctx`` actually holds (ctx.slot — set at
        grant time, NOT re-derived from the live knobs: a rejected
        acquire holds nothing, and an admission toggle mid-statement
        must neither leak nor double-free a slot)."""
        with self._lock:
            cur = self._running.get(ctx.session_id)
            if cur is ctx:
                del self._running[ctx.session_id]
            slot, ctx.slot = ctx.slot, None
            if slot == "large":
                if self._large_active > 0:
                    self._large_active -= 1
                lane = self._tenants.get(ctx.tenant)
                if lane is not None and lane.large_active > 0:
                    lane.large_active -= 1
                self._grant_large_locked()
            elif slot == "normal":
                lane = self._tenants.get(ctx.tenant)
                if lane is not None and lane.active > 0:
                    lane.active -= 1
                self._grant_locked()
            # slot None ("rejected"/"demotion-denied") or "disabled":
            # nothing was held — nothing to free

    def demote(self, ctx: StmtCtx):
        """Yield ``ctx``'s normal slot to the queue and move it to the
        low-priority large-query lane (point queries stop starving
        behind a scan).  When the large lane itself is saturated the
        statement waits — bounded by its own deadline/cancel flags —
        before continuing."""
        with self._lock:
            ctx.demoted = True
            if ctx.slot != "normal":
                return  # nothing to yield (disabled / already large)
            lane = self._tenants.get(ctx.tenant)
            if lane is not None and lane.active > 0:
                lane.active -= 1
            ctx.slot = None  # held by the queue now, not by us
            self._grant_locked()  # the freed slot admits a waiter NOW
            self.demotions += 1
            if self._large_active < self._large_slots():
                self._large_active += 1
                self._lane(ctx.tenant).large_active += 1
                ctx.lane = "large"
                ctx.slot = "large"
                return
            w = _Waiter(ctx, lane="large")
            self._large_queue.append(w)
        while not w.event.wait(timeout=0.05):
            if ctx.cancel.is_set() or (
                    ctx.deadline is not None
                    and time.monotonic() > ctx.deadline):
                with self._lock:
                    if w.granted:
                        break
                    try:
                        self._large_queue.remove(w)
                    except ValueError:
                        pass
                # holding NOTHING now (the normal slot was yielded,
                # the large lane denied); re-raise through the
                # ordinary checkpoint machinery (kills/timeouts
                # counted once, there)
                ctx.lane = "large_denied"
                ctx.check()
                return
        ctx.lane = "large"
        ctx.slot = "large"

    # -- grant machinery (callers hold self._lock) ---------------------
    def _grant_locked(self):
        """Hand freed capacity to waiters in weighted round-robin order
        across tenants."""
        while True:
            total = sum(x.active for x in self._tenants.values())
            if total >= self._slots():
                return
            w = self._next_waiter_locked()
            if w is None:
                return
            lane = self._lane(w.ctx.tenant)
            lane.active += 1
            lane.admitted += 1
            w.granted = True
            w.event.set()

    def _next_waiter_locked(self) -> _Waiter | None:
        """The WRR pick: rotate tenant order, spending up to ``weight``
        credits per tenant before moving on; tenants over their own cap
        or with empty queues are skipped."""
        if not self._rr:
            return None
        n = len(self._rr)
        scanned = 0
        while scanned <= n:
            if self._rr_pos >= len(self._rr):
                self._rr_pos = 0
            name = self._rr[self._rr_pos]
            lane = self._tenants[name]
            if self._rr_credits <= 0:
                self._rr_credits = self._weight(name)
            if lane.queue and lane.active < self._tenant_slots():
                self._rr_credits -= 1
                if self._rr_credits <= 0:
                    self._rr_pos = (self._rr_pos + 1) % len(self._rr)
                return lane.queue.popleft()
            # nothing grantable here: move on, dropping stale credits
            self._rr_credits = 0
            self._rr_pos = (self._rr_pos + 1) % len(self._rr)
            scanned += 1
        return None

    def _grant_large_locked(self):
        while self._large_queue and \
                self._large_active < self._large_slots():
            w = self._large_queue.popleft()
            self._large_active += 1
            self._lane(w.ctx.tenant).large_active += 1
            w.granted = True
            w.event.set()

    # -- KILL ----------------------------------------------------------
    def kill(self, session_id: int, query_only: bool = True) -> bool:
        """KILL QUERY <id>: flag the session's running (or queued)
        statement; the victim unwinds at its next checkpoint with
        typed QueryKilled.  Plain KILL <id> additionally EVICTS the
        session — every later statement on it fails typed, like the
        MySQL connection kill (the client reconnects).  -> True when a
        statement was cancelled or the session was evicted."""
        with self._lock:
            ctx = self._running.get(session_id)
            evicted = False
            if not query_only:
                while len(self._killed_sessions) >= self._KILLED_MAX:
                    self._killed_sessions.popitem(last=False)
                self._killed_sessions[session_id] = True
                evicted = True
        if ctx is not None:
            ctx.kill(reason="KILL QUERY" if query_only else "KILL")
        return ctx is not None or evicted

    def check_session(self, session_id: int):
        """Statement-entry gate: a session evicted by plain KILL takes
        no more statements (raises typed QueryKilled)."""
        with self._lock:
            killed = session_id in self._killed_sessions
        if killed:
            raise QueryKilled(
                f"session {session_id} was killed; reconnect")

    def forget_session(self, session_id: int):
        """Session teardown: drop the eviction flag (ids are unique per
        Database, but don't let a dead flag outlive its session)."""
        with self._lock:
            self._killed_sessions.pop(session_id, None)
            self._running.pop(session_id, None)

    # -- observability -------------------------------------------------
    def stats(self) -> list[dict]:
        """Per-tenant admission rows (the reference serves them as
        gv$tenant_resource)."""
        with self._lock:
            out = []
            for name in sorted(self._tenants):
                lane = self._tenants[name]
                out.append({
                    "tenant": name,
                    "slots_in_use": lane.active,
                    "slots_total": self._tenant_slots(),
                    "queue_depth": len(lane.queue),
                    "queue_limit": self._queue_limit(),
                    "weight": self._weight(name),
                    "admitted": lane.admitted,
                    "queued": lane.queued,
                    "rejected": lane.rejected,
                    "kills": lane.kills,
                    "timeouts": lane.timeouts,
                    # THIS tenant's demoted statements; large_slots is
                    # the shared process-wide lane capacity
                    "large_in_use": lane.large_active,
                    "large_slots": self._large_slots(),
                })
            return out

    def queue_depth(self, tenant: str) -> int:
        with self._lock:
            lane = self._tenants.get(tenant)
            return len(lane.queue) if lane is not None else 0

    def active_slots(self) -> int:
        with self._lock:
            return sum(x.active for x in self._tenants.values()) + \
                self._large_active


__all__ = ["AdmissionController", "QueryKilled", "QueryTimeout",
           "ServerBusy", "StmtCtx", "activate", "checkpoint"]
