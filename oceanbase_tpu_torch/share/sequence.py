"""Sequences: CREATE SEQUENCE with cached allocation.

Port of ``oceanbase_tpu/share/sequence.py`` (host only), with one
change: a definition or high-water mark also reaches the engine's slog
when it changes, so a sequence (or an AUTO_INCREMENT counter) created or
advanced after the last checkpoint survives a crash.

Reference analog: src/share/sequence + src/sql/engine/sequence — sequences
allocate value ranges through the (replicated) meta store and serve
nextval from a local cache so the hot path is lock-only.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class SequenceDef:
    name: str
    start: int = 1
    increment: int = 1
    cache: int = 1000


class SequenceManager:
    """Per-tenant sequence registry; persistence rides the engine meta
    (checkpointed high-water marks never hand out duplicates)."""

    def __init__(self, engine=None):
        self._defs: dict[str, SequenceDef] = {}
        self._next: dict[str, int] = {}     # next value in local cache
        self._limit: dict[str, int] = {}    # exclusive end of cached range
        self._lock = threading.Lock()
        self.engine = engine
        if engine is not None:
            for name, st in engine.meta.get("sequences", {}).items():
                self._defs[name] = SequenceDef(name, st["start"],
                                               st["increment"], st["cache"])
                # resume AFTER the persisted high-water mark
                self._next[name] = st["hwm"]
                self._limit[name] = st["hwm"]

    def create(self, name: str, start=1, increment=1, cache=1000):
        with self._lock:
            if name in self._defs:
                raise ValueError(f"sequence {name} exists")
            self._defs[name] = SequenceDef(name, start, increment, cache)
            self._next[name] = start
            self._limit[name] = start
            self._persist(name, start)

    def drop(self, name: str):
        with self._lock:
            self._defs.pop(name, None)
            self._next.pop(name, None)
            self._limit.pop(name, None)
            if self.engine is not None:
                self.engine.meta.get("sequences", {}).pop(name, None)
                self.engine.log_sequence(name, None)

    def peek(self, name: str) -> int:
        """Next value WITHOUT advancing (EXPLAIN / dry planning)."""
        with self._lock:
            if name not in self._defs:
                raise KeyError(f"unknown sequence {name}")
            return self._next[name]

    def nextval(self, name: str) -> int:
        with self._lock:
            d = self._defs.get(name)
            if d is None:
                raise KeyError(f"unknown sequence {name}")
            exhausted = (self._next[name] >= self._limit[name]
                         if d.increment > 0
                         else self._next[name] <= self._limit[name])
            if exhausted:
                # allocate + persist a new range (≙ range fetch through
                # the meta table; crash loses at most `cache` values)
                new_limit = self._next[name] + d.cache * d.increment
                self._limit[name] = new_limit
                self._persist(name, new_limit)
            v = self._next[name]
            self._next[name] += d.increment
            return v

    def advance_past(self, name: str, value: int):
        """Bump the counter beyond an explicitly supplied value (MySQL
        AUTO_INCREMENT semantics: explicit inserts advance the counter)."""
        with self._lock:
            d = self._defs.get(name)
            if d is None or d.increment <= 0:
                return
            if self._next[name] <= value:
                self._next[name] = value + d.increment
                if self._limit[name] < self._next[name]:
                    self._limit[name] = self._next[name]
                self._persist(name, self._limit[name])

    def _persist(self, name: str, hwm: int):
        if self.engine is None:
            return
        d = self._defs[name]
        state = {"start": d.start, "increment": d.increment,
                 "cache": d.cache, "hwm": hwm}
        self.engine.meta.setdefault("sequences", {})[name] = state
        # the reference keeps it in the checkpointed meta only, so after
        # a crash an AUTO_INCREMENT counter restarts below ids it handed
        # out (ROADMAP Queue 3 #15)
        self.engine.log_sequence(name, state)
