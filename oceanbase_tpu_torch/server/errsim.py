"""Errsim: runtime-armable fault-injection tracepoints.

Reference analog: the ERRSIM_POINT_DEF / EN_* tracepoint system
(deps/oblib/src/lib/utility/ob_tracepoint.h:101,394) — thousands of named
sites where tests inject error codes, armed at runtime via config.

Usage at a site:       errsim.hit("palf.append")         # may raise
Arming from a test:    errsim.arm("palf.append", error=IOError("inject"),
                                  count=2, prob=1.0)

Port of ``oceanbase_tpu/server/errsim.py``; the port's sites are
``storage.flush`` (``StorageEngine.freeze_and_flush``), ``tx.commit``
(``TransService.commit``) and ``palf.append`` (``PalfCluster.append``),
listed by ``v$errsim``.  ``ERRSIM`` is process-global.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Optional


@dataclass
class _Point:
    error: Exception
    count: int          # remaining trigger budget (-1 = unlimited)
    prob: float
    hits: int = 0
    fired: int = 0


class Errsim:
    def __init__(self):
        self._points: dict[str, _Point] = {}
        self._lock = threading.Lock()
        self.registered: set[str] = set()

    def hit(self, name: str):
        """Call at an injection site; raises the armed error if triggered."""
        self.registered.add(name)
        with self._lock:
            p = self._points.get(name)
            if p is None:
                return
            p.hits += 1
            if p.count == 0:
                return
            if p.prob < 1.0 and random.random() > p.prob:
                return
            if p.count > 0:
                p.count -= 1
            p.fired += 1
            err = p.error
        raise err

    def arm(self, name: str, error: Exception | None = None, count: int = -1,
            prob: float = 1.0):
        with self._lock:
            self._points[name] = _Point(
                error if error is not None else RuntimeError(f"errsim:{name}"),
                count, prob)

    def disarm(self, name: str):
        with self._lock:
            self._points.pop(name, None)

    def reset(self):
        with self._lock:
            self._points.clear()

    def stats(self) -> dict:
        with self._lock:
            return {n: (p.hits, p.fired) for n, p in self._points.items()}


# process-global instance (≙ the tracepoint table)
ERRSIM = Errsim()
