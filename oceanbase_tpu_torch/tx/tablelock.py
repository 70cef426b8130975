"""Table locks + deadlock detection.

Port of ``oceanbase_tpu/tx/tablelock.py`` (host only, copied as it is).

Reference analog: src/storage/tablelock (table/object locks held through
transactions) and the LCL deadlock detector (src/share/deadlock).

Locks: shared (S) / exclusive (X) table locks acquired by transactions,
released at commit/rollback.  Deadlock handling is detection-based: a
wait-for graph cycle check on every blocked acquisition (single-node, so
the reference's distributed lazy-cycle-propagation collapses to a local
DFS); the newest waiter in the cycle aborts (≙ victim selection by tx age).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

from oceanbase_tpu_torch.tx.errors import TxAborted, WriteConflict


class DeadlockDetected(TxAborted):
    pass


class LockTable:
    def __init__(self):
        self._lock = threading.Condition()
        # table -> {"S": set[tx_id], "IX": set[tx_id], "X": tx_id|None}
        self._held: dict[str, dict] = defaultdict(
            lambda: {"S": set(), "IX": set(), "X": None})
        # waiter tx -> set of holder txs it waits for (wait-for graph)
        self._waits: dict[int, set] = {}

    # ------------------------------------------------------------------
    def _conflicts(self, table: str, mode: str, tx_id: int) -> set:
        """Compatibility matrix: IX~IX compatible; S~S compatible;
        S conflicts IX/X; IX conflicts S/X; X conflicts everything
        (DML takes IX implicitly; LOCK TABLES READ/WRITE take S/X)."""
        st = self._held[table]
        blockers = set()
        if st["X"] is not None and st["X"] != tx_id:
            blockers.add(st["X"])
        if mode == "S":
            blockers |= {t for t in st["IX"] if t != tx_id}
        elif mode == "IX":
            blockers |= {t for t in st["S"] if t != tx_id}
        else:  # X
            blockers |= {t for t in st["S"] if t != tx_id}
            blockers |= {t for t in st["IX"] if t != tx_id}
        return blockers

    def _would_deadlock(self, tx_id: int, blockers: set) -> bool:
        """DFS over the wait-for graph: does making tx_id wait on
        ``blockers`` close a cycle?  (≙ LCL cycle detection)"""
        stack = list(blockers)
        seen = set()
        while stack:
            t = stack.pop()
            if t == tx_id:
                return True
            if t in seen:
                continue
            seen.add(t)
            stack.extend(self._waits.get(t, ()))
        return False

    def acquire(self, table: str, mode: str, tx_id: int,
                timeout: float = 10.0):
        """Block until granted; raises DeadlockDetected on a cycle or
        WriteConflict on timeout."""
        assert mode in ("S", "X", "IX")
        with self._lock:
            deadline = None
            while True:
                blockers = self._conflicts(table, mode, tx_id)
                if not blockers:
                    st = self._held[table]
                    if mode == "S":
                        st["S"].add(tx_id)
                    elif mode == "IX":
                        st["IX"].add(tx_id)
                    else:
                        st["X"] = tx_id
                    self._waits.pop(tx_id, None)
                    return
                if self._would_deadlock(tx_id, blockers):
                    self._waits.pop(tx_id, None)
                    raise DeadlockDetected(
                        f"tx {tx_id} would deadlock on {table}")
                self._waits[tx_id] = blockers
                if deadline is None:
                    deadline = time.monotonic() + timeout
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._waits.pop(tx_id, None)
                    raise WriteConflict(
                        f"lock wait timeout on {table} (tx {tx_id})")
                self._lock.wait(timeout=min(remaining, 0.5))

    def release_all(self, tx_id: int):
        with self._lock:
            for st in self._held.values():
                st["S"].discard(tx_id)
                st["IX"].discard(tx_id)
                if st["X"] == tx_id:
                    st["X"] = None
            self._waits.pop(tx_id, None)
            self._lock.notify_all()

    def holders(self, table: str) -> dict:
        with self._lock:
            st = self._held[table]
            return {"S": set(st["S"]), "X": st["X"]}
