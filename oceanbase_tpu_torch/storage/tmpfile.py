"""Temp-file system: spill runs for out-of-memory operators.

The port's copy of ``oceanbase_tpu/storage/tmpfile.py``.  A run is a
sequence of npz-compressed column batches, append-ordered, read back
chunk-at-a-time so peak host memory stays at one chunk per open cursor
(≙ the tmp-file layer backing sort/hash spill, src/storage/tmp_file).

Accounting is byte-based per store; deletion is eager (``close_run`` /
``clear``) with a directory sweep on close.  A store may carry a spill
budget (``DiskManager``'s spill surface: a chunk is admitted before it
publishes, so a rejected one leaves no file) and a fault plane
(``FaultPlane``: seeded ENOSPC/EIO on ``kind="spill"``); a failed write
raises the disk manager's typed errors.
"""

from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass

import numpy as np

from oceanbase_tpu_torch.server.diskmgr import wrap_disk_error


@dataclass
class _Run:
    run_id: int
    n_chunks: int = 0
    n_rows: int = 0
    nbytes: int = 0


class TempFileStore:
    """One spill directory; runs are subdirectories of chunk files."""

    def __init__(self, root: str, budget=None, faults=None,
                 label: str = ""):
        """``budget``: a server/diskmgr.DiskManager whose spill surface
        accounts every chunk this store writes (admit on append,
        release on run close) — exhaustion kills only the spilling
        statement.  ``faults``: a net/faults.FaultPlane consulted
        before each chunk write (seeded ENOSPC/EIO on kind="spill").
        ``label`` names this store in gv$disk's per-statement rows."""
        self.root = root
        self.budget = budget
        self.faults = faults
        self.label = label
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._next = 0
        self._runs: dict[int, _Run] = {}
        self.bytes_written = 0  # lifetime counter (tests/diagnostics)

    # -- write ----------------------------------------------------------
    def new_run(self) -> int:
        with self._lock:
            rid = self._next
            self._next += 1
            self._runs[rid] = _Run(rid)
        os.makedirs(self._chunk_dir(rid), exist_ok=True)
        return rid

    def append_chunk(self, run_id: int, arrays: dict,
                     valids: dict | None = None):
        """Append one column batch to a run (written compressed)."""
        run = self._runs[run_id]
        n = len(next(iter(arrays.values()))) if arrays else 0
        payload = {}
        for k, v in arrays.items():
            v = np.asarray(v)
            payload[f"a/{k}"] = (v.astype("U") if v.dtype == object else v)
        for k, v in (valids or {}).items():
            if v is not None:
                payload[f"v/{k}"] = np.asarray(v)
        path = self._chunk_path(run_id, run.n_chunks)
        try:
            if self.faults is not None:
                self.faults.check_write("spill", path)
            with open(path + ".tmp", "wb") as f:
                np.savez_compressed(f, **payload)
        except OSError as exc:
            try:
                os.remove(path + ".tmp")
            except OSError:
                pass
            raise wrap_disk_error(exc, "spill chunk write") from exc
        sz = os.path.getsize(path + ".tmp")
        if self.budget is not None:
            # admit BEFORE publishing: a rejected chunk leaves no file
            # behind and kills only this statement (SpillBudgetExceeded)
            try:
                self.budget.admit_spill(sz, store=self, label=self.label)
            except Exception:
                try:
                    os.remove(path + ".tmp")
                except OSError:
                    pass
                raise
        os.replace(path + ".tmp", path)
        with self._lock:
            run.n_chunks += 1
            run.n_rows += n
            run.nbytes += sz
            self.bytes_written += sz

    # -- read -----------------------------------------------------------
    def run(self, run_id: int) -> _Run:
        return self._runs[run_id]

    def read_chunks(self, run_id: int):
        """Yield (arrays, valids) per stored chunk, one in memory at a
        time; strings come back as object arrays."""
        run = self._runs[run_id]
        for i in range(run.n_chunks):
            with np.load(self._chunk_path(run_id, i),
                         allow_pickle=False) as z:
                arrays, valids = {}, {}
                for k in z.files:
                    kind, name = k.split("/", 1)
                    if kind == "a":
                        a = z[k]
                        if a.dtype.kind == "U":
                            a = a.astype(object)
                        arrays[name] = a
                    else:
                        valids[name] = z[k]
            yield arrays, valids

    # -- lifecycle ------------------------------------------------------
    def close_run(self, run_id: int):
        run = self._runs.pop(run_id, None)
        if run is not None:
            shutil.rmtree(self._chunk_dir(run_id), ignore_errors=True)
            if self.budget is not None:
                self.budget.release_spill(store=self, nbytes=run.nbytes)

    def clear(self):
        for rid in list(self._runs):
            self.close_run(rid)
        if self.budget is not None:
            # sweep accounting residue (partial runs, failed appends)
            self.budget.release_spill(store=self)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._runs.values())

    def _chunk_dir(self, rid: int) -> str:
        return os.path.join(self.root, f"run_{rid}")

    def _chunk_path(self, rid: int, i: int) -> str:
        return os.path.join(self._chunk_dir(rid), f"c{i}.npz")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.clear()
        shutil.rmtree(self.root, ignore_errors=True)


__all__ = ["TempFileStore"]
