"""DBMS job scheduler: periodic maintenance jobs per database.

Port of ``oceanbase_tpu/server/jobs.py``, unchanged.  Reference analog:
the dbms_job/dbms_scheduler services (src/observer/dbms_job,
dbms_scheduler) running stats auto-gather and maintenance windows (daily
major freeze).  Jobs run on one daemon thread, started by ``start()`` or
at boot with ``enable_dbms_jobs``, and stopped by ``Database.close()``;
every run is recorded in ``history``; ``v$dbms_jobs`` serves the job
registry.

Built-ins:
- stats_gather   — ANALYZE tables whose row count drifted >= 50% since
  the last gather (≙ DBMS_STATS auto gather)
- auto_compact   — major-compact tables whose L0/L1 segment count
  exceeds the minor trigger (≙ the daily merge window)

Custom SQL jobs register via ``schedule(name, interval_s, sql)``.
"""

from __future__ import annotations

import threading
import time


class JobScheduler:
    def __init__(self, db, tick_s: float = 1.0):
        self.db = db
        self.tick_s = tick_s
        self.jobs: dict[str, dict] = {}
        self.history: list[dict] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stats_seen: dict[str, int] = {}

    # ------------------------------------------------------------------
    def register_builtins(self, stats_interval_s: float = 600.0,
                          compact_interval_s: float = 3600.0):
        self.schedule_fn("stats_gather", stats_interval_s,
                         self._stats_gather)
        self.schedule_fn("auto_compact", compact_interval_s,
                         self._auto_compact)

    def schedule_fn(self, name: str, interval_s: float, fn):
        self.jobs[name] = {"interval": interval_s, "fn": fn,
                           "next": time.monotonic() + interval_s,
                           "runs": 0, "failures": 0, "last_s": 0.0}

    def schedule(self, name: str, interval_s: float, sql: str):
        """A recurring SQL job (≙ DBMS_SCHEDULER.create_job)."""

        def run():
            s = self.db.session()
            try:
                s.execute(sql)
            finally:
                s.close()

        self.schedule_fn(name, interval_s, run)

    def cancel(self, name: str):
        self.jobs.pop(name, None)

    # ------------------------------------------------------------------
    def _stats_gather(self):
        t = self.db.tenants.get("sys")
        if t is None:
            return
        s = self.db.session()
        try:
            for name in list(t.engine.tables):
                if name.startswith("__idx__"):
                    continue
                ts = t.engine.tables[name]
                rows = ts.tablet.row_count_estimate()
                seen = self._stats_seen.get(name)
                if seen is None or (rows and abs(rows - seen) * 2 >=
                                    max(seen, 1)):
                    s.execute(f"analyze table {name}")
                    self._stats_seen[name] = rows
        finally:
            s.close()

    def _auto_compact(self):
        t = self.db.tenants.get("sys")
        if t is None:
            return
        trigger = int(self.db.config["minor_compact_trigger"])
        for name in list(t.engine.tables):
            ts = t.engine.tables[name]
            # the trigger is an UNCOMPACTED (below-baseline) segment
            # count per partition — total segments would re-compact an
            # already-major-compacted partitioned table forever
            per_part: dict = {}
            for seg, part in ts.tablet.segment_locations():
                if seg.level < 2:
                    per_part[part] = per_part.get(part, 0) + 1
            if per_part and max(per_part.values()) > trigger:
                t.engine.major_compact(name)

    # ------------------------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.tick_s):
            now = time.monotonic()
            for name, j in list(self.jobs.items()):
                if now < j["next"]:
                    continue
                ts = time.time()       # record timestamp (wall)
                t0 = time.monotonic()  # elapsed source (step-proof)
                ok, err = True, ""
                try:
                    j["fn"]()
                except Exception as e:  # noqa: BLE001 — record + continue
                    ok, err = False, f"{type(e).__name__}: {e}"
                    j["failures"] += 1
                j["runs"] += 1
                j["last_s"] = time.monotonic() - t0
                j["next"] = time.monotonic() + j["interval"]
                self.history.append({
                    "ts": ts, "job": name, "ok": ok, "error": err,
                    "elapsed_s": j["last_s"]})
                del self.history[:-1000]

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="dbms-jobs")
            self._thread.start()
        return self

    def stop(self):
        """Stop and WAIT for any in-flight job: Database.close() must not
        tear tenants down under a running ANALYZE/compaction."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            self._thread = None
