"""The benchmark of ``oceanbase_tpu_torch``: one cell, one run.

``python3 obbench/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` looks the cell up in ``BENCHMARK.json``,
and finds by name everything that belongs to it:

- its configuration, ``obbench/configs/<config>.json``, whose
  ``dataset`` names the module in ``obbench/datasets/`` that makes the
  data from the seed, loads them into the program, turns a traffic mix
  into statements and judges the answers against the plain reference in
  ``obbench/reference/``;
- its traffic mix, ``obbench/traffic/<traffic>.json``, read by
  ``traffic.py``;
- each metric, ``obbench/metrics/<metric>.py``, a ``read(run)`` that
  gives the number or None.

Set-up makes the data, opens ``Database(None, device=cuda)`` (in
memory: no file is written), applies the configuration's settings with
``ALTER SYSTEM SET``, loads the tables and runs each statement that the
mix warms.  The window is a closed loop of one client through
``session.execute(sql).rows()``.  With ``--trace 1`` the window runs
under ``torch.profiler``, and the statements' audit records and spans
are read once after it, from rings sized for the whole window, so the
harness does no reading between statements.  After the window the
program is freed and the kept answers are judged; the last line of
standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from obbench import devtrace, guard, traffic

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
SEED_MASK = (1 << 63) - 1
#: program spans read per statement in a traced run
SPAN_NAMES = ("compile", "execute", "statement")
#: a traced window's audit and span rings: room for every statement of
#: the window, which a deque with a maximum length does not allocate
WINDOW_RECORDS = 1 << 22


def load_spec(root: Path = CHECKOUT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, traced: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), as BENCHMARK.json lists them."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, run) -> float | None:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "obbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


class Run:
    """What one run measured, as the metric readers see it."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.latencies_s: list = []
        self.stmts: list = []       # traced: one dict per statement
        self.trace = None           # traced: devtrace.Reduced
        self.facts: dict = {}

    def rate(self):
        if self.window_s <= 0:
            return None
        done = sum(1 for t in self.latencies_s if math.isfinite(t))
        return done / self.window_s

    def percentile_ms(self, p: float):
        """Nearest-rank percentile of every statement's latency."""
        if not self.latencies_s:
            return None
        lat = sorted(self.latencies_s)
        return lat[max(0, math.ceil(p / 100 * len(lat)) - 1)] * 1e3

    def mean_ms(self, key: str, label: str | None = None):
        vals = [s[key] for s in self.stmts
                if key in s and (label is None or s["label"] == label)]
        return float(np.mean(vals)) * 1e3 if vals else None

    def idle_share_pct(self):
        t = self.trace
        if t is None or t.window_s <= 0 or t.busy_s <= 0:
            return None
        return 100.0 * (1.0 - t.busy_s / t.window_s)

    def roofline_pct(self, label: str, nbytes: int):
        from obbench.roofline import H100_HBM_BYTES_S

        busy = self.mean_ms("busy_s", label)
        if not busy:
            return None
        return 100.0 * nbytes / (busy / 1e3) / H100_HBM_BYTES_S


def _finite(v):
    return v if math.isfinite(v) else 1e308


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window_records(db, labels):
    """Every window statement's audit record and spans, read once after
    the window -> (records, [[(name, start, elapsed)]])."""
    recs = db.audit.recent(None)[-len(labels):]
    if len(recs) != len(labels):
        raise RuntimeError(f"{len(recs)} audit records for "
                           f"{len(labels)} statements")
    by_trace: dict = {}
    for s in db.trace_registry.recent(None):
        if s.name in SPAN_NAMES:
            by_trace.setdefault(s.trace_id, []).append(s)
    out, spans_of = [], []
    for rec, label in zip(recs, labels):
        spans = by_trace.get(rec.trace_id, []) if rec.trace_id else []
        r = {"label": label, "dispatch_s": rec.dispatch_s}
        for s in spans:
            if s.name == "compile":
                r["compile_s"] = s.elapsed_s
        out.append(r)
        spans_of.append([(s.name, s.start_ts, s.elapsed_s) for s in spans])
    return out, spans_of


def run_cell(spec: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float | None = None,
             log=sys.stderr) -> dict:
    """One run of ``cell`` -> the result object (without printing)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    seed = int(seed) & SEED_MASK
    cfg = load_config(cell["config"])
    mix = traffic.load(cell["traffic"])
    dataset = importlib.import_module(f"obbench.datasets.{cfg['dataset']}")

    # -- set-up ------------------------------------------------------------
    from oceanbase_tpu_torch.server.database import Database

    marks = [("start", t_start), ("imports", time.perf_counter())]
    data = dataset.make(cfg, seed, device)
    marks.append(("make", time.perf_counter()))
    db = Database(None, device=device)
    sess = db.session()
    for k, v in cfg.get("settings", {}).items():
        sess.execute(f"alter system set {k} = {v}")
    marks.append(("open", time.perf_counter()))
    dataset.load(sess, cfg, data)
    _sync(torch, device)
    marks.append(("load", time.perf_counter()))
    sched = traffic.Schedule(dataset, cfg, mix, data, seed)
    for _label, sql, _key in sched.warm:
        sess.execute(sql).rows()
    _sync(torch, device)
    marks.append(("warm", time.perf_counter()))
    run = Run()
    run.facts = dataset.facts(cfg, data)
    run.setup_s = time.perf_counter() - t_start
    print("set-up (s): " + ", ".join(
        f"{n} {t - marks[j][1]:.3f}" for j, (n, t) in enumerate(marks[1:]))
        + f"; setup_s {run.setup_s:.3f}", file=log)

    # -- the window ----------------------------------------------------------
    samples: list = []
    failed = 0
    if traced:
        from oceanbase_tpu_torch.server.monitor import SqlAudit
        from oceanbase_tpu_torch.server.trace import TraceRegistry

        db.audit = SqlAudit(WINDOW_RECORDS)
        db.trace_registry = TraceRegistry(WINDOW_RECORDS)
    if device.type == "cuda":
        # the window's peak, not set-up's
        torch.cuda.reset_peak_memory_stats(device)
    cap = devtrace.Capture() if traced else None
    if cap is not None:
        cap.__enter__()
    i = 0
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        label, sql, key = sched[i]
        t0 = time.perf_counter()
        try:
            if cap is not None:
                with cap.stmt(label):
                    rows = sess.execute(sql).rows()
            else:
                rows = sess.execute(sql).rows()
        except Exception as e:  # noqa: BLE001 — a failed statement is
            # counted and reported, and the run goes on
            rows = None
            failed += 1
            print(f"statement {label} failed: {type(e).__name__}: {e}",
                  file=log)
        t1 = time.perf_counter()
        # a failed statement misses every latency limit
        run.latencies_s.append(t1 - t0 if rows is not None else math.inf)
        if rows is not None and sched.keep(i):
            samples.append((key, rows))
        i += 1
        if t1 >= deadline and sched.closes_after(i - 1):
            break
    run.window_s = time.perf_counter() - w0
    _sync(torch, device)
    if cap is not None:
        cap.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if cap is not None:
        run.stmts, spans_of = _window_records(
            db, [sched[j][0] for j in range(i)])
        run.trace = devtrace.reduce(cap.events(), cap.wall_ns, spans_of,
                                    cap.gc_pauses)
        if run.trace.busy_s > 0:
            # a trace with no device operation has no busy or idle time
            for rec, busy, idle in zip(run.stmts, run.trace.stmt_busy_s,
                                       run.trace.stmt_idle_s):
                rec["busy_s"] = busy
                # the session's envelope: the device idle while the host
                # is in Session.execute outside the compile and execute
                # spans (admission, audit, trace, materialization), or in
                # Result.rows()
                rec["envelope_s"] = (idle.get("statement", 0.0)
                                     + idle.get("rows", 0.0))
        del cap

    # -- the check, with the program freed -----------------------------------
    del sess, db
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = dataset.judge(cfg, data, samples, device)
    print(f"check: {len(samples)} answers judged in "
          f"{time.perf_counter() - t_check:.3f} s", file=log)
    limits = cfg["limits"]
    checks = {n: {"value": _finite(numbers[n]), "limit": limits[n]}
              for n in limits}
    correct = failed == 0 and bool(samples) and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in cell_metrics(spec, cell["name"], traced):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": i, "failed": failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
        print("idle by label (s): " + json.dumps(
            {k: round(v, 6) for k, v in sorted(
                run.trace.idle_by_label.items(), key=lambda kv: -kv[1])}),
            file=log)
    by_label: dict = {}
    for j, t in enumerate(run.latencies_s):
        by_label.setdefault(sched[j][0], []).append(t)
    print("mean ms by statement: " + json.dumps(
        {k: round(float(np.mean(v)) * 1e3, 3) for k, v in by_label.items()}),
        file=log)
    print(f"judged {len(samples)} of {i} statements; "
          f"{len(sched.stmts)} in the list; window {run.window_s:.3f} s",
          file=log)
    out["checks"] = checks
    return out


def card_line() -> str:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return p.stdout.strip().splitlines()[0] if p.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell = find_cell(spec, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    found = guard.forbidden_loaded()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
