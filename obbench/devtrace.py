"""The device trace of a run's window, and its reduction.

``Capture`` runs ``torch.profiler`` (CPU and CUDA activities, CUPTI on
the card) over the window.  The harness marks each statement with a
``record_function`` range named ``ob:<label>``; a range ``ob:clock``,
entered right after a wall-clock read, ties the profiler's clock to the
wall clock that the program's own spans carry.

``reduce`` turns the events into:

- the busy union: every interval in which a kernel, a copy or a memset
  ran on the device, merged, inside the window from the first
  statement's start to the last one's end (``busy_s``, ``window_s``);
- each statement's busy time: the union inside the stretch from its own
  start to the next statement's start (a statement ends in a read of its
  result, so its work is done by then);
- each statement's device idle time by the phase the host was in;
- the device operations that took most time, by name (cut to
  ``NAME_CHARS`` characters);
- the idle gaps, longest first, each named by what the host was doing at
  its middle: ``<label>/<phase>`` inside a statement, where the phase is
  the program's span there (``compile``, ``execute``, else ``statement``
  for the rest of ``Session.execute``, else ``rows`` for the result's
  conversion in ``Result.rows()``), or ``harness`` between statements;
  ``:gc<n>`` is added where the middle falls in a collection of the
  interpreter's garbage collector (generation n, 1 ms or longer), which
  the capture records through ``gc.callbacks``.
"""

from __future__ import annotations

import bisect
import gc
import time
from dataclasses import dataclass, field

PREFIX = "ob:"
NAME_CHARS = 160


class Capture:
    def __init__(self):
        import torch

        self._torch = torch
        act = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            act.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=act,
                                           record_shapes=False,
                                           profile_memory=False,
                                           with_stack=False)
        self.wall_ns = 0
        self.gc_pauses: list = []      # (start wall ns, end wall ns, gen)
        self._gc_t0 = 0

    def _on_gc(self, phase, info):
        now = time.time_ns()
        if phase == "start":
            self._gc_t0 = now
        elif now - self._gc_t0 >= 1_000_000:
            self.gc_pauses.append((self._gc_t0, now, info["generation"]))

    def __enter__(self):
        self.prof.__enter__()
        self.wall_ns = time.time_ns()
        with self._torch.profiler.record_function(PREFIX + "clock"):
            pass
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self.prof.__exit__(*exc)
        return False

    def stmt(self, label: str):
        return self._torch.profiler.record_function(PREFIX + label)

    def events(self) -> list:
        """-> [(start_ns, end_ns, name, on_device)]."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            on_dev = str(e.device_type()).endswith("CUDA")
            out.append((s, s + e.duration_ns(), e.name(), on_dev))
        return out


@dataclass
class Reduced:
    window_s: float = 0.0
    busy_s: float = 0.0
    stmt_busy_s: list = field(default_factory=list)
    stmt_idle_s: list = field(default_factory=list)   # {phase: s}
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    idle_by_label: dict = field(default_factory=dict)


def _merge(iv: list) -> list:
    iv.sort()
    out: list = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _phase(mid: int, spans: list) -> str:
    for name in ("compile", "execute", "statement"):
        for nm, s, e in spans:
            if nm == name and s <= mid < e:
                return name
    return "rows"


def reduce(events: list, wall_ns: int, stmt_spans: list,
           gc_pauses: tuple = (), top: int = 10) -> Reduced:
    """``stmt_spans[i]``: the program's spans of statement i as [(name,
    start wall s, elapsed s)], in the statements' order; ``gc_pauses``:
    (start wall ns, end wall ns, generation)."""
    anns = sorted((s, e, n[len(PREFIX):]) for s, e, n, dev in events
                  if not dev and n.startswith(PREFIX))
    clock = [s for s, _e, n in anns if n == "clock"]
    offset = (clock[0] - wall_ns) if clock else 0
    stmts = [(s, e, n) for s, e, n in anns if n != "clock"]
    red = Reduced()
    if not stmts:
        return red
    w0, w1 = stmts[0][0], max(e for _s, e, _n in stmts)
    red.window_s = (w1 - w0) / 1e9
    by_name: dict = {}
    iv = []
    for s, e, n, dev in events:
        if not dev or n.startswith(PREFIX):
            continue
        n = n[:NAME_CHARS]
        by_name[n] = by_name.get(n, 0) + (e - s)
        s, e = max(s, w0), min(e, w1)
        if e > s:
            iv.append([s, e])
    merged = _merge(iv)
    red.busy_s = sum(e - s for s, e in merged) / 1e9
    red.device_ops = [[n, t / 1e9] for n, t in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:top]]
    starts = [s for s, _e in merged]
    cum = [0]
    for s, e in merged:
        cum.append(cum[-1] + e - s)

    def busy_before(t: int) -> int:
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0
        s, e = merged[i - 1]
        return cum[i - 1] + min(t, e) - s

    bounds = [s for s, _e, _n in stmts] + [w1]
    red.stmt_busy_s = [(busy_before(bounds[i + 1]) - busy_before(bounds[i]))
                       / 1e9 for i in range(len(stmts))]
    # idle gaps inside the window, each named at its middle
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    sstarts = [s for s, _e, _n in stmts]
    red.stmt_idle_s = [{} for _ in stmts]
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(sstarts, mid) - 1
        if i >= 0 and mid < stmts[i][1]:
            spans = [(nm, int(st * 1e9) + offset,
                      int(st * 1e9) + offset + int(el * 1e9))
                     for nm, st, el in (stmt_spans[i] if i < len(stmt_spans)
                                        else [])]
            phase = _phase(mid, spans)
            label = f"{stmts[i][2]}/{phase}"
            idle = red.stmt_idle_s[i]
            idle[phase] = idle.get(phase, 0.0) + (b - a) / 1e9
        else:
            label = "harness"
        for g0, g1, gen in gc_pauses:
            if g0 + offset <= mid < g1 + offset:
                label += f":gc{gen}"
                break
        red.idle_gaps.append([label, (b - a) / 1e9])
        red.idle_by_label[label] = red.idle_by_label.get(label, 0.0) + \
            (b - a) / 1e9
    red.idle_gaps.sort(key=lambda g: -g[1])
    red.idle_gaps = red.idle_gaps[:top]
    return red
