"""Metrics plane: counters, gauges, log-bucketed histograms.

Port of ``oceanbase_tpu/server/metrics.py`` (≙ the per-tenant and
per-session sysstat counters and wait statistics of
deps/oblib/src/lib/stat/ob_diagnose_info.h, surfaced as gv$sysstat and
the sysstat histograms, plus p50/p95/p99 from bucket counts, never from
stored samples).  Pure host code, the same as the reference line for
line, so a series means the same thing in both packages:

- **host-side only** — updates happen at result and span-close
  boundaries, never between the launches of an operator, and never
  read a tensor;
- **lock-free fast path** — each thread owns a private shard dict, so
  an increment is one dict lookup + an int add with no lock;
  ``snapshot()`` merges shards and folds the shards of dead threads
  into a retired pool so per-query worker threads cannot leak;
- **declared names only** — every series name must come from a
  ``declare(...)`` registration (checked on first use per shard): a
  dynamically formatted name cannot typo itself into a fresh series.

Histograms are log-bucketed (geometric bounds, factor √2 from 1µs):
p50/p95/p99 are computed from bucket counts with rank interpolation;
exact min/max ride along.  Buckets are sparse dicts, so a series costs
only the buckets it touched and merges are plain sums.

Surfaces: ``gv$sysstat`` / ``gv$sysstat_histogram`` and ``SHOW METRICS``
(Prometheus text exposition).  ``wire_snapshot``/``merge_wire``/
``wire_to_flat`` are the scrape body's plain functions, which a cluster
node's ``metrics.scrape`` verb ships between nodes (gv$sysstat merges
every reachable peer's).
"""

from __future__ import annotations

import math
import threading
import weakref
from dataclasses import dataclass

__all__ = [
    "declare", "inc", "observe", "set_gauge", "enabled", "set_enabled",
    "Histogram", "snapshot", "wire_snapshot", "merge_wire",
    "wire_to_flat", "sysstat_dict", "prom_text", "hist_stats",
    "counter_value", "reset", "declared",
]

# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MetricDef:
    name: str
    kind: str          # counter | gauge | histogram
    doc: str = ""
    unit: str = ""


_DECLS: dict[str, MetricDef] = {}
_KINDS = ("counter", "gauge", "histogram")


def declare(name: str, kind: str, doc: str = "", unit: str = "") -> str:
    """Register a series name (idempotent).  Updates to undeclared names
    raise."""
    if kind not in _KINDS:
        raise ValueError(f"metric kind {kind!r} not in {_KINDS}")
    cur = _DECLS.get(name)
    if cur is not None and cur.kind != kind:
        raise ValueError(
            f"metric {name!r} already declared as {cur.kind}, not {kind}")
    _DECLS[name] = MetricDef(name, kind, doc, unit)
    return name


def declared() -> dict[str, MetricDef]:
    return dict(_DECLS)


def _check_declared(name: str, kind: str):
    d = _DECLS.get(name)
    if d is None:
        raise KeyError(f"metric {name!r} was never declare()d")
    if d.kind != kind:
        raise TypeError(f"metric {name!r} is a {d.kind}, not a {kind}")


# ---------------------------------------------------------------------------
# enable flag (ALTER SYSTEM SET enable_metrics; watched by Database).
# Collection is cheap enough to default on; the flag exists so its
# cost can be priced.
# ---------------------------------------------------------------------------

_ENABLED = True


def set_enabled(on: bool):
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


# ---------------------------------------------------------------------------
# histogram (shared type: WaitEvents and every *_s series use it)
# ---------------------------------------------------------------------------

#: geometric bucket ladder: bucket 0 covers (0, FLOOR]; bucket i covers
#: (FLOOR*G^(i-1), FLOOR*G^i]; the last bucket absorbs everything above.
HIST_FLOOR = 1e-6
HIST_GROWTH = 2.0 ** 0.5
HIST_BUCKETS = 64
_INV_LOG_G = 1.0 / math.log(HIST_GROWTH)


def bucket_index(v: float) -> int:
    if v <= HIST_FLOOR:
        return 0
    i = int(math.ceil(math.log(v / HIST_FLOOR) * _INV_LOG_G))
    # guard the exact-bound float wobble: log(G^i)/log(G) can land an
    # epsilon above i, pushing a bound value one bucket up
    if v <= HIST_FLOOR * HIST_GROWTH ** (i - 1):
        i -= 1
    return i if i < HIST_BUCKETS else HIST_BUCKETS - 1


def bucket_bound(i: int) -> float:
    """Inclusive upper bound of bucket ``i``."""
    if i >= HIST_BUCKETS - 1:
        return float("inf")
    return HIST_FLOOR * HIST_GROWTH ** i


class Histogram:
    """Sparse log-bucketed histogram with exact count/sum/min/max."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict[int, int] = {}

    def observe(self, v: float):
        v = float(v)
        i = bucket_index(v)
        b = self.buckets
        b[i] = b.get(i, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    # -- merge / copy ----------------------------------------------------
    def merge(self, other: "Histogram"):
        # tolerate racy reads of a live shard's histogram: bucket dicts
        # only ever GROW, so a retry after a resize-during-iteration sees
        # a superset (monotonic counters may be an instant stale — fine
        # for metrics)
        for _ in range(4):
            try:
                items = list(other.buckets.items())
                break
            except RuntimeError:
                continue
        else:
            items = []
        for i, n in items:
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max

    def copy(self) -> "Histogram":
        h = Histogram()
        h.merge(self)
        return h

    # -- stats -----------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Rank-interpolated percentile from bucket counts (clamped to
        the exact observed min/max)."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        for i in sorted(self.buckets):
            n = self.buckets[i]
            if cum + n >= target:
                lo = 0.0 if i == 0 else HIST_FLOOR * HIST_GROWTH ** (i - 1)
                hi = bucket_bound(i)
                if math.isinf(hi):
                    hi = self.max
                frac = (target - cum) / n
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            cum += n
        return self.max

    def to_wire(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "buckets": {str(i): n for i, n in
                            sorted(self.buckets.items())}}

    @staticmethod
    def from_wire(d: dict) -> "Histogram":
        h = Histogram()
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        if h.count:
            h.min = float(d.get("min", 0.0))
            h.max = float(d.get("max", 0.0))
        h.buckets = {int(i): int(n)
                     for i, n in (d.get("buckets") or {}).items()}
        return h


def hist_stats(h: Histogram) -> dict:
    """The gv$sysstat_histogram row shape."""
    return {
        "count": h.count, "sum": h.sum,
        "min": h.min if h.count else 0.0,
        "max": h.max if h.count else 0.0,
        "p50": h.percentile(50.0), "p95": h.percentile(95.0),
        "p99": h.percentile(99.0),
    }


# ---------------------------------------------------------------------------
# thread-sharded store
# ---------------------------------------------------------------------------


class _Shard:
    __slots__ = ("counters", "hists")

    def __init__(self):
        # key: (name, ((label, value), ...)) — tuple-sorted labels
        self.counters: dict[tuple, int] = {}
        self.hists: dict[tuple, Histogram] = {}


_tls = threading.local()
_lock = threading.Lock()          # shard registry + retired + gauges
_shards: list[tuple[weakref.ref, _Shard]] = []
_retired = _Shard()               # folded shards of dead threads
_gauges: dict[tuple, float] = {}


def _fold_dead_locked():
    alive = []
    for ref, s in _shards:
        t = ref()
        if t is None or not t.is_alive():
            _merge_shard(_retired, s)
        else:
            alive.append((ref, s))
    _shards[:] = alive


def _merge_shard(dst: _Shard, src: _Shard):
    for _ in range(4):
        try:
            items = list(src.counters.items())
            break
        except RuntimeError:
            continue
    else:
        items = []
    for k, v in items:
        dst.counters[k] = dst.counters.get(k, 0) + v
    for _ in range(4):
        try:
            hitems = list(src.hists.items())
            break
        except RuntimeError:
            continue
    else:
        hitems = []
    for k, h in hitems:
        acc = dst.hists.get(k)
        if acc is None:
            acc = dst.hists[k] = Histogram()
        acc.merge(h)


def _shard() -> _Shard:
    s = getattr(_tls, "shard", None)
    if s is None:
        s = _Shard()
        _tls.shard = s
        with _lock:
            _fold_dead_locked()
            _shards.append((weakref.ref(threading.current_thread()), s))
    return s


def _key(name: str, labels: dict) -> tuple:
    if not labels:
        return (name, ())
    return (name, tuple(sorted(labels.items())))


# -- the fast path ----------------------------------------------------------


def inc(name: str, n: int = 1, **labels):
    """Counter add: one shard-dict lookup + an int add (no lock)."""
    if not _ENABLED:
        return
    k = _key(name, labels)
    c = _shard().counters
    v = c.get(k)
    if v is None:
        _check_declared(name, "counter")  # series birth: validate once
        c[k] = n
    else:
        c[k] = v + n


def observe(name: str, value: float, **labels):
    """Histogram observation (log-bucketed)."""
    if not _ENABLED:
        return
    k = _key(name, labels)
    hs = _shard().hists
    h = hs.get(k)
    if h is None:
        _check_declared(name, "histogram")
        h = hs[k] = Histogram()
    h.observe(value)


def set_gauge(name: str, value: float, **labels):
    """Gauge store (last write wins, cluster-visible via scrape)."""
    if not _ENABLED:
        return
    k = _key(name, labels)
    with _lock:
        if k not in _gauges:
            _check_declared(name, "gauge")
        _gauges[k] = float(value)


# ---------------------------------------------------------------------------
# snapshot / wire / merge
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    """Merged process-wide view:
    {"counters": {key: int}, "gauges": {key: float},
     "hists": {key: Histogram}} with key = (name, labels_tuple)."""
    acc = _Shard()
    with _lock:
        _fold_dead_locked()
        _merge_shard(acc, _retired)
        for _ref, s in _shards:
            _merge_shard(acc, s)
        gauges = dict(_gauges)
    return {"counters": acc.counters, "gauges": gauges,
            "hists": acc.hists}


def counter_value(name: str, **labels) -> int:
    """Sum of every counter series matching ``name`` and the given
    label subset (cheap aggregation helper for benches/tests)."""
    want = set(labels.items())
    total = 0
    for (n, lt), v in snapshot()["counters"].items():
        if n == name and want <= set(lt):
            total += v
    return total


def wire_snapshot() -> dict:
    """JSON-able scrape body (the metrics.scrape reply):
    {"counters": [[name, {labels}, value], ...], "gauges": [...],
     "hists": [[name, {labels}, hist_wire], ...]}."""
    snap = snapshot()
    return {
        "counters": [[n, dict(lt), v]
                     for (n, lt), v in sorted(snap["counters"].items())],
        "gauges": [[n, dict(lt), v]
                   for (n, lt), v in sorted(snap["gauges"].items())],
        "hists": [[n, dict(lt), h.to_wire()]
                  for (n, lt), h in sorted(snap["hists"].items())],
    }


def merge_wire(a: dict, b: dict) -> dict:
    """Sum two scrape bodies (cluster aggregation: counters/hist buckets
    add, gauges last-write-wins by b)."""
    def kf(entry):
        return (entry[0], tuple(sorted(entry[1].items())))

    counters: dict = {}
    for src in (a, b):
        for n, lbl, v in src.get("counters", []):
            k = kf([n, lbl])
            counters[k] = counters.get(k, 0) + v
    gauges: dict = {}
    for src in (a, b):
        for n, lbl, v in src.get("gauges", []):
            gauges[kf([n, lbl])] = v
    hists: dict = {}
    for src in (a, b):
        for n, lbl, hw in src.get("hists", []):
            k = kf([n, lbl])
            h = hists.get(k)
            if h is None:
                hists[k] = Histogram.from_wire(hw)
            else:
                h.merge(Histogram.from_wire(hw))
    return {
        "counters": [[n, dict(lt), v]
                     for (n, lt), v in sorted(counters.items())],
        "gauges": [[n, dict(lt), v]
                   for (n, lt), v in sorted(gauges.items())],
        "hists": [[n, dict(lt), h.to_wire()]
                  for (n, lt), h in sorted(hists.items())],
    }


def series_id(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def wire_to_flat(wire: dict) -> dict:
    """Scrape body -> flat {series_id: value} dict — the shape bench
    artifacts embed so they share one schema with gv$sysstat."""
    out = {}
    for n, lbl, v in wire.get("counters", []):
        out[series_id(n, lbl)] = v
    for n, lbl, v in wire.get("gauges", []):
        out[series_id(n, lbl)] = v
    return out


def sysstat_dict() -> dict:
    """Local flat snapshot (counters + gauges), sorted keys."""
    return wire_to_flat(wire_snapshot())


# ---------------------------------------------------------------------------
# Prometheus text exposition (SHOW METRICS / metrics.scrape(format="prom"))
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    return "ob_" + name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    d = dict(labels)
    if extra:
        d.update(extra)
    if not d:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(d[k]).replace("\\", "\\\\").replace('"', '\\"'))
        for k in sorted(d))
    return "{" + inner + "}"


def prom_text(wire: dict | None = None) -> str:
    """Render a scrape body (default: this process) as Prometheus text
    exposition: counters/gauges verbatim, histograms as cumulative
    ``_bucket{le=...}`` series plus ``_count``/``_sum``."""
    if wire is None:
        wire = wire_snapshot()
    lines: list[str] = []
    seen_type: set[str] = set()

    def _type_line(pname: str, kind: str):
        if pname not in seen_type:
            seen_type.add(pname)
            lines.append(f"# TYPE {pname} {kind}")

    for n, lbl, v in wire.get("counters", []):
        pn = _prom_name(n)
        _type_line(pn, "counter")
        lines.append(f"{pn}{_prom_labels(lbl)} {v}")
    for n, lbl, v in wire.get("gauges", []):
        pn = _prom_name(n)
        _type_line(pn, "gauge")
        lines.append(f"{pn}{_prom_labels(lbl)} {v}")
    for n, lbl, hw in wire.get("hists", []):
        pn = _prom_name(n)
        _type_line(pn, "histogram")
        h = Histogram.from_wire(hw)
        cum = 0
        for i in sorted(h.buckets):
            cum += h.buckets[i]
            le = bucket_bound(i)
            if math.isinf(le):
                continue  # the overflow bucket IS the +Inf line below
            lines.append(
                f"{pn}_bucket{_prom_labels(lbl, {'le': f'{le:.9g}'})} "
                f"{cum}")
        lines.append(
            f"{pn}_bucket{_prom_labels(lbl, {'le': '+Inf'})} {h.count}")
        lines.append(f"{pn}_sum{_prom_labels(lbl)} {h.sum}")
        lines.append(f"{pn}_count{_prom_labels(lbl)} {h.count}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# reset (benches/tests only — concurrent writers may lose an in-flight
# increment; production never resets)
# ---------------------------------------------------------------------------


def reset():
    global _retired
    with _lock:
        _retired = _Shard()
        _gauges.clear()
        for _ref, s in _shards:
            s.counters.clear()
            s.hists.clear()
