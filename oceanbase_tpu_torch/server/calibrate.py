"""Roofline calibration: measured machine constants per backend.

Port of ``oceanbase_tpu/server/calibrate.py``.  Turning an execution's
flops/bytes (``exec/plan.py``'s analytic count) into *predicted seconds*
needs machine constants no datasheet gives: achieved FLOP/s, achieved
bytes/s and the per-launch overhead of the live backend.  A small
canonical suite — stream copy, masked reduce, segment group-by,
searchsorted probe, small matmul — runs across the shape-bucket ladder
on the database's device.  The reference writes the five probes in
``jnp``, not Pallas, so here they are plain torch ops; each is
mask-disciplined like the reference's (dead pad lanes cannot influence
its result).  From the measurements:

- ``peak_bytes_s``      — best achieved bytes/s (the bandwidth roof,
                          set by the streaming kernels);
- ``eff_bytes_s``       — WORST achieved bytes/s across the relational
                          suite (segment group-by, searchsorted probe
                          set it): relational programs are gather/
                          scatter-bound, so their roof is below stream
                          copy's;
- ``peak_flops_s``      — best achieved FLOP/s (the matmul probe);
- ``launch_overhead_s`` — a trivial ``x + 1`` with a synchronize, timed
                          on the host (median of repeats);
- ``rpc_s_per_byte``    — rpc.call_s over rpc.bytes from the metrics
                          plane; 0.0 in a single-node process.

Timing: on the card each probe runs once to warm up, then is captured
in a CUDA graph as calls over enough copies of its inputs (at least 128
MiB in all, over the H100's 50 MB L2) that each call reads from HBM,
not L2, forked over 4 streams so one call's fixed cost overlaps the
others' transfers; each repeat replays the graph between a CUDA
event pair (as many replays as keep the card busy about 5 ms, so its
clocks ramp and the replay launches amortize), and a call's time is the
minimum over repeats divided by the calls.  The graph keeps the host's
launch rate out of a device measurement: eager launches of a 3 µs
kernel would time the host.  On
the CPU a host clock times each repeat and the launch overhead is
subtracted, as the reference does.  The flops/bytes of each probe are
the reference's analytic pair (no XLA cost analysis here).

``predict_seconds`` is the roofline model the plan monitor q-errors
against measured device time: ``max(flops/F, bytes/B_eff) + calls * L``.

Constants persist as ``cost_units.json`` under the database root with a
crc64 of the canonical payload (``native.crc64``): a corrupt file raises
``CorruptionError`` and is quarantined (never served), after which the
probe runs again.  The probe is cached process-wide per backend — the
constants describe the device, not a Database instance.  It runs at
first boot ("boot" preset) and on ``ALTER SYSTEM CALIBRATE`` ("full"
ladder); knob ``enable_calibration`` gates both.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.native import crc64
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.storage.integrity import CorruptionError
from oceanbase_tpu_torch.vector.column import bucket_capacity

UNITS_FILE = "cost_units.json"

#: probe ladder presets: rungs for the vector kernels (rows) and the
#: matmul probe (square dim); "boot" stays well under a second so a
#: Database boot barely notices, "full" is ALTER SYSTEM CALIBRATE's
PRESETS = {
    "boot": {"rows": (65536,), "matmul": (128,), "repeats": 3},
    "full": {"rows": (16384, 65536, 262144, 1048576),
             "matmul": (128, 256), "repeats": 5},
}

_ROTATE_BYTES = 128 << 20   # inputs a graph replay streams through
_MAX_COPIES = 1024
_BUSY_S = 5e-3              # device time one measurement spans
_STREAMS = 4                # streams a captured graph forks its calls on


# ---------------------------------------------------------------------------
# the canonical kernel suite (mask-disciplined: dead lanes are inert)
# ---------------------------------------------------------------------------


def k_stream_copy(x, mask):
    """Pure streaming: read + write one lane per row; dead lanes emit
    the identity (0)."""
    return torch.where(mask, x, 0.0)


def k_masked_reduce(x, mask):
    """Bandwidth-bound reduction with the mask identity-element rule."""
    return torch.where(mask, x, 0.0).sum()


def k_segment_groupby(codes, vals, mask, n_groups: int):
    """Group-by core: masked segment-sum; dead lanes route to an
    overflow segment that is sliced away."""
    seg = torch.where(mask, codes, n_groups).to(torch.int64)
    sums = torch.zeros(n_groups + 1, dtype=vals.dtype, device=vals.device)
    sums.index_add_(0, seg, torch.where(mask, vals, 0.0))
    return sums[:n_groups]


def k_searchsorted(keys, probes, mask):
    """Join-probe core: binary search of probes in a sorted key column;
    dead probe lanes are sanitized before the search and zeroed after."""
    idx = torch.searchsorted(keys, torch.where(mask, probes, 0))
    return torch.where(mask, idx, 0)


def k_matmul(a, b, mask):
    """Compute-bound probe (the FLOP roof): dead rows of ``a`` zero out
    before the contraction."""
    return (a * mask[:, None].to(a.dtype)) @ b


def _ladder(rungs, floor: int = 64, growth: float = 2.0):
    """Snap the requested rungs to the shape-bucket ladder."""
    return tuple(bucket_capacity(r, floor, growth) for r in rungs)


def _probe_mask(n: int, device):
    """Probe relations carry ~1/8 dead pad lanes, mirroring a padded
    bucket, so the mask path is part of what gets measured."""
    return torch.as_tensor(np.arange(n) % 8 != 7, device=device)


def probe_cases(preset: str = "boot", device=None):
    """-> list of (name, rows, build() -> (fn, args), analytic_flops,
    analytic_bytes); ``build`` materializes the inputs on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    device = default_device(device)
    p = PRESETS[preset]
    cases = []
    for n in _ladder(p["rows"]):
        def build_stream(n=n):
            return k_stream_copy, (
                torch.arange(n, dtype=torch.float32, device=device),
                _probe_mask(n, device))

        cases.append(("stream_copy", n, build_stream,
                      float(n), float(n * 4 * 2 + n)))

        def build_reduce(n=n):
            return k_masked_reduce, (
                torch.arange(n, dtype=torch.float32, device=device),
                _probe_mask(n, device))

        cases.append(("masked_reduce", n, build_reduce,
                      float(2 * n), float(n * 4 + n)))

        def build_seg(n=n):
            g = max(min(n // 64, 4096), 8)
            codes = torch.as_tensor(np.arange(n) % g, dtype=torch.int32,
                                    device=device)
            vals = torch.arange(n, dtype=torch.float32, device=device)

            def fn(c, v, m):
                return k_segment_groupby(c, v, m, g)

            return fn, (codes, vals, _probe_mask(n, device))

        cases.append(("segment_groupby", n, build_seg,
                      float(2 * n), float(n * 8 + n)))

        def build_ss(n=n):
            keys = torch.arange(n, dtype=torch.int32, device=device)
            probes = torch.as_tensor((np.arange(n) * 7919) % n,
                                     dtype=torch.int32, device=device)
            return k_searchsorted, (keys, probes, _probe_mask(n, device))

        cases.append(("searchsorted", n, build_ss,
                      float(n * max(int(np.log2(max(n, 2))), 1)),
                      float(n * 12)))
    for m in p["matmul"]:
        def build_mm(m=m):
            a = torch.as_tensor(np.random.default_rng(7).standard_normal(
                (m, m)), dtype=torch.float32, device=device)
            b = torch.as_tensor(np.random.default_rng(11).standard_normal(
                (m, m)), dtype=torch.float32, device=device)
            return k_matmul, (a, b, torch.ones((m,), dtype=torch.bool,
                                               device=device))

        cases.append(("small_matmul", m, build_mm,
                      float(2 * m * m * m), float(3 * m * m * 4)))
    return cases


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


@dataclass
class CostUnits:
    """Per-backend machine constants (the gv$cost_units payload)."""

    backend: str = "unknown"
    device_kind: str = ""
    device_count: int = 0
    peak_flops_s: float = 0.0
    peak_bytes_s: float = 0.0
    eff_bytes_s: float = 0.0
    launch_overhead_s: float = 0.0
    rpc_s_per_byte: float = 0.0
    calibrated_ts: float = 0.0     # wall clock (record timestamp)
    preset: str = "boot"
    probe_s: float = 0.0           # how long the probe itself took
    measurements: list = field(default_factory=list)

    def age_s(self) -> float:
        return max(time.time() - self.calibrated_ts, 0.0) \
            if self.calibrated_ts else -1.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_overhead_s(device, repeats: int = 7) -> float:
    """Launch + sync floor: a 1-element ``x + 1`` and a synchronize,
    median of repeats on the host clock."""
    x = torch.zeros((1,), dtype=torch.float32, device=device)
    x + 1.0
    _sync(device)
    ts = []
    for _ in range(max(repeats, 3)):
        t0 = time.perf_counter()
        x + 1.0
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _time_graph(fn, args, device, repeats: int, nbytes: float):
    """-> (device seconds, raw host seconds) of one call on the card: a
    CUDA graph of back-to-back calls over rotated input copies, replayed
    between an event pair (module docstring)."""
    copies = int(min(max(-(-_ROTATE_BYTES // max(int(nbytes), 1)), 1),
                     _MAX_COPIES))
    sets = [args] + [tuple(a.clone() for a in args)
                     for _ in range(copies - 1)]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for a in sets[:3]:
            fn(*a)
    torch.cuda.current_stream(device).wait_stream(side)
    _sync(device)
    graph = torch.cuda.CUDAGraph()
    # thread-local capture: other sessions' threads may launch meanwhile
    # (ALTER SYSTEM CALIBRATE on a serving database)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        # fork the calls over a few streams and join them: a call's fixed
        # cost (a few µs a kernel node) overlaps the others' transfers,
        # as the many launches of a plan overlap on the card
        main = torch.cuda.current_stream(device)
        lanes = [main] + [torch.cuda.Stream(device)
                          for _ in range(_STREAMS - 1)]
        for lane in lanes[1:]:
            lane.wait_stream(main)
        outs = []
        for i, a in enumerate(sets):
            with torch.cuda.stream(lanes[i % _STREAMS]):
                outs.append(fn(*a))
        for lane in lanes[1:]:
            main.wait_stream(lane)

    def timed(replays):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for _ in range(replays):
            graph.replay()
        ev1.record()
        ev1.synchronize()
        return (ev0.elapsed_time(ev1) / 1e3,
                time.perf_counter() - t0)

    # enough replays per measurement that the card works a few ms: its
    # clocks ramp and the replays' own launches amortize
    once, _raw = timed(1)
    replays = int(min(max(_BUSY_S // max(once, 1e-9), 1), 1000))
    best_dev = best_raw = float("inf")
    for _ in range(max(repeats, 2)):
        dev_s, raw_s = timed(replays)
        best_dev, best_raw = min(best_dev, dev_s), min(best_raw, raw_s)
    del graph, outs, sets
    calls = copies * replays
    return max(best_dev / calls, 1e-9), best_raw / calls


def _time_call(fn, args, device, repeats: int, launch_s: float,
               nbytes: float = 0.0):
    """-> (device seconds, raw host seconds) of one call, min of
    ``repeats`` after a warm-up; a replayed CUDA graph on the card, the
    host clock minus the launch floor on the CPU."""
    fn(*args)  # warm
    _sync(device)
    if device.type == "cuda":
        return _time_graph(fn, args, device, repeats, nbytes)
    best_raw = float("inf")
    for _ in range(max(repeats, 2)):
        t0 = time.perf_counter()
        fn(*args)
        best_raw = min(best_raw, time.perf_counter() - t0)
    return max(best_raw - launch_s, 1e-9), best_raw


def _backend(device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def run_probe(preset: str = "boot", device=None) -> CostUnits:
    """Run the canonical suite on ``device`` (``cuda`` unless the caller
    asks for the CPU) -> fresh CostUnits.  Pure measurement: no caching,
    no persistence (ensure_units layers those)."""
    device = default_device(device)
    t_start = time.perf_counter()
    on_cuda = device.type == "cuda"
    units = CostUnits(
        backend=_backend(device),
        device_kind=(torch.cuda.get_device_name(device) if on_cuda
                     else device.type),
        device_count=torch.cuda.device_count() if on_cuda else 1,
        preset=preset,
        calibrated_ts=time.time(),
    )
    units.launch_overhead_s = _launch_overhead_s(device)
    repeats = PRESETS[preset]["repeats"]
    best_bytes_s = 0.0
    best_flops_s = 0.0
    worst_bytes_s = float("inf")
    for name, rows, build, flops, nbytes in probe_cases(preset, device):
        fn, args = build()
        dev_s, raw_s = _time_call(fn, args, device, repeats,
                                  units.launch_overhead_s, nbytes)
        units.measurements.append({
            "kernel": name, "rows": int(rows),
            "flops": float(flops), "bytes": float(nbytes),
            "device_s": round(dev_s, 9), "raw_s": round(raw_s, 9),
            "gflops": round(flops / dev_s / 1e9, 4),
            "gbps": round(nbytes / dev_s / 1e9, 4)})
        if name in ("stream_copy", "masked_reduce") and nbytes > 0:
            best_bytes_s = max(best_bytes_s, nbytes / dev_s)
        if name != "small_matmul" and nbytes > 0:
            # the relational kernels' WORST rate is the effective
            # bandwidth roof for plan-shaped work
            worst_bytes_s = min(worst_bytes_s, nbytes / dev_s)
        if flops > 0:
            best_flops_s = max(best_flops_s, flops / dev_s)
    units.peak_bytes_s = best_bytes_s
    units.eff_bytes_s = (worst_bytes_s
                         if worst_bytes_s != float("inf") else 0.0)
    units.peak_flops_s = best_flops_s
    units.rpc_s_per_byte = rpc_s_per_byte()
    units.probe_s = round(time.perf_counter() - t_start, 4)
    return units


def rpc_s_per_byte() -> float:
    """Wire cost per byte from the metrics plane: total rpc rtt seconds
    over total rpc payload bytes (0.0 before any rpc ran)."""
    snap = qmetrics.snapshot()
    rtt_s = sum(h.sum for (n, _lbl), h in snap["hists"].items()
                if n == "rpc.call_s")
    nbytes = sum(v for (n, _lbl), v in snap["counters"].items()
                 if n == "rpc.bytes")
    return rtt_s / nbytes if nbytes > 0 else 0.0


# ---------------------------------------------------------------------------
# the roofline model (what the CBO prices plans with)
# ---------------------------------------------------------------------------


def predict_seconds(units: CostUnits, flops: float, nbytes: float,
                    calls: int = 1) -> float:
    """Roofline prediction: ``max(flops/F, bytes/B_eff) + calls * L``
    with the effective relational bandwidth as the byte roof (falling
    back to the stream peak where none was measured)."""
    t = 0.0
    if units.peak_flops_s > 0:
        t = max(t, max(flops, 0.0) / units.peak_flops_s)
    bytes_s = units.eff_bytes_s or units.peak_bytes_s
    if bytes_s > 0:
        t = max(t, max(nbytes, 0.0) / bytes_s)
    return t + max(int(calls), 1) * max(units.launch_overhead_s, 0.0)


def time_q_error(pred_s: float, actual_s: float) -> float:
    """Symmetric misprediction factor, >= 1.0 (0.0 = nothing to
    compare) — the time twin of exec/plan.py::q_error."""
    if pred_s <= 0.0 or actual_s <= 0.0:
        return 0.0
    return max(pred_s / actual_s, actual_s / pred_s)


# ---------------------------------------------------------------------------
# persistence (checksummed, never serve poisoned)
# ---------------------------------------------------------------------------


def _units_path(root: str) -> str:
    return os.path.join(root, UNITS_FILE)


def save_units(root: str, units: CostUnits) -> str:
    """Persist with an embedded crc64 of the canonical payload bytes."""
    payload = json.dumps(asdict(units), sort_keys=True)
    doc = {"crc": crc64(payload.encode()), "units": json.loads(payload)}
    path = _units_path(root)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_units(root: str) -> CostUnits | None:
    """-> persisted CostUnits, None when absent.  A file that fails its
    checksum raises CorruptionError — corrupt machine constants must
    never price a plan."""
    path = _units_path(root)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            doc = json.load(fh)
        body = doc["units"]
        want = int(doc["crc"])
    except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
        raise CorruptionError(
            f"cost_units.json unreadable: {e}", kind="cost_units",
            path=path) from e
    got = crc64(json.dumps(body, sort_keys=True).encode())
    if got != want:
        raise CorruptionError(
            f"cost_units.json checksum mismatch (stored {want}, "
            f"computed {got})", kind="cost_units", path=path)
    known = {f.name for f in CostUnits.__dataclass_fields__.values()}
    return CostUnits(**{k: v for k, v in body.items() if k in known})


def quarantine_units(root: str) -> str | None:
    """Move a corrupt cost_units.json aside (kept for forensics) so the
    next probe starts clean."""
    path = _units_path(root)
    if not os.path.exists(path):
        return None
    dst = path + ".corrupt"
    try:
        os.replace(path, dst)
        return dst
    except OSError:
        return None


# ---------------------------------------------------------------------------
# process-wide cache (the constants describe the device, not a Database)
# ---------------------------------------------------------------------------

_PROC_UNITS: CostUnits | None = None
_PROC_LOCK = threading.Lock()


def get_cost_units() -> CostUnits | None:
    """The process's current machine constants (None until a boot probe
    or ALTER SYSTEM CALIBRATE ran)."""
    return _PROC_UNITS


def set_cost_units(units: CostUnits | None):
    global _PROC_UNITS
    _PROC_UNITS = units


def ensure_units(root: str | None = None, preset: str = "boot",
                 force: bool = False, device=None) -> CostUnits:
    """Boot/CALIBRATE entry point: adopt valid persisted constants for
    this backend (``device``'s; ``cuda`` unless the caller asks for the
    CPU), else probe once per process; persist to ``root`` when given.
    ``force`` re-probes (ALTER SYSTEM CALIBRATE)."""
    global _PROC_UNITS
    device = default_device(device)
    backend = _backend(device)
    with _PROC_LOCK:
        if not force:
            if _PROC_UNITS is not None and \
                    _PROC_UNITS.backend == backend:
                if root and not os.path.exists(_units_path(root)):
                    save_units(root, _PROC_UNITS)
                return _PROC_UNITS
            if root:
                try:
                    loaded = load_units(root)
                except CorruptionError:
                    quarantine_units(root)
                    loaded = None
                if loaded is not None and loaded.backend == backend:
                    _PROC_UNITS = loaded
                    return loaded
        units = run_probe(preset, device)
        _PROC_UNITS = units
        if root:
            save_units(root, units)
        return units


__all__ = ["CostUnits", "PRESETS", "UNITS_FILE", "ensure_units",
           "get_cost_units", "load_units", "predict_seconds",
           "probe_cases", "quarantine_units", "run_probe", "save_units",
           "set_cost_units", "time_q_error"]
