"""Machine constants the cost-based optimizer prices plans with.

The part of ``oceanbase_tpu/server/calibrate.py`` the optimizer needs:
``CostUnits``, the roofline ``predict_seconds`` and the process-wide
units (``get_cost_units``).  Nothing here measures yet, so
``get_cost_units()`` is None and the optimizer prices plans with its
uncalibrated constants, as the JAX package does before its first probe.
The probes (timed on the card with CUDA events) wait for ROADMAP Queue 1
item 9.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CostUnits:
    """Per-backend machine constants (the gv$cost_units payload)."""

    backend: str = "unknown"
    peak_flops_s: float = 0.0
    peak_bytes_s: float = 0.0
    eff_bytes_s: float = 0.0
    launch_overhead_s: float = 0.0


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


_PROC_UNITS: CostUnits | None = None


def get_cost_units() -> CostUnits | None:
    """The process's measured machine constants (None: not measured)."""
    return _PROC_UNITS


__all__ = ["CostUnits", "get_cost_units", "predict_seconds"]
