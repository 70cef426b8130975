"""Resolved-backend identity: which hardware this database runs on.

Port of ``oceanbase_tpu/server/backend_info.py``: the same record shape
(platform, device kind, device count, cpu_fallback), resolved from
``torch.cuda`` for the database's device instead of a JAX probe.  It
feeds the ``Database`` boot log line and ``gv$backend``.
``cpu_fallback`` is true only when the caller asked for the CPU: the
port never falls back on its own (``oceanbase_tpu_torch.default_device``
raises without CUDA).  The reference also reads its TPU probe's log;
the port has no such probe, so those gv$backend columns are empty.
"""

from __future__ import annotations

import torch


def resolve_backend(device) -> dict:
    """-> {platform, device_kind, device_count, cpu_fallback} of
    ``device`` (a torch.device)."""
    if device.type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(device),
                "device_count": torch.cuda.device_count(),
                "cpu_fallback": False}
    return {"platform": device.type, "device_kind": device.type,
            "device_count": 1, "cpu_fallback": True}


def backend_summary(device, units=None) -> str:
    """One-line boot summary: backend kind, device count, fallback,
    calibration age."""
    b = resolve_backend(device)
    age = units.age_s() if units is not None else -1.0
    return " ".join([
        f"platform={b['platform']}",
        f"device_kind={b['device_kind'] or '-'}",
        f"devices={b['device_count']}",
        f"cpu_fallback={int(b['cpu_fallback'])}",
        "calibration_age_s="
        + (f"{age:.0f}" if age >= 0 else "uncalibrated"),
    ])


__all__ = ["backend_summary", "resolve_backend"]
