"""Fused scan-filter-aggregate kernel (TPC-H Q6 shape) on Hopper.

Port of ``oceanbase_tpu/ops/scan_kernels.py``.  ``q6_filter_sum`` is the
wrapper of the hand-written CUDA kernel ``csrc/q6_filter_sum.cu`` (see
the note at its head for what bounds it and how it is built);
``q6_filter_sum_reference`` is its plain torch version.  The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from oceanbase_tpu_torch.ops import _build

KERNEL = "q6_filter_sum"
_COLUMNS = ("shipdate", "discount", "quantity", "extendedprice", "live")


def q6_filter_sum_reference(shipdate, discount, quantity, extendedprice,
                            live, *, ship_lo, ship_hi, disc_lo, disc_hi,
                            qty_hi) -> torch.Tensor:
    """Plain torch Q6: the masked sum of price * discount in int64."""
    keep = ((shipdate >= ship_lo) & (shipdate < ship_hi)
            & (discount >= disc_lo) & (discount <= disc_hi)
            & (quantity < qty_hi) & (live != 0))
    prod = extendedprice.to(torch.int64) * discount.to(torch.int64)
    return torch.where(keep, prod, torch.zeros_like(prod)).sum()


def _check_columns(cols) -> None:
    n = cols[0].shape[0] if cols[0].dim() == 1 else None
    dev = cols[0].device
    for name, t in zip(_COLUMNS, cols):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"q6_filter_sum: {name} is not a tensor")
        if t.dtype != torch.int32:
            raise TypeError(
                f"q6_filter_sum: {name} must be int32, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(
                f"q6_filter_sum: {name} must be 1-D of the same length as "
                f"shipdate, got shape {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(
                f"q6_filter_sum: {name} is on {t.device}, shipdate on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"q6_filter_sum: {name} must be contiguous")


def _launcher():
    fn = _build.load(KERNEL).q6_filter_sum_launch
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong,
                       i32, i32, i32, i32, i32, ptr, ptr]
        fn.restype = ctypes.c_int
    return fn


def q6_filter_sum(shipdate, discount, quantity, extendedprice, live,
                  *, ship_lo, ship_hi, disc_lo, disc_hi, qty_hi):
    """Exact fused Q6: sum(price * discount) over the filtered live rows.

    Five int32 column tensors of one length on one device; returns the
    scale-4 fixed-point revenue as a 0-d int64 tensor on that device.
    """
    cols = (shipdate, discount, quantity, extendedprice, live)
    _check_columns(cols)
    bounds = dict(ship_lo=int(ship_lo), ship_hi=int(ship_hi),
                  disc_lo=int(disc_lo), disc_hi=int(disc_hi),
                  qty_hi=int(qty_hi))
    dev = shipdate.device
    if dev.type == "cpu":
        return q6_filter_sum_reference(*cols, **bounds)
    if dev.type != "cuda":
        raise ValueError(f"q6_filter_sum: unsupported device {dev}")
    launch = _launcher()
    out = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*(t.data_ptr() for t in cols), shipdate.shape[0],
                    bounds["ship_lo"], bounds["ship_hi"], bounds["disc_lo"],
                    bounds["disc_hi"], bounds["qty_hi"], out.data_ptr(),
                    stream)
    if rc != 0:
        raise RuntimeError(f"q6_filter_sum: CUDA launch failed (error {rc})")
    _build.count_launch(KERNEL)
    return out
