"""Hand-written CUDA kernels for the hottest scan paths (port of
``oceanbase_tpu.ops``).  Sources live in ``csrc/``; ``_build`` compiles
them with nvcc for sm_90a at first use and loads them with ctypes."""

from oceanbase_tpu_torch.ops.scan_kernels import (
    q6_filter_sum,
    q6_filter_sum_reference,
)

__all__ = ["q6_filter_sum", "q6_filter_sum_reference"]
