"""The card's published peaks and the least time a kernel's work needs.

One NVIDIA H100 SXM (NVIDIA's data sheet, at its full 700 W limit): HBM
at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores counting an FMA
as two operations.  The port's kernels are built with `-fmad=false`, so a
multiply and an add are two instructions and the single-operation rate is
33.5e12/s.  A Moller-Trumbore ray-triangle test is 46 such operations
(the count the port's bounds have always used).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 33.5e12
MT_FLOPS = 46


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The larger of moving n_bytes at the HBM rate and doing n_ops single
    float operations at the float32 rate, in seconds."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S)
