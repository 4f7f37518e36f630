"""Row gathers with zeros outside the table: K5a and its backward K5b (port
of `ops/gather.py`).

`take_rows(table, idx)` is out[i] = table[idx[i]], a row of zeros where idx
lies outside [0, T).  One autograd Function carries it: its forward is K5a
and its backward K5b, the scatter-add of the cotangent rows into d_table
(`csrc/gather.cu`); the indices get no gradient.  On a CUDA tensor both
directions launch the kernels; on a CPU tensor they run the plain
versions (`take_rows_plain`: clamp, index, where; `take_rows_bwd_plain`:
`index_add_` over the in-range rows).

The reference keeps its one-hot Pallas kernel off by default: on the TPU the
custom call broke XLA's fusion around every call site.  Eager PyTorch has
no fusion to break, and the native gather costs about five launches forward
(clamp, index, two compares, where) and several backward, where K5 costs one
each way for the same function (rows are copied exactly).  So every CUDA
`take_rows` runs K5, whatever T is: the Hopper kernel reads rows from
global memory and has no counterpart of the reference's VMEM row limit.
"""

from __future__ import annotations

import torch

from . import cuda_lib

# Kernel launches since the last reset, one count per direction.
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0


def take_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain-torch K5a: out[i] = table[idx[i]]; zeros outside [0, T)."""
    t = table.shape[0]
    rows = table[torch.clamp(idx, 0, t - 1)]
    good = ((idx >= 0) & (idx < t))[:, None]
    return torch.where(good, rows, 0.0)


def take_rows_bwd_plain(idx: torch.Tensor, ct: torch.Tensor,
                        t: int) -> torch.Tensor:
    """Plain-torch K5b: d_table f32[T, W], the sum of the cotangent rows
    ct[i] over the i with idx[i] == k; out-of-range rows add nothing."""
    good = (idx >= 0) & (idx < t)
    d_table = torch.zeros((t, ct.shape[1]), dtype=ct.dtype, device=ct.device)
    return d_table.index_add_(0, idx[good].long(), ct[good])


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"take_rows wants table [T, W] and idx [N], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.device != idx.device:
        raise ValueError(f"table is on {table.device}, idx on {idx.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"take_rows: unsupported device {table.device}")


def _check_kernel_args(values: torch.Tensor, idx: torch.Tensor, t: int,
                       w: int) -> None:
    """The kernels take an f32 table (forward) or cotangent (backward), int32
    or int64 indices, both contiguous, and a table of under 2^31 values."""
    if values.dtype != torch.float32:
        raise TypeError(f"table and cotangent must be float32, got "
                        f"{values.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if not values.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table, cotangent and idx must be contiguous")
    if t * w >= 1 << 31:
        raise ValueError(f"a [{t}, {w}] table is too large for the kernels' "
                         "32-bit table indexing")


def gather_fwd(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5a on the tensors' device: the kernel for CUDA tensors, the plain
    version for CPU tensors (no autograd of its own)."""
    global LAUNCHES_FWD
    _check(table, idx)
    if table.device.type == "cpu":
        return take_rows_plain(table, idx)
    n, (t, w) = idx.shape[0], table.shape
    _check_kernel_args(table, idx, t, w)
    out = torch.empty((n, w), dtype=torch.float32, device=table.device)
    if n == 0 or w == 0:
        return out
    lib = cuda_lib.library()
    fn = (lib.pbr_gather_fwd_i32 if idx.dtype == torch.int32
          else lib.pbr_gather_fwd_i64)
    rc = fn(table.data_ptr(), idx.data_ptr(), n, t, w, out.data_ptr(),
            cuda_lib.stream_ptr(table.device))
    cuda_lib.check(rc, "pbr_gather_fwd")
    LAUNCHES_FWD += 1
    return out


def gather_bwd(idx: torch.Tensor, ct: torch.Tensor, t: int) -> torch.Tensor:
    """K5b on the tensors' device: d_table f32[T, W] from the cotangent rows
    ct f32[N, W] (kernel for CUDA tensors, plain version for CPU ones)."""
    global LAUNCHES_BWD
    _check(ct, idx)
    if ct.shape[0] != idx.shape[0]:
        raise ValueError(f"ct has {ct.shape[0]} rows, idx {idx.shape[0]}")
    if ct.device.type == "cpu":
        return take_rows_bwd_plain(idx, ct, t)
    n, w = ct.shape
    _check_kernel_args(ct, idx, t, w)
    d_table = torch.zeros((t, w), dtype=torch.float32, device=ct.device)
    if n == 0 or w == 0 or t == 0:
        return d_table
    lib = cuda_lib.library()
    fn = (lib.pbr_gather_bwd_i32 if idx.dtype == torch.int32
          else lib.pbr_gather_bwd_i64)
    rc = fn(idx.data_ptr(), ct.data_ptr(), n, t, w, d_table.data_ptr(),
            cuda_lib.stream_ptr(ct.device))
    cuda_lib.check(rc, "pbr_gather_bwd")
    LAUNCHES_BWD += 1
    return d_table


class _TakeRows(torch.autograd.Function):
    """out = K5a(table, idx); d_table = K5b(idx, d_out); no gradient for
    idx."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return gather_fwd(table, idx)

    @staticmethod
    def backward(ctx, ct):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        # Autograd may hand over a broadcast or strided cotangent; the
        # kernel reads dense rows.
        return gather_bwd(idx, ct.contiguous(), ctx.n_rows), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]; zeros where idx is outside [0, T).

    table f32[T, W], idx int32 or int64 [N].  K5a forward and K5b backward:
    the kernels on a CUDA tensor, their plain versions on a CPU tensor.
    The reference's `force` switch is not carried over: `take_rows_plain`
    is the plain torch route (with torch's own autograd) on any device.
    """
    return _TakeRows.apply(table, idx)


def take_values(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """1-D convenience: out[i] = table[idx[i]] for table f32[T]."""
    return take_rows(table[:, None], idx)[:, 0]
