"""The four primitive probes P1-P4 (port of the kernels of the reference
repository's `tools/probe2.py`): wrappers, plain versions, launch counts.

  P1 `scalar_stack(boxes)`    one scalar walk of an implicit binary tree of
                              boxes with a stack -> (visited, leaves), leaves
  P2 `relayout(x)`            an [8, 128] tile moved to a [1024, 1] column
                              ten times (x + i), summed, and moved back
  P3 `onehot_mm(win, rows)`   rows.T[win] as a one-hot product
  P4 `gather(x, idx, axis)`   take_along_axis(x, idx, axis)

Each wrapper launches its kernel (`csrc/probes.cu`) for CUDA tensors and
raises on what the kernel does not take; for CPU tensors it runs the plain
version beside it.  The plain versions repeat the kernels' arithmetic step
by step and are used by the tests and by nothing on a card.  `LAUNCHES`
counts kernel launches by probe name.  The tool that drives them is
`tools/probe2.py` of this package.
"""

from __future__ import annotations

import torch

from . import cuda_lib

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"scalar_stack": 0, "relayout": 0, "onehot_mm": 0, "gather": 0}

TILE = (8, 128)        # P2's tile: eight sublanes by 128 lanes
RELAYOUT_MOVES = 10
MAX_NODES = 8191       # P1: boxes, stack and leaf list fit in 227 KB
MAX_MM_ROWS = 32       # P3: attribute rows per CTA


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor of "
                         f"{dtype}, got {t.dtype} {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _same_device(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"inputs are on {a.device} and {b.device}")


# --------------------------------------------------------------------- P1

def leaf_capacity(n_nodes: int) -> int:
    """Leaves of the implicit tree: the nodes whose left child 2 i + 1 lies
    outside it."""
    return (n_nodes + 1) // 2


def scalar_stack_plain(boxes: torch.Tensor):
    """Plain P1: a Python loop over a CPU copy of the boxes.  Pop the top
    of the stack, test max(lo) <= min(hi) in float32, push the children
    (left, then left + 1) or record a leaf."""
    b = boxes.detach().cpu().reshape(-1, 6)
    n = b.shape[0]
    near = b[:, :3].amax(dim=1)
    far = b[:, 3:].amin(dim=1)
    hit = (near <= far).tolist()
    stack, cand, visited = [0], [], 0
    while stack:
        node = stack.pop()
        if hit[node]:
            left = 2 * node + 1
            if left < n:
                stack.append(left)
                stack.append(left + 1)
            else:
                cand.append(node)
        visited += 1
    out = torch.tensor([visited, len(cand)], dtype=torch.int32,
                       device=boxes.device)
    leaves = torch.full((leaf_capacity(n),), -1, dtype=torch.int32)
    leaves[:len(cand)] = torch.tensor(cand, dtype=torch.int32)
    return out, leaves.to(boxes.device)


def scalar_stack(boxes: torch.Tensor):
    """P1 -> (out i32[2] = (nodes visited, leaves found), leaves
    i32[(n + 1) // 2]: the leaves in visiting order, then -1).

    boxes f32[n * 6], node i at [6 i : 6 i + 6] as lo xyz | hi xyz; n odd
    (a complete binary tree: every inner node has both children).
    """
    _require(boxes, "boxes", torch.float32, 1)
    n = boxes.shape[0] // 6
    if boxes.shape[0] != n * 6 or n % 2 == 0 or not 1 <= n <= MAX_NODES:
        raise ValueError(f"boxes must hold 6 floats for an odd number of "
                         f"nodes up to {MAX_NODES}, got {boxes.shape[0]} "
                         "floats")
    if boxes.device.type == "cpu":
        return scalar_stack_plain(boxes)
    cap = leaf_capacity(n)
    out = torch.empty((2,), dtype=torch.int32, device=boxes.device)
    leaves = torch.empty((cap,), dtype=torch.int32, device=boxes.device)
    rc = cuda_lib.library().pbr_probe_scalar_stack(
        boxes.data_ptr(), n, cap, out.data_ptr(), leaves.data_ptr(),
        cuda_lib.stream_ptr(boxes.device))
    cuda_lib.check(rc, "pbr_probe_scalar_stack")
    LAUNCHES["scalar_stack"] += 1
    return out, leaves


# --------------------------------------------------------------------- P2

def relayout_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain P2: ten times (x + i) reshaped to a column and summed, then
    reshaped back."""
    acc = torch.zeros((x.numel(), 1), dtype=x.dtype, device=x.device)
    for i in range(RELAYOUT_MOVES):
        acc = acc + (x + float(i)).reshape(-1, 1)
    return acc.reshape(x.shape)


def relayout(x: torch.Tensor, exchange: bool = True) -> torch.Tensor:
    """P2: x f32[8, 128] -> sum over i < 10 of (x + i), each term moved from
    tile to column ownership across the block's threads and the sum moved
    back.  exchange=False runs the kernel's second instantiation, which
    keeps every value in its thread: the same result, and the time of
    everything but the moves."""
    _require(x, "x", torch.float32, 2)
    if tuple(x.shape) != TILE:
        raise ValueError(f"x must be {TILE}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return relayout_plain(x)
    out = torch.empty_like(x)
    rc = cuda_lib.library().pbr_probe_relayout(
        x.data_ptr(), out.data_ptr(), int(exchange),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "pbr_probe_relayout")
    LAUNCHES["relayout"] += 1
    return out


# --------------------------------------------------------------------- P3

def onehot_mm_plain(win: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain P3: the one-hot mask times the rows, summed over the lanes,
    step by step (no matrix product)."""
    lanes = torch.arange(rows.shape[1], device=rows.device, dtype=win.dtype)
    mask = (lanes[None, :] == win.reshape(-1, 1)).to(torch.float32)
    return (mask[:, None, :] * rows[None, :, :]).sum(dim=-1)


def onehot_mm(win: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """P3: win i32[N, 1] (the winning lane of each output row), rows
    f32[R <= 32, L] -> f32[N, R], out[i, r] = sum over lane of
    (lane == win[i]) * rows[r, lane]: rows.T[win] as a contraction over the
    lanes, on the CUDA cores."""
    _require(win, "win", torch.int32, 2)
    _require(rows, "rows", torch.float32, 2)
    _same_device(win, rows)
    n, (r, l) = win.shape[0], rows.shape
    if win.shape[1] != 1 or not 1 <= r <= MAX_MM_ROWS or l < 1:
        raise ValueError(f"win must be [N, 1] and rows [R <= {MAX_MM_ROWS}, "
                         f"L], got {tuple(win.shape)} and {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return onehot_mm_plain(win, rows)
    out = torch.empty((n, r), dtype=torch.float32, device=rows.device)
    if n == 0:
        return out
    rc = cuda_lib.library().pbr_probe_onehot_mm(
        win.data_ptr(), rows.data_ptr(), n, r, l, out.data_ptr(),
        cuda_lib.stream_ptr(rows.device))
    cuda_lib.check(rc, "pbr_probe_onehot_mm")
    LAUNCHES["onehot_mm"] += 1
    return out


# --------------------------------------------------------------------- P4

def gather_plain(x: torch.Tensor, idx: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Plain P4 by advanced indexing; indices are clamped into range, as in
    the kernel."""
    rows, lanes = x.shape
    k = idx.long().clamp(0, (rows if axis == 0 else lanes) - 1)
    if axis == 0:
        return x[k, torch.arange(lanes, device=x.device)[None, :]]
    return x[torch.arange(rows, device=x.device)[:, None], k]


def gather(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """P4: take_along_axis.  x f32[R, L], idx i32[R, L] ->
    out[r, c] = x[idx[r, c], c] (axis 0) or x[r, idx[r, c]] (axis 1);
    indices outside the axis are clamped to its ends."""
    _require(x, "x", torch.float32, 2)
    _require(idx, "idx", torch.int32, 2)
    _same_device(x, idx)
    if idx.shape != x.shape or axis not in (0, 1):
        raise ValueError(f"idx must have x's shape {tuple(x.shape)} and axis "
                         f"be 0 or 1, got {tuple(idx.shape)} and {axis}")
    if x.numel() >= 1 << 31:
        raise ValueError("x is too large for the kernel's 32-bit indexing")
    if x.device.type == "cpu":
        return gather_plain(x, idx, axis)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = cuda_lib.library().pbr_probe_gather(
        x.data_ptr(), idx.data_ptr(), x.shape[0], x.shape[1], axis,
        out.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "pbr_probe_gather")
    LAUNCHES["gather"] += 1
    return out
