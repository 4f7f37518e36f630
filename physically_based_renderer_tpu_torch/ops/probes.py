"""The primitive probes P1-P8 (port of the kernels of the reference
repository's `tools/probe2.py`, `tools/probe_mosaic.py` and
`tools/exp_subtile_dma.py`): wrappers, plain versions, launch counts.

  P1 `scalar_stack(boxes)`    what a scalar walk of an implicit binary tree
                              of boxes with a stack finds -> (visited,
                              leaves), the leaves in pop order
  P2 `relayout(x, route)`     an [8, 128] tile moved to a [1024, 1] column
                              ten times (x + i), summed, and moved back:
                              element by element, since both views have
                              the same flat order (route "elementwise"),
                              or across threads ("exchange")
  P3 `onehot_mm(win, rows)`   rows.T[win] as a one-hot product
  P4 `gather(x, idx, axis)`   take_along_axis(x, idx, axis)
  P5 `mosaic_gather(x, idx, axis, reps)`
                              sum over i < reps of take_along_axis(x,
                              (idx + i) mod size, axis)
  P6 `mosaic_scalar_stack(boxes)`
                              P1's walk without the leaf list -> visited
  P7 `chunk(o, t, n_chunks)`  the block tracer's per-chunk arithmetic on
                              b rays x w columns, masked, min
  P8 `subtile_copy(src, idx, n_iters, ch)`
                              [16, 32] tiles picked by idx, summed over rows
                              and steps (the reference: double-buffered
                              copies)

Each wrapper launches its kernel (`csrc/probes.cu` for P1-P4,
`csrc/mosaic.cu` for P5-P8) for CUDA tensors and raises on what the kernel
does not take; for CPU tensors it runs the plain version beside it.  The
plain versions repeat the kernels' arithmetic step by step and are used by
the tests and by nothing on a card.  `LAUNCHES` counts kernel launches by
probe name.  The tools that drive them are `tools/probe2.py`,
`tools/probe_mosaic.py` and `tools/exp_subtile_dma.py` of this package.
`empty_kernel` launches a kernel that does nothing, the floor under these
kernels' times, `sector_read` one that reads a table at precomputed
random addresses, the card's random-sector read ceiling under P4's gather,
and `subtile_read` one that reads P8's copies in its direct route's order
with no arithmetic, the every-copy read ceiling under that route; they
port nothing and are counted nowhere.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_lib

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"scalar_stack": 0, "relayout": 0, "onehot_mm": 0, "gather": 0,
            "mosaic_gather": 0, "mosaic_scalar_stack": 0, "chunk": 0,
            "subtile_copy": 0}

TILE = (8, 128)        # P2's tile: eight sublanes by 128 lanes
RELAYOUT_MOVES = 10
RELAYOUT_ROUTES = ("elementwise", "exchange")
MAX_NODES = 8191       # P1, P6: a flag a node in static shared memory
MAX_MM_ROWS = 32       # P3: attribute rows at most (the probe's chunk rows)
TILE_P8 = (16, 32)     # P8: one copied tile, 2 KB
MAX_P8_CH = 32         # P8: ch x 32 threads a CTA


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b (float32) hold the same bit patterns, the sign of zero
    included."""
    b = b.to(a.device)
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def same_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b (float32) are NaN at the same places and hold the same bit
    patterns elsewhere, the sign of zero included (a NaN's own bits differ
    between the CPU and the card)."""
    b = b.to(a.device)
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return False
    ok = a.isnan()
    return torch.equal(a.view(torch.int32)[~ok], b.view(torch.int32)[~ok])


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
    i32[(n + 1) // 2]: the leaves in the walk's pop order, then -1).  The
    kernel finds them without a serial walk (`csrc/probes.cu`).

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


def empty_kernel(device) -> None:
    """Launch a kernel of one warp that does nothing on the CUDA `device`:
    the launch floor under every kernel this small."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_kernel: needs a CUDA device, got {device}")
    cuda_lib.check(cuda_lib.library().pbr_probe_empty(
        cuda_lib.stream_ptr(device)), "pbr_probe_empty")


# --------------------------------------------------------------------- P2

def relayout_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain P2: ten times (x + i) reshaped to a column and summed, then
    reshaped back."""
    acc = torch.zeros((x.numel(), 1), dtype=x.dtype, device=x.device)
    for i in range(RELAYOUT_MOVES):
        acc = acc + (x + float(i)).reshape(-1, 1)
    return acc.reshape(x.shape)


def relayout(x: torch.Tensor, route: str = "elementwise") -> torch.Tensor:
    """P2: x f32[8, 128] -> sum over i < 10 of (x + i), reshaped to a column
    and back.  Route "elementwise" (`probe_relayout_kernel`): a thread owns
    four consecutive elements, the same in both views, so no value crosses
    a thread (x 16-byte aligned).  Route "exchange"
    (`probe_relayout_exchange_kernel`): each term moved from tile to column
    ownership across the block's threads through shared memory and the sum
    moved back, the price of a real relayout on the card.  The same result
    bit for bit; one launch either way."""
    _require(x, "x", torch.float32, 2)
    if tuple(x.shape) != TILE:
        raise ValueError(f"x must be {TILE}, got {tuple(x.shape)}")
    if route not in RELAYOUT_ROUTES:
        raise ValueError(f"route must be one of {RELAYOUT_ROUTES}, got "
                         f"{route!r}")
    if x.device.type == "cpu":
        return relayout_plain(x)
    if route == "elementwise" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the elementwise route")
    out = torch.empty_like(x)
    rc = cuda_lib.library().pbr_probe_relayout(
        x.data_ptr(), out.data_ptr(), int(route == "exchange"),
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
    lanes.  The kernel computes it as the gather it is, without the
    product: rows[r, win[i]] + 0.0, NaN where row r holds a non-finite
    entry at another lane (0 * inf), +0.0 or that NaN for a win outside
    [0, L) (`csrc/probes.cu`)."""
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


def gather_plan(rows: int, lanes: int, axis: int) -> GatherPlan:
    """P4's route for x [rows, lanes] along `axis`: P5's plan at reps 1
    (`mosaic_gather_plan`), a slab a CTA stages or the direct route,
    whichever its byte model finds faster.  (Read at each call, so that
    `tools/sweep.py` can time other plans.)"""
    return mosaic_gather_plan(rows, lanes, axis, 1)


def gather(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """P4: take_along_axis.  x f32[R, L], idx i32[R, L] ->
    out[r, c] = x[idx[r, c], c] (axis 0) or x[r, idx[r, c]] (axis 1);
    indices outside the axis are clamped to its ends.  The kernel takes
    `gather_plan`'s route: the direct one (a thread an output, x read
    through L1/L2) or P5's slab staged in shared memory."""
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
    rows, lanes = x.shape
    plan = gather_plan(rows, lanes, axis)
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(x.device)
    if plan.route == "slab":
        rc = lib.pbr_probe_gather_slab(
            x.data_ptr(), idx.data_ptr(), rows, lanes, axis, plan.tile,
            plan.per, plan.threads, out.data_ptr(), stream)
    else:
        rc = lib.pbr_probe_gather(x.data_ptr(), idx.data_ptr(), rows, lanes,
                                  axis, out.data_ptr(), stream)
    cuda_lib.check(rc, f"pbr_probe_gather ({plan.route})")
    LAUNCHES["gather"] += 1
    return out


def sector_read_plain(table: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """Plain `sector_read`: each four reads summed in order."""
    v = table.reshape(-1)[addr.long()].reshape(-1, 4)
    return ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]


def sector_read(table: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """The card's random-sector read ceiling: table f32 (contiguous, any
    shape), addr i32[n] (n % 4 == 0, each an index into the flattened
    table) -> f32[n / 4], out[t] = ((table[a0] + table[a1]) + table[a2]) +
    table[a3] over addr[4 t : 4 t + 4].  Each thread reads its four
    addresses as one int4 and gathers without arithmetic or clamping: at
    random rows of a table it times the gathered sectors alone.  Ports
    nothing; counted nowhere."""
    _require(addr, "addr", torch.int32, 1)
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("table must be a contiguous float32 tensor")
    _same_device(table, addr)
    if addr.shape[0] % 4 or table.numel() >= 1 << 31:
        raise ValueError(f"addr must hold a multiple of 4 indices into a "
                         f"table below 2^31 floats, got {addr.shape[0]} "
                         f"and {table.numel()}")
    if table.device.type == "cpu":
        return sector_read_plain(table, addr)
    _aligned16(addr, "addr")
    out = torch.empty((addr.shape[0] // 4,), dtype=torch.float32,
                      device=table.device)
    rc = cuda_lib.library().pbr_probe_sector_read(
        table.data_ptr(), addr.data_ptr(), addr.shape[0], out.data_ptr(),
        cuda_lib.stream_ptr(table.device))
    cuda_lib.check(rc, "pbr_probe_sector_read")
    return out


def _aligned16(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         "kernel reads it in 16-byte pieces)")


# --------------------------------------------------------------------- P5

# P5's routes (csrc/mosaic.cu: kRouteSlab, kRouteDirect).
GATHER_ROUTES = {"slab": 0, "direct": 1}
P5_SMEM = 227 * 1024      # bytes of shared memory a CTA may take
P5_SMS = 132              # the H100's SMs: the CTAs of one wave
# Axis 0: the widest slab.  16 columns (a 2-way bank conflict a gathered
# read) beat 32 (none, twice the bytes restaged) at [32, 512], [256, 512]
# and [1024, 512] (PERF.md, PR 10).
P5_COLUMNS = 16
# The bytes all CTAs together may restage: a slab is split among at most
# P5_RESTAGE / (table bytes) CTAs.  At [4096, 128] four restages of the
# 2 MiB table beat eight, at [16, 16384] eight of 1 MiB beat four
# (PERF.md, PR 10).
P5_RESTAGE = 8 << 20
P5_MIN_OUTPUTS = 256      # outputs a CTA at least, where the table allows
P5_THREADS = 1024         # threads a CTA at most
P5_DIRECT_THREADS = 256   # the direct route's threads a CTA
# The route: the one whose time, modelled from the bytes it moves, is less.
# The direct route moves its gathered sectors (`mosaic_gather_l2_bytes`)
# at P5_L2_RATE; a slab costs a round trip before the first gather and its
# bytes at one CTA's staging rate.  Rates from the card ("NVIDIA H100 80GB
# HBM3, 700.00 W"; PERF.md, PR 10): the direct route at [4096, 128] x 2
# moved 33.5 MB in ~8 us above its launch; a CTA staged 128 KB in ~5 us
# and 64 KB in ~2.5 us, the SMs' slabs at once.  The model picks the
# faster route at all 18 calls `tools/sweep.py --cases p5` times.  A slab
# is priced by what one CTA stages, not by all CTAs' bytes at the L2's
# rate: [4096, 128] x 1 and [1024, 512] x 1 move the same bytes on each
# route, yet the first is faster direct and the second on 64 KB slabs.
P5_L2_RATE = 4.0e6        # bytes a microsecond
P5_STAGE_RATE = 2.6e4     # bytes a microsecond, one CTA
P5_STAGE_US = 0.3         # microseconds
SECTOR = 32               # bytes the L2 moves at a time


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """How P5's kernel cuts [rows, lanes] (csrc/mosaic.cu).  Route "slab":
    along axis 0 CTA (bx, by) owns columns [bx tile, bx tile + tile) and
    output rows [by per, by per + per), and stages those columns over all
    rows; along axis 1 it owns rows [bx tile, bx tile + tile) and output
    columns [by per, by per + per), and stages those rows.  Route
    "direct": one thread an output, x read through L1/L2."""
    route: str
    tile: int
    per: int
    threads: int

    def grid(self, rows: int, lanes: int, axis: int) -> tuple[int, int]:
        if self.route == "direct":
            return -(-rows * lanes // self.threads), 1
        if axis == 0:
            return -(-lanes // self.tile), -(-rows // self.per)
        return -(-rows // self.tile), -(-lanes // self.per)

    def slab_bytes(self, rows: int, lanes: int, axis: int) -> int:
        if self.route == "direct":
            return 0
        return 4 * (rows * self.tile if axis == 0
                    else min(self.tile, rows) * lanes)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def direct_reach(rows: int, lanes: int, axis: int, threads: int) -> int:
    """The bytes of x that one CTA of the direct route (`threads`
    consecutive outputs) can gather from: its columns over all rows along
    axis 0, about its row along axis 1."""
    if axis == 0:
        return 4 * rows * min(lanes, threads)
    return 4 * max(lanes, threads)


def slab_plan(rows: int, lanes: int, axis: int) -> GatherPlan | None:
    """P5's slab plan for x [rows, lanes] along `axis`, or None where no
    slab fits P5_SMEM.  Axis 0: the widest slab of at most P5_COLUMNS
    columns (a power of two from 32 down to 4, and no wider than the
    table) that fits.  Axis 1: enough whole rows a slab for P5_MIN_OUTPUTS
    outputs.  The CTAs of a slab split its outputs (rows along axis 0,
    columns along axis 1) so that all CTAs come to about P5_SMS (one wave
    on the SMs), each keeping at least P5_MIN_OUTPUTS outputs, and all of
    them restage at most P5_RESTAGE bytes.  Threads: one an output up to
    P5_THREADS.  (The constants are read at each call, so that
    `tools/sweep.py` can time other values.)"""
    restages = max(1, P5_RESTAGE // (4 * rows * lanes))
    if axis == 0:
        c = min(P5_COLUMNS, max(4, 1 << (lanes - 1).bit_length()))
        while c > 4 and rows * c * 4 > P5_SMEM:
            c //= 2
        if rows * c * 4 > P5_SMEM:
            return None
        groups = -(-lanes // c)
        most = max(1, rows // max(1, P5_MIN_OUTPUTS // c))
        split = max(1, min(P5_SMS // groups, most, restages))
        per = -(-rows // split)
        return GatherPlan("slab", c, per,
                          min(P5_THREADS, _round_up(per * c, 32)))
    if lanes * 4 > P5_SMEM:
        return None
    tile = max(1, min(P5_SMEM // (lanes * 4), -(-P5_MIN_OUTPUTS // lanes),
                      rows))
    groups = -(-rows // tile)
    most = max(1, tile * lanes // P5_MIN_OUTPUTS)
    split = max(1, min(P5_SMS // groups, most, restages))
    per = -(-lanes // split)
    return GatherPlan("slab", tile, per,
                      min(P5_THREADS, _round_up(tile * per, 32)))


def modelled_us(plan: GatherPlan, rows: int, lanes: int, axis: int,
                reps: int) -> float:
    """A plan's time above its launch, modelled from the bytes it moves
    (P5_L2_RATE, P5_STAGE_RATE, P5_STAGE_US)."""
    if plan.route == "direct":
        return mosaic_gather_l2_bytes(plan, rows, lanes, axis,
                                      reps)["stage"] / P5_L2_RATE
    return P5_STAGE_US + plan.slab_bytes(rows, lanes, axis) / P5_STAGE_RATE


def direct_plan() -> GatherPlan:
    """P5's direct route: one thread an output, P5_DIRECT_THREADS a
    CTA."""
    return GatherPlan("direct", 0, 0, P5_DIRECT_THREADS)


def mosaic_gather_plan(rows: int, lanes: int, axis: int,
                       reps: int) -> GatherPlan:
    """P5's plan for x [rows, lanes] along `axis`, `reps` gathers an
    output: `slab_plan`'s slabs or the direct route, whichever
    `modelled_us` finds faster (the direct route where no slab fits)."""
    direct, tiled = direct_plan(), slab_plan(rows, lanes, axis)
    if tiled is not None and (modelled_us(tiled, rows, lanes, axis, reps)
                              < modelled_us(direct, rows, lanes, axis,
                                            reps)):
        return tiled
    return direct


def _sectors(start, length) -> np.ndarray:
    """32-byte sectors spanned by byte ranges [start, start + length)."""
    return (start + length + SECTOR - 1) // SECTOR - start // SECTOR


def mosaic_gather_l2_bytes(plan: GatherPlan, rows: int, lanes: int,
                           axis: int, reps: int) -> dict:
    """The bytes a plan reads from and writes to L2, in whole 32-byte
    sectors: {"stage": the slabs, every CTA its own (direct: a CTA's
    gathered reads, a sector each, or the bytes it can reach where that is
    less: L1 holds them after the first miss), "idx", "out", "total"}."""
    n = rows * lanes
    if plan.route == "direct":
        per_cta = min(plan.threads * reps * SECTOR,
                      _round_up(direct_reach(rows, lanes, axis,
                                             plan.threads), SECTOR))
        stage = plan.grid(rows, lanes, axis)[0] * per_cta
    elif axis == 0:
        gx, gy = plan.grid(rows, lanes, axis)
        c0 = np.arange(gx) * plan.tile
        w = np.minimum(plan.tile, lanes - c0)
        starts = (np.arange(rows)[:, None] * lanes + c0[None, :]) * 4
        stage = int(_sectors(starts, w[None, :] * 4).sum()) * SECTOR * gy
    else:
        gx, gy = plan.grid(rows, lanes, axis)
        q0 = np.arange(gx) * plan.tile
        nr = np.minimum(plan.tile, rows - q0)
        stage = int(_sectors(q0 * lanes * 4, nr * lanes * 4).sum()) \
            * SECTOR * gy
    io = int(_sectors(0, n * 4)) * SECTOR
    return {"stage": int(stage), "idx": io, "out": io,
            "total": int(stage) + 2 * io}


def mosaic_gather_plain(x: torch.Tensor, idx: torch.Tensor, axis: int,
                        reps: int) -> torch.Tensor:
    """Plain P5: the sum over i < reps of the gathers at (idx + i) mod
    size, the modulo a floor modulo, as jnp's %; in rep order from 0."""
    size = x.shape[axis]
    acc = torch.zeros_like(x)
    for i in range(reps):
        acc = acc + torch.gather(x, axis, (idx.long() + i) % size)
    return acc


def mosaic_gather(x: torch.Tensor, idx: torch.Tensor, axis: int,
                  reps: int) -> torch.Tensor:
    """P5: x f32[R, L], idx i32[R, L] -> out[r, c] = sum over i < reps of
    x[(idx[r, c] + i) mod R, c] (axis 0) or x[r, (idx[r, c] + i) mod L]
    (axis 1).  The kernel stages, a CTA at a time, the slab of x its
    outputs can reach, or reads x through L1/L2, as `mosaic_gather_plan`
    chooses."""
    _require(x, "x", torch.float32, 2)
    _require(idx, "idx", torch.int32, 2)
    _same_device(x, idx)
    if idx.shape != x.shape or axis not in (0, 1) or reps < 0:
        raise ValueError(f"idx must have x's shape {tuple(x.shape)}, axis be "
                         f"0 or 1 and reps >= 0, got {tuple(idx.shape)}, "
                         f"{axis}, {reps}")
    if x.numel() >= 1 << 31:
        raise ValueError("x is too large for the kernel's 32-bit indexing")
    if x.device.type == "cpu":
        return mosaic_gather_plain(x, idx, axis, reps)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _aligned16(x, "x")
    rows, lanes = x.shape
    plan = mosaic_gather_plan(rows, lanes, axis, reps)
    rc = cuda_lib.library().pbr_mosaic_gather(
        x.data_ptr(), idx.data_ptr(), rows, lanes, axis, reps,
        GATHER_ROUTES[plan.route], plan.tile, plan.per, plan.threads,
        out.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "pbr_mosaic_gather")
    LAUNCHES["mosaic_gather"] += 1
    return out


# --------------------------------------------------------------------- P6

def mosaic_scalar_stack_plain(boxes: torch.Tensor) -> torch.Tensor:
    """Plain P6: P1's walk (a Python loop over a CPU copy) counting the
    nodes visited; no leaf list."""
    b = boxes.detach().cpu().reshape(-1, 6)
    n = b.shape[0]
    hit = (b[:, :3].amax(dim=1) <= b[:, 3:].amin(dim=1)).tolist()
    stack, visited = [0], 0
    while stack:
        node = stack.pop()
        left = 2 * node + 1
        if hit[node] and left < n:
            stack.append(left)
            stack.append(left + 1)
        visited += 1
    return torch.tensor([visited], dtype=torch.int32, device=boxes.device)


def mosaic_scalar_stack(boxes: torch.Tensor) -> torch.Tensor:
    """P6 -> i32[1]: the nodes a walk of the implicit tree visits.  boxes
    f32[n * 6] as for P1 (lo xyz | hi xyz a node; n odd)."""
    _require(boxes, "boxes", torch.float32, 1)
    n = boxes.shape[0] // 6
    if boxes.shape[0] != n * 6 or n % 2 == 0 or not 1 <= n <= MAX_NODES:
        raise ValueError(f"boxes must hold 6 floats for an odd number of "
                         f"nodes up to {MAX_NODES}, got {boxes.shape[0]} "
                         "floats")
    if boxes.device.type == "cpu":
        return mosaic_scalar_stack_plain(boxes)
    out = torch.empty((1,), dtype=torch.int32, device=boxes.device)
    rc = cuda_lib.library().pbr_mosaic_scalar_stack(
        boxes.data_ptr(), n, out.data_ptr(), cuda_lib.stream_ptr(boxes.device))
    cuda_lib.check(rc, "pbr_mosaic_scalar_stack")
    LAUNCHES["mosaic_scalar_stack"] += 1
    return out


# --------------------------------------------------------------------- P7

def chunk_plain(o: torch.Tensor, t: torch.Tensor,
                n_chunks: int) -> torch.Tensor:
    """Plain P7, the reference's arithmetic op by op in float32."""
    rox = o[0, :, None]
    acc = torch.full((o.shape[1], 1), 1e30, dtype=torch.float32,
                     device=o.device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=o.device)
    for j in range(n_chunks):
        e = (t * f32(j + 1.0)) * f32(1.0001)
        px = rox * e[0][None, :]
        det = px * e[1][None, :] + px
        inv = torch.where(det.abs() > f32(1e-9), f32(1.0) / det, f32(0.0))
        uu = px * inv
        vv = uu * inv + px
        tt = vv * uu + uu
        ok = (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
        tt = torch.where(ok, tt, f32(1e30))
        acc = torch.minimum(acc, tt.amin(dim=1, keepdim=True))
    return acc


def chunk(o: torch.Tensor, t: torch.Tensor, n_chunks: int = 8) -> torch.Tensor:
    """P7: o f32[8, b], t f32[16, w] -> f32[b, 1].  Per chunk j < n_chunks:
    e = t (j + 1) 1.0001; px = o[0] e[0]; det = px e[1] + px; inv = 1/det
    (0 where |det| <= 1e-9); u = px inv; v = u inv + px; tt = v u + u; tt
    where u, v >= 0, u + v <= 1, tt > 0, else 1e30; the min over the
    columns and over the chunks."""
    _require(o, "o", torch.float32, 2)
    _require(t, "t", torch.float32, 2)
    _same_device(o, t)
    if o.shape[0] < 1 or t.shape[0] < 2 or n_chunks < 0:
        raise ValueError(f"o must have a row and t two, n_chunks >= 0; got "
                         f"{tuple(o.shape)}, {tuple(t.shape)}, {n_chunks}")
    if o.device.type == "cpu":
        return chunk_plain(o, t, n_chunks)
    b, w = o.shape[1], t.shape[1]
    out = torch.empty((b, 1), dtype=torch.float32, device=o.device)
    if b == 0:
        return out
    rc = cuda_lib.library().pbr_mosaic_chunk(
        o.data_ptr(), t.data_ptr(), b, w, n_chunks, out.data_ptr(),
        cuda_lib.stream_ptr(o.device))
    cuda_lib.check(rc, "pbr_mosaic_chunk")
    LAUNCHES["chunk"] += 1
    return out


# --------------------------------------------------------------------- P8

# P8's routes (csrc/mosaic.cu): "row_sums", each tile's rows summed once,
# then 128-byte rows of those sums gathered (`pbr_subtile_copy_row_sums`,
# one cooperative launch), or "direct", every copy streamed through shared
# memory (`pbr_subtile_copy`).  P8_ROW_SUMS_COPIES: the copies a table tile
# from which the row sums are taken.  The row-sum pass reads every tile of
# the table once, so fewer copies than tiles read fewer bytes directly;
# and the direct route's few CTAs are bound by their eight dependent copy
# rounds, not by bytes: on the card ("NVIDIA H100 80GB HBM3, 700.00 W";
# `tools/sweep.py --cases p8`, PERF.md) the routes tie at 8,192 copies of
# a 4,096-tile table (0.0050 ms each), the direct route wins at 4,096
# (0.0047 against 0.0050) and the row sums at 16,384 (0.0050 against
# 0.0063).
P8_ROW_SUMS_COPIES = 2


def subtile_copy_route(n_src: int, n_copies: int) -> str:
    """P8's route for `n_copies` copies of tiles picked from a table of
    `n_src`: "row_sums" from P8_ROW_SUMS_COPIES copies a tile of the
    table, else "direct".  (Read at each call, so that `tools/sweep.py`
    and `chip_smoke.py` can time the other route.)"""
    return ("row_sums" if n_copies >= P8_ROW_SUMS_COPIES * n_src
            else "direct")


def subtile_copy_plain(src: torch.Tensor, idx: torch.Tensor, n_iters: int,
                       ch: int) -> torch.Tensor:
    """Plain P8: per block and step, the picked tiles' rows summed in
    order (row 0 + row 1 + ...), then added to the running sum; indices
    clamped into range, as in the kernel."""
    nb = idx.shape[0] // (n_iters * ch)
    k = idx.long().clamp(0, src.shape[0] - 1).reshape(nb, n_iters, ch)
    acc = torch.zeros((nb, ch, TILE_P8[1]), dtype=torch.float32,
                      device=src.device)
    for j in range(n_iters):
        tiles = src[k[:, j]]                    # [nb, ch, 16, 32]
        rows = tiles[:, :, 0]
        for r in range(1, TILE_P8[0]):
            rows = rows + tiles[:, :, r]
        acc = acc + rows
    return acc.reshape(nb, 1, ch * TILE_P8[1])


def _check_subtile(src: torch.Tensor, idx: torch.Tensor, n_iters: int,
                   ch: int) -> None:
    _require(src, "src", torch.float32, 3)
    _require(idx, "idx", torch.int32, 1)
    _same_device(src, idx)
    if (tuple(src.shape[1:]) != TILE_P8 or src.shape[0] < 1
            or n_iters < 1 or not 1 <= ch <= MAX_P8_CH
            or idx.shape[0] % (n_iters * ch)):
        raise ValueError(f"src must be [C >= 1, 16, 32], 1 <= ch <= "
                         f"{MAX_P8_CH}, n_iters >= 1 and idx a multiple of "
                         f"n_iters * ch long; got {tuple(src.shape)}, "
                         f"ch {ch}, n_iters {n_iters}, {idx.shape[0]} indices")
    if src.numel() >= 1 << 31:
        raise ValueError("src is too large for the kernel's indexing")


def subtile_copy(src: torch.Tensor, idx: torch.Tensor, n_iters: int,
                 ch: int) -> torch.Tensor:
    """P8: src f32[C, 16, 32], idx i32[nb * n_iters * ch] ->
    f32[nb, 1, ch * 32]: out[g, 0, 32 i + l] = sum over j < n_iters of the
    row sum of src[idx[g n_iters ch + j ch + i], :, l], rows summed in
    order, steps in order from 0; indices clamped into range.  The kernel
    takes `subtile_copy_route`'s route; either is one launch."""
    _check_subtile(src, idx, n_iters, ch)
    if src.device.type == "cpu":
        return subtile_copy_plain(src, idx, n_iters, ch)
    nb = idx.shape[0] // (n_iters * ch)
    out = torch.empty((nb, 1, ch * TILE_P8[1]), dtype=torch.float32,
                      device=src.device)
    if nb == 0:
        return out
    _aligned16(src, "src")
    route = subtile_copy_route(src.shape[0], idx.shape[0])
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(src.device)
    if route == "row_sums":
        rows = torch.empty((src.shape[0], TILE_P8[1]), dtype=torch.float32,
                           device=src.device)
        rc = lib.pbr_subtile_copy_row_sums(
            src.data_ptr(), idx.data_ptr(), src.shape[0], nb, n_iters, ch,
            rows.data_ptr(), out.data_ptr(), stream)
    else:
        rc = lib.pbr_subtile_copy(src.data_ptr(), idx.data_ptr(),
                                  src.shape[0], nb, n_iters, ch,
                                  out.data_ptr(), stream)
    cuda_lib.check(rc, f"pbr_subtile_copy ({route})")
    LAUNCHES["subtile_copy"] += 1
    return out


def subtile_read_plain(src: torch.Tensor, idx: torch.Tensor, n_iters: int,
                       ch: int) -> torch.Tensor:
    """Plain `subtile_read`: the XOR of the picked tiles' bits over steps,
    copies and rows, by halves."""
    nb = idx.shape[0] // (n_iters * ch)
    k = idx.long().clamp(0, src.shape[0] - 1)
    v = src.view(torch.int32)[k].reshape(nb, -1, TILE_P8[1])
    acc = torch.zeros((nb, TILE_P8[1]), dtype=torch.int32, device=src.device)
    while v.shape[1] > 1:
        if v.shape[1] % 2:
            acc = acc ^ v[:, -1]
            v = v[:, :-1]
        half = v.shape[1] // 2
        v = v[:, :half] ^ v[:, half:]
    return acc ^ v[:, 0]


def subtile_read(src: torch.Tensor, idx: torch.Tensor, n_iters: int,
                 ch: int) -> torch.Tensor:
    """The every-copy read ceiling under P8's direct route: the same copies
    in the same order, each read once through L2 with no float arithmetic
    -> i32[nb, 32], out[g, l] = the XOR over j, i and rows r of the bits of
    src[idx[g n_iters ch + j ch + i], r, l] (indices clamped).  Ports
    nothing; counted nowhere."""
    _check_subtile(src, idx, n_iters, ch)
    if src.device.type == "cpu":
        return subtile_read_plain(src, idx, n_iters, ch)
    nb = idx.shape[0] // (n_iters * ch)
    out = torch.empty((nb, TILE_P8[1]), dtype=torch.int32, device=src.device)
    if nb == 0:
        return out
    _aligned16(src, "src")
    rc = cuda_lib.library().pbr_subtile_read(
        src.data_ptr(), idx.data_ptr(), src.shape[0], nb, n_iters, ch,
        out.data_ptr(), cuda_lib.stream_ptr(src.device))
    cuda_lib.check(rc, "pbr_subtile_read")
    return out
