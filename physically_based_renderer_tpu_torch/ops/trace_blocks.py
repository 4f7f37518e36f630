"""Block-stream tracer kernel (K1): closest-hit / any-hit of ray blocks
against their candidate clusters.

Port of the reference's `ops/pallas_trace.py::_mt_kernel_body` (:54),
entered through `trace_blocks_pallas` (:252).  Each block of B rays
carries U candidate clusters, sorted nearest-entry first by phase A
(ops/blocktrace.py); the clusters are processed in chunks of `ch`, and
each chunk's ch x K triangles are tested against every ray of the block
in flat order f = i * K + k (candidate i of the chunk, triangle k).  A ray
keeps the smallest t and its flat winner j * ch * K + f, ties going to the
lowest flat index.  After each chunk the block stops early:

  * closest hit: once max over live lanes of min(best_t, t_max) is no
    larger than the next chunk's entry (its first candidate's
    conservative entry distance; BIG past the last valid candidate);
  * any hit: once no live lane is still open, or the next entry lies
    beyond every open lane's t_max.

Live lanes have t_max > 0 (phase A gives culled and padding lanes
t_max = 0).  Padding triangles and the all-zero sentinel cluster reject
themselves through det = 0 (inverse 0, so t = 0 fails t > t_min >= 0).

`trace_blocks_plain` is that function in torch; the wrapper
`trace_blocks` launches the CUDA kernel (`csrc/trace_blocks.cu`) for CUDA
tensors and takes the plain version only for CPU tensors.  The kernel runs
B / R threads a block, each testing R rays (R = 2 where B % 64 == 0, else
1), and copies the soup with 16-byte copies, so on the card K must be a
multiple of 4 and the soup 16-byte aligned.  Its reciprocal of det is a
branch-free sequence checked equal to 1.0f / det over every float of
[RCP_LO, RCP_HI) on the card (`rcp_mismatches`); a group of tests with
|det| beyond it divides.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel.clusters import SOUP_ROWS
from . import cuda_lib
from .intersect import BIG

# Kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0
# Elements of one [blocks, B, ch*K] intersection array of the plain version.
_PLAIN_CHUNK = 1 << 22
# The range of |det| over which the kernel's branch-free reciprocal is
# checked equal to 1.0f / det (csrc/trace_blocks.cu kRcpLo, kRcpHi).
RCP_LO, RCP_HI = 1e-9, 2.0 ** 126


def _check(u_idx, o, d, t_max, soup, n_valid, entry, t_min, chunk):
    nb, n_u = u_idx.shape
    b = o.shape[1] if o.dim() == 3 else -1
    dev = o.device
    for name, x, dtype, shape in (
            ("u_idx", u_idx, torch.int32, (nb, n_u)),
            ("o", o, torch.float32, (nb, b, 3)),
            ("d", d, torch.float32, (nb, b, 3)),
            ("t_max", t_max, torch.float32, (nb, b)),
            ("soup", soup, torch.float32, tuple(soup.shape[:1])
             + (SOUP_ROWS, soup.shape[-1])),
            ("n_valid", n_valid, torch.int32, (nb,)),
            ("entry", entry, torch.float32, (nb, n_u))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ch = min(chunk, n_u)
    if ch < 1 or n_u % ch:
        raise ValueError(f"candidate count {n_u} must be a multiple of the "
                         f"chunk {ch}; pad u_idx with the sentinel")
    if t_min < 0.0:
        raise ValueError("t_min must be >= 0 (padding rejects via t > t_min)")
    if b % 32 or not 32 <= b <= 1024:
        raise ValueError(f"block size {b} must be a multiple of 32 in "
                         "[32, 1024]")
    return ch


def _plain_group(u_idx, o, d, tm, soup, n_valid, entry, t_min, any_hit, ch):
    """Plain K1 for a group of G blocks: every block runs its own chunk
    loop and early exit (blocks that have stopped are masked)."""
    g, n_u = u_idx.shape
    b = o.shape[1]
    k = soup.shape[-1]
    w = ch * k
    dev = o.device
    rox, roy, roz = (o[..., c][..., None] for c in range(3))   # [G, B, 1]
    rdx, rdy, rdz = (d[..., c][..., None] for c in range(3))
    rtm = tm[..., None]
    live = tm > 0.0
    n_chunks = (n_valid + ch - 1) // ch
    best_t = torch.full((g, b), BIG, dtype=torch.float32, device=dev)
    best_flat = torch.full((g, b), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros((g, b), dtype=torch.bool, device=dev)
    done = torch.zeros((g,), dtype=torch.bool, device=dev)
    lane = torch.arange(w, dtype=torch.int32, device=dev)
    for j in range(int(n_chunks.max()) if g else 0):
        run = (j < n_chunks) & ~done                           # [G]
        if not bool(run.any()):
            break
        slots = torch.clamp_max(torch.arange(j * ch, j * ch + ch,
                                             device=dev), n_u - 1)
        rows = soup[u_idx[:, slots].long()]                    # [G,ch,9,K]
        rows = rows.permute(0, 2, 1, 3).reshape(g, SOUP_ROWS, 1, w)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows.unbind(1)
        px = rdy * e2z - rdz * e2y
        py = rdz * e2x - rdx * e2z
        pz = rdx * e2y - rdy * e2x
        det = px * e1x + py * e1y + pz * e1z
        inv = torch.where(det.abs() > 1e-9, 1.0 / det, 0.0)
        tx = rox - v0x
        ty = roy - v0y
        tz = roz - v0z
        uu = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (rdx * qx + rdy * qy + rdz * qz) * inv
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (tt > t_min) & (tt < rtm))                     # [G, B, W]
        nxt = torch.where((j + 1) * ch < n_valid,
                          entry[:, min(j + 1, n_u // ch - 1) * ch], BIG)
        if any_hit:
            occ = occ | (ok.any(dim=-1) & run[:, None])
            open_ = live & ~occ
            rem_tmax = torch.where(open_, tm, 0.0).max(dim=1).values
            stop = ~open_.any(dim=1) | (nxt > rem_tmax)
        else:
            tt = torch.where(ok, tt, BIG)
            tmin = tt.min(dim=-1, keepdim=True).values
            kmin = torch.where(tt <= tmin, lane, w).min(dim=-1).values
            better = (tmin[..., 0] < best_t) & run[:, None]
            best_t = torch.where(better, tmin[..., 0], best_t)
            best_flat = torch.where(better, j * w + kmin, best_flat)
            worst = torch.where(live, torch.minimum(best_t, tm),
                                0.0).max(dim=1).values
            stop = worst <= nxt
        done = done | (run & stop)
    if any_hit:
        return occ
    return best_t, best_flat


def trace_blocks_plain(u_idx, o, d, t_max, soup, n_valid, entry, *,
                       t_min: float, any_hit: bool, chunk: int = 4):
    """Plain-torch K1 -> (best_t f32[NB, B], best_flat i32[NB, B]) with
    (BIG, -1) on a miss, or for any_hit the occlusion mask bool[NB, B].

    u_idx i32[NB, U] candidate clusters (sentinel C past n_valid), o/d
    f32[NB, B, 3], t_max f32[NB, B], soup f32[C+1, 9, K], n_valid i32[NB],
    entry f32[NB, U] (only chunk-start entries are read); U must be a
    whole number of chunks of min(chunk, U)."""
    ch = _check(u_idx, o, d, t_max, soup, n_valid, entry, t_min, chunk)
    nb, b = t_max.shape
    step = max(1, _PLAIN_CHUNK // max(b * ch * soup.shape[-1], 1))
    parts = [_plain_group(u_idx[s:s + step], o[s:s + step], d[s:s + step],
                          t_max[s:s + step], soup, n_valid[s:s + step],
                          entry[s:s + step], t_min, any_hit, ch)
             for s in range(0, nb, step)]
    if any_hit:
        return (torch.cat(parts) if parts
                else torch.zeros((0, b), dtype=torch.bool, device=o.device))
    if not parts:
        return (torch.zeros((0, b), device=o.device),
                torch.zeros((0, b), dtype=torch.int32, device=o.device))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def trace_blocks(u_idx, o, d, t_max, soup, n_valid, entry, *,
                 t_min: float, any_hit: bool, chunk: int = 4):
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and outputs as
    `trace_blocks_plain`."""
    global LAUNCHES
    ch = _check(u_idx, o, d, t_max, soup, n_valid, entry, t_min, chunk)
    if o.device.type == "cpu":
        return trace_blocks_plain(u_idx, o, d, t_max, soup, n_valid, entry,
                                  t_min=t_min, any_hit=any_hit, chunk=chunk)
    if o.device.type != "cuda":
        raise ValueError(f"block tracer: unsupported device {o.device}")
    nb, b = t_max.shape
    n_u, k = u_idx.shape[1], soup.shape[-1]
    if k % 4 or soup.data_ptr() % 16:
        raise ValueError(f"the kernel copies soup rows 16 bytes at a time: "
                         f"K = {k} must be a multiple of 4 and the soup "
                         "16-byte aligned")
    lib = cuda_lib.library()
    args = (u_idx.data_ptr(), n_valid.data_ptr(), entry.data_ptr(),
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), soup.data_ptr(),
            nb, b, n_u, k, ch, float(t_min))
    stream = cuda_lib.stream_ptr(o.device)
    if any_hit:
        occ = torch.empty((nb, b), dtype=torch.bool, device=o.device)
        rc = lib.pbr_trace_blocks_any(*args, occ.data_ptr(), stream)
        cuda_lib.check(rc, "pbr_trace_blocks_any")
        LAUNCHES += 1
        return occ
    best_t = torch.empty((nb, b), dtype=torch.float32, device=o.device)
    best_flat = torch.empty((nb, b), dtype=torch.int32, device=o.device)
    rc = lib.pbr_trace_blocks_closest(*args, best_t.data_ptr(),
                                      best_flat.data_ptr(), stream)
    cuda_lib.check(rc, "pbr_trace_blocks_closest")
    LAUNCHES += 1
    return best_t, best_flat


def rcp_mismatches(device) -> int:
    """Floats x with |x| in [1e-9, 2^126), both signs, for which the
    branch-free reciprocal of K1, K2 and K4 (`csrc/rcp.cuh`) and 1.0f / x
    differ in any bit, counted on the card over every such float (0 means
    the kernels' t and winners are those of a division)."""
    lo = int(np.float32(RCP_LO).view(np.uint32))
    hi = int(np.float32(RCP_HI).view(np.uint32))
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    stream = cuda_lib.stream_ptr(device)
    for sign in (0, 1 << 31):
        rc = cuda_lib.library().pbr_rcp_check(sign + lo, hi - lo,
                                              bad.data_ptr(), stream)
        cuda_lib.check(rc, "pbr_rcp_check")
    return int(bad.item())
