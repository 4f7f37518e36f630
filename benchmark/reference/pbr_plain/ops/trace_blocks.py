# Frozen copy of physically_based_renderer_tpu_torch/ops/trace_blocks.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
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

At K = 32 (the reference's sub-clusters) a chunk is a multiple of 4
candidates, at least 4 (`chunk_width`), as the reference takes it; its
four lane-group soup variants summed are the compact rows read here, so
the flat order, the tie rule and the early exit are the same.

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

import torch

from ..accel.clusters import SOUP_ROWS
from .intersect import BIG

# Elements of one [blocks, B, ch*K] intersection array of the plain version.
_PLAIN_CHUNK = 1 << 22
# The range of |det| over which the kernel's branch-free reciprocal is
# checked equal to 1.0f / det (csrc/trace_blocks.cu kRcpLo, kRcpHi).
RCP_LO, RCP_HI = 1e-9, 2.0 ** 126


def chunk_width(chunk: int, n_u: int, k: int) -> int:
    """Candidate clusters a step, as the reference's trace_blocks_pallas
    takes them (:287-290): min(chunk, n_u); at K = 32 (sub-clusters) a
    multiple of 4, at least 4."""
    if k == 32:
        return max(4, (min(chunk, n_u) // 4) * 4)
    return min(chunk, n_u)


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
    ch = chunk_width(chunk, n_u, soup.shape[-1])
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
    whole number of chunks of `chunk_width(chunk, U, K)`."""
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
    return trace_blocks_plain(u_idx, o, d, t_max, soup, n_valid, entry,
                              t_min=t_min, any_hit=any_hit, chunk=chunk)


