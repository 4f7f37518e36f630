"""Resident tracer (K2): closest-hit / any-hit against a small whole soup.

Port of the reference's `ops/resident.py`.  For scenes whose
triangle soup fits in one block's shared memory, the kernel
(`csrc/resident.cu`) stages the whole soup per block and runs a dense
Moller-Trumbore per ray.  `trace_plain` is the same function in plain
torch; the wrapper `trace` takes it only for CPU tensors.  The search is
DETACHED; `integrator/shading.py` re-intersects the winner attached.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .intersect import BIG, Hit

# Largest triangle count the kernel accepts: 2048 x 36 B = 72 KB of shared
# memory per block.
RESIDENT_MAX_TRIS = 2048
# Auto-dispatch threshold (integrator/path._auto_tracer).
RESIDENT_AUTO_MAX_TRIS = 512
SOUP_W = 9

# Kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0

# Pairwise [rays, tris] elements per chunk of the plain version.
_PLAIN_CHUNK = 1 << 22


def pack_resident_soup(geometry) -> torch.Tensor:
    """Detached triangle soup f32[T, 9]: v0 | e1 | e2, contiguous."""
    v0, v1, v2 = (v.detach() for v in geometry.tri_vertices())
    return torch.cat([v0, v1 - v0, v2 - v0], dim=1).contiguous()


def _plain_block(soup, o, d, t_max, t_min: float, any_hit: bool):
    n_tris = soup.shape[0]
    c = [soup[:, j][None, :] for j in range(SOUP_W)]   # [1, T]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = c
    rox, roy, roz = (o[:, j][:, None] for j in range(3))  # [B, 1]
    rdx, rdy, rdz = (d[:, j][:, None] for j in range(3))
    rtm = t_max[:, None]

    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = px * e1x + py * e1y + pz * e1z
    nonzero = det.abs() > 1e-9
    inv = torch.where(nonzero, 1.0 / det, 0.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (rdx * qx + rdy * qy + rdz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = (nonzero & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > t_min) & (tt < rtm))
    if any_hit:
        return ok.any(dim=1)
    tt = torch.where(ok, tt, BIG)
    tmin = tt.min(dim=1, keepdim=True).values
    row = torch.arange(n_tris, dtype=torch.int32, device=soup.device)
    kmin = torch.where(tt <= tmin, row, n_tris).min(dim=1).values
    tmin = tmin[:, 0]
    return tmin, torch.where(tmin < BIG, kmin, -1).to(torch.int32)


def trace_plain(soup, o, d, t_max, t_min: float, any_hit: bool):
    """Plain-torch K2: closest -> (t f32[N], tri i32[N]) with ties to the
    lowest index and (BIG, -1) on a miss; any-hit -> bool[N]."""
    n = o.shape[0]
    step = max(1, _PLAIN_CHUNK // max(soup.shape[0], 1))
    parts = [_plain_block(soup, o[s:s + step], d[s:s + step],
                          t_max[s:s + step], t_min, any_hit)
             for s in range(0, n, step)]
    if any_hit:
        return (torch.cat(parts) if parts
                else torch.zeros((0,), dtype=torch.bool, device=o.device))
    if not parts:
        return (torch.zeros((0,), device=o.device),
                torch.zeros((0,), dtype=torch.int32, device=o.device))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _check(soup, o, d, t_max):
    dev = o.device
    for name, x, shape in (("soup", soup, (soup.shape[0], SOUP_W)),
                           ("o", o, (o.shape[0], 3)),
                           ("d", d, (o.shape[0], 3)),
                           ("t_max", t_max, (o.shape[0],))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if soup.shape[0] > RESIDENT_MAX_TRIS:
        raise ValueError(f"{soup.shape[0]} triangles exceed the resident "
                         f"cap of {RESIDENT_MAX_TRIS}")
    if o.shape[0] >= 1 << 31:
        raise ValueError("too many rays for 32-bit indexing")


def trace(soup, o, d, t_max, t_min: float, any_hit: bool):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Same outputs as `trace_plain`."""
    global LAUNCHES
    _check(soup, o, d, t_max)
    if o.device.type == "cpu":
        return trace_plain(soup, o, d, t_max, t_min, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"resident tracer: unsupported device {o.device}")
    lib = cuda_lib.library()
    n, n_tris = o.shape[0], soup.shape[0]
    stream = cuda_lib.stream_ptr(o.device)
    if any_hit:
        occ = torch.empty((n,), dtype=torch.bool, device=o.device)
        rc = lib.pbr_resident_any(o.data_ptr(), d.data_ptr(),
                                  t_max.data_ptr(), soup.data_ptr(), n,
                                  n_tris, float(t_min), occ.data_ptr(),
                                  stream)
        cuda_lib.check(rc, "pbr_resident_any")
        LAUNCHES += 1
        return occ
    t_out = torch.empty((n,), dtype=torch.float32, device=o.device)
    tri_out = torch.empty((n,), dtype=torch.int32, device=o.device)
    rc = lib.pbr_resident_closest(o.data_ptr(), d.data_ptr(),
                                  t_max.data_ptr(), soup.data_ptr(), n,
                                  n_tris, float(t_min), t_out.data_ptr(),
                                  tri_out.data_ptr(), stream)
    cuda_lib.check(rc, "pbr_resident_closest")
    LAUNCHES += 1
    return t_out, tri_out


def intersect_resident(geometry, o, d, t_min: float = 1e-4, t_max=BIG,
                       any_hit: bool = False, soup=None):
    """Closest-hit (detached Hit; u = v = 0, shade_surface re-intersects
    attached) or any-hit occlusion mask bool[N] via K2.  Pass a prebuilt
    `soup` (pack_resident_soup) to skip repacking."""
    n = o.shape[0]
    if soup is None:
        soup = pack_resident_soup(geometry)
    o_s = o.detach().to(torch.float32).contiguous()
    d_s = d.detach().to(torch.float32).contiguous()
    if isinstance(t_max, torch.Tensor):
        t_max_arr = torch.broadcast_to(
            t_max.to(device=o.device, dtype=torch.float32),
            (n,)).detach().contiguous()
    else:       # a number fills on the device: no copy from the host
        t_max_arr = torch.full((n,), t_max, dtype=torch.float32,
                               device=o.device)
    if any_hit:
        return trace(soup, o_s, d_s, t_max_arr, t_min, True)
    t, tri = trace(soup, o_s, d_s, t_max_arr, t_min, False)
    zeros = torch.zeros((n,), dtype=torch.float32, device=o.device)
    return Hit(t=t, tri=tri, u=zeros, v=zeros)
