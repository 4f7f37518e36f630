"""Brute-force Moller-Trumbore ray/triangle queries (port of `ops/intersect.py`).

`tracer="brute"`: every ray against every triangle, chunked over
triangles with a running best hit.  It is the CPU oracle for the resident
tracer (`ops/resident.py`) and stays differentiable: hit t/u/v carry
gradients to vertex positions.  Backfaces are hit (double-sided).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import math3d

BIG = 1e30


@dataclasses.dataclass(frozen=True)
class Hit:
    """Closest-hit record, SoA over rays."""

    t: torch.Tensor    # f32[N] distance (BIG when miss)
    tri: torch.Tensor  # i32[N] triangle index (-1 when miss)
    u: torch.Tensor    # f32[N] barycentric of v1
    v: torch.Tensor    # f32[N] barycentric of v2

    @property
    def miss(self) -> torch.Tensor:
        return self.tri < 0


def _moller_trumbore(o, d, v0, v1, v2, t_min, t_max):
    """Rays [N,3] against tris [T,3] pairwise -> (t, u, v, valid) [N, T]."""
    return mt_rows(o[:, None], d[:, None], v0[None], (v1 - v0)[None],
                   (v2 - v0)[None], t_min, t_max)


def mt_rows(o, d, v0, e1, e2, t_min: float, t_max, eps: float = 1e-9):
    """Moller-Trumbore -> (t, u, v, valid): one triangle a ray ([N, 3]
    each), or every ray against every triangle when the shapes broadcast
    (rays [..., N, 1, 3] against triangles [..., 1, T, 3] give [..., N, T])."""
    p = math3d.cross(d, e2)
    det = torch.sum(p * e1, dim=-1)
    inv_det = torch.where(det.abs() > eps, 1.0 / det, 0.0)
    tv = o - v0
    u = torch.sum(tv * p, dim=-1) * inv_det
    q = math3d.cross(tv, e1)
    v = torch.sum(d * q, dim=-1) * inv_det
    t = torch.sum(e2 * q, dim=-1) * inv_det
    valid = ((det.abs() > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < t_max))
    return t, u, v, valid


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Safe reciprocal direction for slab tests."""
    return torch.where(d >= 0.0, 1.0, -1.0) / torch.clamp_min(d.abs(), 1e-12)


def intersect_brute(o: torch.Tensor, d: torch.Tensor, v0, v1, v2,
                    t_min: float = 1e-4, t_max: float = BIG,
                    chunk: int = 1024) -> Hit:
    """Closest hit of rays [N,3] against all T triangles, chunked over T."""
    n = o.shape[0]
    zero = d[:, 0] * 0.0
    best_t = zero + BIG
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=d.device)
    best_u, best_v = zero, zero
    rows = torch.arange(n, device=d.device)
    for c0 in range(0, v0.shape[0], max(chunk, 1)):
        sl = slice(c0, c0 + chunk)
        t, u, v, valid = _moller_trumbore(o, d, v0[sl], v1[sl], v2[sl],
                                          t_min, t_max)
        t = torch.where(valid, t, BIG)
        j = torch.argmin(t, dim=-1)
        tj = t[rows, j]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_tri = torch.where(better, (j + c0).to(torch.int32), best_tri)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def occluded_brute(o: torch.Tensor, d: torch.Tensor, v0, v1, v2,
                   t_min: float = 1e-4, t_max=BIG,
                   chunk: int = 1024) -> torch.Tensor:
    """Any-hit (shadow ray) query -> bool[N]. t_max may be per-ray [N]."""
    n = o.shape[0]
    t_max_arr = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=d.device), (n,))
    occ = torch.zeros((n,), dtype=torch.bool, device=d.device)
    for c0 in range(0, v0.shape[0], max(chunk, 1)):
        sl = slice(c0, c0 + chunk)
        _, _, _, valid = _moller_trumbore(o, d, v0[sl], v1[sl], v2[sl],
                                          t_min, t_max_arr[:, None])
        occ = occ | valid.any(dim=-1)
    return occ
