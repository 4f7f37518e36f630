"""Small vector helpers (port of the reference's `core/math3d.py`).

Only the vector part of the reference module is on the main path: dot,
cross, normalize, the Duff et al. orthonormal basis and the local/world
frame changes.  Everything broadcasts over leading dims, f32, and is
differentiable.  `maximum`, `minimum` and `clip` bound a value that
carries gradient with the reference's tie rule.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def maximum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound) with the reference's tie rule: where x == bound, x gets
    half the gradient, as JAX's `maximum` and `clip` give it
    (`torch.clamp_min` passes all of it).  The bound is a 0-dim CPU
    tensor, which torch accepts beside a tensor on any device."""
    return torch.maximum(x, torch.tensor(bound, dtype=x.dtype))


def minimum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """min(x, bound) with the reference's tie rule (see `maximum`)."""
    return torch.minimum(x, torch.tensor(bound, dtype=x.dtype))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """JAX's clip(x, lo, hi) = min(max(x, lo), hi), ties split in half."""
    return minimum(maximum(x, lo), hi)


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Batched dot product over the last axis."""
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(v: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(
        torch.sum(v * v, dim=-1, keepdim=keepdims), EPS * EPS))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize over the last axis (returns v/|v|, guarded near 0)."""
    return v / length(v)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction `d` about normal `n` (both unit)."""
    return d - 2.0 * dot(d, n) * n


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of linear RGB, over the last axis."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tangent/bitangent for unit normal `n` (branchless Duff et al.).

    Returns (t, b) with [t, b, n] a right-handed orthonormal frame.
    """
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    bv = nx * ny * a
    t = torch.cat([1.0 + s * nx ** 2 * a, s * bv, -s * nx], dim=-1)
    b = torch.cat([bv, s + ny ** 2 * a, -ny], dim=-1)
    return t, b


def to_world(local: torch.Tensor, t: torch.Tensor, b: torch.Tensor,
             n: torch.Tensor) -> torch.Tensor:
    """Transform a local-frame (tangent space) vector into world space."""
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def to_local(world: torch.Tensor, t: torch.Tensor, b: torch.Tensor,
             n: torch.Tensor) -> torch.Tensor:
    """Transform a world vector into the [t, b, n] local frame."""
    return torch.stack([dot(world, t, False), dot(world, b, False),
                        dot(world, n, False)], dim=-1)
