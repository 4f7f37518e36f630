# Frozen copy of physically_based_renderer_tpu_torch/core/math3d.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""Small vector helpers (port of the reference's `core/math3d.py`).

The vector part is on the main path: dot, cross, normalize, the Duff et
al. orthonormal basis and the local/world frame changes.  Quaternions
(x, y, z, w), TRS transforms and the glm camera matrices complete the
reference module's public API.  Everything broadcasts over leading dims,
f32, and is differentiable.  `maximum`, `minimum` and `clip` bound a value
that carries gradient with the reference's tie rule.
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


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w), glTF component order
# ---------------------------------------------------------------------------

def quat_identity(device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                        device=device)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = torch.movedim(q1, -1, 0)
    x2, y2, z2, w2 = torch.movedim(q2, -1, 0)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_from_axis_angle(axis, angle) -> torch.Tensor:
    """Unit quaternion rotating by `angle` (radians) about `axis`.

    Broadcasts: axis [..., 3], angle [...] -> quat [..., 4].
    """
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    half = torch.as_tensor(angle, dtype=torch.float32,
                           device=axis.device)[..., None] / 2.0
    axis, half = torch.broadcast_tensors(axis, half)
    return torch.cat([axis * torch.sin(half), torch.cos(half[..., :1])],
                     dim=-1)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (batched over leading dims)."""
    x, y, z, w = torch.movedim(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat3_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w). Branchless, f32."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; the signs pick the right one.
    qw = torch.sqrt(torch.clamp_min(1.0 + tr, 0.0)) / 2.0
    qx = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)) / 2.0
    qy = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)) / 2.0
    qz = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)) / 2.0
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return normalize(torch.stack([qx, qy, qz, qw], dim=-1))


# ---------------------------------------------------------------------------
# TRS transforms: translate @ rotate @ scale
# ---------------------------------------------------------------------------

def trs_to_mat4(translation, rotation_quat, scale) -> torch.Tensor:
    """Compose translate @ rotate @ scale into a 4x4 (batched)."""
    r = quat_to_mat3(torch.as_tensor(rotation_quat, dtype=torch.float32))
    s = torch.as_tensor(scale, dtype=r.dtype, device=r.device)
    r = r * s[..., None, :]
    t = torch.as_tensor(translation, dtype=r.dtype, device=r.device)
    t = torch.broadcast_to(t, r.shape[:-2] + (3,))
    top = torch.cat([r, t[..., :, None]], dim=-1)              # [..., 3, 4]
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype,
                        device=r.device).expand(r.shape[:-2] + (1, 4))
    return torch.cat([top, last], dim=-2)


def normal_matrix(model: torch.Tensor) -> torch.Tensor:
    """Inverse-transpose of the upper 3x3."""
    return torch.linalg.inv(model[..., :3, :3]).mT


def transform_points(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 `m` to points p[..., 3]."""
    return p @ m[..., :3, :3].mT + m[..., :3, 3]


def transform_dirs(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Apply the linear part of 4x4 `m` to directions d[..., 3]."""
    return d @ m[..., :3, :3].mT


# ---------------------------------------------------------------------------
# Camera matrices (glm conventions)
# ---------------------------------------------------------------------------

def look_at_rh(eye, center, up) -> torch.Tensor:
    """Right-handed look-at view matrix, glm::lookAtRH semantics."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    center = torch.as_tensor(center, dtype=torch.float32, device=eye.device)
    up = torch.as_tensor(up, dtype=torch.float32, device=eye.device)
    f = normalize(center - eye)          # forward
    s = normalize(cross(f, up))          # right
    u = cross(s, f)                      # true up
    rows = torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        torch.tensor([0.0, 0.0, 0.0, 1.0], device=eye.device),
    ])
    return rows


def _perspective(fovy, aspect, m22, m23) -> torch.Tensor:
    tan_half = torch.tan(torch.as_tensor(fovy, dtype=torch.float32) / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32, device=tan_half.device)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = m22
    m[2, 3] = m23
    m[3, 2] = -1.0
    return m


def perspective_rh_no(fovy, aspect: float, znear: float,
                      zfar: float) -> torch.Tensor:
    """glm::perspectiveRH_NO (depth -1..1)."""
    return _perspective(fovy, aspect, -(zfar + znear) / (zfar - znear),
                        -(2.0 * zfar * znear) / (zfar - znear))


def perspective_rh_zo(fovy, aspect: float, znear: float,
                      zfar: float) -> torch.Tensor:
    """glm::perspectiveRH_ZO (depth 0..1, Vulkan-style)."""
    return _perspective(fovy, aspect, zfar / (znear - zfar),
                        -(zfar * znear) / (zfar - znear))
