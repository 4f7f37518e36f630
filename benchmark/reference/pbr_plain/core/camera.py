# Frozen copy of physically_based_renderer_tpu_torch/core/camera.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""Camera model and primary-ray generation (port of `core/camera.py`).

Right-handed look-at with the reference engine's **y-down** up vector
(0, -1, 0), vertical-FOV pinhole.  Pixel (0, 0) is the TOP-LEFT of the
image, x right, y down; with the y-down up vector the camera's 'up' basis
points down in world space, so world +y renders to the top rows.
`generate_rays` makes a band of rows (or the whole image),
`generate_rays_flat` the flat batch of the debug shading and
`generate_rays_at` rays at explicit pixels (the integrator's morton
order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math3d

ZNEAR = 0.01
ZFAR = 1024.0
UP_Y_DOWN = (0.0, -1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera; every field is an f32 tensor on the render device."""

    position: torch.Tensor  # f32[3]
    target: torch.Tensor    # f32[3]
    up: torch.Tensor        # f32[3]
    fov_y: torch.Tensor     # f32[] vertical field of view, radians
    znear: torch.Tensor     # f32[]
    zfar: torch.Tensor      # f32[]

    @classmethod
    def make(cls, position, target, fov_y=1.0471976, up=UP_Y_DOWN,
             znear=ZNEAR, zfar=ZFAR, device=None) -> "Camera":
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        return cls(position=f32(position), target=f32(target), up=f32(up),
                   fov_y=f32(fov_y), znear=f32(znear), zfar=f32(zfar))

    def basis(self):
        """Camera-space basis in world coords: (right, up, forward)."""
        fwd = math3d.normalize(self.target - self.position)
        right = math3d.normalize(math3d.cross(fwd, self.up))
        up = math3d.cross(right, fwd)
        return right, up, fwd


def camera_from_numpy(arrays, device=None) -> Camera:
    """Camera from a mapping of numpy arrays keyed by the reference
    Camera's field names (position, target, up, fov_y, znear, zfar)."""
    a = {k: np.array(arrays[k], np.float32) for k in
         ("position", "target", "up", "fov_y", "znear", "zfar")}
    return Camera.make(position=a["position"], target=a["target"],
                       fov_y=a["fov_y"], up=a["up"], znear=a["znear"],
                       zfar=a["zfar"], device=device)


def generate_rays(camera: Camera, width: int, height: int,
                  jitter: torch.Tensor | None = None, row_start: int = 0,
                  n_rows: int | None = None):
    """Primary rays for a band of rows of a width x height image.

    jitter: optional f32[n_rows, width, 2] in [0, 1) (sub-pixel samples);
    None takes the pixel centres (0.5, 0.5).  row_start / n_rows select
    the band; the defaults cover the whole image.
    Returns (origins f32[n_rows, W, 3] (a broadcast view), directions
    f32[n_rows, W, 3] unit), equal to generate_rays_at on the row-major
    grid.
    """
    if n_rows is None:
        n_rows = height
    aspect = width / height
    right, up, fwd = camera.basis()
    tan_half = torch.tan(camera.fov_y / 2.0)
    dev = camera.position.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(n_rows, dtype=torch.float32, device=dev) + float(
        row_start)
    py, px = torch.meshgrid(ys, xs, indexing="ij")       # [n_rows, W]
    if jitter is None:
        jitter = torch.full((n_rows, width, 2), 0.5, dtype=torch.float32,
                            device=dev)
    ndc_x = (2.0 * (px + jitter[..., 0]) / width - 1.0) * aspect * tan_half
    ndc_y = (2.0 * (py + jitter[..., 1]) / height - 1.0) * tan_half
    d = ndc_x[..., None] * right + ndc_y[..., None] * up + fwd
    d = math3d.normalize(d)
    o = camera.position.expand(d.shape)
    return o, d


def generate_rays_flat(camera: Camera, width: int, height: int,
                       key: torch.Tensor | None = None):
    """Flat [H*W, 3] ray batch, row-major, with optional jitter drawn from
    one key (`rng.uniform(key, (H, W, 2))`, the reference's draw; the
    integrators key each ray instead)."""
    jitter = None
    if key is not None:
        from . import rng
        jitter = rng.uniform(key, (height, width, 2))
    o, d = generate_rays(camera, width, height, jitter)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def generate_rays_at(camera: Camera, width: int, height: int,
                     px: torch.Tensor, py: torch.Tensor,
                     jitter: torch.Tensor):
    """Primary rays at explicit pixel coordinates (flat batch form).

    px, py: f32[N] integer pixel coords; jitter: f32[N, 2] in [0, 1).
    Returns (origins f32[N, 3] (a broadcast view), directions f32[N, 3]).
    """
    aspect = width / height
    right, up, fwd = camera.basis()
    tan_half = torch.tan(camera.fov_y / 2.0)
    ndc_x = (2.0 * (px + jitter[:, 0]) / width - 1.0) * aspect * tan_half
    ndc_y = (2.0 * (py + jitter[:, 1]) / height - 1.0) * tan_half
    d = ndc_x[:, None] * right + ndc_y[:, None] * up + fwd
    d = math3d.normalize(d)
    o = camera.position.expand(d.shape)
    return o, d
