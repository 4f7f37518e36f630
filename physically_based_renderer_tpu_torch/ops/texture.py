"""Texture filtering: quad-packed mip pyramid + one gather per level (port of
`ops/texture.py`).

Every texel row of every mip level is stored quad-packed: row (l, y, x)
holds the 2x2 neighbourhood [c(y,x) | c(y,x+1) | c(y+1,x) | c(y+1,x+1)]
with the +1 wrap baked in, so a bilinear fetch is one [N, 16] row gather
(ops/gather.take_rows) and a trilinear fetch two.  Per-texture shape, wrap
and filter metadata rides the per-triangle attribute row
(integrator/shading.pack_tri_attrs), so a fetch needs no metadata gather.
The pyramid is built from `TextureStack.texels` with plain torch ops, so
gradients can reach the texels; it is the quads tensor itself (the
reference wraps it in a one-field `TexturePyramid` record).  Mirror wrap
folds the continuous coordinate (u' = 1 - |1 - u mod 2|).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core import math3d
from ..scene.types import (FILTER_NEAREST, MIP_LINEAR, MIP_NONE,
                           TextureStack, WRAP_CLAMP, WRAP_MIRROR,
                           WRAP_REPEAT)
from .gather import take_rows

L_MAX = 13       # textures up to 8192 on the long side
META_W = 9       # meta row: off0 h0 w0 wrapS wrapT mag min_inner min_mip nl


def _levels(h: int, w: int, min_mip: int) -> list[tuple[int, int]]:
    """Static mip-level dims for a texture: [(h0, w0), (h1, w1), ...]."""
    if min_mip == MIP_NONE:
        return [(h, w)]
    dims = [(h, w)]
    while max(h, w) > 1:
        h, w = max(1, h // 2), max(1, w // 2)
        dims.append((h, w))
    return dims


def texture_meta(stack: TextureStack) -> np.ndarray:
    """Static per-texture metadata table f32[T, META_W].

    off0 is the texture's level-0 row offset into the mip pyramid's arena
    (levels of one texture are contiguous, nearest first).
    """
    return _texture_meta(stack.shapes, stack.wrap, stack.filt)


def meta_table(stack: TextureStack, device) -> torch.Tensor:
    """`texture_meta(stack)` on `device`, made once per layout of the stack
    (its static shapes, wraps and filters, all the table reads) and device,
    and shared by its readers: no copy to the card per frame.  Never
    evicted: a captured frame (integrator/frame_graph.py) reads it by
    address."""
    return _meta_table(stack.shapes, stack.wrap, stack.filt,
                       torch.device(device))


@functools.lru_cache(maxsize=None)
def _meta_table(shapes, wrap, filt, device) -> torch.Tensor:
    return torch.from_numpy(_texture_meta(shapes, wrap, filt)).to(device)


def _texture_meta(shapes, wrap, filt) -> np.ndarray:
    rows = []
    off = 0
    for (h, w), (ws, wt), (mag, mi, mm) in zip(shapes, wrap, filt):
        dims = _levels(h, w, mm)
        rows.append([off, h, w, ws, wt, mag, mi, mm, len(dims)])
        off += sum(hl * wl for hl, wl in dims)
    if off >= (1 << 24):
        raise ValueError("texture pyramid exceeds exact-f32 addressing")
    return np.asarray(rows, np.float32)


def _shift(img: torch.Tensor, wrap: int, dim: int) -> torch.Tensor:
    """img -> its +1 neighbour along `dim` (x: 1, y: 0): repeat rolls;
    clamp and mirror repeat the edge texel."""
    if wrap == WRAP_REPEAT:
        return torch.roll(img, -1, dims=dim)
    n = img.shape[dim]
    return torch.cat([img.narrow(dim, 1, n - 1), img.narrow(dim, n - 1, 1)],
                     dim=dim)


def _downsample(img: torch.Tensor) -> torch.Tensor:
    """2x2 box filter [h, w, c] -> [max(1, h//2), max(1, w//2), c]; odd
    dims are edge-padded to even first."""
    h, w = img.shape[0], img.shape[1]
    if h > 1 and h % 2:
        img = torch.cat([img, img[-1:]], dim=0)
    if w > 1 and w % 2:
        img = torch.cat([img, img[:, -1:]], dim=1)
    h2, w2 = max(1, h // 2), max(1, w // 2)
    if h == 1:
        return img.reshape(1, w2, 2, -1).mean(dim=2)
    if w == 1:
        return img.reshape(h2, 2, 1, -1).mean(dim=1)
    return img.reshape(h2, 2, w2, 2, -1).mean(dim=(1, 3))


def _quad_pack(img: torch.Tensor, ws: int, wt: int) -> torch.Tensor:
    """[h, w, 4] -> [h*w, 16] quad rows (c00 | c10 | c01 | c11)."""
    nx = _shift(img, ws, 1)
    ny = _shift(img, wt, 0)
    nxy = _shift(nx, wt, 0)
    return torch.cat([img, nx, ny, nxy], dim=-1).reshape(-1, 16)


def build_pyramid(stack: TextureStack) -> torch.Tensor:
    """Mip chain + quad pack of every texture -> quads f32[RQ, 16].

    Built once per frame (integrator/path.frame_tables)."""
    pieces = []
    for off, (h, w), (ws, wt), (_, _, mm) in zip(
            stack.offsets, stack.shapes, stack.wrap, stack.filt):
        img = stack.texels[off:off + h * w].reshape(h, w, 4)
        for (hl, wl) in _levels(h, w, mm):
            if (hl, wl) != tuple(img.shape[:2]):
                img = _downsample(img)
            pieces.append(_quad_pack(img, ws, wt))
    return torch.cat(pieces, dim=0)


def _wrap_u(u: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """Continuous wrap: mirror folds; clamp defers to the per-level texel
    clip, repeat to the integer mod."""
    mirrored = 1.0 - torch.abs(1.0 - torch.remainder(u, 2.0))
    return torch.where(mode == WRAP_MIRROR, mirrored, u)


def _fetch_level(quads, meta, u, v, level):
    """One quad gather at per-ray level -> (quad f32[N, 16], fx, fy)."""
    off0, h0, w0 = meta[:, 0], meta[:, 1], meta[:, 2]
    ws, wt = meta[:, 3], meta[:, 4]
    # level dims + offset in exact small-int f32 math
    scale = torch.exp2(-level)
    hl = torch.clamp_min(torch.floor(h0 * scale), 1.0)
    wl = torch.clamp_min(torch.floor(w0 * scale), 1.0)
    off = off0
    for j in range(L_MAX - 1):
        hj = torch.clamp_min(torch.floor(h0 * (0.5 ** j)), 1.0)
        wj = torch.clamp_min(torch.floor(w0 * (0.5 ** j)), 1.0)
        off = off + torch.where(j < level, hj * wj, 0.0)
    x = u * wl - 0.5
    y = v * hl - 0.5
    # clamp wraps the continuous coordinate (exact, incl. the border lerp);
    # x and y carry gradient to the uvs, so the bound splits ties (math3d)
    x = torch.where(ws == WRAP_CLAMP,
                    torch.minimum(math3d.maximum(x, 0.0), wl - 1.0), x)
    y = torch.where(wt == WRAP_CLAMP,
                    torch.minimum(math3d.maximum(y, 0.0), hl - 1.0), y)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = torch.where(ws == WRAP_REPEAT, torch.remainder(x0, wl),
                     torch.minimum(torch.clamp_min(x0, 0.0), wl - 1.0))
    y0 = torch.where(wt == WRAP_REPEAT, torch.remainder(y0, hl),
                     torch.minimum(torch.clamp_min(y0, 0.0), hl - 1.0))
    idx = (off + y0 * wl + x0).to(torch.int32)
    return take_rows(quads, idx), fx[:, None], fy[:, None]


def _lerp_quad(q, fx, fy, nearest):
    """Bilinear (or snapped-nearest) blend of one quad row [N, 16] -> [N, 4]."""
    fx = torch.where(nearest, (fx >= 0.5).to(torch.float32), fx)
    fy = torch.where(nearest, (fy >= 0.5).to(torch.float32), fy)
    top = q[:, 0:4] * (1.0 - fx) + q[:, 4:8] * fx
    bot = q[:, 8:12] * (1.0 - fx) + q[:, 12:16] * fx
    return top * (1.0 - fy) + bot * fy


def sample_slot(quads: torch.Tensor, meta: torch.Tensor, uv: torch.Tensor,
                lod: torch.Tensor | None = None, default=1.0,
                trilinear: bool = True) -> torch.Tensor:
    """Sample one texture slot -> f32[N, 4].

    meta f32[N, META_W] per-ray metadata rows (off0 < 0: no texture, the
    lane returns `default`); uv f32[N, 2]; lod f32[N] = log2 of the ray's
    footprint in uv units (the texture-size term is added here), or None
    for level-0 bilinear.  trilinear=False drops the second level's gather.
    """
    has = meta[:, 0] >= 0.0
    safe = torch.where(has[:, None], meta, 0.0)
    h0, w0 = safe[:, 1], safe[:, 2]
    mag, mi, mm = safe[:, 5], safe[:, 6], safe[:, 7]
    nl = torch.clamp_min(safe[:, 8], 1.0)
    u = _wrap_u(uv[:, 0], safe[:, 3])
    v = _wrap_u(uv[:, 1], safe[:, 4])

    if lod is None:
        l0 = torch.zeros_like(h0)
        frac = 0.0
        minify = torch.zeros_like(has)
        tri = False
    else:
        # footprint in texels = footprint in uv x sqrt(h w)
        ll = lod + 0.5 * torch.log2(torch.clamp_min(h0 * w0, 1.0))
        minify = ll > 0.0
        lmax = nl - 1.0
        lc = torch.minimum(torch.clamp_min(ll, 0.0), lmax)
        # MIP_NEAREST snaps; MIP_NONE has nl = 1 so lc = 0 naturally
        l0 = torch.where(mm == MIP_LINEAR, torch.floor(lc), torch.round(lc))
        frac = torch.where((mm == MIP_LINEAR) & (l0 < lmax), lc - l0,
                           0.0)[:, None]
        tri = trilinear

    nearest = torch.where(minify, mi == FILTER_NEAREST,
                          mag == FILTER_NEAREST)[:, None]
    q0, fx, fy = _fetch_level(quads, safe, u, v, l0)
    out = _lerp_quad(q0, fx, fy, nearest)
    if tri:
        l1 = torch.minimum(l0 + 1.0, nl - 1.0)
        q1, fx1, fy1 = _fetch_level(quads, safe, u, v, l1)
        out = out * (1.0 - frac) + _lerp_quad(q1, fx1, fy1, nearest) * frac
    return torch.where(has[:, None], out, default)


def sample_bilinear(stack: TextureStack, tex_idx: torch.Tensor,
                    uv: torch.Tensor, default: float = 1.0) -> torch.Tensor:
    """Level-0 bilinear fetch by texture index -> f32[N, 4] (tests and
    tools; the integrator uses sample_slot with the metadata riding the
    attribute row).  tex_idx int[N]; entries < 0 return `default`.  The
    metadata rows and the texels are both K5a gathers on the card."""
    quads = build_pyramid(stack)
    meta_tab = meta_table(stack, quads.device)
    rows = take_rows(meta_tab, torch.clamp_min(tex_idx, 0))
    rows = torch.where((tex_idx >= 0)[:, None], rows, -1.0)
    return sample_slot(quads, rows, uv, lod=None, default=default)


def env_quads(data: torch.Tensor) -> torch.Tensor:
    """Quad-pack an equirect env map [H, W, 3] -> f32[H*W, 12] (x repeats
    across the phi seam, y clamps at the poles)."""
    nx = torch.roll(data, -1, dims=1)
    ny = torch.cat([data[1:], data[-1:]], dim=0)
    nxy = torch.roll(ny, -1, dims=1)
    return torch.cat([data, nx, ny, nxy], dim=-1).reshape(-1, 12)


def sample_env_bilinear(data: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Equirect lookup for unit directions d[N, 3] -> radiance [N, 3].

    theta = acos(y) maps to rows (0 = +y pole), phi = atan2(z, x) to
    columns; one quad-row gather."""
    h, w = data.shape[0], data.shape[1]
    q = env_quads(data)
    theta = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0))
    phi = torch.atan2(d[:, 2], d[:, 0])
    x = (phi / (2.0 * math.pi) + 0.5) * w - 0.5
    y = torch.clamp(theta / math.pi * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0 = torch.remainder(x0, w)
    rows = take_rows(q, (y0 * w + x0).to(torch.int32))
    top = rows[:, 0:3] * (1.0 - fx) + rows[:, 3:6] * fx
    bot = rows[:, 6:9] * (1.0 - fx) + rows[:, 9:12] * fx
    return top * (1.0 - fy) + bot * fy
