"""Procedural helmet-class binary asset: the `helmet` config (port of
`scene/helmet_asset.py`).

Authors a stand-in for a real scanned asset at the same scale and feature
mix: ~100k triangles, three primitives across two meshes and nodes, three
materials, four textures of mixed sizes across all four slots (albedo
256^2, metallic-roughness 256^2, normal map 128^2, emissive 64^2), smooth
normals, UV-gradient tangents.  It is written to a real .glb by
scene/export.py and read back through the whole scene/gltf.py loader (sRGB
decode, samplers, transform baking), so the `helmet` config covers the path
a user takes with their own binary model.

Deterministic: the same parameters give byte-identical geometry and
textures.  The authored file is cached under a name that carries a hash of
its content's sources (`asset_key`), so a file written by other code or for
other parameters is never picked up.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from pathlib import Path

import numpy as np

from ..core import film as film_mod
from . import export as export_mod
from . import graph as graph_mod
from .procedural import _materials
from .types import Scene, TextureStack

TWO_PI = 2.0 * np.pi


# --------------------------------------------------------------------------
# Procedural textures (numpy, deterministic)
# --------------------------------------------------------------------------

def _value_noise(size: int, cells: int, seed: int) -> np.ndarray:
    """Tileable bilinear value noise in [0,1] (deterministic)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (cells, cells)).astype(np.float32)
    gx = np.concatenate([g, g[:, :1]], axis=1)
    gxy = np.concatenate([gx, gx[:1, :]], axis=0)
    u = np.linspace(0.0, cells, size, endpoint=False)
    i = np.floor(u).astype(np.int64)
    f = (u - i).astype(np.float32)
    f = f * f * (3.0 - 2.0 * f)                      # smoothstep
    c00 = gxy[np.ix_(i, i)]
    c10 = gxy[np.ix_(i, i + 1)]
    c01 = gxy[np.ix_(i + 1, i)]
    c11 = gxy[np.ix_(i + 1, i + 1)]
    top = c00 * (1 - f[None, :]) + c10 * f[None, :]
    bot = c01 * (1 - f[None, :]) + c11 * f[None, :]
    return top * (1 - f[:, None]) + bot * f[:, None]


def _fbm(size: int, seed: int, octaves: int = 4) -> np.ndarray:
    acc = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        acc += amp * _value_noise(size, 4 << o, seed + o)
        total += amp
        amp *= 0.5
    return acc / total


def _panel_lines(size: int, n: int = 6) -> np.ndarray:
    """Darkened seam grid (helmet panel lines), value in [0,1]."""
    u = np.linspace(0.0, 1.0, size, endpoint=False)
    d = np.minimum(np.abs((u * n) % 1.0), np.abs(1.0 - (u * n) % 1.0))
    line = np.clip(d * size * n / 28.0, 0.0, 1.0)
    return np.minimum(line[:, None], line[None, :]).astype(np.float32)


def make_shell_albedo(size: int = 256) -> np.ndarray:
    """Rust-and-paint shell albedo RGBA (linear space)."""
    rust = _fbm(size, seed=11)
    paint = np.array([0.32, 0.36, 0.42], np.float32)
    rust_c = np.array([0.42, 0.22, 0.10], np.float32)
    w = np.clip((rust - 0.45) * 3.0, 0.0, 1.0)[..., None]
    rgb = paint * (1 - w) + rust_c * w
    rgb = rgb * (0.55 + 0.45 * _panel_lines(size))[..., None]
    a = np.ones((size, size, 1), np.float32)
    return np.concatenate([rgb, a], axis=-1).astype(np.float32)


def make_shell_mr(size: int = 256) -> np.ndarray:
    """Metallic-roughness map: G=roughness (rough where rusty), B=metallic
    (metal where paint worn through)."""
    rust = _fbm(size, seed=11)
    wear = _fbm(size, seed=23)
    mr = np.zeros((size, size, 4), np.float32)
    mr[..., 1] = np.clip(0.25 + 0.65 * rust, 0.0, 1.0)
    mr[..., 2] = (wear > 0.55).astype(np.float32)
    mr[..., 3] = 1.0
    return mr


def make_shell_normal(size: int = 128, strength: float = 2.0) -> np.ndarray:
    """Tangent-space normal map from the fbm heightfield (dents)."""
    h = _fbm(size, seed=37, octaves=5)
    dx = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) * size / 2.0
    dy = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) * size / 2.0
    n = np.stack([-dx * strength, -dy * strength,
                  np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgba = np.ones((size, size, 4), np.float32)
    rgba[..., :3] = n * 0.5 + 0.5
    return rgba


def make_visor_emissive(size: int = 64) -> np.ndarray:
    """HUD-strip emissive map: two glowing scanlines on black."""
    e = np.zeros((size, size, 4), np.float32)
    y = np.arange(size)
    for c, (r, g, b) in ((size // 3, (0.2, 0.9, 1.0)),
                         (2 * size // 3, (1.0, 0.45, 0.1))):
        w = np.exp(-0.5 * ((y - c) / (size / 40.0)) ** 2)[:, None]
        e[..., 0] += w * r
        e[..., 1] += w * g
        e[..., 2] += w * b
    e[..., 3] = 1.0
    return e


# --------------------------------------------------------------------------
# Geometry (numpy, deterministic)
# --------------------------------------------------------------------------

def _uv_tangents(positions, normals, uvs, indices) -> np.ndarray:
    """Per-vertex UV-gradient tangents (Lengyel), averaged and
    orthogonalized — the frame normal mapping assumes."""
    v = positions.shape[0]
    tan = np.zeros((v, 3), np.float64)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    d1 = uvs[i1] - uvs[i0]
    d2 = uvs[i2] - uvs[i0]
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    for k, ii in ((0, i0), (1, i1), (2, i2)):
        np.add.at(tan, ii, t)
    tan -= normals * np.sum(tan * normals, axis=-1, keepdims=True)
    lens = np.linalg.norm(tan, axis=-1, keepdims=True)
    bad = lens[:, 0] < 1e-8
    # degenerate UVs: any frame orthogonal to n works
    alt = np.cross(np.where(np.abs(normals[:, :1]) < 0.9,
                            [1.0, 0, 0], [0, 1.0, 0]), normals)
    tan = np.where(bad[:, None], alt, tan / np.maximum(lens, 1e-12))
    t4 = np.ones((v, 4), np.float32)
    t4[:, :3] = tan.astype(np.float32)
    return t4


def _lat_band(radius, rings, sectors, th0, th1, radial_fn=None,
              uv_scale=(1.0, 1.0)):
    """Latitude band of a sphere with per-vertex radial displacement.
    Returns (positions, normals, uvs, indices)."""
    theta = np.linspace(th0, th1, rings + 1)
    phi = np.linspace(0.0, TWO_PI, sectors + 1)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    n = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                  np.sin(tt) * np.sin(pp)], axis=-1).astype(np.float32)
    r = np.full(tt.shape, radius, np.float32)
    if radial_fn is not None:
        r = r + radial_fn(tt, pp).astype(np.float32)
    pos = (n * r[..., None]).reshape(-1, 3).astype(np.float32)
    uv = np.stack([pp / TWO_PI * uv_scale[0],
                   (tt - th0) / max(th1 - th0, 1e-6) * uv_scale[1]],
                  axis=-1).reshape(-1, 2).astype(np.float32)
    faces = []
    stride = sectors + 1
    for i in range(rings):
        for j in range(sectors):
            a = i * stride + j
            b = a + stride
            faces.append([a, b, a + 1])
            faces.append([a + 1, b, b + 1])
    idx = np.asarray(faces, np.int32)
    # smooth normals from the displaced surface
    nrm = _smooth_normals(pos, idx)
    return pos, nrm, uv, idx


def _smooth_normals(positions, indices):
    n = np.zeros_like(positions, dtype=np.float64)
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(lens, 1e-12)).astype(np.float32)


def _torus(r_major, r_minor, rings, sectors, uv_scale=(4.0, 1.0)):
    u = np.linspace(0.0, TWO_PI, rings + 1)
    v = np.linspace(0.0, TWO_PI, sectors + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx = np.cos(uu) * (r_major + r_minor * np.cos(vv))
    cz = np.sin(uu) * (r_major + r_minor * np.cos(vv))
    cy = r_minor * np.sin(vv)
    pos = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3).astype(np.float32)
    nx = np.cos(uu) * np.cos(vv)
    nz = np.sin(uu) * np.cos(vv)
    ny = np.sin(vv)
    nrm = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([uu / TWO_PI * uv_scale[0],
                   vv / TWO_PI * uv_scale[1]],
                  axis=-1).reshape(-1, 2).astype(np.float32)
    faces = []
    stride = sectors + 1
    for i in range(rings):
        for j in range(sectors):
            a = i * stride + j
            b = a + stride
            faces.append([a, b, a + 1])
            faces.append([a + 1, b, b + 1])
    return pos, nrm, uv, np.asarray(faces, np.int32)


def _prim(pos, nrm, uv, idx, material):
    return graph_mod.MeshPrimitive(
        positions=pos, normals=nrm,
        tangents=_uv_tangents(pos, nrm, uv, idx),
        uvs=uv, indices=idx, material=material)


def _dent_field(seed=5):
    """Radial displacement: low-frequency warp + sharp dents."""
    rng = np.random.default_rng(seed)
    k = rng.normal(0.0, 1.0, (3, 3)).astype(np.float32)
    centers = rng.uniform(0.0, 1.0, (8, 2)).astype(np.float32)
    centers[:, 0] *= np.pi
    centers[:, 1] *= TWO_PI
    depth = rng.uniform(0.02, 0.06, 8).astype(np.float32)
    width = rng.uniform(0.08, 0.25, 8).astype(np.float32)

    def f(tt, pp):
        d = (0.03 * np.sin(3.0 * tt + k[0, 0]) * np.sin(4.0 * pp + k[0, 1])
             + 0.02 * np.sin(7.0 * tt + k[1, 0]) * np.sin(6.0 * pp
                                                          + k[1, 1]))
        for c, dep, wid in zip(centers, depth, width):
            dist2 = ((tt - c[0]) ** 2
                     + (np.minimum(np.abs(pp - c[1]),
                                   TWO_PI - np.abs(pp - c[1]))) ** 2)
            d = d - dep * np.exp(-dist2 / (wid * wid))
        return d

    return f


def build_helmet_graph(scale_tris: float = 1.0):
    """Author the helmet SceneGraph + materials + textures.

    scale_tris scales tessellation (1.0 -> ~100k tris total).
    """
    s = float(np.sqrt(scale_tris))
    dent = _dent_field()

    # Shell: dome + lower skirt, dented, panel-textured (material 0).
    shell = _lat_band(1.0, int(160 * s), int(200 * s),
                      0.06 * np.pi, 0.78 * np.pi,
                      radial_fn=dent, uv_scale=(3.0, 2.0))
    # Visor: tighter band floating just off the shell front (material 1).
    visor = _lat_band(1.035, int(60 * s), int(130 * s),
                      0.32 * np.pi, 0.55 * np.pi,
                      radial_fn=None, uv_scale=(1.0, 1.0))
    # Collar ring: torus under the shell (material 2).
    collar = _torus(0.86, 0.10, int(110 * s), int(90 * s))

    g = graph_mod.SceneGraph(name="helmet")
    g.meshes = [
        graph_mod.HostMesh(name="helmet",
                           primitives=[_prim(*shell, 0), _prim(*visor, 1)]),
        graph_mod.HostMesh(name="collar", primitives=[_prim(*collar, 2)]),
    ]
    tr = graph_mod.Transform
    g.roots = [
        graph_mod.Node(name="helmet", mesh=0),
        graph_mod.Node(
            name="collar", mesh=1,
            transform=tr(translation=np.array([0.0, -0.62, 0.0],
                                              np.float32))),
    ]

    stack = TextureStack.from_images([
        make_shell_albedo(256),    # 0 sRGB albedo
        make_shell_mr(256),        # 1 linear MR
        make_shell_normal(128),    # 2 linear normal map
        make_visor_emissive(64),   # 3 sRGB emissive
    ])
    m = _materials(
        base_color_factor=np.asarray(
            [[1.0, 1.0, 1.0, 1.0],
             [0.05, 0.05, 0.06, 1.0],
             [0.56, 0.57, 0.58, 1.0]], np.float32),
        metallic_factor=np.asarray([1.0, 1.0, 1.0], np.float32),
        roughness_factor=np.asarray([1.0, 0.18, 0.42], np.float32),
        emissive_factor=np.asarray(
            [[0, 0, 0], [3.5, 3.5, 3.5], [0, 0, 0]], np.float32),
        base_color_tex=np.asarray([0, -1, -1], np.int32),
        metallic_roughness_tex=np.asarray([1, -1, -1], np.int32),
        normal_tex=np.asarray([2, -1, -1], np.int32),
        emissive_tex=np.asarray([-1, 3, -1], np.int32),
        normal_scale=np.asarray([0.8, 1.0, 1.0], np.float32),
    )
    return g, m, stack


def author_helmet_glb(path: str | Path, scale_tris: float = 1.0) -> Path:
    """Write the helmet .glb (export_glb) and return the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    g, m, stack = build_helmet_graph(scale_tris)
    export_mod.export_glb(path, g, m, stack)
    return path


def default_cache_dir() -> Path:
    """`PBR_TORCH_ASSET_CACHE`, else `build/torch_assets/` at the
    repository root (beside the kernels' build directory)."""
    env = os.environ.get("PBR_TORCH_ASSET_CACHE")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_assets"


def asset_key(scale_tris: float) -> str:
    """Hash of everything the authored file's bytes depend on: the
    tessellation scale and the sources that author, export and encode it."""
    h = hashlib.sha256(repr(float(scale_tris)).encode())
    for mod in (graph_mod, export_mod, film_mod):
        h.update(Path(mod.__file__).read_bytes())
    h.update(Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def cached_helmet_glb(cache_dir: str | Path | None = None,
                      scale_tris: float = 1.0) -> Path:
    """The helmet .glb for `scale_tris`, authored on a cache miss.  The
    file is written under a temporary name and renamed, so a reader never
    sees a partial file."""
    cache_dir = Path(cache_dir) if cache_dir is not None else (
        default_cache_dir())
    path = cache_dir / f"helmet_{scale_tris:g}_{asset_key(scale_tris)}.glb"
    if not path.exists():
        cache_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".glb.tmp")
        os.close(fd)
        try:
            author_helmet_glb(tmp, scale_tris)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def load_helmet_scene(cache_dir: str | Path | None = None,
                      scale_tris: float = 1.0) -> Scene:
    """Author (cached) + ingest the helmet through the whole .glb pipeline
    and attach the HDR environment.  This is the `helmet` config's scene."""
    from . import gltf as gltf_mod
    from .procedural import make_gradient_sky
    scene, _graph, _cam = gltf_mod.load(
        cached_helmet_glb(cache_dir, scale_tris))
    return dataclasses.replace(scene, env=make_gradient_sky())
