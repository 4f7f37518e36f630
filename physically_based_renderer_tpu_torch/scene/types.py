"""Scene representation: flat structure-of-arrays records of tensors.

Port of the reference's `scene/types.py`.  Frozen dataclasses take the
place of the reference's struct dataclasses; the static flags of `Scene`
(which light families and texture slots exist) are plain Python values
that the integrator branches on.  Scenes are built on the host (numpy,
then CPU tensors) and moved to the render device once by `upload_scene`.
`scene_from_numpy` carries a reference scene across, flattened to numpy
arrays plus its static flags, so both packages can render identical data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..accel.bvh import BVH, LEAF_SIZE, build_bvh
from ..accel.clusters import (SOUP_ROWS, ClusterGrid, build_clusters,
                              pack_soup_host)

# Texture wrap modes / filters: same encoding as the reference.
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2
FILTER_NEAREST = 0
FILTER_LINEAR = 1
MIP_NONE = 0
MIP_NEAREST = 1
MIP_LINEAR = 2


def _t(x, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.from_numpy(np.array(x)).to(dtype)


def _f32(x) -> torch.Tensor:
    return _t(x, torch.float32)


def _i32(x) -> torch.Tensor:
    return _t(x, torch.int32)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """World-space triangle soup (transforms baked at build)."""

    positions: torch.Tensor     # f32[V, 3]
    normals: torch.Tensor       # f32[V, 3]
    tangents: torch.Tensor      # f32[V, 4] xyz tangent, w bitangent sign
    uvs: torch.Tensor           # f32[V, 2]
    indices: torch.Tensor       # i32[T, 3]
    tri_material: torch.Tensor  # i32[T]

    @property
    def num_tris(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    def tri_vertices(self):
        """Per-triangle corner positions -> (v0, v1, v2) each f32[T, 3]."""
        p, i = self.positions, self.indices
        return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


@dataclasses.dataclass(frozen=True)
class Materials:
    """glTF 2.0 metallic-roughness material table (SoA over materials)."""

    base_color_factor: torch.Tensor       # f32[M, 4]
    metallic_factor: torch.Tensor         # f32[M]
    roughness_factor: torch.Tensor        # f32[M]
    emissive_factor: torch.Tensor         # f32[M, 3]
    normal_scale: torch.Tensor            # f32[M]
    specular_factor: torch.Tensor         # f32[M] scales dielectric F0
    base_color_tex: torch.Tensor          # i32[M]; -1 = no texture
    metallic_roughness_tex: torch.Tensor  # i32[M]
    normal_tex: torch.Tensor              # i32[M]
    emissive_tex: torch.Tensor            # i32[M]

    @property
    def num_materials(self) -> int:
        return self.base_color_factor.shape[0]

    @classmethod
    def default(cls, n: int = 1) -> "Materials":
        return cls(
            base_color_factor=torch.ones((n, 4)),
            metallic_factor=torch.zeros((n,)),
            roughness_factor=torch.ones((n,)),
            emissive_factor=torch.zeros((n, 3)),
            normal_scale=torch.ones((n,)),
            specular_factor=torch.ones((n,)),
            base_color_tex=torch.full((n,), -1, dtype=torch.int32),
            metallic_roughness_tex=torch.full((n,), -1, dtype=torch.int32),
            normal_tex=torch.full((n,), -1, dtype=torch.int32),
            emissive_tex=torch.full((n,), -1, dtype=torch.int32),
        )


@dataclasses.dataclass(frozen=True)
class TextureStack:
    """All scene textures as one flat texel arena (linear RGBA rows).

    `texels[offsets[i] : offsets[i] + h_i * w_i]` is texture i, row-major
    (y down).  Shapes, wrap modes and filters are static tuples; the
    sampler (ops/texture.py) builds the mip pyramid from the arena.  An
    untextured scene carries the 1x1 `empty()` stack.
    """

    texels: torch.Tensor  # f32[R, 4]
    shapes: tuple         # ((h, w), ...)
    wrap: tuple           # ((wrapS, wrapT), ...)
    filt: tuple           # ((mag, min_inner, min_mip), ...)

    @classmethod
    def empty(cls) -> "TextureStack":
        return cls(texels=torch.ones((1, 4)), shapes=((1, 1),),
                   wrap=((WRAP_REPEAT, WRAP_REPEAT),),
                   filt=((FILTER_LINEAR, FILTER_LINEAR, MIP_NONE),))

    @classmethod
    def from_images(cls, images, wrap=None, filt=None) -> "TextureStack":
        """Build from a list of [h, w, 4] float arrays (host).

        wrap: per-texture (wrapS, wrapT), default repeat; filt: per-texture
        (mag, min_inner, min_mip), default trilinear (MIP_LINEAR), the glTF
        default when a sampler leaves its filters undefined.
        """
        images = [np.asarray(im, np.float32) for im in images]
        if not images:
            return cls.empty()
        n = len(images)
        wrap = (tuple(tuple(w) for w in wrap) if wrap is not None
                else ((WRAP_REPEAT, WRAP_REPEAT),) * n)
        filt = (tuple(tuple(f) for f in filt) if filt is not None
                else ((FILTER_LINEAR, FILTER_LINEAR, MIP_LINEAR),) * n)
        texels = np.concatenate([im.reshape(-1, 4) for im in images], axis=0)
        return cls(texels=torch.from_numpy(texels),
                   shapes=tuple((im.shape[0], im.shape[1]) for im in images),
                   wrap=wrap, filt=filt)

    @property
    def num_textures(self) -> int:
        return len(self.shapes)

    @property
    def offsets(self) -> tuple:
        """Static start row of each texture in `texels`."""
        offs, acc = [], 0
        for (h, w) in self.shapes:
            offs.append(acc)
            acc += h * w
        return tuple(offs)

    def image(self, i: int) -> np.ndarray:
        """Host copy of texture i as f32[h, w, 4] (tests, export)."""
        h, w = self.shapes[i]
        off = self.offsets[i]
        return _np(self.texels[off:off + h * w]).reshape(h, w, 4)


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    """Emissive-triangle sampling table for next-event estimation.

    Radiance is read from materials.emissive_factor at sampling time; this
    table holds only the (detached) distribution.
    """

    tri_idx: torch.Tensor     # i32[E] triangle ids (masked by valid)
    valid: torch.Tensor       # bool[E]
    area: torch.Tensor        # f32[E] world-space area
    pdf_tri: torch.Tensor     # f32[E] discrete prob of picking each emitter
    cdf: torch.Tensor         # f32[E] inclusive CDF over pdf_tri
    alias_prob: torch.Tensor  # f32[E] Walker alias acceptance
    alias_idx: torch.Tensor   # i32[E] Walker alias target

    @classmethod
    def empty(cls) -> "EmitterTable":
        return cls(tri_idx=torch.zeros((1,), dtype=torch.int32),
                   valid=torch.zeros((1,), dtype=torch.bool),
                   area=torch.zeros((1,)), pdf_tri=torch.zeros((1,)),
                   cdf=torch.ones((1,)), alias_prob=torch.ones((1,)),
                   alias_idx=torch.zeros((1,), dtype=torch.int32))

    @property
    def num_emitters(self) -> int:
        return self.tri_idx.shape[0]


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    """Single directional 'sun'; zero radiance = disabled."""

    direction: torch.Tensor  # f32[3] unit, points FROM light TOWARD scene
    radiance: torch.Tensor   # f32[3]

    @classmethod
    def off(cls) -> "DirectionalLight":
        return cls(direction=torch.tensor([0.0, -1.0, 0.0]),
                   radiance=torch.zeros((3,)))


@dataclasses.dataclass(frozen=True)
class EnvMap:
    """Equirect HDR environment map with importance-sampling tables
    (`build_env_tables`); sampled by models/lights.py."""

    data: torch.Tensor             # f32[H, W, 3] radiance
    conditional_cdf: torch.Tensor  # f32[H, W]
    marginal_cdf: torch.Tensor     # f32[H]
    pdf: torch.Tensor              # f32[H, W] solid-angle pdf per texel
    alias_prob: torch.Tensor       # f32[H*W]
    alias_idx: torch.Tensor        # i32[H*W]

    @classmethod
    def constant(cls, radiance, height: int = 8, width: int = 16) -> "EnvMap":
        data = np.broadcast_to(np.asarray(radiance, np.float32),
                               (height, width, 3))
        return build_env_tables(data)


@dataclasses.dataclass(frozen=True)
class Scene:
    geometry: Geometry
    materials: Materials
    textures: TextureStack
    emitters: EmitterTable
    directional: DirectionalLight
    env: EnvMap | None
    # Acceleration structures, None when absent: the BVH of the stack-walk
    # tracer (accel/bvh.py, `with_bvh`) and the block tracers' cluster grid
    # (accel/clusters.py, `with_clusters`), which wins when both are set.
    bvh: BVH | None = None
    clusters: ClusterGrid | None = None
    # Static flags: the integrator skips whole light paths / texture slots.
    has_emitters: bool = False
    has_directional: bool = False
    has_textures: bool = False
    tex_slots: tuple = (False, False, False, False)
    flat_normals: bool = False

    @property
    def device(self) -> torch.device:
        return self.geometry.positions.device


def _build_alias_table(p: np.ndarray):
    """Walker/Vose alias table for a discrete distribution p (sums to 1).

    Sampling: slot j ~ U{0..M-1}; return j if u < prob[j] else alias[j].
    """
    p = np.asarray(p, np.float64)
    m = p.size
    scaled = p * m
    prob = np.ones(m, np.float64)
    alias = np.arange(m, dtype=np.int64)
    small = [i for i in range(m) if scaled[i] < 1.0]
    large = [i for i in range(m) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    # Leftovers (float slop) keep prob = 1 (self-alias).
    return prob.astype(np.float32), alias.astype(np.int32)


def build_env_tables(data) -> EnvMap:
    """Importance tables for an equirect env map (host numpy).

    Rows are weighted by sin(theta); pdf is in solid-angle measure:
    p(omega) = p_img(x, y) * (H * W) / (2 pi^2 sin(theta)).
    """
    data = np.asarray(data, np.float32)
    h, w = data.shape[0], data.shape[1]
    lum = np.maximum(data.mean(axis=-1), 1e-12)
    theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
    sin_t = np.sin(theta).astype(np.float32)
    weighted = lum * sin_t[:, None]
    row_sums = weighted.sum(axis=1)
    total = max(row_sums.sum(), 1e-12)
    conditional_cdf = np.cumsum(weighted, axis=1) / np.maximum(
        row_sums[:, None], 1e-12)
    marginal_cdf = np.cumsum(row_sums) / total
    p_img = weighted / total  # probability of each texel
    pdf_sa = p_img * (h * w) / (2.0 * np.pi * np.pi * np.maximum(
        sin_t[:, None], 1e-6))
    alias_prob, alias_idx = _build_alias_table(p_img.reshape(-1))
    return EnvMap(data=_f32(np.ascontiguousarray(data)),
                  conditional_cdf=_f32(conditional_cdf.astype(np.float32)),
                  marginal_cdf=_f32(marginal_cdf.astype(np.float32)),
                  pdf=_f32(pdf_sa.astype(np.float32)),
                  alias_prob=_f32(alias_prob), alias_idx=_i32(alias_idx))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_emitter_table(geometry: Geometry,
                        materials: Materials) -> EmitterTable:
    """Host-side scan for emissive triangles -> sampling table.

    Power-weighted discrete distribution (area x luminance of
    emissive_factor); probabilities are detached by construction (numpy).
    """
    pos = _np(geometry.positions)
    idx = _np(geometry.indices)
    tri_mat = _np(geometry.tri_material)
    emissive = _np(materials.emissive_factor)

    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    lum = emissive[tri_mat] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    power = area * np.maximum(lum, 0.0)
    ids = np.nonzero(power > 0.0)[0].astype(np.int32)
    if ids.size == 0:
        return EmitterTable.empty()

    p = (power[ids] / power[ids].sum()).astype(np.float32)
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    alias_prob, alias_idx = _build_alias_table(p)
    return EmitterTable(tri_idx=_i32(ids),
                        valid=torch.ones((ids.size,), dtype=torch.bool),
                        area=_f32(area[ids].astype(np.float32)),
                        pdf_tri=_f32(p),
                        cdf=_f32(cdf.astype(np.float32)),
                        alias_prob=_f32(alias_prob),
                        alias_idx=_i32(alias_idx))


def make_scene(geometry: Geometry, materials: Materials,
               textures: TextureStack | None = None,
               directional: DirectionalLight | None = None,
               env: EnvMap | None = None) -> Scene:
    """Assemble a Scene, deriving the emitter table and the static flags."""
    emitters = build_emitter_table(geometry, materials)
    directional = (directional if directional is not None
                   else DirectionalLight.off())
    pos = _np(geometry.positions)
    idx = _np(geometry.indices)
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                  pos[idx[:, 2]] - pos[idx[:, 0]])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    nrm = _np(geometry.normals)
    flat = bool(all(np.allclose(fn, nrm[idx[:, k]], atol=1e-5)
                    for k in range(3)))
    slots = tuple(bool((_np(t) >= 0).any()) for t in (
        materials.base_color_tex, materials.metallic_roughness_tex,
        materials.normal_tex, materials.emissive_tex))
    return Scene(
        geometry=geometry,
        materials=materials,
        textures=textures if textures is not None else TextureStack.empty(),
        emitters=emitters,
        directional=directional,
        env=env,
        has_emitters=bool(_np(emitters.valid).any()),
        has_directional=bool(_np(directional.radiance).sum() > 0),
        has_textures=any(slots),
        tex_slots=slots,
        flat_normals=flat,
    )


def map_tensors(obj, fn):
    """`obj` (a record of tensors: a Scene, a Camera, a cluster grid) with
    fn applied to every tensor, nested records included."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


def _to_device(obj, device):
    return map_tensors(obj, lambda t: t.to(device))


def with_bvh(scene: Scene) -> Scene:
    """Build the BVH (host numpy builder, which the reference's native
    builder equals bit for bit) and attach it, as tensors on the scene's
    device; the stack-walk tracer (ops/traverse.py) needs it.  Its leaves
    hold at most `LEAF_SIZE` triangles, the count the walk tests."""
    bvh = build_bvh(_np(scene.geometry.positions),
                    _np(scene.geometry.indices), leaf_size=LEAF_SIZE)
    bvh = BVH(**{f.name: torch.from_numpy(getattr(bvh, f.name))
                 for f in dataclasses.fields(BVH)})
    return dataclasses.replace(scene, bvh=_to_device(bvh, scene.device))


def with_clusters(scene: Scene) -> Scene:
    """Build the cluster grid (`accel.clusters.CLUSTER_K` triangles a
    cluster) and its packed soup (host numpy builder) and attach it; the
    block tracer (ops/blocktrace.py) needs it."""
    pos = _np(scene.geometry.positions)
    idx = _np(scene.geometry.indices)
    grid = pack_soup_host(build_clusters(pos, idx), pos, idx)
    return dataclasses.replace(scene, clusters=_to_device(grid, scene.device))


def upload_scene(scene, device):
    """Move every tensor of the scene (or of another record of tensors,
    such as a Camera) to `device`; the scene's device is then the render
    device of everything derived from it."""
    return _to_device(scene, torch.device(device))


_INT_FIELDS = {"indices", "tri_material", "base_color_tex",
               "metallic_roughness_tex", "normal_tex", "emissive_tex",
               "tri_idx", "alias_idx"}
_FLAG_FIELDS = ("has_emitters", "has_directional", "has_textures",
                "tex_slots", "flat_normals")


def _record(cls, arrays: Mapping[str, Any]):
    kw = {}
    for f in dataclasses.fields(cls):
        v = arrays[f.name]
        if isinstance(v, tuple):
            kw[f.name] = tuple(tuple(x) for x in v)
        elif f.name == "valid":
            kw[f.name] = _t(v, torch.bool)
        elif f.name in _INT_FIELDS:
            kw[f.name] = _i32(v)
        else:
            kw[f.name] = _f32(v)
    return cls(**kw)


def scene_from_numpy(arrays: Mapping[str, Any], device=None) -> Scene:
    """Scene from a reference scene flattened to numpy.

    `arrays` maps each record name (geometry, materials, textures,
    emitters, directional, env) to a mapping of its field names to numpy
    arrays (tuples for the texture stack's static fields; env may be None),
    plus "flags": a mapping of the Scene's static flags.  An optional
    "clusters" mapping carries the reference's cluster grid; its soup's
    zero rows beyond the first 9 (TPU DMA alignment) are dropped.
    """
    flags = arrays["flags"]
    grid = arrays.get("clusters")
    if grid is not None:
        grid = ClusterGrid(
            aabb_min=_f32(grid["aabb_min"]), aabb_max=_f32(grid["aabb_max"]),
            tri_id=_i32(grid["tri_id"]), parent_min=_f32(grid["parent_min"]),
            parent_max=_f32(grid["parent_max"]),
            soup=(None if grid.get("soup") is None else _f32(
                np.ascontiguousarray(np.asarray(grid["soup"])[:, :SOUP_ROWS]))))
    scene = Scene(
        geometry=_record(Geometry, arrays["geometry"]),
        materials=_record(Materials, arrays["materials"]),
        textures=_record(TextureStack, arrays["textures"]),
        emitters=_record(EmitterTable, arrays["emitters"]),
        directional=_record(DirectionalLight, arrays["directional"]),
        env=(None if arrays.get("env") is None
             else _record(EnvMap, arrays["env"])),
        clusters=grid,
        **{k: (tuple(bool(x) for x in flags[k]) if k == "tex_slots"
               else bool(flags[k])) for k in _FLAG_FIELDS},
    )
    return scene if device is None else upload_scene(scene, device)
