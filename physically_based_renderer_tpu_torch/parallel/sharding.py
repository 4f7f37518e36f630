"""Image-tile and spp sharding over ranks (port of `parallel/sharding.py`).

The reference runs one program over many devices under `shard_map`; the
port runs one process per rank, each with one device, on
`torch.distributed` (parallel/distributed.py starts them).  A mesh is a
`DeviceMesh` over every rank of the world, with the reference's axis
names:

  * `tiles`: rank i renders image rows [i H/n, (i + 1) H/n) over all
    samples; the rows assemble on every rank by one
    `all_gather_into_tensor` over the axis' group;
  * `spp` (2-D mesh): rank j renders its share spp/n_spp of the samples;
    the sample sums add by one `all_reduce` over the axis' group;
  * the scene is replicated: every rank builds it from the same config,
    and `replicate_scene` broadcasts its tensors once from rank 0, so all
    ranks trace the same bytes.

Per-ray keys derive from GLOBAL pixel ids and the global sample index, so
a 1-D sharded render equals the single render bit for bit, and a 2-D one
up to the order of the spp sum.  Every shape check raises `ValueError` on
every rank before any collective, so a bad shape cannot leave a rank
waiting.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core import rng as rng_mod
from ..core.camera import Camera
from ..core.film import Film
from ..integrator.path import RenderConfig, render_band, render_sample
from ..scene.types import Scene, map_tensors, upload_scene
from . import distributed, exchange as exchange_mod

TILE_AXIS = "tiles"
SPP_AXIS = "spp"

# all_gather_into_tensor is named all_gather_single from torch 2.13.
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _check_world(n: int, what: str) -> None:
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"{what} needs {n} devices, one a rank; the world "
                         f"has {world} ranks (a mesh covers every rank)")


def make_mesh(n_tiles: int | None = None) -> DeviceMesh:
    """1-D `tiles` mesh over which image rows are sharded: every rank of
    the world (`n_tiles`, where given, must be the world size)."""
    if n_tiles is not None:
        _check_world(n_tiles, f"a mesh of {n_tiles} tiles")
    return distributed.global_mesh(TILE_AXIS)


def make_mesh_2d(n_tiles: int, n_spp: int) -> DeviceMesh:
    """(tiles, spp) mesh: rows over `tiles`, samples over `spp`; rank r is
    tile r // n_spp, sample share r % n_spp."""
    _check_world(n_tiles * n_spp,
                 f"mesh ({n_tiles} tiles x {n_spp} spp)")
    return init_device_mesh(distributed.device_type(), (n_tiles, n_spp),
                            mesh_dim_names=(TILE_AXIS, SPP_AXIS))


def replicate_scene(scene: Scene, mesh: DeviceMesh) -> Scene:
    """The scene on this rank's device with rank 0's bytes: each tensor
    is broadcast once over the world (the mesh covers it).  Every rank must
    pass a scene of the same structure and shapes."""
    scene = upload_scene(scene, distributed.rank_device())

    def bcast(t):
        buf = t.detach().clone().contiguous()
        if buf.numel() == 0:
            return buf
        wire = buf.to(torch.uint8) if buf.dtype == torch.bool else buf
        dist.broadcast(wire, src=0)
        return wire.to(torch.bool) if buf.dtype == torch.bool else wire

    return map_tensors(scene, bcast)


def _check_divisible(height: int, n: int):
    if height % n:
        raise ValueError(
            f"image height {height} must divide by mesh size {n} "
            f"(pad the film or change the tile split)")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    return mesh.size(names.index(axis))


def _rows(cfg: RenderConfig, mesh: DeviceMesh):
    """(n tiles, this rank's tile, rows a tile) after the shape check."""
    n = axis_size(mesh, TILE_AXIS)
    _check_divisible(cfg.height, n)
    i = mesh.get_local_rank(TILE_AXIS)
    return n, i, cfg.height // n


def gather_rows(band: torch.Tensor, group) -> torch.Tensor:
    """The bands [rows, ...] of the group's ranks stacked in rank order."""
    n = dist.get_world_size(group)
    band = band.contiguous()
    out = torch.empty((n * band.shape[0], *band.shape[1:]),
                      dtype=band.dtype, device=band.device)
    _all_gather(out, band, group=group)
    return out


def render_sample_sharded(scene: Scene, camera: Camera, key: torch.Tensor,
                          cfg: RenderConfig, mesh: DeviceMesh,
                          exchange: bool = False) -> torch.Tensor:
    """One sample per pixel over the mesh: each rank renders H / n rows.

    exchange=True routes the block tracer's calls through the ring ray
    exchange (parallel/exchange.py); the result is the same.  Returns the
    full [H, W, 3] radiance on every rank."""
    n, i, rows = _rows(cfg, mesh)
    if exchange:
        cfg = dataclasses.replace(cfg, exchange_axis=TILE_AXIS)
    with torch.no_grad(), exchange_mod.on_mesh(mesh):
        band = render_sample(scene, camera, key, cfg, row_start=i * rows,
                             n_rows=rows)
    return gather_rows(band, mesh.get_group(TILE_AXIS))


@torch.no_grad()
def render_sharded_with_stats(scene: Scene, camera: Camera,
                              key: torch.Tensor, cfg: RenderConfig,
                              mesh: DeviceMesh):
    """Full sharded render (all spp, rows over the mesh) and the int64
    ray-query count summed over the ranks; both on every rank."""
    n, i, rows = _rows(cfg, mesh)
    group = mesh.get_group(TILE_AXIS)
    keys = rng_mod.split(key.to(scene.device), cfg.spp)
    film, count = render_band(scene, camera, keys, cfg, row_start=i * rows,
                              n_rows=rows)
    dist.all_reduce(count, group=group)
    return Film(hdr=gather_rows(film.hdr, group), spp=film.spp), count


def render_sharded(scene: Scene, camera: Camera, key: torch.Tensor,
                   cfg: RenderConfig, mesh: DeviceMesh) -> Film:
    """Full sharded render: all spp, rows over the mesh."""
    return render_sharded_with_stats(scene, camera, key, cfg, mesh)[0]


@torch.no_grad()
def render_sharded_2d(scene: Scene, camera: Camera, key: torch.Tensor,
                      cfg: RenderConfig, mesh: DeviceMesh) -> Film:
    """Render over a (tiles, spp) mesh: each rank renders H / n_tiles rows
    x spp / n_spp samples (keys by global sample index), the sample sums
    all-reduce over `spp`, the rows assemble over `tiles`.  Equal to
    `render()` up to the order of the spp sum."""
    nt, i, rows = _rows(cfg, mesh)
    ns = axis_size(mesh, SPP_AXIS)
    if cfg.spp % ns:
        raise ValueError(f"spp {cfg.spp} must divide by mesh axis "
                         f"'{SPP_AXIS}' size {ns}")
    per = cfg.spp // ns
    j = mesh.get_local_rank(SPP_AXIS)
    keys = rng_mod.split(key.to(scene.device), cfg.spp)[j * per:(j + 1) * per]
    film, _ = render_band(scene, camera, keys, cfg, row_start=i * rows,
                          n_rows=rows)
    dist.all_reduce(film.hdr, group=mesh.get_group(SPP_AXIS))
    return Film(hdr=gather_rows(film.hdr, mesh.get_group(TILE_AXIS)),
                spp=float(cfg.spp))
