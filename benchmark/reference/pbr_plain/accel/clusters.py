# Frozen copy of physically_based_renderer_tpu_torch/accel/clusters.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""Cluster grid: the block tracer's acceleration structure (port of
`accel/clusters.py`).

Triangles are partitioned into C clusters of at most K triangles (the leaf
ranges of the BVH builder, accel/bvh.py, padded to exactly K with id -1).
Phase A of the block tracer (ops/blocktrace.py) culls ray blocks against
the C cluster boxes, or first against the parent boxes over groups of 4
consecutive clusters; the kernel K1 (ops/trace_blocks.py) then streams each
candidate cluster's packed triangle soup.

Built on the host in numpy and held as CPU tensors until
`scene.types.upload_scene`.  The soup is f32[C+1, 9, K]: rows v0 xyz, e1
xyz, e2 xyz.  Padding triangles are degenerate (v0 = 2e30, e1 = e2 = 0)
and the sentinel cluster C is all zeros, so both reject themselves in the
kernel through det = 0.  The reference's seven zero rows, which align TPU
DMAs, are left out.  `refit_clusters` rebuilds boxes and soup on the
render device when vertex positions are trained.

Cluster sizes are the reference's: k = 32 (sub-clusters) or a multiple of
128.  The port keeps the one soup layout f32[C+1, 9, K] for every k, k = 32
included.  The reference stores a k = 32 soup as four lane-group variants,
f32[(C+1)*4, 16, 128] (`pack_soup32`), because a TPU DMA copies only
128-lane aligned tiles; the variants are zero outside their 32 lanes, so
`unpack_soup32` recovers the compact soup from them exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bvh import build_bvh

CLUSTER_K = 128  # triangles per cluster (padded)
SOUP_ROWS = 9    # v0 xyz | e1 xyz | e2 xyz


@dataclasses.dataclass(frozen=True)
class ClusterGrid:
    aabb_min: torch.Tensor     # f32[C, 3]
    aabb_max: torch.Tensor     # f32[C, 3]
    tri_id: torch.Tensor       # i32[C, K] original triangle ids (-1 = pad)
    # Boxes over groups of 4 consecutive clusters, for phase A's
    # hierarchical selection; a grid without them (the reference allows
    # one) takes the flat top-k over all C clusters.
    parent_min: torch.Tensor | None = None  # f32[ceil(C/4), 3]
    parent_max: torch.Tensor | None = None  # f32[ceil(C/4), 3]
    soup: torch.Tensor | None = None  # f32[C+1, 9, K] detached soup

    @property
    def num_clusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def k(self) -> int:
        return self.tri_id.shape[1]


def _parent_boxes(amin, amax):
    """Union boxes over groups of 4 consecutive clusters; the tail group
    pads with inverted (never-hit) boxes.  Arrays or tensors in, tensors
    out (on the boxes' device: the refit runs on the render device)."""
    amin, amax = torch.as_tensor(amin), torch.as_tensor(amax)
    c = amin.shape[0]
    npar = -(-c // 4)
    pad = npar * 4 - c
    lo = torch.cat([amin, amin.new_full((pad, 3), 3e30)], dim=0)
    hi = torch.cat([amax, amax.new_full((pad, 3), -3e30)], dim=0)
    return (lo.reshape(npar, 4, 3).amin(dim=1),
            hi.reshape(npar, 4, 3).amax(dim=1))


def build_clusters(positions, indices, k: int = CLUSTER_K) -> ClusterGrid:
    """Partition triangles into spatially tight clusters of <= k (numpy)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    bvh = build_bvh(positions, indices, leaf_size=k)
    left, right = bvh.node_left, bvh.node_right
    leaves = np.nonzero(left < 0)[0]
    c = len(leaves)
    tri_id = np.full((c, k), -1, np.int32)
    amin = np.empty((c, 3), np.float32)
    amax = np.empty((c, 3), np.float32)
    for i, nid in enumerate(leaves):
        start = -left[nid] - 1
        count = right[nid]
        tri_id[i, :count] = bvh.tri_order[start:start + count]
        amin[i] = bvh.node_min[nid]
        amax[i] = bvh.node_max[nid]
    pmin, pmax = _parent_boxes(amin, amax)
    return ClusterGrid(aabb_min=torch.from_numpy(amin),
                       aabb_max=torch.from_numpy(amax),
                       tri_id=torch.from_numpy(tri_id),
                       parent_min=pmin, parent_max=pmax)


def _check_k(grid: ClusterGrid) -> None:
    """The reference's cluster sizes: k == 32 or k % 128 == 0."""
    if grid.k != 32 and grid.k % 128:
        raise ValueError(
            f"Pallas tracer needs cluster size k == 32 (lane-group variant "
            f"layout) or k % 128 == 0 (VMEM DMA tiling); got k={grid.k}.")


def cluster_tri_soup(tri_id, positions, indices):
    """Dense per-cluster triangles (v0, e1, e2), each f32[C, K, 3], from
    tri_id i32[C, K] and the mesh; padding (-1) becomes a degenerate
    triangle at a far point that is never hit.  Differentiable in
    positions; the packed soup and the refit take it detached."""
    tri_id = tri_id.long()
    tri = indices.long()[torch.clamp_min(tri_id, 0)]        # [C, K, 3]
    v0 = positions[tri[..., 0]]
    v1 = positions[tri[..., 1]]
    v2 = positions[tri[..., 2]]
    pad = (tri_id < 0)[..., None]
    v0 = torch.where(pad, 2e30, v0)
    return (v0, torch.where(pad, 0.0, v1 - v0),
            torch.where(pad, 0.0, v2 - v0))


def _pack_soup(v0, e1, e2) -> torch.Tensor:
    """[C, K, 3] components -> soup f32[C+1, 9, K] with the all-zero
    sentinel cluster last."""
    comp = torch.cat([v0.transpose(1, 2), e1.transpose(1, 2),
                      e2.transpose(1, 2)], dim=1)
    return torch.cat([comp, comp.new_zeros((1, SOUP_ROWS, comp.shape[-1]))],
                     dim=0).contiguous()


def pack_soup32(comp) -> torch.Tensor:
    """The reference's k = 32 sub-cluster soup: components f32[C, 9, 32]
    in, f32[(C+1)*4, 16, 128] lane-group variants out.  Variant p of a
    sub-cluster holds component row c at row c, lanes [32p, 32p + 32), and
    zeros elsewhere; the sentinel's four variants are all zeros.  The port's
    kernel reads the compact soup (`unpack_soup32` inverts this)."""
    comp = torch.as_tensor(comp, dtype=torch.float32)
    c, rows, k = comp.shape
    if (rows, k) != (SOUP_ROWS, 32):
        raise ValueError(f"components have shape {tuple(comp.shape)}, "
                         f"expected [C, {SOUP_ROWS}, 32]")
    comp16 = torch.cat([comp, comp.new_zeros((c, 16 - rows, k))], dim=1)
    variants = [torch.cat([comp.new_zeros((c, 16, 32 * p)), comp16,
                           comp.new_zeros((c, 16, 32 * (3 - p)))], dim=2)
                for p in range(4)]
    soup = torch.stack(variants, dim=1).reshape(c * 4, 16, 128)
    return torch.cat([soup, comp.new_zeros((4, 16, 128))], dim=0)


def unpack_soup32(soup) -> torch.Tensor:
    """A lane-group variant soup f32[(C+1)*4, 16, 128] (`pack_soup32`) ->
    the compact soup f32[C+1, 9, 32]: variant 0's rows and lanes."""
    soup = torch.as_tensor(soup, dtype=torch.float32)
    if soup.dim() != 3 or soup.shape[0] % 4 or soup.shape[1:] != (16, 128):
        raise ValueError(f"soup has shape {tuple(soup.shape)}, expected "
                         "[(C+1)*4, 16, 128]")
    c1 = soup.shape[0] // 4
    return soup.reshape(c1, 4, 16, 128)[:, 0, :SOUP_ROWS, :32].contiguous()


def pack_soup_host(grid: ClusterGrid, positions,
                   indices) -> ClusterGrid:
    """Attach the packed soup f32[C+1, 9, K] (at build time, on the CPU;
    k = 32 too); the last cluster is the all-zero sentinel."""
    _check_k(grid)
    comp = cluster_tri_soup(
        grid.tri_id.cpu(), torch.from_numpy(np.asarray(positions, np.float32)),
        torch.from_numpy(np.asarray(indices, np.int32)))
    return dataclasses.replace(grid, soup=_pack_soup(*comp))


def refit_clusters(grid: ClusterGrid, geometry) -> ClusterGrid:
    """Recompute the cluster boxes, the parent boxes (where the grid has
    them) and the packed soup from the current vertex positions (detached),
    keeping the triangle partition.

    The inverse-rendering step calls this when vertex positions are trained
    (grad/inverse.py), so a moving mesh never escapes its boxes; boxes grow
    as vertices spread, they never miss.  The soup keeps the port's
    SOUP_ROWS-row layout at every k (the reference repacks k = 32 as
    `pack_soup32`).
    """
    _check_k(grid)
    v0, e1, e2 = cluster_tri_soup(grid.tri_id, geometry.positions.detach(),
                                  geometry.indices)
    pad = (grid.tri_id < 0)[..., None]
    v1 = v0 + e1
    v2 = v0 + e2
    lo3 = torch.minimum(torch.minimum(v0, v1), v2)
    hi3 = torch.maximum(torch.maximum(v0, v1), v2)
    amin = torch.where(pad, 3e30, lo3).amin(dim=1)          # [C, 3]
    amax = torch.where(pad, -3e30, hi3).amax(dim=1)
    soup = None if grid.soup is None else _pack_soup(v0, e1, e2)
    pmin = pmax = None
    if grid.parent_min is not None:
        pmin, pmax = _parent_boxes(amin, amax)
    return dataclasses.replace(grid, aabb_min=amin, aabb_max=amax,
                               parent_min=pmin, parent_max=pmax, soup=soup)
