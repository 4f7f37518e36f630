"""Cluster grid: the block tracer's acceleration structure (port of
`accel/clusters.py` for k % 128 == 0).

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
DMAs, are left out.  Not ported: `pack_soup32` (the k = 32 TPU layout)
and `refit_clusters` (it comes with gradients).
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
    parent_min: torch.Tensor   # f32[ceil(C/4), 3] boxes over 4 clusters
    parent_max: torch.Tensor   # f32[ceil(C/4), 3]
    soup: torch.Tensor | None = None  # f32[C+1, 9, K] detached soup

    @property
    def num_clusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def k(self) -> int:
        return self.tri_id.shape[1]


def _parent_boxes(amin: np.ndarray, amax: np.ndarray):
    """Union boxes over groups of 4 consecutive clusters; the tail group
    pads with inverted (never-hit) boxes."""
    c = amin.shape[0]
    npar = -(-c // 4)
    pad = npar * 4 - c
    big = np.float32(3e30)
    lo = np.concatenate([amin, np.full((pad, 3), big, np.float32)], axis=0)
    hi = np.concatenate([amax, np.full((pad, 3), -big, np.float32)], axis=0)
    return (lo.reshape(npar, 4, 3).min(axis=1),
            hi.reshape(npar, 4, 3).max(axis=1))


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
                       parent_min=torch.from_numpy(pmin),
                       parent_max=torch.from_numpy(pmax))


def _soup_components(tri_id: np.ndarray, positions: np.ndarray,
                     indices: np.ndarray) -> np.ndarray:
    """(v0, e1, e2) component rows f32[C, 9, K], padding degenerate."""
    tri = indices[np.maximum(tri_id, 0)]                 # [C, K, 3]
    v0 = positions[tri[..., 0]]
    v1 = positions[tri[..., 1]]
    v2 = positions[tri[..., 2]]
    pad = (tri_id < 0)[..., None]
    v0 = np.where(pad, np.float32(2e30), v0)
    e1 = np.where(pad, np.float32(0.0), v1 - v0)
    e2 = np.where(pad, np.float32(0.0), v2 - v0)
    return np.concatenate([np.moveaxis(v0, -1, 1), np.moveaxis(e1, -1, 1),
                           np.moveaxis(e2, -1, 1)], axis=1)


def pack_soup_host(grid: ClusterGrid, positions,
                   indices) -> ClusterGrid:
    """Attach the packed soup f32[C+1, 9, K] (numpy, at build time); the
    last cluster is the all-zero sentinel."""
    if grid.k % 128:
        raise ValueError(f"cluster size k={grid.k} is not a multiple of 128 "
                         "(the k=32 layout is not ported)")
    comp = _soup_components(grid.tri_id.cpu().numpy(),
                            np.asarray(positions, np.float32),
                            np.asarray(indices, np.int32))
    soup = np.concatenate(
        [comp, np.zeros((1, SOUP_ROWS, grid.k), np.float32)], axis=0)
    return dataclasses.replace(grid, soup=torch.from_numpy(
        np.ascontiguousarray(soup, np.float32)))
