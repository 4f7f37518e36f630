# Frozen copy of physically_based_renderer_tpu_torch/accel/bvh.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""BVH build on the host (port of the BVH build in `accel/bvh.py`).

Median splits on the largest centroid axis over morton-sorted triangles,
with multi-triangle leaves over a reordered triangle array, so every leaf
is a contiguous range.  The cluster grid (accel/clusters.py) takes its
leaves.  Both argsorts are stable, so the partition equals the reference's
bit for bit.  Layout (numpy):

  node_min/max  f32[N, 3]  node AABBs
  node_left     i32[N]     >= 0: left child; < 0: leaf, start = -x - 1
  node_right    i32[N]     >= 0: right child; for leaves: triangle count
  tri_order     i32[T]     BVH position -> original triangle id

The builder and the host checks (`refit_bvh`, `bvh_depth`, `validate_bvh`)
work on numpy arrays; a BVH attached to a scene (`scene.types.with_bvh`)
holds the same fields as tensors on the render device, which the traversal
(`ops/traverse.py`, `tracer="bvh"`) reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 4
MAX_DEPTH = 64  # stack slots a ray in the traversal


@dataclasses.dataclass(frozen=True)
class BVH:
    node_min: np.ndarray    # f32[N, 3]
    node_max: np.ndarray    # f32[N, 3]
    node_left: np.ndarray   # i32[N]
    node_right: np.ndarray  # i32[N]
    tri_order: np.ndarray   # i32[T]


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes; x u32[N, 3]."""
    def split(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return ((split(x[:, 0]) << np.uint64(2)) | (split(x[:, 1]) << np.uint64(1))
            | split(x[:, 2]))


def build_bvh(positions: np.ndarray, indices: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> BVH:
    """Host BVH build; positions f32[V, 3], indices i32[T, 3]."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    t = indices.shape[0]
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    centroid = (v0 + v1 + v2) / 3.0
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)

    # Morton pre-sort for locality (median splits then near LBVH quality).
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    q = ((centroid - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(
        np.uint32)
    order = np.argsort(_morton3(q), kind="stable").astype(np.int32)

    node_min, node_max, node_left, node_right = [], [], [], []

    def new_node():
        node_min.append(np.zeros(3, np.float32))
        node_max.append(np.zeros(3, np.float32))
        node_left.append(0)
        node_right.append(0)
        return len(node_left) - 1

    out_order = np.empty(t, np.int32)
    out_pos = 0
    stack = [(new_node(), 0, t)]          # (node id, start, end) in `order`
    while stack:
        nid, s, e = stack.pop()
        ids = order[s:e]
        node_min[nid] = tmin[ids].min(axis=0)
        node_max[nid] = tmax[ids].max(axis=0)
        count = e - s
        if count <= leaf_size:
            node_left[nid] = -(out_pos + 1)
            node_right[nid] = count
            out_order[out_pos:out_pos + count] = ids
            out_pos += count
            continue
        # median of the largest centroid axis, stable full sort
        c = centroid[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        m = count // 2
        order[s:e] = ids[np.argsort(c[:, axis], kind="stable")]
        left, right = new_node(), new_node()
        node_left[nid] = left
        node_right[nid] = right
        stack.append((right, s + m, e))
        stack.append((left, s, s + m))
    if out_pos != t:
        raise AssertionError("BVH build lost triangles")
    return BVH(node_min=np.stack(node_min).astype(np.float32),
               node_max=np.stack(node_max).astype(np.float32),
               node_left=np.asarray(node_left, np.int32),
               node_right=np.asarray(node_right, np.int32),
               tri_order=out_order)


def refit_bvh(bvh: BVH, positions, indices, pad: float = 0.0) -> BVH:
    """Node boxes recomputed from moved vertices, bottom-up (the build
    emits parents before children, so reverse node order is bottom-up);
    the topology is kept, so rebuild after a large deformation."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    order = bvh.tri_order
    v0 = positions[indices[order, 0]]
    v1 = positions[indices[order, 1]]
    v2 = positions[indices[order, 2]]
    tmin = np.minimum(np.minimum(v0, v1), v2) - pad
    tmax = np.maximum(np.maximum(v0, v1), v2) + pad
    left, right = bvh.node_left, bvh.node_right
    nmin, nmax = bvh.node_min.copy(), bvh.node_max.copy()
    for nid in range(len(left) - 1, -1, -1):
        if left[nid] < 0:
            s0 = -left[nid] - 1
            c = right[nid]
            nmin[nid] = tmin[s0:s0 + c].min(axis=0)
            nmax[nid] = tmax[s0:s0 + c].max(axis=0)
        else:
            nmin[nid] = np.minimum(nmin[left[nid]], nmin[right[nid]])
            nmax[nid] = np.maximum(nmax[left[nid]], nmax[right[nid]])
    return dataclasses.replace(bvh, node_min=nmin, node_max=nmax)


def bvh_depth(bvh: BVH) -> int:
    """Largest depth, root at 1 (a host check that MAX_DEPTH stack slots
    suffice)."""
    left, right = bvh.node_left, bvh.node_right
    depth = 0
    stack = [(0, 1)]
    while stack:
        nid, d = stack.pop()
        depth = max(depth, d)
        if left[nid] >= 0:
            stack.append((left[nid], d + 1))
            stack.append((right[nid], d + 1))
    return depth


def validate_bvh(bvh: BVH, positions, indices) -> None:
    """Structural invariants (raises AssertionError): every triangle once;
    child boxes inside their parents' (1e-5 slack); the leaves' ranges
    cover the triangle order."""
    t = bvh.tri_order
    assert np.array_equal(np.sort(t), np.arange(len(t)))
    left, right = bvh.node_left, bvh.node_right
    nmin, nmax = bvh.node_min, bvh.node_max
    stack = [0]
    seen = 0
    while stack:
        nid = stack.pop()
        if left[nid] < 0:
            seen += right[nid]
            continue
        for c in (left[nid], right[nid]):
            assert (nmin[c] >= nmin[nid] - 1e-5).all()
            assert (nmax[c] <= nmax[nid] + 1e-5).all()
            stack.append(c)
    assert seen == len(t)
