"""The port's accel/ (BVH build, cluster grid, packed soup), core/morton and
the cluster plumbing of scene/types against the reference: all exact."""

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.accel import clusters as jclusters
from physically_based_renderer_tpu.accel.bvh import build_bvh as j_build_bvh
from physically_based_renderer_tpu.core.morton import (
    morton_codes as j_morton_codes, morton_pixel_ids as j_morton_pixel_ids)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.accel import bvh, clusters
from physically_based_renderer_tpu_torch.core import morton
from physically_based_renderer_tpu_torch.scene import procedural, types
from torch_parity import flat, np_, scene_arrays

torch.set_num_threads(1)

GRID_FIELDS = ("aabb_min", "aabb_max", "tri_id", "parent_min", "parent_max")
GEOMETRIES = {
    "sphere20": lambda: jproc.make_uv_sphere(rings=20, sectors=20),
    "helmet24": lambda: jproc.make_helmet_class_scene(24, 24).geometry,
    "random700": lambda: jproc.make_random_tris(700, seed=3),
}


def _reference_grid(geometry):
    """The reference's `with_clusters` grid of a geometry."""
    scene = jtypes.make_scene(geometry, jtypes.Materials.default(1))
    return jtypes.with_clusters(scene).clusters


def assert_grid_matches(grid, ref):
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(np_(getattr(grid, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    soup = np.asarray(ref.soup)
    assert soup.shape == (grid.num_clusters + 1, 16, grid.k)
    np.testing.assert_array_equal(np_(grid.soup), soup[:, :9])
    np.testing.assert_array_equal(soup[:, 9:], 0.0)   # TPU DMA alignment


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_clusters_match_reference_with_clusters(name):
    g = GEOMETRIES[name]()
    pos, idx = np.asarray(g.positions), np.asarray(g.indices)
    grid = clusters.pack_soup_host(clusters.build_clusters(pos, idx), pos,
                                   idx)
    assert grid.k == clusters.CLUSTER_K
    assert grid.soup.dtype == torch.float32 and grid.soup.is_contiguous()
    assert_grid_matches(grid, _reference_grid(g))
    # the sentinel cluster is all zeros; padding triangles are degenerate
    assert not grid.soup[-1].any()
    pad = grid.tri_id < 0
    if bool(pad.any()):
        v0x = grid.soup[:-1, 0][pad]
        assert bool((v0x == np.float32(2e30)).all())
        assert not grid.soup[:-1, 3:][pad[:, None, :].expand(-1, 6, -1)].any()


@pytest.mark.parametrize("leaf", [4, 128])
def test_bvh_matches_reference(leaf):
    g = GEOMETRIES["random700"]()
    pos, idx = np.asarray(g.positions), np.asarray(g.indices)
    got, want = bvh.build_bvh(pos, idx, leaf), j_build_bvh(pos, idx, leaf)
    for f in ("node_min", "node_max", "node_left", "node_right", "tri_order"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_parent_boxes_pad_the_tail_group():
    rng = np.random.default_rng(0)
    amin = rng.normal(size=(6, 3)).astype(np.float32)
    amax = amin + 1.0
    pmin, pmax = clusters._parent_boxes(amin, amax)
    assert pmin.shape == (2, 3)
    np.testing.assert_array_equal(pmin[1], amin[4:6].min(0))
    np.testing.assert_array_equal(pmax[0], amax[:4].max(0))


@pytest.mark.parametrize("k", [32, 64, 256])
def test_cluster_sizes_the_reference_accepts(k):
    """k = 32 and multiples of 128 pack the port's [C+1, 9, k] soup (k = 32
    against the reference's variant soup unpacked, k = 256 against its
    rows); any other k raises, as the reference's tracer does."""
    g = GEOMETRIES["sphere20"]()
    pos, idx = np.asarray(g.positions), np.asarray(g.indices)
    grid = clusters.build_clusters(pos, idx, k=k)
    if k == 64:
        with pytest.raises(ValueError, match="k == 32 .* got k=64"):
            clusters.pack_soup_host(grid, pos, idx)
        return
    grid = clusters.pack_soup_host(grid, pos, idx)
    assert grid.k == k
    assert grid.soup.shape == (grid.num_clusters + 1, 9, k)
    ref = jclusters.pack_soup_host(jclusters.build_clusters(pos, idx, k=k),
                                   pos, idx)
    want = (clusters.unpack_soup32(ref.soup) if k == 32
            else np.asarray(ref.soup)[:, :9])
    np.testing.assert_array_equal(np_(grid.soup), np_(want))


def test_with_clusters_matches_reference():
    ref = jtypes.with_clusters(jproc.make_helmet_class_scene(24, 24))
    port = types.with_clusters(procedural.make_helmet_class_scene(24, 24))
    assert_grid_matches(port.clusters, ref.clusters)
    assert port.clusters.num_clusters == 16


def test_scene_from_numpy_carries_clusters():
    ref = jtypes.with_clusters(jproc.make_helmet_class_scene(24, 24))
    arrays = scene_arrays(ref)
    arrays["clusters"] = flat(ref.clusters)
    port = types.scene_from_numpy(arrays)
    assert_grid_matches(port.clusters, ref.clusters)
    assert port.clusters.tri_id.dtype == torch.int32
    assert types.scene_from_numpy(scene_arrays(ref)).clusters is None


def test_upload_scene_moves_the_grid():
    scene = types.upload_scene(
        types.with_clusters(procedural.make_cornell_box()), "meta")
    assert scene.clusters.soup.device.type == "meta"
    assert scene.clusters.parent_min.device.type == "meta"


@pytest.mark.parametrize("shape", [(16, 16), (32, 48), (7, 13), (1, 5)])
def test_morton_pixel_ids_match_reference(shape):
    h, w = shape
    got = morton.morton_pixel_ids(h, w)
    np.testing.assert_array_equal(got, j_morton_pixel_ids(h, w))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(np.sort(got), np.arange(h * w))
    np.testing.assert_array_equal(morton.morton_pixel_ids(h, w, 2, 3),
                                  j_morton_pixel_ids(h, w, 2, 3))
    ys, xs = np.mgrid[0:h, 0:w]
    np.testing.assert_array_equal(morton.morton_codes(ys, xs),
                                  j_morton_codes(ys, xs))


def test_morton_blocks_are_tiles():
    """A 256-ray block of a 512-wide image is a 16x16 tile."""
    ids = morton.morton_pixel_ids(512, 512)[:256]
    assert (ids // 512).max() == 15 and (ids % 512).max() == 15
