"""A cluster grid without parent boxes against the reference: phase A's
flat top-k over all C clusters (`_select_candidates`), K1's plain version
on the lists it makes, `scene_from_numpy`, `refit_clusters` and a
vertex-training step.

The reference lets `ClusterGrid.parent_min`/`parent_max` be None
(`accel/clusters.py:53-54`); phase A then selects from all C clusters
instead of going through the parents (`ops/blocktrace.py:355`).  The data:
the reference's 40x40 UV sphere at k = 32 (128 sub-clusters, max_u 4,
block 32) with its clusters permuted by a seeded permutation, so that
every parent box (4 consecutive clusters) spans the sphere and the two
selections pick different winners; the soup is left out, so both packages
pack it at trace time.  Candidate lists and winners are exact; hit
distances agree to T_RTOL (the reference's jitted kernel contracts
multiply-adds into FMAs on the CPU, tests/test_torch_blocktrace.py).  The
reference's K1 runs in interpret mode on 256 rays a call.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.accel import clusters as jclusters
from physically_based_renderer_tpu.ops import blocktrace as jbt
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.accel import clusters
from physically_based_renderer_tpu_torch.grad import inverse as pinv
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import blocktrace as bt
from physically_based_renderer_tpu_torch.ops.intersect import BIG
from physically_based_renderer_tpu_torch.scene import types
from torch_parity import flat, np_, params_to_port, scene_arrays

torch.set_num_threads(1)
T_RTOL = 1e-5
BLOCK, MAX_U = 32, 4
BOXES = ("aabb_min", "aabb_max")


def _sphere(k=32):
    return jtypes.with_clusters(jtypes.make_scene(
        jproc.make_uv_sphere(rings=40, sectors=40),
        jtypes.Materials.default(1)), k=k)


def _carried(ref, grid):
    """The port's scene of a reference scene with `grid` carried across."""
    arrays = scene_arrays(ref)
    arrays["clusters"] = flat(grid)
    return types.scene_from_numpy(arrays)


@pytest.fixture(scope="module")
def permuted():
    """(reference scene, {"parents": grid, "none": grid} of the reference,
    the same two grids carried into the port)."""
    ref = _sphere()
    g = ref.clusters
    perm = np.random.default_rng(0).permutation(g.num_clusters)
    amin, amax, tri_id = (np.asarray(x)[perm]
                          for x in (g.aabb_min, g.aabb_max, g.tri_id))
    pmin, pmax = jclusters._parent_boxes(amin, amax)
    with_parents = jclusters.ClusterGrid(
        aabb_min=jnp.asarray(amin), aabb_max=jnp.asarray(amax),
        tri_id=jnp.asarray(tri_id), parent_min=jnp.asarray(pmin),
        parent_max=jnp.asarray(pmax))
    grids = {"parents": with_parents,
             "none": with_parents.replace(parent_min=None, parent_max=None)}
    ports = {k: _carried(ref, v) for k, v in grids.items()}
    assert g.num_clusters > 4 * MAX_U
    return ref, grids, ports


def _camera_rays():
    """16x16 pinhole rays at the sphere: coherent blocks of 32."""
    xs = np.linspace(-1.2, 1.2, 16, dtype=np.float32)
    x, y = np.meshgrid(xs, xs)
    n = x.size
    o = np.tile(np.float32([[0.3, 0.2, 3.0]]), (n, 1))
    d = np.stack([x.ravel(), y.ravel(), np.full(n, -3.0, np.float32)], -1)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _inner_rays(seed=1):
    """8 blocks of 32 rays, each from about a point just inside the
    sphere's surface (inside some sub-cluster boxes: entries tied at 0),
    directions in a cone into the sphere."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(8, 1, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    o = p * np.float32(0.98) + rng.normal(0, 0.01, (8, 32, 3))
    d = -p + np.float32(0.3) * rng.normal(size=(8, 32, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.reshape(-1, 3).astype(np.float32),
            d.reshape(-1, 3).astype(np.float32))


RAYS = {"camera": _camera_rays, "inner": _inner_rays}


def _trace_both(ref, grid, port, o, d, **kw):
    """The reference's K1 (interpret mode) on `grid` and the port's plain
    K1 on the carried scene `port`, on the same rays."""
    want = jbt.intersect_blocks_pallas(grid, ref.geometry, jnp.asarray(o),
                                       jnp.asarray(d), interpret=True,
                                       lean=True, **kw)
    got = bt.intersect_blocks_pallas(port.clusters, torch.from_numpy(o),
                                     torch.from_numpy(d),
                                     geometry=port.geometry, **kw)
    return got, want


@pytest.mark.parametrize("chunk", [4, 16])
def test_parentless_grid_traces_as_reference(permuted, chunk):
    """Closest hits through the port's plain K1 on both grids against the
    reference's K1: winners exact and t within T_RTOL on each, and the
    parent-less grid's winners differ from the parented grid's on some rays
    in both packages (the flat top-k ran)."""
    ref, grids, ports = permuted
    o, d = _camera_rays()
    kw = dict(t_min=1e-4, block=BLOCK, max_u=MAX_U, chunk=chunk)
    tri = {}
    for name in grids:
        got, want = _trace_both(ref, grids[name], ports[name], o, d, **kw)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri),
                                      err_msg=name)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=T_RTOL, err_msg=name)
        tri[name] = (got.tri.numpy(), np.asarray(want.tri))
    port_differ = tri["none"][0] != tri["parents"][0]
    ref_differ = tri["none"][1] != tri["parents"][1]
    assert int(port_differ.sum()) > 0 and int(ref_differ.sum()) > 0
    np.testing.assert_array_equal(port_differ, ref_differ)
    # the flat selection keeps the nearest clusters: it finds more hits
    assert (tri["none"][0] >= 0).sum() > (tri["parents"][0] >= 0).sum()


@pytest.mark.parametrize("rays", sorted(RAYS))
def test_parentless_any_hit_matches_reference(permuted, rays):
    """Shadow-style any-hit queries (t_max 2.5, the octant sort) on the
    parent-less grid: masks exact."""
    ref, grids, ports = permuted
    o, d = RAYS[rays]()
    kw = dict(t_min=1e-4, t_max=2.5, any_hit=True, sort=True, block=BLOCK,
              max_u=MAX_U, chunk=4)
    got, want = _trace_both(ref, grids["none"], ports["none"], o, d, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("rays", sorted(RAYS))
def test_flat_candidate_lists_match_reference(permuted, rays):
    """`_select_candidates` on the parent-less grid: every list, entry and
    count equals the reference's, on coherent camera blocks and on blocks
    whose rays start inside sub-cluster boxes (entries tied at 0, where
    the lower cluster index comes first in both top-ks); on the camera
    blocks the lists differ from the parented grid's."""
    ref, grids, ports = permuted
    o, d = RAYS[rays]()
    nb = len(o) // BLOCK
    tm = np.full(len(o), BIG, np.float32)
    got = {name: bt._select_candidates(p.clusters, *map(torch.from_numpy,
                                                        (o, d, tm)),
                                       nb, BLOCK, 1e-4, MAX_U)
           for name, p in ports.items()}
    want = jbt._select_candidates(grids["none"], jnp.asarray(o),
                                  jnp.asarray(d), jnp.asarray(tm), nb, BLOCK,
                                  1e-4, MAX_U)
    for name, a, b in zip(("u_idx", "u_entry", "n_valid"), got["none"],
                          want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    u_idx, u_entry, n_valid = got["none"][:3]
    assert u_idx.shape == (nb, MAX_U) and u_idx.dtype == torch.int32
    assert int((n_valid == MAX_U).sum()) > 0
    if rays == "camera":
        assert not torch.equal(u_idx, got["parents"][0])
    else:
        assert int((u_entry == 0).sum()) > 0


@pytest.mark.parametrize("k", [32, 128])
def test_scene_from_numpy_carries_a_parentless_grid(k):
    """A reference grid with parent_min = parent_max = None (and one whose
    mapping lacks the two keys) carries across with None; its boxes,
    tri_id and soup as the parented grid's; upload keeps None."""
    ref = _sphere(k)
    grid = ref.clusters.replace(parent_min=None, parent_max=None)
    port = _carried(ref, grid).clusters
    parented = _carried(ref, ref.clusters).clusters
    assert port.parent_min is None and port.parent_max is None
    assert parented.parent_min is not None and port.k == k
    for f in BOXES + ("tri_id", "soup"):
        assert torch.equal(getattr(port, f), getattr(parented, f)), f
    arrays = flat(grid)
    del arrays["parent_min"], arrays["parent_max"]
    scene = types.scene_from_numpy({**scene_arrays(ref), "clusters": arrays})
    assert scene.clusters.parent_min is None
    moved = types.upload_scene(scene, "cpu")
    assert moved.clusters.parent_min is None
    assert moved.clusters.parent_max is None


@pytest.mark.parametrize("k", [32, 128])
def test_refit_keeps_a_parentless_grid_parentless(k):
    """`refit_clusters` on a moved sphere: the parents stay None and the
    boxes equal the reference's refit, as on the parented grid, whose
    parents are recomputed."""
    ref = _sphere(k)
    moved = (np.asarray(ref.geometry.positions) * np.float32([1.5, 1.0, 0.5])
             + np.float32([0.25, -1.0, 2.0]))
    ref_geom = ref.geometry.replace(positions=jnp.asarray(moved))
    port = _carried(ref, ref.clusters)
    geom = dataclasses.replace(port.geometry,
                               positions=torch.from_numpy(moved))
    for parents in (False, True):
        jgrid = (ref.clusters if parents else
                 ref.clusters.replace(parent_min=None, parent_max=None))
        want = jclusters.refit_clusters(jgrid, ref_geom)
        got = clusters.refit_clusters(_carried(ref, jgrid).clusters, geom)
        for g in (got, want):
            assert (g.parent_min is None) == (g.parent_max is None)
            assert (g.parent_min is None) == (not parents)
        fields = BOXES + (("parent_min", "parent_max") if parents else ())
        for f in fields:
            np.testing.assert_array_equal(np_(getattr(got, f)),
                                          np.asarray(getattr(want, f)), f)


def test_vertex_training_step_on_a_parentless_grid():
    """Two Adam steps on the vertices of a ramp quad through K1's route
    ("pallas", refit every step) on a grid without parents give the
    parented grid's losses and vertices bit for bit (one cluster: both
    take the flat branch), and the live refit keeps the parents None."""
    from physically_based_renderer_tpu.core.camera import Camera as JCamera
    from physically_based_renderer_tpu_torch.core import rng
    from physically_based_renderer_tpu_torch.core.camera import (
        camera_from_numpy)
    from test_inverse import _ramp_quad_scene
    cam = camera_from_numpy(flat(JCamera.make(
        position=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0), fov_y=1.0)))
    cfg = path.RenderConfig(width=16, height=16, spp=1, max_bounces=1,
                            tracer="pallas")
    base = types.with_clusters(types.scene_from_numpy(
        scene_arrays(_ramp_quad_scene(0.0))), k=32)
    target = path.render(types.with_clusters(types.scene_from_numpy(
        scene_arrays(_ramp_quad_scene(0.3)))), cam, rng.key(5),
        cfg).mean().detach()
    out = {}
    for parents in (True, False):
        scene = base if parents else dataclasses.replace(
            base, clusters=dataclasses.replace(
                base.clusters, parent_min=None, parent_max=None))
        params = pinv.TrainableParams.from_scene(scene, vertices=True)
        params, losses = pinv.fit(scene, cam, target, params, cfg, steps=2,
                                  lr=2e-2, seed=3)
        out[parents] = (losses, np_(params.vertex_positions))
        live = pinv._with_live_accel(scene, params_to_port(
            {"vertex_positions": out[parents][1]}))
        assert (live.clusters.parent_min is None) == (not parents)
    assert out[True][0] == out[False][0] and np.isfinite(out[False][0]).all()
    assert out[False][0][1] != out[False][0][0]
    np.testing.assert_array_equal(out[True][1], out[False][1])
