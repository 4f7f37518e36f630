"""The BVH route (`tracer="bvh"`): the host checks of the BVH build, the
stack walk of ops/traverse.py against brute force and against the
reference's `intersect_bvh`, refit, renders and gradients (the oracles of
tests/test_bvh.py without its k=32 tests)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.accel import bvh as jbvh
from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.ops.traverse import (
    intersect_bvh as j_intersect_bvh)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.accel import bvh
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.grad import inverse
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import traverse
from physically_based_renderer_tpu_torch.ops.intersect import (
    intersect_brute, occluded_brute)
from physically_based_renderer_tpu_torch.scene import types
from torch_parity import (assert_render_agrees, flat, np_, params_to_port,
                          scene_arrays)

torch.set_num_threads(1)

CORNELL_CAM = dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                   fov_y=0.95)
# Winners are equal; t, u and v agree within T_ATOL (XLA's CPU backend
# contracts multiply-adds, torch does not).
T_ATOL = 1e-5


def _rays(n, seed, extent=2.0):
    g = np.random.default_rng(seed)
    o = g.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _geometry(jgeom):
    """A reference Geometry as the port's, and the port's BVH over it as
    tensors (the numpy builder, bit-equal to the reference's)."""
    scene = types.with_bvh(types.scene_from_numpy(scene_arrays(
        jtypes.make_scene(jgeom, jtypes.Materials.default(1)))))
    return scene.geometry, scene.bvh


def _ref_hit(jgeom, o, d, **kw):
    jb = jax.device_put(jbvh.build_bvh(jgeom.positions, jgeom.indices))
    g = jax.device_put(jgeom)
    return jax.jit(lambda o, d: j_intersect_bvh(jb, g, o, d, **kw))(
        jnp.asarray(o), jnp.asarray(d))


@pytest.mark.parametrize("num_tris", [1, 5, 33, 500])
def test_structure_and_builder_match_reference(num_tris):
    g = jproc.make_random_tris(num_tris, seed=num_tris)
    pos, idx = np.asarray(g.positions), np.asarray(g.indices)
    got, want = bvh.build_bvh(pos, idx), jbvh.build_bvh(pos, idx)
    for f in dataclasses.fields(bvh.BVH):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      np.asarray(getattr(want, f.name)))
    bvh.validate_bvh(got, pos, idx)
    assert bvh.bvh_depth(got) == jbvh.bvh_depth(want) < bvh.MAX_DEPTH


def test_validate_bvh_finds_a_broken_tree():
    g = jproc.make_random_tris(33, seed=2)
    pos, idx = np.asarray(g.positions), np.asarray(g.indices)
    tree = bvh.build_bvh(pos, idx)
    child = int(tree.node_left[0])
    shrunk = tree.node_max.copy()
    shrunk[0] = tree.node_min[0]           # the root no longer holds its kids
    with pytest.raises(AssertionError):
        bvh.validate_bvh(dataclasses.replace(tree, node_max=shrunk), pos,
                         idx)
    order = tree.tri_order.copy()
    order[0] = order[1]                    # a triangle twice, one missing
    with pytest.raises(AssertionError):
        bvh.validate_bvh(dataclasses.replace(tree, tri_order=order), pos,
                         idx)
    assert child > 0


@pytest.mark.parametrize("num_tris", [7, 100, 1000])
def test_matches_brute_force_and_reference(num_tris):
    jg = jproc.make_random_tris(num_tris, seed=1)
    geom, tree = _geometry(jg)
    o, d = _rays(256, seed=2)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    h = traverse.intersect_bvh(tree, geom, ot, dt)
    hb = intersect_brute(ot, dt, *geom.tri_vertices())
    # brute force: the same distances (ids may differ on exact ties)
    np.testing.assert_allclose(h.t.numpy(), hb.t.numpy(), rtol=1e-5)
    assert (h.tri == hb.tri).float().mean() > 0.99
    # the reference's walk: the same winners
    ref = _ref_hit(jg, o, d)
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(ref.tri))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(h, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=T_ATOL, err_msg=k)


@pytest.mark.parametrize("seed", [4, 5])
def test_any_hit_matches_brute_and_reference(seed):
    jg = jproc.make_random_tris(200, seed=seed)
    geom, tree = _geometry(jg)
    o, d = _rays(256, seed=seed + 1)
    t_max = np.full((256,), 1.5, np.float32)
    occ = traverse.intersect_bvh(tree, geom, torch.from_numpy(o),
                                 torch.from_numpy(d),
                                 t_max=torch.from_numpy(t_max), any_hit=True)
    ob = occluded_brute(torch.from_numpy(o), torch.from_numpy(d),
                        *geom.tri_vertices(), t_max=torch.from_numpy(t_max))
    assert occ.dtype == torch.bool and 0 < int(occ.sum()) < 256
    assert torch.equal(occ, ob)
    ref = _ref_hit(jg, o, d, t_max=jnp.asarray(t_max), any_hit=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))


def test_walk_does_not_depend_on_how_often_it_checks(monkeypatch):
    """The working set is tested every CHECK_EVERY steps; a step of a
    finished ray changes nothing, so any period gives the same hits."""
    geom, tree = _geometry(jproc.make_random_tris(300, seed=11))
    o, d = map(torch.from_numpy, _rays(200, seed=12))
    want = traverse.intersect_bvh(tree, geom, o, d)
    for every in (1, 3):
        monkeypatch.setattr(traverse, "CHECK_EVERY", every)
        before = traverse.STEPS
        got = traverse.intersect_bvh(tree, geom, o, d)
        assert traverse.STEPS > before
        assert torch.equal(got.tri, want.tri) and torch.equal(got.t, want.t)
    empty = traverse.intersect_bvh(tree, geom, o[:0], d[:0])
    assert empty.tri.shape == (0,)


def test_cornell_box_agreement():
    scene = types.with_bvh(types.scene_from_numpy(scene_arrays(
        jproc.make_cornell_box())))
    o, d = _rays(512, seed=3, extent=0.9)
    o = torch.from_numpy(o + np.array([0.0, 1.0, 0.0], np.float32))
    d = torch.from_numpy(d)
    h = traverse.intersect_bvh(scene.bvh, scene.geometry, o, d)
    hb = intersect_brute(o, d, *scene.geometry.tri_vertices())
    np.testing.assert_allclose(h.t.numpy(), hb.t.numpy(), rtol=1e-5)
    assert torch.equal(h.tri >= 0, hb.tri >= 0)


def test_per_ray_t_max():
    geom, tree = _geometry(jproc.make_random_tris(50, seed=6))
    o, d = map(torch.from_numpy, _rays(64, seed=7))
    full = traverse.intersect_bvh(tree, geom, o, d)
    # every ray cut off just before its hit: no hits
    t_cut = torch.where(full.tri >= 0, full.t * 0.99, 0.1)
    occ = traverse.intersect_bvh(tree, geom, o, d, t_max=t_cut,
                                 any_hit=True)
    assert (full.tri >= 0).any() and not occ[full.tri >= 0].any()


def test_refit_after_move():
    jg = jproc.make_random_tris(100, seed=8)
    pos, idx = np.asarray(jg.positions), np.asarray(jg.indices)
    moved = pos + np.array([0.5, 0.0, 0.0], np.float32)
    refit = bvh.refit_bvh(bvh.build_bvh(pos, idx), moved, idx)
    want = jbvh.refit_bvh(jbvh.build_bvh(pos, idx), moved, idx)
    np.testing.assert_array_equal(refit.node_min, np.asarray(want.node_min))
    np.testing.assert_array_equal(refit.node_max, np.asarray(want.node_max))
    bvh.validate_bvh(refit, moved, idx)
    # the walk over the refit tree agrees with brute force on the moved mesh
    geom, _ = _geometry(jg.replace(positions=jnp.asarray(moved)))
    tree = bvh.BVH(**{f.name: torch.from_numpy(getattr(refit, f.name))
                      for f in dataclasses.fields(bvh.BVH)})
    o, d = map(torch.from_numpy, _rays(128, seed=9))
    h = traverse.intersect_bvh(tree, geom, o, d)
    hb = intersect_brute(o, d, *geom.tri_vertices())
    np.testing.assert_allclose(h.t.numpy(), hb.t.numpy(), rtol=1e-5)


def test_render_with_bvh_matches_brute():
    """A cornell render through the BVH equals the brute-force one: the
    same samples and estimator, only the intersector differs (the
    reference's tolerance)."""
    scene = types.scene_from_numpy(scene_arrays(jproc.make_cornell_box()))
    cam = camera_from_numpy(flat(JCamera.make(**CORNELL_CAM)))
    cfg = path.RenderConfig(width=24, height=24, spp=2, max_bounces=2)
    a = path.render(scene, cam, rng.key(0),
                    dataclasses.replace(cfg, tracer="brute")).mean()
    b = path.render(types.with_bvh(scene), cam, rng.key(0),
                    dataclasses.replace(cfg, tracer="bvh")).mean()
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)


def test_bvh_render_matches_reference():
    """tracer="bvh" per pixel against the reference's at the same key and
    RenderConfig (PIXEL_FRAC within ATOL + RTOL |ref|, mean and ray count
    within 0.5%)."""
    ref = jtypes.with_bvh(jproc.make_cornell_box())
    jcam = JCamera.make(**CORNELL_CAM)
    small = dict(width=16, height=16, spp=2, max_bounces=2, tracer="bvh")
    jfilm, jcount = j_render_with_stats(ref, jcam, jax.random.key(3),
                                        JRenderConfig(**small))
    port = types.with_bvh(types.scene_from_numpy(scene_arrays(ref)))
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(3),
                                         path.RenderConfig(**small))
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))


def test_bvh_differentiable_wrt_positions():
    """The hit distance's gradient flows through the walk to the vertices:
    against central differences (rtol 1e-2, the reference's test) and the
    reference's jax.grad (rtol 1e-4)."""
    jg = jproc.make_uv_sphere(rings=6, sectors=8)
    geom, tree = _geometry(jg)
    o_np = np.array([[0.13, 0.21, 3.0]], np.float32)
    d_np = np.array([[0.0, 0.0, -1.0]], np.float32)
    o, d = torch.from_numpy(o_np), torch.from_numpy(d_np)

    def hit_t(scale):
        g2 = dataclasses.replace(geom, positions=geom.positions * scale)
        return traverse.intersect_bvh(tree, g2, o, d).t[0]

    scale = torch.tensor(1.0, requires_grad=True)
    t = hit_t(scale)
    assert float(t.detach()) < 3.0          # the ray hits
    (grad,) = torch.autograd.grad(t, scale)
    eps = 1e-3
    fd = (float(hit_t(torch.tensor(1.0 + eps)))
          - float(hit_t(torch.tensor(1.0 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(grad), fd, rtol=1e-2)
    jb = jax.device_put(jbvh.build_bvh(jg.positions, jg.indices))
    g = jax.device_put(jg)
    j_grad = jax.grad(lambda s: j_intersect_bvh(
        jb, g.replace(positions=g.positions * s), jnp.asarray(o_np),
        jnp.asarray(d_np)).t[0])(jnp.float32(1.0))
    np.testing.assert_allclose(float(grad), float(j_grad), rtol=1e-4)


def test_with_bvh_matches_reference():
    ref = jtypes.with_bvh(jproc.make_cornell_box())
    port = types.with_bvh(types.scene_from_numpy(scene_arrays(ref)))
    for f in dataclasses.fields(bvh.BVH):
        np.testing.assert_array_equal(np_(getattr(port.bvh, f.name)),
                                      np.asarray(getattr(ref.bvh, f.name)),
                                      err_msg=f.name)
    assert path.make_tracer(port,
                            path.RenderConfig(tracer="bvh")).name == "bvh"
    with pytest.raises(ValueError, match="BVH"):
        path.make_tracer(dataclasses.replace(port, bvh=None),
                         path.RenderConfig(tracer="bvh"))


def test_with_live_accel_drops_the_bvh():
    """Under vertex training the BVH is dropped, as the reference drops it;
    with vertices frozen the scene is kept as it is."""
    scene = types.with_bvh(types.with_clusters(types.scene_from_numpy(
        scene_arrays(jproc.make_cornell_box()))))
    frozen = params_to_port({"base_color_factor": np.asarray(
        scene.materials.base_color_factor)})
    assert inverse._with_live_accel(scene, frozen) is scene
    moving = params_to_port({"vertex_positions": np_(
        scene.geometry.positions)})
    live = inverse._with_live_accel(scene, moving)
    assert live.bvh is None and live.clusters is not None
    assert path._auto_tracer(dataclasses.replace(live, clusters=None)) in (
        "resident", "brute")
