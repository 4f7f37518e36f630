"""Silhouette edge sampling (grad/edge.py) in the port against the reference:
the edge table, the boundary term's gradient on vertex positions at the same
key, and the translation check against finite differences of the port's own
render (tests/test_edge_grad.py's scenes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.grad import edge as jedge
from physically_based_renderer_tpu.integrator.path import \
    RenderConfig as JRenderConfig
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.grad import edge as pedge
from physically_based_renderer_tpu_torch.grad import inverse as pinv
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from test_edge_grad import BG, _quad_scene, _scene
from torch_parity import flat, np_, scene_arrays

torch.set_num_threads(1)

CAM = dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0), fov_y=1.0)
# 32x32, 4 spp, primary visibility only; brute force in both packages (the
# reference's CPU default for a scene without clusters).
SMALL = dict(width=32, height=32, spp=4, max_bounces=0, tracer="brute")
N_EDGE = 256
REL = 1e-4

OCC = ([[-0.4, -0.6, 0.0], [0.4, -0.6, 0.0], [0.4, 0.6, 0.0],
        [-0.4, 0.6, 0.0]], 1)
SCENES = {
    # test_edge_grad.py:254-268: a nearer blocker over half the occluder
    "partially_occluded": lambda: _quad_scene(
        [BG, OCC, ([[-0.9, -0.8, 0.5], [0.9, -0.8, 0.5], [0.9, 0.0, 0.5],
                    [-0.9, 0.0, 0.5]], 2)]),
    # :271-275
    "vertical": lambda: _quad_scene(
        [BG, ([[-0.4, -0.5, 0.0], [0.4, -0.5, 0.0], [0.4, 0.5, 0.0],
               [-0.4, 0.5, 0.0]], 1)]),
    # :278-283
    "rotation": lambda: _quad_scene(
        [BG, ([[-0.7, -0.25, 0.0], [0.7, -0.25, 0.0], [0.7, 0.25, 0.0],
               [-0.7, 0.25, 0.0]], 1)]),
    # :286-294
    "two_occluders": lambda: _quad_scene(
        [BG, ([[-0.9, -0.5, 0.0], [-0.2, -0.5, 0.0], [-0.2, 0.5, 0.0],
               [-0.9, 0.5, 0.0]], 1),
         ([[0.25, -0.35, 0.2], [0.85, -0.35, 0.2], [0.85, 0.45, 0.2],
           [0.25, 0.45, 0.2]], 2)]),
}


@pytest.mark.parametrize("build", [_scene, jproc.make_cornell_box,
                                   lambda: jproc.make_uv_sphere(1.0, 6, 8)])
def test_edge_table_matches_reference(build):
    obj = build()
    indices = np.asarray(getattr(obj, "geometry", obj).indices)
    want = jedge.build_edge_table(indices)
    got = pedge.build_edge_table(indices)
    np.testing.assert_array_equal(np_(got.verts), np.asarray(want.verts))
    np.testing.assert_array_equal(np_(got.faces), np.asarray(want.faces))
    assert got.num_edges == want.num_edges
    assert got.verts.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(SCENES))
def test_edge_gradient_matches_reference(name):
    """The boundary term's gradient on every vertex position, same key,
    same dL/dI (a fixed random field: the term is linear in it)."""
    ref = SCENES[name]()
    jcam = JCamera.make(**CAM)
    jcfg = JRenderConfig(**SMALL)
    dl_di = np.random.default_rng(0).normal(
        size=(SMALL["height"], SMALL["width"], 3)).astype(np.float32) * 1e-3
    edges_j = jedge.build_edge_table(ref.geometry.indices)

    def j_term(pos):
        s = ref.replace(geometry=ref.geometry.replace(positions=pos))
        return jedge.edge_boundary_loss(s, jcam, jcfg, jnp.asarray(dl_di),
                                        jax.random.key(7), edges_j,
                                        n_samples=N_EDGE)

    pos0 = jnp.asarray(ref.geometry.positions)
    j_val, j_grad = jax.value_and_grad(j_term)(pos0)
    want = np.asarray(j_grad)

    port = scene_from_numpy(scene_arrays(ref))
    pos = port.geometry.positions.clone().requires_grad_(True)
    s = pinv.apply_params(port, pinv.TrainableParams(vertex_positions=pos))
    term = pedge.edge_boundary_loss(
        s, camera_from_numpy(flat(jcam)), path.RenderConfig(**SMALL),
        torch.from_numpy(dl_di), rng.key(7),
        pedge.build_edge_table(port.geometry.indices), n_samples=N_EDGE)
    assert float(term.detach()) == 0.0 == float(j_val)
    term.backward()
    got = pos.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0.0
    err = np.abs(got - want).max()
    print(f"{name}: max|g| {scale:.4g}, max err / max|g| {err / scale:.3g}")
    assert err <= REL * scale


def test_silhouette_translation_gradient_matches_fd():
    """test_edge_grad.py:73-103 on the port alone: interior autodiff gives
    exactly zero for a flat occluder's translation, the edge term has the
    sign of central finite differences of the port's render and agrees
    within 30%."""
    port = scene_from_numpy(scene_arrays(_scene()))
    cam = camera_from_numpy(flat(JCamera.make(**CAM)))
    cfg = path.RenderConfig(width=64, height=64, spp=64, max_bounces=0)
    occ = torch.arange(4, 8)
    base = port.geometry.positions

    def scene_at(theta):
        pos = base.clone()
        pos[occ, 0] = pos[occ, 0] + theta
        return pinv.apply_params(port, pinv.TrainableParams(
            vertex_positions=pos))

    with torch.no_grad():
        target = path.render(scene_at(torch.tensor(0.25)), cam, rng.key(9),
                             cfg).mean()
    edges = pedge.build_edge_table(port.geometry.indices)

    def loss(theta, n_edge):
        s = scene_at(theta)
        img = path.render(s, cam, rng.key(3), cfg).mean()
        val = pinv.pixel_loss(img, target)
        if n_edge:
            val = val + pedge.edge_boundary_loss(
                s, cam, cfg, pinv.pixel_loss_grad(img, target), rng.key(7),
                edges, n_samples=n_edge)
        return val

    def grad(n_edge):
        theta = torch.zeros((), requires_grad=True)
        loss(theta, n_edge).backward()
        return float(theta.grad)

    assert abs(grad(0)) < 1e-8
    g_edge = grad(4096)
    h = 0.04
    with torch.no_grad():
        g_fd = float(loss(torch.tensor(h), 0) - loss(torch.tensor(-h), 0)) / (
            2 * h)
    print(f"edge {g_edge:.5f}, finite differences {g_fd:.5f}")
    assert abs(g_fd) > 1e-3
    assert np.sign(g_edge) == np.sign(g_fd)
    np.testing.assert_allclose(g_edge, g_fd, rtol=0.3)
