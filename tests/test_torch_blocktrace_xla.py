"""The XLA block tracer (`tracer="block"`, ops/blocktrace.py::
intersect_blocks) and its demand diagnostic `block_union_counts` against
the reference's, and a `tracer="block"` render per pixel."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.ops import blocktrace as jbt
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import blocktrace
from physically_based_renderer_tpu_torch.scene import types
from torch_parity import assert_render_agrees, flat, scene_arrays

torch.set_num_threads(1)

HELMET_CAM = dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                  fov_y=1.0)
# Winners equal; t, u, v of the attached finish within T_ATOL (XLA's CPU
# backend contracts multiply-adds, torch does not).
T_ATOL = 1e-5


@pytest.fixture(scope="module")
def sphere():
    """A 3,200-triangle sphere with the reference's cluster grid (25
    clusters), the port's scene built from it, and rays aimed at it from a
    shell around it (most hit)."""
    ref = jtypes.with_clusters(jtypes.make_scene(
        jproc.make_uv_sphere(radius=1.0, rings=40, sectors=40),
        jtypes.Materials.default(1)))
    port = types.with_clusters(types.scene_from_numpy(scene_arrays(ref)))
    g = np.random.default_rng(1)
    o = g.normal(size=(700, 3)).astype(np.float32)
    o *= 2.5 / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (g.uniform(-0.6, 0.6, (700, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ref, port, o, d


# (ray block, candidate clusters): a whole chunk of 8; a list padded from 12
# to 16; a truncated list of 6 of the 25 clusters.
@pytest.mark.parametrize("block,max_u", [(128, 8), (64, 12), (256, 6)])
@pytest.mark.parametrize("sort", [False, True])
def test_intersect_blocks_matches_reference(sphere, block, max_u, sort):
    ref, port, o, d = sphere
    kw = dict(t_min=1e-4, block=block, max_u=max_u, sort=sort)
    want = jbt.intersect_blocks(ref.clusters, ref.geometry, jnp.asarray(o),
                                jnp.asarray(d), **kw)
    got = blocktrace.intersect_blocks(port.clusters, port.geometry,
                                      torch.from_numpy(o),
                                      torch.from_numpy(d), **kw)
    assert (np.asarray(want.tri) >= 0).mean() > 0.3
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=T_ATOL, err_msg=k)
    t_max = np.random.default_rng(2).uniform(0.5, 3.0, o.shape[0]).astype(
        np.float32)
    occ_want = jbt.intersect_blocks(ref.clusters, ref.geometry,
                                    jnp.asarray(o), jnp.asarray(d),
                                    t_max=jnp.asarray(t_max), any_hit=True,
                                    **kw)
    occ = blocktrace.intersect_blocks(port.clusters, port.geometry,
                                      torch.from_numpy(o),
                                      torch.from_numpy(d),
                                      t_max=torch.from_numpy(t_max),
                                      any_hit=True, **kw)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_want))


def test_groups_of_blocks_do_not_change_a_hit(sphere, monkeypatch):
    """The dense tests run for groups of blocks of at most PAIRS_A_GROUP
    pairs; any grouping gives the same winners and masks."""
    _, port, o, d = sphere
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    kw = dict(block=64, max_u=12, sort=True)
    want = blocktrace.intersect_blocks(port.clusters, port.geometry, o, d,
                                       **kw)
    occ = blocktrace.intersect_blocks(port.clusters, port.geometry, o, d,
                                      t_max=2.0, any_hit=True, **kw)
    monkeypatch.setattr(blocktrace, "PAIRS_A_GROUP", 1)   # a block a group
    got = blocktrace.intersect_blocks(port.clusters, port.geometry, o, d,
                                      **kw)
    assert torch.equal(got.tri, want.tri) and torch.equal(got.t, want.t)
    assert torch.equal(blocktrace.intersect_blocks(
        port.clusters, port.geometry, o, d, t_max=2.0, any_hit=True, **kw),
        occ)


@pytest.mark.parametrize("t_max", [1e30, 2.0, "per_ray"])
def test_block_union_counts_matches_reference(sphere, t_max):
    ref, port, o, d = sphere
    if t_max == "per_ray":
        t_max = np.full(o.shape[0], 2.0, np.float32)
        jt, pt = jnp.asarray(t_max), torch.from_numpy(t_max)
    else:
        jt = pt = t_max
    want = jbt.block_union_counts(ref.clusters, jnp.asarray(o),
                                  jnp.asarray(d), block=128, t_max=jt)
    got = blocktrace.block_union_counts(port.clusters, torch.from_numpy(o),
                                        torch.from_numpy(d), block=128,
                                        t_max=pt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (-(-o.shape[0] // 128),)


def test_block_hits_carry_gradients_to_positions(sphere):
    """The closest hit is re-intersected attached: d t / d (position
    scale) equals the reference's jax.grad (rtol 1e-4)."""
    ref, port, _, _ = sphere
    o = np.array([[0.13, 0.21, 3.0], [-0.3, 0.1, 3.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    kw = dict(block=64, max_u=8)

    def j_t(s):
        g = ref.geometry.replace(positions=ref.geometry.positions * s)
        return jbt.intersect_blocks(ref.clusters, g, jnp.asarray(o),
                                    jnp.asarray(d), **kw).t.sum()

    scale = torch.tensor(1.0, requires_grad=True)
    g = dataclasses.replace(port.geometry,
                            positions=port.geometry.positions * scale)
    t = blocktrace.intersect_blocks(port.clusters, g, torch.from_numpy(o),
                                    torch.from_numpy(d), **kw).t.sum()
    (grad,) = torch.autograd.grad(t, scale)
    np.testing.assert_allclose(float(t.detach()), float(j_t(1.0)), rtol=1e-6)
    np.testing.assert_allclose(float(grad),
                               float(jax.grad(j_t)(jnp.float32(1.0))),
                               rtol=1e-4)


def test_block_render_matches_reference():
    """tracer="block" on the 1,152-triangle helmet24 (9 clusters, max_u 8:
    truncated lists) per pixel against the reference's at the same key
    (PIXEL_FRAC within ATOL + RTOL |ref|, mean and ray count within
    0.5%)."""
    ref = jtypes.with_clusters(jproc.make_helmet_class_scene(24, 24))
    jcam = JCamera.make(**HELMET_CAM)
    small = dict(width=16, height=16, spp=2, max_bounces=2, max_u=8,
                 tracer="block")
    jfilm, jcount = j_render_with_stats(ref, jcam, jax.random.key(0),
                                        JRenderConfig(**small))
    port = types.with_clusters(types.scene_from_numpy(scene_arrays(ref)))
    cfg = path.RenderConfig(**small)
    assert path._tracer(port, cfg) == "block"
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(0), cfg)
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))
