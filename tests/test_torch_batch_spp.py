"""`RenderConfig(batch_spp=True)`: all samples of render_with_stats's dense
path as one sample-inner ray stream, per pixel against the reference's
batched render and against the port's own sample loop."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.scene import types
from torch_parity import (assert_render_agrees, flat, render_agreement,
                          scene_arrays)

torch.set_num_threads(1)

CORNELL_CAM = dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                   fov_y=0.95)
HELMET_CAM = dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                  fov_y=1.0)


@pytest.mark.parametrize("scene,tracer", [("cornell", "brute"),
                                          ("helmet24", "block")])
def test_batch_spp_matches_reference(scene, tracer):
    """The batched render per pixel against the reference's at the same key
    and RenderConfig (PIXEL_FRAC within ATOL + RTOL |ref|, mean and ray
    count within 0.5%); the block tracer takes the stream in morton order,
    each pixel's samples together."""
    if scene == "cornell":
        ref, cam_kw = jproc.make_cornell_box(), CORNELL_CAM
    else:
        ref = jtypes.with_clusters(jproc.make_helmet_class_scene(24, 24))
        cam_kw = HELMET_CAM
    jcam = JCamera.make(**cam_kw)
    small = dict(width=16, height=16, spp=2, max_bounces=2, max_u=8,
                 tracer=tracer, batch_spp=True)
    jfilm, jcount = j_render_with_stats(ref, jcam, jax.random.key(5),
                                        JRenderConfig(**small))
    port = types.scene_from_numpy(scene_arrays(ref))
    if ref.clusters is not None:
        port = types.with_clusters(port)
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(5),
                                         path.RenderConfig(**small))
    assert film.spp == 2.0
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))


def _cornell():
    ref = jproc.make_cornell_box()
    return (types.scene_from_numpy(scene_arrays(ref)),
            camera_from_numpy(flat(JCamera.make(**CORNELL_CAM))))


def test_batch_spp_equals_the_sample_loop():
    """The same per-ray keys as the loop: with an order-invariant tracer
    the images differ only by the order of the film sums (PIXEL_FRAC
    within ATOL + RTOL |loop|), and the ray counts are equal."""
    scene, cam = _cornell()
    cfg = path.RenderConfig(width=16, height=16, spp=4, max_bounces=2,
                            tracer="resident")
    loop, n_loop = path.render_with_stats(scene, cam, rng.key(1), cfg)
    batch, n_batch = path.render_with_stats(
        scene, cam, rng.key(1), dataclasses.replace(cfg, batch_spp=True))
    frac, _ = render_agreement(batch.mean().numpy(), loop.mean().numpy())
    assert frac >= 0.99 and int(n_batch) == int(n_loop)
    np.testing.assert_allclose(batch.hdr.numpy(), loop.hdr.numpy(), rtol=0,
                               atol=1e-5)


def test_render_and_exchange_with_batch_spp():
    """render() keeps one pass a sample whatever batch_spp says (as the
    reference's render does); the batched stream renders on one device, so
    an exchange axis is refused."""
    scene, cam = _cornell()
    cfg = path.RenderConfig(width=8, height=8, spp=2, max_bounces=1,
                            tracer="resident")
    want = path.render(scene, cam, rng.key(2), cfg).hdr
    got = path.render(scene, cam, rng.key(2),
                      dataclasses.replace(cfg, batch_spp=True)).hdr
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="exchange_axis"):
        path.render_with_stats(scene, cam, rng.key(2), dataclasses.replace(
            cfg, batch_spp=True, exchange_axis="tiles"))
