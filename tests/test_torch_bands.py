"""Row bands of the port's integrator (`_sample_radiance(row_start=,
n_rows=)`, `render_sample`, `render_band`): a band is the same rows of the
full render bit for bit, on the resident and the block-tracer ('pallas')
route, and agrees with the reference's `render_sample(row_start=,
n_rows=)` per pixel."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_sample as j_render_sample)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from torch_parity import flat, render_agreement, scene_arrays

torch.set_num_threads(1)

CAM = dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0), fov_y=0.95)
CFG = dict(width=16, height=32, spp=2, max_bounces=2)
# route -> (reference tracer, port tracer); both on the Cornell box with its
# cluster grid.
ROUTES = {"resident": ("resident", "resident"), "pallas": ("pallas", "pallas")}


@pytest.fixture(scope="module")
def cornell():
    ref = jtypes.with_clusters(jproc.make_cornell_box())
    arrays = scene_arrays(ref)
    arrays["clusters"] = flat(ref.clusters)
    jcam = JCamera.make(**CAM)
    return ref, jcam, scene_from_numpy(arrays), camera_from_numpy(flat(jcam))


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bands_are_the_rows_of_the_full_render(cornell, route, n_bands):
    _, _, scene, cam = cornell
    cfg = path.RenderConfig(**CFG, tracer=ROUTES[route][1])
    key = rng.key(5)
    full = path.render_sample(scene, cam, key, cfg)
    film = path.render(scene, cam, key, cfg)
    rows = cfg.height // n_bands
    keys = rng.split(key, cfg.spp)
    bands, films = [], []
    for i in range(n_bands):
        bands.append(path.render_sample(scene, cam, key, cfg,
                                        row_start=i * rows, n_rows=rows))
        f, _ = path.render_band(scene, cam, keys, cfg, row_start=i * rows,
                                n_rows=rows)
        films.append(f.hdr)
    assert bands[0].shape == (rows, cfg.width, 3)
    assert torch.equal(torch.cat(bands), full)
    assert torch.equal(torch.cat(films), film.hdr)
    assert float(full.mean()) > 0.0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_band_matches_reference_render_sample(cornell, route):
    """Rows 8-15 of the 16x32 frame against the reference's band (its
    "pallas" route is K1 in interpret mode)."""
    ref, jcam, scene, cam = cornell
    j_tracer, tracer = ROUTES[route]
    jcfg = JRenderConfig(**CFG, tracer=j_tracer)
    want = np.asarray(jax.jit(lambda s, c, k: j_render_sample(
        s, c, k, jcfg, row_start=8, n_rows=8))(ref, jcam, jax.random.key(3)))
    got = path.render_sample(scene, cam, rng.key(3),
                             path.RenderConfig(**CFG, tracer=tracer),
                             row_start=8, n_rows=8).numpy()
    frac, n_bad = render_agreement(got, want)
    print(f"{route}: {n_bad} of {got.shape[0] * got.shape[1]} band pixels "
          "outside the render tolerance")
    assert frac == 1.0 and got.shape == (8, 16, 3) and got.mean() > 0.0


def test_render_image_is_the_mean_of_render(cornell):
    _, _, scene, cam = cornell
    cfg = dataclasses.replace(path.RenderConfig(**CFG), spp=1)
    assert torch.equal(path.render_image(scene, cam, 4, cfg),
                       path.render(scene, cam, rng.key(4), cfg).mean())


def test_bands_on_a_clustered_scene():
    """helmet_proc (1,024 clusters, blocks of 256) without the direction
    sort: a band of whole 16-row tile rows blocks its rays as the full
    frame does (one morton tile a block), so each block gets the same
    candidate list (its nearest `max_u` clusters) and the bands are the
    frame's rows bit for bit.  A band that splits a tile row, or the
    direction sort, which blocks bounce and shadow rays among the band's
    rays only, changes which rays share a block, and pixels may differ."""
    from physically_based_renderer_tpu_torch.utils import config

    bc = config.get("helmet_proc")
    scene, cam = config.build_scene(bc.scene, torch.device("cpu"))
    cfg = dataclasses.replace(bc.render, width=32, height=64, spp=1,
                              resort=False)
    key = rng.key(0)
    full = path.render_sample(scene, cam, key, cfg)
    bands = torch.cat([path.render_sample(scene, cam, key, cfg,
                                          row_start=r * 16, n_rows=16)
                       for r in range(4)])
    assert torch.equal(bands, full)
    assert float(full.mean()) > 0.0
