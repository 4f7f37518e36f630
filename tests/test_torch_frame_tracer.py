"""The dense frame's tracer (`integrator/path.py::make_tracer`): chosen and
prepared once a frame by `frame_tables`, never inside a tracer call, with
the camera rays' order and their pixel ids (`FrameTables.pix`) made once a
band; `camera_rays` against the inline code it replaced.  Port only, on the
CPU, at 8x8."""

import dataclasses

import pytest
import torch

from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import (Camera,
                                                             generate_rays_at)
from physically_based_renderer_tpu_torch.core.morton import morton_pixel_ids
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.scene import procedural, types

SIZE = 8
CAM = Camera.make(position=(0.0, 0.1, 3.0), target=(0.0, 0.0, 0.0),
                  fov_y=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(tracer):
    """cornell for the resident tracer, a small textured helmet_proc-class
    sphere with its cluster grid for the block tracer."""
    if tracer == "resident":
        return procedural.make_cornell_box()
    return types.with_clusters(procedural.make_helmet_class_scene(8, 8))


def _cfg(tracer):
    return path.RenderConfig(width=SIZE, height=SIZE, spp=3, max_bounces=1,
                             tracer=tracer)


@pytest.mark.parametrize("tracer", ["resident", "pallas"])
def test_make_tracer_runs_once_a_band_outside_tracer_calls(tracer,
                                                           monkeypatch):
    """render_band at 3 spp chooses its tracer once, in frame_tables,
    before the first tracer call; every closest-hit and shadow call of the
    frame goes to that one Tracer."""
    scene = _scene(tracer)
    events = []
    real = path.make_tracer

    def spy(scene_, cfg_):
        events.append("make")
        t = real(scene_, cfg_)

        def closest(*a, **kw):
            events.append("trace")
            return t.closest(*a, **kw)

        def occluded(*a, **kw):
            events.append("trace")
            return t.occluded(*a, **kw)

        return dataclasses.replace(t, closest=closest, occluded=occluded)

    monkeypatch.setattr(path, "make_tracer", spy)
    cfg = _cfg(tracer)
    path.render_band(scene, CAM, rng.split(rng.key(1), cfg.spp), cfg)
    # 3 samples x (2 closest-hit calls + 1 shadow call a light family).
    assert events[0] == "make" and events.count("make") == 1
    assert events.count("trace") == 3 * 3


def test_morton_ids_are_made_once_a_band(monkeypatch):
    """The block tracer's morton pixel ids come to the device once a band,
    not once a sample, and each band gets its own rows."""
    scene = _scene("pallas")
    calls = []
    real = path.morton_pixel_ids

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(path, "morton_pixel_ids", spy)
    cfg = _cfg("pallas")
    keys = rng.split(rng.key(2), cfg.spp)
    half = SIZE // 2
    for row_start in (0, half):
        path.render_band(scene, CAM, keys, cfg, row_start=row_start,
                         n_rows=half)
    assert calls == [(SIZE, SIZE, 0, half), (SIZE, SIZE, half, half)]


@pytest.mark.parametrize("tracer", ["resident", "pallas"])
def test_camera_rays_equal_the_inline_rays(tracer):
    """frame_tables' pixel ids and camera_rays give, bit for bit, what the
    integrator built inline: morton ids for the block tracer (a textured
    scene: a cone angle), row-major ids otherwise (no textures: none)."""
    scene = _scene(tracer)
    cfg = _cfg(tracer)
    row_start, n_rows = 2, 4
    tables = path.frame_tables(scene, cfg, row_start, n_rows)
    if tracer == "pallas":
        pix = torch.from_numpy(morton_pixel_ids(
            SIZE, SIZE, row_start, n_rows)).to(dtype=torch.int64)
    else:
        pix = torch.arange(row_start * SIZE, (row_start + n_rows) * SIZE,
                           dtype=torch.int64)
    assert tables.tracer.morton == (tracer == "pallas")
    assert torch.equal(tables.pix, pix)
    keys = rng.ray_keys(rng.key(3), pix)
    jitter = rng.ray_uniform(keys, 0, rng.STREAM_PIXEL_JITTER, 2)
    o, d = generate_rays_at(CAM, SIZE, SIZE, (pix % SIZE).to(torch.float32),
                            (pix // SIZE).to(torch.float32), jitter)
    got_o, got_d, cone = path.camera_rays(scene, CAM, cfg, tables.pix, keys)
    assert torch.equal(got_o, o) and torch.equal(got_d, d)
    if scene.has_textures:
        assert torch.equal(cone, 2.0 * torch.tan(CAM.fov_y * 0.5) / SIZE)
    else:
        assert cone is None


@pytest.mark.parametrize("tracer,scene_of,match", [
    ("bvh2", "resident", "unknown tracer"),
    ("pallas", "resident", "cluster grid"),
    ("bvh", "resident", "BVH")])
def test_bad_tracer_raises_in_frame_tables(tracer, scene_of, match,
                                           monkeypatch):
    """An unknown name, or a tracer whose structure the scene lacks, raises
    in frame_tables, before any camera ray is made."""
    scene = _scene(scene_of)
    cfg = _cfg(tracer)
    with pytest.raises(ValueError, match=match):
        path.frame_tables(scene, cfg)

    def no_rays(*a):
        raise AssertionError("a camera ray was made")

    monkeypatch.setattr(path, "camera_rays", no_rays)
    with pytest.raises(ValueError, match=match):
        path.render_with_stats(scene, CAM, rng.key(0), cfg)
