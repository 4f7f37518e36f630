"""`--debug-checks` (utils/debug.py) against the reference's checkify path:
a clean scene passes and renders what render() renders; NaN radiance
raises NonFiniteRenderError; an out-of-range material id raises in both
packages, the port's error naming the site, the index and the size; each
checked site catches its own corruption; take_rows (K5a) is not flagged;
and with the checks off the render runs exactly the ops it ran before.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.utils import debug as jdebug
from physically_based_renderer_tpu_torch.apps import render as render_app
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import (
    Camera, camera_from_numpy)
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import gather, resident, traverse
from physically_based_renderer_tpu_torch.scene import procedural, types
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from physically_based_renderer_tpu_torch.utils import debug
from physically_based_renderer_tpu_torch.utils.debug import (
    IndexCheckError, NonFiniteRenderError, checked_render)
from torch_parity import flat, many_emitters_reference, scene_arrays

torch.set_num_threads(1)
CAM = dict(position=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0), fov_y=0.8)
CFG = dict(width=8, height=8, spp=1, max_bounces=1)


def _setup():
    return (procedural.make_triangle_scene(), Camera.make(**CAM),
            path.RenderConfig(**CFG))


def _replace(scene, record, **fields):
    return dataclasses.replace(scene, **{record: dataclasses.replace(
        getattr(scene, record), **fields)})


def test_checked_render_passes_on_clean_scene():
    scene, cam, cfg = _setup()
    film = checked_render(scene, cam, rng.key(0), cfg)
    assert torch.isfinite(film.hdr).all() and film.hdr.max() > 0
    # The checks clip nothing on clean data: the image is render()'s.
    want = path.render(scene, cam, rng.key(0),
                       dataclasses.replace(cfg, tracer="brute"))
    assert torch.equal(film.hdr, want.hdr)
    assert debug._records is None


def test_checked_render_takes_the_bvh_walk():
    scene, cam, cfg = _setup()
    traverse.STEPS = 0
    film = checked_render(types.with_bvh(scene), cam, rng.key(0), cfg)
    assert traverse.STEPS > 0 and torch.isfinite(film.hdr).all()


def test_checked_render_raises_on_injected_nan():
    scene, cam, cfg = _setup()
    m = scene.materials
    scene = _replace(scene, "materials", base_color_factor=torch.full_like(
        m.base_color_factor, float("nan")))
    with pytest.raises(NonFiniteRenderError, match="non-finite"):
        checked_render(scene, cam, rng.key(0), cfg)


def test_material_out_of_range_raises_in_both_packages():
    """tri_material 7 with one material: the reference's checkify raises
    naming the gather; the port names the site, the index and the size."""
    ref = jproc.make_triangle_scene()
    ref = ref.replace(geometry=ref.geometry.replace(
        tri_material=np.full_like(np.asarray(ref.geometry.tri_material), 7)))
    jcam = JCamera.make(**CAM)
    with pytest.raises(Exception, match="out-of-bounds indexing"):
        jdebug.checked_render(ref, jcam, jax.random.key(0),
                              JRenderConfig(**CFG))
    scene = scene_from_numpy(scene_arrays(ref))
    with pytest.raises(IndexCheckError, match="material ids") as e:
        checked_render(scene, camera_from_numpy(flat(jcam)), rng.key(0),
                       path.RenderConfig(**CFG))
    assert (e.value.site, e.value.index, e.value.size) == (
        "material ids", 7, 1)
    assert isinstance(e.value, IndexError)


def _corrupt(site):
    """(scene, camera) whose data sends one checked site out of range."""
    cam = Camera.make(**CAM)
    if site in ("emitter alias", "emitter triangles"):
        scene = scene_from_numpy(scene_arrays(many_emitters_reference()))
        cam = Camera.make(position=(0.0, 0.0, 4.0), target=(0.0, 0.0, 0.0),
                          fov_y=0.9)
        em = scene.emitters
        if site == "emitter alias":
            return _replace(scene, "emitters",
                            alias_prob=em.alias_prob[:10]), cam
        tri = em.tri_idx.clone()
        tri[3] = scene.geometry.num_tris + 4
        return _replace(scene, "emitters", tri_idx=tri), cam
    scene = procedural.make_triangle_scene()
    g = scene.geometry
    if site == "vertex ids":
        idx = g.indices.clone()
        idx[0, 1] = 1000
        return _replace(scene, "geometry", indices=idx), cam
    if site == "texture ids":
        return _replace(scene, "materials", base_color_tex=torch.full_like(
            scene.materials.base_color_tex, 5)), cam
    if site == "env alias":
        scene = procedural.make_furnace_scene()
        env = scene.env
        return _replace(scene, "env",
                        alias_prob=torch.zeros_like(env.alias_prob),
                        alias_idx=torch.full_like(
                            env.alias_idx, env.alias_idx.numel() + 9)), cam
    scene = types.with_bvh(_tris_scene())
    bvh = scene.bvh
    if site == "bvh nodes":
        left = bvh.node_left.clone()
        left[0] = bvh.node_left.numel() + 2
        return dataclasses.replace(scene, bvh=dataclasses.replace(
            bvh, node_left=left)), cam
    order = bvh.tri_order.clone()
    order[0] = scene.geometry.num_tris + 1
    return dataclasses.replace(scene, bvh=dataclasses.replace(
        bvh, tri_order=order)), cam


def _tris_scene():
    """64 random triangles in front of the camera, one material."""
    g = procedural.make_random_tris(64, seed=1, extent=0.8)
    return types.make_scene(g, types.Materials.default(1))


@pytest.mark.parametrize("site", ["vertex ids", "texture ids",
                                  "emitter triangles", "emitter alias",
                                  "env alias", "bvh nodes", "bvh triangles"])
def test_each_site_catches_its_corruption(site):
    scene, cam = _corrupt(site)
    with pytest.raises(IndexCheckError) as e:
        checked_render(scene, cam, rng.key(0), path.RenderConfig(**CFG))
    assert e.value.site == site
    assert not 0 <= e.value.index < e.value.size


def test_take_rows_is_not_flagged():
    """K5a clips and fills by design, as the reference's take_rows does."""
    table = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([-1, 0, 3, 4, 99], dtype=torch.int32)
    with debug.index_checks() as records:
        out = gather.take_rows(table, idx)
    assert records == []
    np.testing.assert_array_equal(out[[0, 3, 4]].numpy(), 0.0)
    np.testing.assert_array_equal(out[2].numpy(), [9.0, 10.0, 11.0])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bvh", [False, True])
def test_checks_off_add_no_work(bvh, monkeypatch):
    """Outside the context every site returns its index untouched: the
    render dispatches the same ops as with the sites removed, and launches
    no kernel more."""
    scene, cam, cfg = _setup()
    scene = procedural.make_cornell_box() if not bvh else types.with_bvh(
        _tris_scene())
    cfg = dataclasses.replace(cfg, tracer="bvh" if bvh else "brute")

    def count():
        before = (resident.LAUNCHES, gather.LAUNCHES_FWD)
        with _CountOps() as mode:
            path.render(scene, cam, rng.key(0), cfg)
        assert (resident.LAUNCHES, gather.LAUNCHES_FWD) == before
        return mode.ops

    with_sites = count()
    monkeypatch.setattr(debug, "check_index", lambda site, idx, size,
                        skip=None: idx)
    assert with_sites == count()


def test_index_checks_do_not_nest():
    with debug.index_checks():
        with pytest.raises(RuntimeError):
            with debug.index_checks():
                pass


def test_cli_debug_checks_renders(tmp_path):
    out = tmp_path / "d.png"
    assert render_app.main(["triangle", "--debug-checks", "-o", str(out),
                            "--width", "8", "--height", "8", "--spp", "1",
                            "--device", "cpu"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("extra", [["--tiles", "2"], ["--blinn-phong"]])
def test_cli_rejects_debug_checks_with_tiles(extra, tmp_path, capsys):
    rc = render_app.main(["triangle", "--debug-checks", *extra, "-o",
                          str(tmp_path / "never.png"), "--device", "cpu"])
    assert rc == 2
    assert capsys.readouterr().err.startswith("error: ")
    assert not (tmp_path / "never.png").exists()
