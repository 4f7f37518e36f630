"""The helmet asset of the port against the reference's: textures, geometry,
the content-keyed cache, the loaded scene, and whole renders of the small
helmet through the block tracer's plain version and brute force."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.scene import helmet_asset as jhelmet
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import fused, trace_blocks
from physically_based_renderer_tpu_torch.scene import helmet_asset
from physically_based_renderer_tpu_torch.scene.types import with_clusters
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (COUNT_REL, MEAN_REL, PIXEL_FRAC,
                          assert_graphs_equal, assert_records_equal,
                          assert_scene_matches, flat, golden_module,
                          render_agreement)

torch.set_num_threads(1)

SCALE = 0.02
CAM = dict(position=(0.0, 0.1, 3.0), target=(0.0, 0.0, 0.0), fov_y=1.0)


@pytest.mark.parametrize("name,size", [
    ("make_shell_albedo", 64), ("make_shell_albedo", 256),
    ("make_shell_mr", 256), ("make_shell_normal", 128),
    ("make_visor_emissive", 64)])
def test_texture_painters_match_reference(name, size):
    a, b = getattr(helmet_asset, name)(size), getattr(jhelmet, name)(size)
    assert a.dtype == b.dtype == np.float32 and a.shape == (size, size, 4)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [SCALE, 0.05])
def test_helmet_graph_matches_reference(scale):
    g, m, stack = helmet_asset.build_helmet_graph(scale)
    jg, jm, jstack = jhelmet.build_helmet_graph(scale)
    assert_graphs_equal(g, jg)
    assert_records_equal(m, jm)
    assert_records_equal(stack, jstack)
    assert stack.shapes == ((256, 256), (256, 256), (128, 128), (64, 64))


def test_geometry_helpers_match_reference():
    dent, jdent = helmet_asset._dent_field(), jhelmet._dent_field()
    tt, pp = np.meshgrid(np.linspace(0.1, 2.5, 9), np.linspace(0, 6.2, 11),
                         indexing="ij")
    np.testing.assert_array_equal(dent(tt, pp), jdent(tt, pp))
    for a, b in zip(helmet_asset._lat_band(1.0, 6, 8, 0.2, 2.0, dent,
                                           (3.0, 2.0)),
                    jhelmet._lat_band(1.0, 6, 8, 0.2, 2.0, jdent,
                                      (3.0, 2.0))):
        np.testing.assert_array_equal(a, b)
    torus, jtorus = helmet_asset._torus(0.86, 0.1, 7, 5), jhelmet._torus(
        0.86, 0.1, 7, 5)
    for a, b in zip(torus, jtorus):
        np.testing.assert_array_equal(a, b)
    # degenerate uvs take the fallback frame
    pos, nrm, uv, idx = torus
    np.testing.assert_array_equal(
        helmet_asset._uv_tangents(pos, nrm, np.zeros_like(uv), idx),
        jhelmet._uv_tangents(pos, nrm, np.zeros_like(uv), idx))


def test_authoring_is_deterministic(tmp_path):
    p1 = helmet_asset.author_helmet_glb(tmp_path / "a" / "x.glb", SCALE)
    p2 = helmet_asset.author_helmet_glb(tmp_path / "b.glb", SCALE)
    assert p1.read_bytes() == p2.read_bytes()


def test_cache_is_keyed_by_content(tmp_path, monkeypatch):
    """A tested divergence from the reference, whose cache goes by file name
    alone: a file left by other code, or for another scale, is not used."""
    key = helmet_asset.asset_key(SCALE)
    assert key == helmet_asset.asset_key(SCALE)
    assert key != helmet_asset.asset_key(0.05)
    # the reference's name for the same asset, holding junk: never read
    (tmp_path / f"helmet_{SCALE:g}.glb").write_bytes(b"stale")
    path = helmet_asset.cached_helmet_glb(tmp_path, SCALE)
    assert key in path.name and path.read_bytes()[:4] == b"glTF"
    assert not list(tmp_path.glob("*.tmp"))
    stamp = path.stat().st_mtime_ns
    assert helmet_asset.cached_helmet_glb(tmp_path, SCALE) == path
    assert path.stat().st_mtime_ns == stamp          # a hit: not rewritten
    scene = helmet_asset.load_helmet_scene(tmp_path, SCALE)
    assert scene.geometry.num_tris == 1880
    # a change of the authoring sources changes the key: the file written
    # by the old code is stale and a new one is authored beside it
    real = helmet_asset.Path.read_bytes

    def edited(self):
        data = real(self)
        return data + b"# edited" if self.name == "export.py" else data
    monkeypatch.setattr(helmet_asset.Path, "read_bytes", edited)
    assert helmet_asset.asset_key(SCALE) != key
    path.write_bytes(b"written by the old exporter")
    fresh = helmet_asset.cached_helmet_glb(tmp_path, SCALE)
    assert fresh != path and fresh.read_bytes()[:4] == b"glTF"


def test_default_cache_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("PBR_TORCH_ASSET_CACHE", raising=False)
    d = helmet_asset.default_cache_dir()
    assert d.parts[-2:] == ("build", "torch_assets")
    assert d.parent.parent == helmet_asset.Path(
        helmet_asset.__file__).resolve().parents[2]
    monkeypatch.setenv("PBR_TORCH_ASSET_CACHE", str(tmp_path / "c"))
    assert helmet_asset.default_cache_dir() == tmp_path / "c"


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("helmet")
    return (helmet_asset.load_helmet_scene(d / "port", SCALE),
            jhelmet.load_helmet_scene(cache_dir=d / "ref", scale_tris=SCALE))


def test_loaded_scene_matches_reference(small):
    scene, ref = small
    assert_scene_matches(scene, ref)
    assert scene.tex_slots == (True, True, True, True)
    assert scene.emitters.num_emitters == 288 and scene.env is not None
    assert not scene.flat_normals
    port_grid = with_clusters(scene).clusters
    ref_grid = jtypes.with_clusters(ref).clusters
    np.testing.assert_array_equal(port_grid.tri_id.numpy(),
                                  np.asarray(ref_grid.tri_id))


@pytest.mark.parametrize("tracer,block", [("pallas", 512), ("brute", 256)])
def test_small_helmet_render_matches_reference(small, tracer, block):
    """32x32 x 2 spp x 2 bounces: normal map, emissive visor through the
    alias pick (288 emitters), env MIS.  The reference runs its block kernel
    in interpret mode; the port runs K1's plain version."""
    scene, ref = small
    kw = dict(width=32, height=32, spp=2, max_bounces=2, tracer=tracer,
              block_size=block)
    jcam = JCamera.make(**CAM)
    jfilm, jcount = j_render_with_stats(jtypes.with_clusters(ref), jcam,
                                        jax.random.key(7), JRenderConfig(**kw))
    before = (trace_blocks.LAUNCHES, fused.LAUNCHES)
    film, count = path.render_with_stats(
        with_clusters(scene), camera_from_numpy(flat(jcam)), rng.key(7),
        path.RenderConfig(**kw))
    assert (trace_blocks.LAUNCHES, fused.LAUNCHES) == before
    img, want = film.mean().numpy(), np.asarray(jfilm.mean())
    frac, n_bad = render_agreement(img, want)
    print(f"{tracer} B={block}: {n_bad} of 1024 pixels outside tolerance")
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / want.mean() - 1.0) <= MEAN_REL
    assert abs(int(count) / float(jcount) - 1.0) <= COUNT_REL


def test_fused_gate_refuses_the_helmet(small):
    scene, _ = small
    assert not fused.fused_applicable(with_clusters(scene),
                                      path.RenderConfig())


def test_helmet_config_builds_the_full_asset():
    bc = config.get("helmet")
    scene, cam = config.build_scene(bc.scene, "cpu")
    assert scene.geometry.num_tris == 99_400
    assert scene.emitters.num_emitters == 15_600
    assert scene.clusters.num_clusters == 1024
    assert scene.textures.shapes == ((256, 256), (256, 256), (128, 128),
                                     (64, 64))
    assert bc.render.block_size == 512
    assert path.make_tracer(scene, bc.render).name == "pallas"
    np.testing.assert_array_equal(cam.position.numpy(),
                                  np.float32([0.0, 0.1, 3.0]))


def test_helmet_golden_matches_fresh_reference_render():
    """The committed helmet golden is what the reference renders today (the
    full .glb asset, its block kernel in interpret mode at block 512)."""
    mod = golden_module()
    np.testing.assert_allclose(mod.render_helmet_glb_golden(),
                               np.load(mod.HELMET_GLB["path"]), rtol=1e-5,
                               atol=1e-6)
