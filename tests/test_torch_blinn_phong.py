"""The headlight Blinn-Phong debug shading (`--blinn-phong`) against the
reference: the lighting formula, whole renders per pixel (cornell at
24x24, the small helmet asset with its textures), the committed goldens
(cornell at 64x64, the full `helmet` at 32x32), the brute-force chunk, and
the CLI.

Tolerance: a pixel agrees within ATOL + RTOL * |ref| (1e-4 + 1e-3 |ref|),
and at least PIXEL_FRAC (99%) of the pixels must agree (torch_parity.py);
the lighting formula within 1e-6.
"""

import json

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.models import blinn_phong as jbp
from physically_based_renderer_tpu.scene import helmet_asset as jhelmet
from physically_based_renderer_tpu.utils import config as jconfig
from physically_based_renderer_tpu_torch.apps import render as render_app
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.models import blinn_phong as bp
from physically_based_renderer_tpu_torch.scene import helmet_asset
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (PIXEL_FRAC, flat, golden_module, render_agreement,
                          scene_arrays)

torch.set_num_threads(1)


def _assert_agrees(img, ref):
    frac, n_bad = render_agreement(img, ref)
    print(f"{n_bad} of {img.shape[0] * img.shape[1]} pixels outside "
          f"tolerance ({frac:.4%} agree)")
    assert img.shape == ref.shape
    assert frac >= PIXEL_FRAC


def test_lighting_matches_reference():
    g = np.random.default_rng(0)
    albedo = g.random((64, 3)).astype(np.float32)
    n, v, l = (g.normal(size=(64, 3)).astype(np.float32) for _ in range(3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t = lambda x: torch.from_numpy(x)
    got = bp.blinn_phong_lighting(t(albedo), t(n), t(v), t(v)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jbp.blinn_phong_lighting(albedo, n, v, v)),
        rtol=1e-6, atol=1e-6)
    got = bp.blinn_phong_lighting(t(albedo), t(n), t(v), t(l)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jbp.blinn_phong_lighting(albedo, n, v, l)),
        rtol=1e-6, atol=1e-6)


def test_cornell_matches_reference():
    bc = jconfig.get("cornell")
    ref_scene, jcam = jconfig.build_scene(bc.scene)
    want = np.asarray(jbp.render_blinn_phong(ref_scene, jcam, 24, 24))
    scene = scene_from_numpy(scene_arrays(ref_scene))
    got = bp.render_blinn_phong(scene, camera_from_numpy(flat(jcam)), 24, 24)
    assert got.shape == (24, 24, 3) and got.device.type == "cpu"
    _assert_agrees(got.numpy(), want)


def test_small_helmet_matches_reference(tmp_path):
    """The helmet asset at 2% of its triangles: textured base colour, normal
    map, 288 emissive triangles (emission plays no part here)."""
    scale = 0.02
    ref_scene = jhelmet.load_helmet_scene(cache_dir=tmp_path / "ref",
                                          scale_tris=scale)
    scene = helmet_asset.load_helmet_scene(tmp_path / "port", scale)
    kw = dict(position=(0.0, 0.1, 3.0), target=(0.0, 0.0, 0.0), fov_y=1.0)
    jcam = JCamera.make(**kw)
    want = np.asarray(jbp.render_blinn_phong(ref_scene, jcam, 24, 20))
    got = bp.render_blinn_phong(scene, camera_from_numpy(flat(jcam)), 24, 20)
    assert want.max() > 0.0
    _assert_agrees(got.numpy(), want)


@pytest.mark.parametrize("name", ["cornell_bp", "helmet_bp"])
def test_render_matches_golden(name):
    """The port at the goldens' sizes: cornell at 64x64, the full 99,400-
    triangle `helmet` at 32x32 (built by the port's own config)."""
    spec = golden_module().BLINN_PHONG[name]
    scene, cam = config.build_scene(config.get(spec["config"]).scene, "cpu")
    got = bp.render_blinn_phong(scene, cam, spec["size"], spec["size"])
    _assert_agrees(got.numpy(), np.load(spec["path"]))


@pytest.mark.parametrize("name", ["cornell_bp", "helmet_bp"])
def test_golden_matches_fresh_reference_render(name):
    mod = golden_module()
    spec = mod.BLINN_PHONG[name]
    np.testing.assert_allclose(mod.render_blinn_phong_golden(name),
                               np.load(spec["path"]), rtol=1e-5, atol=1e-6)


def test_chunk_does_not_change_the_image(monkeypatch):
    """Within a chunk argmin keeps the first minimum, across chunks `<` is
    strict: any chunk finds the same winner, so the image is bit-equal."""
    scene, cam = config.build_scene(config.get("cornell").scene, "cpu")
    assert bp.brute_chunk(16 * 16) == bp.BRUTE_CHUNK
    assert bp.brute_chunk(512 * 512) == 256
    a = bp.render_blinn_phong(scene, cam, 16, 16)
    for chunk in (1, 7, 13):
        monkeypatch.setattr(bp, "BRUTE_PAIRS", chunk * 16 * 16)
        assert bp.brute_chunk(16 * 16) == chunk
        b = bp.render_blinn_phong(scene, cam, 16, 16)
        assert torch.equal(a, b), chunk


def test_cli_counts_a_ray_a_pixel(tmp_path, capsys):
    out, hdr = tmp_path / "bp.png", tmp_path / "bp.npy"
    assert render_app.main(["cornell", "--blinn-phong", "-o", str(out),
                            "--hdr-output", str(hdr), "--width", "16",
                            "--height", "12", "--stats", "--device",
                            "cpu"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["rays"] == 16 * 12 and stats["tiles"] == 1
    scene, cam = config.build_scene(config.get("cornell").scene, "cpu")
    np.testing.assert_array_equal(
        np.load(hdr), bp.render_blinn_phong(scene, cam, 16, 12).numpy())


def test_cli_ignores_tiles(tmp_path, monkeypatch):
    """As in the reference, --blinn-phong renders on one device and
    --tiles starts no ranks."""
    from physically_based_renderer_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "spawn_local",
                        lambda *a: pytest.fail("ranks were started"))
    assert render_app.main(["cornell", "--blinn-phong", "--tiles", "2",
                            "-o", str(tmp_path / "x.png"), "--width", "8",
                            "--height", "8", "--device", "cpu"]) == 0
