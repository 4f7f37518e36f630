"""Whole renders of the port against the reference, the golden, the CLI and
the package's independence from JAX."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.apps import render as render_app
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import (resident, tonemap,
                                                     trace_blocks)
from physically_based_renderer_tpu_torch.scene.types import (scene_from_numpy,
                                                             with_clusters)
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (assert_render_agrees, flat, golden_module,
                          scene_arrays)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "physically_based_renderer_tpu_torch"

SCENES = {
    "cornell": (jproc.make_cornell_box,
                dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                     fov_y=0.95)),
    "triangle": (jproc.make_triangle_scene,
                 dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                      fov_y=1.2)),
}
SMALL = dict(width=32, height=32, spp=2, max_bounces=2)


def _both(name):
    build, cam = SCENES[name]
    ref = build()
    jcam = JCamera.make(**cam)
    return ref, jcam, scene_from_numpy(scene_arrays(ref)), camera_from_numpy(
        flat(jcam))


@pytest.mark.parametrize("name", ["cornell", "triangle"])
@pytest.mark.parametrize("seed", [0, 3])
def test_render_matches_reference(name, seed):
    ref, jcam, port, cam = _both(name)
    jfilm, jcount = j_render_with_stats(
        ref, jcam, jax.random.key(seed), JRenderConfig(**SMALL,
                                                       tracer="resident"))
    film, count = path.render_with_stats(port, cam, rng.key(seed),
                                         path.RenderConfig(**SMALL))
    assert count.dtype == torch.int64
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                          int(count), float(jcount))


# The dense path's branches: no NEE, NEE without MIS, Russian roulette
# from the first bounce, and from the second without MIS.
BRANCHES = {"no_nee": dict(nee=False), "no_mis": dict(mis=False),
            "rr_start_1": dict(rr_start=1),
            "rr_start_2_no_mis": dict(rr_start=2, mis=False)}


@pytest.mark.parametrize("name", ["cornell", "triangle"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_render_branches_match_reference(name, branch):
    """Per pixel, as test_render_matches_reference, at 16x16."""
    ref, jcam, port, cam = _both(name)
    small = dict(SMALL, width=16, height=16, **BRANCHES[branch])
    jfilm, jcount = j_render_with_stats(
        ref, jcam, jax.random.key(1), JRenderConfig(**small,
                                                    tracer="resident"))
    film, count = path.render_with_stats(port, cam, rng.key(1),
                                         path.RenderConfig(**small))
    got, want = film.mean().numpy(), np.asarray(jfilm.mean())
    if name == "triangle" and branch == "no_nee":
        # Lit by a directional light alone, which only NEE reaches.
        assert not want.any() and not got.any()
        assert int(count) == float(jcount) > 0
        return
    assert_render_agrees(got, want, int(count), float(jcount))


HELMET_CAM = dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                  fov_y=1.0)
# (reference builder, camera, render settings, reference tracer, port
# tracer).  On the CPU the reference's auto tracer takes its XLA block
# tracer, so the reference names its tracer: "pallas" is K1 in interpret
# mode.  helmet24: 1,152 triangles in 16 clusters (above the 512-triangle
# resident cutoff); helmet48 with max_u = 8: 4,608 triangles in 64
# clusters, the hierarchical candidate selection.
TEXTURED = {
    "helmet24": (lambda: jtypes.with_clusters(
        jproc.make_helmet_class_scene(24, 24)), HELMET_CAM,
        dict(width=16, height=16, spp=2, max_bounces=2), "pallas", "auto"),
    "helmet48": (lambda: jtypes.with_clusters(
        jproc.make_helmet_class_scene(48, 48)), HELMET_CAM,
        dict(width=16, height=16, spp=2, max_bounces=2, max_u=8), "pallas",
        "auto"),
    "cornell_ggx": (lambda: jtypes.with_clusters(jproc.make_cornell_box(
        metallic_tall_block=True, roughness=0.25, textured=True)),
        SCENES["cornell"][1], SMALL, "resident", "auto"),
    "furnace": (jproc.make_furnace_scene, HELMET_CAM,
                dict(width=16, height=16, spp=2, max_bounces=2), "brute",
                "brute"),
}


@pytest.mark.parametrize("name", sorted(TEXTURED))
def test_textured_render_matches_reference(name):
    build, cam_kw, small, j_tracer, tracer = TEXTURED[name]
    ref = build()
    jcam = JCamera.make(**cam_kw)
    jfilm, jcount = j_render_with_stats(
        ref, jcam, jax.random.key(0), JRenderConfig(**small, tracer=j_tracer))
    port = scene_from_numpy(scene_arrays(ref))
    if ref.clusters is not None:
        port = with_clusters(port)
    cfg = path.RenderConfig(**small, tracer=tracer)
    assert path._tracer(port, cfg) == ("pallas" if j_tracer == "pallas"
                                       else j_tracer)
    before = trace_blocks.LAUNCHES
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(0), cfg)
    assert trace_blocks.LAUNCHES == before          # CPU: plain versions
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                          int(count), float(jcount))


def test_helmet_golden_matches_fresh_reference_render():
    """The committed helmet_proc golden is what the reference renders
    today (full geometry, K1 in interpret mode)."""
    mod = golden_module()
    np.testing.assert_allclose(mod.render_helmet_golden(),
                               np.load(mod.HELMET["path"]), rtol=1e-5,
                               atol=1e-6)


def test_port_matches_helmet_golden_on_cpu():
    h = golden_module().HELMET
    bc = config.get(h["config"])
    scene, cam = config.build_scene(bc.scene, "cpu")
    assert scene.geometry.num_tris == 100_352
    assert scene.clusters.num_clusters == 1024
    cfg = dataclasses.replace(bc.render, width=h["size"], height=h["size"],
                              spp=h["spp"], max_bounces=h["bounces"])
    assert path._tracer(scene, cfg) == "pallas"
    film, _ = path.render_with_stats(scene, cam, rng.key(h["seed"]), cfg)
    assert_render_agrees(film.mean().numpy(), np.load(h["path"]))


def test_port_matches_helmet_glb_golden_on_cpu():
    """The full `helmet` config (the .glb asset at block 512) against the
    reference's golden; tests/test_torch_helmet.py checks the file against
    a fresh reference render."""
    h = golden_module().HELMET_GLB
    bc = config.get(h["config"])
    scene, cam = config.build_scene(bc.scene, "cpu")
    assert scene.geometry.num_tris == 99_400 and scene.tex_slots == (True,) * 4
    cfg = dataclasses.replace(bc.render, width=h["size"], height=h["size"],
                              spp=h["spp"], max_bounces=h["bounces"])
    assert cfg.block_size == 512 and path._tracer(scene, cfg) == "pallas"
    film, _ = path.render_with_stats(scene, cam, rng.key(h["seed"]), cfg)
    assert_render_agrees(film.mean().numpy(), np.load(h["path"]))


def test_brute_tracer_render_matches_resident():
    _, _, port, cam = _both("cornell")
    imgs = [path.render_with_stats(
        port, cam, rng.key(1), path.RenderConfig(**SMALL, tracer=t))[0].mean()
        for t in ("resident", "brute")]
    assert_render_agrees(imgs[1].numpy(), imgs[0].numpy())


def test_render_is_differentiable_and_equals_stats_render():
    _, _, port, cam = _both("cornell")
    cfg = path.RenderConfig(width=8, height=8, spp=1, max_bounces=1)
    albedo = port.materials.base_color_factor.clone().requires_grad_(True)
    scene = dataclasses.replace(port, materials=dataclasses.replace(
        port.materials, base_color_factor=albedo))
    img = path.render(scene, cam, rng.key(2), cfg).mean()
    img.sum().backward()
    assert torch.isfinite(albedo.grad).all() and albedo.grad.abs().sum() > 0
    stats_img = path.render_with_stats(port, cam, rng.key(2), cfg)[0].mean()
    np.testing.assert_array_equal(img.detach().numpy(), stats_img.numpy())


@pytest.mark.parametrize("change", [dict(exchange_axis="tiles",
                                         tracer="pallas")])
def test_unported_options_raise(change):
    """The ring exchange needs the mesh that render_sample_sharded binds,
    so outside it the block tracer's call raises ValueError (the
    reference's exchange_axis, likewise, names an axis of shard_map
    only)."""
    _, _, port, cam = _both("cornell")
    cfg = path.RenderConfig(width=4, height=4, spp=1, **change)
    with pytest.raises(ValueError):
        path.render_with_stats(with_clusters(port), cam, rng.key(0), cfg)


def test_golden_matches_fresh_reference_render():
    """The committed golden is what the reference renders today."""
    mod = golden_module()
    np.testing.assert_allclose(mod.render_golden(), np.load(mod.GOLDEN),
                               rtol=1e-5, atol=1e-6)


def test_port_matches_golden_on_cpu():
    mod = golden_module()
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, "cpu")
    cfg = dataclasses.replace(bc.render, width=mod.SIZE, height=mod.SIZE,
                              spp=mod.SPP, max_bounces=mod.BOUNCES)
    film, _ = path.render_with_stats(scene, cam, rng.key(mod.SEED), cfg)
    assert_render_agrees(film.mean().numpy(), np.load(mod.GOLDEN))


def test_cli_renders_on_cpu(tmp_path, capsys):
    out, hdr = tmp_path / "tri.png", tmp_path / "tri.npy"
    before = (resident.LAUNCHES, tonemap.LAUNCHES)
    assert render_app.main(["triangle", "-o", str(out), "--hdr-output",
                            str(hdr), "--width", "16", "--height", "12",
                            "--spp", "1", "--stats", "--device", "cpu"]) == 0
    assert (resident.LAUNCHES, tonemap.LAUNCHES) == before
    img = np.asarray(Image.open(out).convert("RGB"))
    assert img.shape == (12, 16, 3) and img.max() > 0
    assert np.load(hdr).shape == (12, 16, 3)
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["rays"] > 0


@pytest.mark.parametrize("argv", [["cornell", "--tiles", "2"],
                                  ["cornell", "--blinn-phong"],
                                  ["cornell", "--debug-checks"],
                                  ["scene.glb", "--tiles", "2"],
                                  ["helmet", "--blinn-phong", "--device",
                                   "cpu"]])
def test_cli_unported_paths_raise(argv, tmp_path, monkeypatch):
    """--blinn-phong and --debug-checks are not ported.  --tiles N without
    a launcher starts N local ranks that rerun the CLI (recorded here;
    tests/test_torch_sharding.py runs the ranks)."""
    from physically_based_renderer_tpu_torch.parallel import distributed
    argv = argv + ["-o", str(tmp_path / "x.png")]
    if "--tiles" not in argv:
        with pytest.raises(NotImplementedError):
            render_app.main(argv)
        return
    argv += ["--device", "cpu"]
    spawned = []
    monkeypatch.setattr(distributed, "spawn_local",
                        lambda *a: spawned.append(a) or 0)
    assert render_app.main(argv) == 0
    assert spawned == [("physically_based_renderer_tpu_torch.apps.render",
                        argv, 2, "gloo")]


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        render_app.main(["triangle", "-o", str(tmp_path / "x.png"),
                         "--device", "cuda"])


def test_package_imports_without_jax():
    """Import the package and its CLI, and render, with jax unimportable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                   'orbax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import physically_based_renderer_tpu_torch as p\n"
        "from physically_based_renderer_tpu_torch.apps import inverse, render\n"
        "from physically_based_renderer_tpu_torch.apps import report\n"
        "from physically_based_renderer_tpu_torch.tools import probe2\n"
        "from physically_based_renderer_tpu_torch.scene import helmet_asset\n"
        "from physically_based_renderer_tpu_torch.grad import edge\n"
        "from physically_based_renderer_tpu_torch.utils import checkpoint\n"
        "from physically_based_renderer_tpu_torch.utils import config\n"
        "s, c = config.build_scene(config.get('triangle').scene, 'cpu')\n"
        "cfg = p.RenderConfig(width=4, height=4, spp=1)\n"
        "f, n = p.render_with_stats(s, c, p.core.rng.key(0), cfg)\n"
        "assert int(n) > 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax',\n"
        "    'physically_based_renderer_tpu') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_names_no_reference_framework():
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax",
                 "physically_based_renderer_tpu"}
    for py in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(py.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in forbidden, f"{py}: {n}"
