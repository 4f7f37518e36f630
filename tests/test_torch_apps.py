"""The port's CLIs on glTF files, on the CPU: render and inverse by path,
broken files, and the scene report against the reference's."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from physically_based_renderer_tpu.apps import render as j_render_app
from physically_based_renderer_tpu.apps import report as j_report_app
from physically_based_renderer_tpu_torch.apps import inverse as inverse_app
from physically_based_renderer_tpu_torch.apps import render as render_app
from physically_based_renderer_tpu_torch.apps import report as report_app
from physically_based_renderer_tpu_torch.core import film
from physically_based_renderer_tpu_torch.ops import (gather, tonemap,
                                                     trace_blocks)
from physically_based_renderer_tpu_torch.scene import helmet_asset
from physically_based_renderer_tpu_torch.tools import probe2
from test_asset_golden import _author_asset
from torch_parity import MEAN_REL, PIXEL_FRAC, render_agreement

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def helmet_glb(tmp_path_factory):
    return helmet_asset.cached_helmet_glb(tmp_path_factory.mktemp("glb"),
                                          0.02)


@pytest.fixture(scope="module")
def asset_glb(tmp_path_factory):
    """The three-mesh asset of tests/test_asset_golden.py, written by the
    reference's exporter (PIL-encoded textures)."""
    p = tmp_path_factory.mktemp("asset") / "scene.glb"
    _author_asset(p)
    return p


def test_render_cli_on_a_glb_path(helmet_glb, tmp_path, capsys):
    """The small helmet by path through both packages' CLIs: the file's
    default camera, the default RenderConfig, the cluster grid (1,880
    triangles: the block tracer).  The file has no sky, so only the visor's
    thin emissive strips light the frame; the images are compared per
    pixel."""
    out, hdr, jhdr = (tmp_path / n for n in ("h.png", "h.npy", "j.npy"))
    size = ["--width", "32", "--height", "28", "--spp", "2"]
    before = (trace_blocks.LAUNCHES, gather.LAUNCHES_FWD, tonemap.LAUNCHES)
    rc = render_app.main([str(helmet_glb), "-o", str(out), "--hdr-output",
                          str(hdr), "--stats", "--device", "cpu"] + size)
    assert rc == 0
    assert (trace_blocks.LAUNCHES, gather.LAUNCHES_FWD,
            tonemap.LAUNCHES) == before          # CPU: plain versions
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["rays"] > 0
    img = np.asarray(Image.open(out))
    assert img.shape == (28, 32, 3)
    np.testing.assert_array_equal(film.read_png(out.read_bytes())[..., :3],
                                  img)
    assert j_render_app.main([str(helmet_glb), "-o", str(tmp_path / "j.png"),
                              "--hdr-output", str(jhdr)] + size) == 0
    radiance, want = np.load(hdr), np.load(jhdr)
    assert np.isfinite(radiance).all() and want.max() > 0
    frac, n_bad = render_agreement(radiance, want)
    assert frac >= PIXEL_FRAC, n_bad
    assert abs(radiance.mean() / want.mean() - 1.0) <= MEAN_REL


def test_render_cli_reads_a_reference_written_glb(asset_glb, tmp_path):
    out = tmp_path / "a.png"
    assert render_app.main([str(asset_glb), "-o", str(out), "--width", "16",
                            "--height", "16", "--spp", "1", "--bounces", "1",
                            "--device", "cpu"]) == 0
    assert np.asarray(Image.open(out)).sum() > 0


@pytest.mark.parametrize("keep", [0, 10, 700, 0.5, 0.99])
def test_render_cli_returns_2_on_a_broken_file(helmet_glb, keep, tmp_path,
                                               capsys):
    data = helmet_glb.read_bytes()
    n = keep if isinstance(keep, int) else int(len(data) * keep)
    bad = tmp_path / "bad.glb"
    bad.write_bytes(data[:n])
    rc = render_app.main([str(bad), "-o", str(tmp_path / "x.png"),
                          "--device", "cpu"])
    assert rc == 2
    assert capsys.readouterr().err.startswith("error: ")
    assert not (tmp_path / "x.png").exists()


def test_render_cli_returns_2_on_a_missing_file(tmp_path, capsys):
    rc = render_app.main([str(tmp_path / "none.glb"), "-o",
                          str(tmp_path / "x.png"), "--device", "cpu"])
    assert rc == 2 and "no such file" in capsys.readouterr().err


def test_inverse_cli_on_a_glb_path(asset_glb, tmp_path, capsys):
    """As the reference's CLI: the file's scene and camera, no cluster grid
    (388 triangles: the resident tracer)."""
    rep = tmp_path / "rep.json"
    assert inverse_app.main(["--scene", str(asset_glb), "--params",
                             "emissive", "--steps", "2", "--size", "12",
                             "--spp", "1", "--bounces", "1", "--device",
                             "cpu", "--report", str(rep)]) == 0
    report = json.loads(rep.read_text())
    assert len(report["losses"]) == 2 and np.isfinite(report["losses"]).all()
    assert set(report["final_error"]) == {"emissive_factor"}
    capsys.readouterr()


@pytest.mark.parametrize("which", ["asset", "helmet"])
def test_report_matches_the_reference(which, asset_glb, helmet_glb, tmp_path,
                                      capsys):
    glb = asset_glb if which == "asset" else helmet_glb
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    assert report_app.main([str(glb), "--json", str(a), "--html",
                            str(tmp_path / "r.html")]) == 0
    out = capsys.readouterr().out
    assert j_report_app.main([str(glb), "--json", str(b)]) == 0
    jout = capsys.readouterr().out
    port, ref = json.loads(a.read_text()), json.loads(b.read_text())
    assert port["tree"] == ref["tree"] and port["stats"] == ref["stats"]
    assert port["graph_name"] == ref["graph_name"]
    strip = lambda text: [ln for ln in text.splitlines()
                          if not ln.startswith("wrote ")]
    assert strip(out) == strip(jout)
    page = (tmp_path / "r.html").read_text()
    assert page.startswith("<!doctype html>") and "DefaultCamera" in page
    if which == "asset":
        for name in ("sphere", "floor", "panel"):
            assert any(name in ln for ln in port["tree"])
        assert port["stats"]["triangles"] == 12 * 16 * 2 + 4
        assert port["stats"]["materials"] == 3


def test_report_builtin_config_and_render(tmp_path, capsys):
    rep = tmp_path / "r.json"
    assert report_app.main(["triangle", "--render", "--spp", "1", "--device",
                            "cpu", "--json", str(rep)]) == 0
    report = json.loads(rep.read_text())
    assert report["stats"]["triangles"] == 1
    assert report["stats"]["directional_light"] is True
    assert report["tree"] == ["- triangle (procedural builtin; no node tree)"]
    perf = report["perf"]
    assert perf["backend"] == "cpu" and perf["spp"] == 1
    assert perf["frame_ms"] > 0 and perf["rays_per_s"] > 0
    assert "ms/frame" in capsys.readouterr().out


def test_report_returns_2_on_a_broken_file(tmp_path, capsys):
    assert report_app.main([str(tmp_path / "none.glb")]) == 2
    bad = tmp_path / "bad.gltf"
    bad.write_text("{")
    assert report_app.main([str(bad)]) == 2
    assert "error: " in capsys.readouterr().err


def test_entry_points_need_a_card_unless_told_cpu(helmet_glb, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_app.main([str(helmet_glb), "-o", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        report_app.main(["triangle", "--render"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe2.main(["relayout"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inverse_app.main(["--scene", str(helmet_glb), "--steps", "1"])
