"""The `cornell_ggx` configuration of the benchmark (BASELINE.json config 3:
the Cornell box with 8x8 albedo and metallic-roughness maps and a GGX
metal block, `benchmark/configs/cornell_ggx.json`): the port and the
benchmark's frozen plain reference (`benchmark/reference/pbr_plain`) build
the same scene, render the same K4 frame (plain version) and dense frame,
and take the same gradient step, bit for bit; the texture fetch counter
and the spans the configuration adds.  On the CPU, small sizes; imports no
JAX."""

import dataclasses
import importlib
import json
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import fused, texture
from physically_based_renderer_tpu_torch.utils import config

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "cornell_ggx.json").read_text())
CORNELL = json.loads((BENCH / "configs" / "cornell.json").read_text())
PORT = "physically_based_renderer_tpu_torch"
REF = "reference.pbr_plain"
PACKAGES = (PORT, REF)
CFG = dict(width=16, height=12, spp=2, max_bounces=3)
KEYS = ((0, 7), (2**31 + 5, 11))


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _build(pkg, conf=CONFIG):
    return importlib.import_module("harness.scenes").build(pkg, conf, "cpu")


def _cfg(pkg, **over):
    return _m(pkg, "integrator.path").RenderConfig(**{**CFG, **over})


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One torch thread; the benchmark's folder on sys.path (its harness
    and the reference)."""
    monkeypatch.syspath_prepend(str(BENCH))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(obj, prefix=""):
    """(name, value) of every leaf of a dataclass tree."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    else:
        yield prefix, obj


def _assert_same_leaves(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(y, torch.Tensor):
            assert (x.dtype, x.shape) == (y.dtype, y.shape), name
            assert torch.equal(x, y), name
        else:
            assert x == y, name


def test_config_is_the_preset_as_the_port_names_it():
    """The configuration file's scene, camera and frame are the port's
    named preset `cornell_ggx` (utils/config.py) with nothing cut."""
    bc = config.get("cornell_ggx")
    scene, cam = config.build_scene(bc.scene, "cpu")
    got, got_cam = _build(PORT)
    _assert_same_leaves(got, scene)
    _assert_same_leaves(got_cam, cam)
    r = CONFIG["render"]
    assert (r["width"], r["height"], r["spp"], r["max_bounces"]) == (
        bc.render.width, bc.render.height, bc.render.spp,
        bc.render.max_bounces)
    assert CONFIG["reduced"] == [] and CONFIG["camera"] == CORNELL["camera"]


def test_port_and_reference_build_the_same_scene_leaf_for_leaf():
    (scene, cam), (ref, ref_cam) = (_build(p) for p in PACKAGES)
    _assert_same_leaves(scene, ref)
    _assert_same_leaves(cam, ref_cam)
    assert scene.has_textures and scene.tex_slots[:2] == (True, True)
    assert float(scene.materials.metallic_factor.max()) == 1.0
    assert fused.fused_applicable(scene, path.RenderConfig(**CONFIG["render"]))


@pytest.mark.parametrize("key", KEYS)
def test_k4_plain_frame_equals_the_reference(key):
    """K4's plain version on the textured GGX box: film and ray count."""
    out = []
    for pkg in PACKAGES:
        scene, cam = _build(pkg)
        f = _m(pkg, "ops.fused")
        frame = f.fused_frame(scene, cam, torch.tensor(key), _cfg(pkg))
        assert frame.textured
        out.append(f.fused_plain(frame))
    (hdr, count), (hdr_r, count_r) = out
    assert torch.isfinite(hdr).all() and float(hdr.mean()) > 0.0
    assert torch.equal(hdr, hdr_r) and int(count) == int(count_r)


@pytest.mark.parametrize("key", KEYS)
def test_dense_textured_frame_equals_the_reference(key):
    out = []
    for pkg in PACKAGES:
        scene, cam = _build(pkg)
        film, count = _m(pkg, "integrator.path").render_with_stats(
            scene, cam, torch.tensor(key), _cfg(pkg, tracer="resident"))
        out.append((film.hdr, int(count)))
    (hdr, count), (hdr_r, count_r) = out
    assert torch.isfinite(hdr).all() and float(hdr.mean()) > 0.0
    assert torch.equal(hdr, hdr_r) and count == count_r


def test_train_step_equals_the_reference():
    """One Adam step over base colour and emissive (the fit mix's fields):
    loss, gradient and update bit for bit, both sides running the same
    plain ops in the same order."""
    out = []
    for pkg in PACKAGES:
        inverse = _m(pkg, "grad.inverse")
        p = _m(pkg, "integrator.path")
        scene, cam = _build(pkg)
        cfg = _cfg(pkg)
        with torch.no_grad():
            target = p.render(scene, cam, torch.tensor([0, 9]), cfg).mean()
        params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
            scene, base_color=True, emissive=True))
        before = {n: v.detach().clone() for n, v in params.items()}
        opt = torch.optim.Adam(params.leaves(), lr=0.05)
        step = inverse.make_train_step(scene, cam, cfg, opt)
        params, _, loss = step(params, None, torch.tensor([3, 4]), target)
        out.append((float(loss),
                    {n: v.grad.clone() for n, v in params.items()},
                    {n: v.detach() - before[n] for n, v in params.items()}))
    (loss, grad, moved), (loss_r, grad_r, moved_r) = out
    assert loss == loss_r and loss > 0.0
    assert set(grad) == set(grad_r) == {"base_color_factor",
                                        "emissive_factor"}
    for n in grad:
        assert torch.equal(grad[n], grad_r[n]), n
        assert float(grad[n].abs().max()) > 0.0, n
        assert torch.equal(moved[n], moved_r[n]), n


def _counted_frame(conf, monkeypatch):
    """A dense frame of `conf`'s scene -> (shading calls, `_fetch_level`
    calls)."""
    scene, cam = _build(PORT, conf)
    calls = []
    real = path.shade_surface

    def shade(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(path, "shade_surface", shade)
    texture.FETCHES = 0
    path.render_with_stats(scene, cam, torch.tensor([0, 5]),
                           path.RenderConfig(**CFG, tracer="resident"))
    return len(calls), texture.FETCHES


@pytest.mark.parametrize("conf,per_call", [(CONFIG, 2), (CORNELL, 0)],
                         ids=["cornell_ggx", "cornell"])
def test_fetches_two_levels_a_shading_call(conf, per_call, monkeypatch):
    """Base colour and metallic-roughness, one level each (MIP_NONE): two
    `_fetch_level` calls a shading call; none on the untextured box."""
    shaded, fetches = _counted_frame(conf, monkeypatch)
    assert shaded == CFG["spp"] * (CFG["max_bounces"] + 1)
    assert fetches == per_call * shaded


def _span_names(conf):
    """Names of the `pbr.*` spans in a dense frame and a K4 frame's
    packing of `conf`'s scene, recorded by torch.profiler."""
    scene, cam = _build(PORT, conf)
    cfg = path.RenderConfig(**CFG, tracer="resident")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        path.render_with_stats(scene, cam, torch.tensor([0, 5]), cfg)
        fused.fused_frame(scene, cam, torch.tensor([0, 5]), cfg)
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU
            and e.name().startswith("pbr.")}


@pytest.mark.parametrize("conf,present", [(CONFIG, True), (CORNELL, False)],
                         ids=["cornell_ggx", "cornell"])
def test_texture_spans_only_where_textures_are(conf, present):
    names = _span_names(conf)
    assert "pbr.k4.pack" in names and "pbr.frame" in names
    assert ("pbr.texture" in names) is present
    assert ("pbr.k4.pack.tex" in names) is present


def test_texture_spans_nest_once_and_change_nothing():
    """`pbr.texture` never sits inside another (outermost calls only), one
    span a slot fetch; `pbr.k4.pack.tex` once inside `pbr.k4.pack`; the
    frame and the tables are the same with the profiler off."""
    scene, cam = _build(PORT)
    cfg = path.RenderConfig(**CFG, tracer="resident")
    key = torch.tensor([0, 5])

    def run():
        texture.FETCHES = 0
        film, count = path.render_with_stats(scene, cam, key, cfg)
        return film.hdr, int(count), fused.fused_frame(scene, cam, key, cfg)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    fetches = texture.FETCHES
    off = run()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]

    def spans(name):
        return [(a, b) for n, a, b in events if n == name]

    tex = spans("pbr.texture")
    assert len(tex) == fetches > 0
    assert not [s for s in tex for o in tex
                if s != o and o[0] <= s[0] and s[1] <= o[1]]
    pack, pack_tex = spans("pbr.k4.pack"), spans("pbr.k4.pack.tex")
    assert len(pack) == len(pack_tex) == 1
    assert pack[0][0] <= pack_tex[0][0] and pack_tex[0][1] <= pack[0][1]
    assert torch.equal(on[0], off[0]) and on[1] == off[1]
    for f in dataclasses.fields(fused.FusedFrame):
        x, y = getattr(on[2], f.name), getattr(off[2], f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name
