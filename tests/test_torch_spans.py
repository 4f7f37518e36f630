"""The port's profiler spans (`utils/profiling.py::span`): a shared no-op
with no profiler, `record_function` under one; where each sits in a
Cornell frame and a Cornell gradient step; and that they change no
output.  All on the CPU; imports no JAX."""

import dataclasses
import json
from unittest import mock

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import EventList, FunctionEvent
from torch.profiler import ProfilerActivity, profile

from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import Camera
from physically_based_renderer_tpu_torch.grad import inverse
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import fused, tonemap
from physically_based_renderer_tpu_torch.scene import procedural, types
from physically_based_renderer_tpu_torch.tools import timing
from physically_based_renderer_tpu_torch.utils import config, profiling

CPU = torch.device("cpu")
FIT_CFG = path.RenderConfig(width=16, height=16, spp=4, max_bounces=4)
FRAME_CFG = path.RenderConfig(width=16, height=12, spp=2, max_bounces=3)


def _cornell():
    scene = types.upload_scene(
        types.with_clusters(procedural.make_cornell_box()), CPU)
    cam = types.upload_scene(Camera.make(
        position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0), fov_y=0.95), CPU)
    return scene, cam


def _profiled(fn):
    """fn() under torch.profiler (CPU activity) -> (its result, the host
    events as (name, start_ns, end_ns), sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CPU), key=lambda x: x[1])
    return out, events


def _spans(events, name):
    return [(a, b) for n, a, b in events if n == name]


def _inside(iv, outer):
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


def _fit_step(profiled: bool, size: int = 16, key: int = 2**31 - 5):
    """One Adam step of the two-field Cornell fit from a fixed start, at
    size x size -> (loss, {field: (leaf, grad, exp_avg, exp_avg_sq)},
    events or None)."""
    scene, cam = _cornell()
    cfg = dataclasses.replace(FIT_CFG, width=size, height=size)
    with torch.no_grad():
        target = path.render(scene, cam, rng.key(7),
                             dataclasses.replace(cfg, spp=8)).mean()
    params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
        scene, base_color=True, emissive=True))
    opt = torch.optim.Adam(params.leaves(), lr=0.05)
    step = inverse.make_train_step(scene, cam, cfg, opt)

    def run():
        return step(params, None, rng.key(key), target)

    if profiled:
        (params, _, loss), events = _profiled(run)
    else:
        (params, _, loss), events = run(), None
    state = {name: (leaf.detach().clone(), leaf.grad.clone(),
                    opt.state[leaf]["exp_avg"].clone(),
                    opt.state[leaf]["exp_avg_sq"].clone())
             for name, leaf in params.items()}
    return loss, state, events


@pytest.fixture(scope="module")
def fit_steps():
    return _fit_step(True), _fit_step(False)


def test_span_without_a_profiler_is_the_shared_noop():
    with mock.patch.object(torch.profiler, "record_function") as rf:
        a, b = profiling.span("pbr.a"), profiling.span("pbr.b")
        with a:
            pass
        rng.ray_uniform(rng.ray_keys(rng.key(3), torch.arange(4)), 1, 2, 2)
    assert a is b is profiling._OFF
    rf.assert_not_called()


def test_the_program_enters_no_record_function_without_a_profiler():
    scene, cam = _cornell()
    cfg = dataclasses.replace(FRAME_CFG, width=8, height=8, spp=1,
                              max_bounces=1)
    params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
        scene, base_color=True))
    step = inverse.make_train_step(scene, cam, cfg,
                                   torch.optim.Adam(params.leaves()))
    with mock.patch.object(torch.profiler, "record_function",
                           side_effect=AssertionError("entered")):
        film, _ = path.render_with_stats(scene, cam, rng.key(1), cfg)
        tonemap.tonemap(film.mean().contiguous())
        fused.fused_frame(scene, cam, rng.key(1), cfg)
        step(params, None, rng.key(2), torch.zeros(8, 8, 3))


def test_span_under_a_profiler_is_recorded():
    def run():
        with profiling.span("pbr.test"):
            return torch.ones(3) + 1

    _, events = _profiled(run)
    assert len(_spans(events, "pbr.test")) == 1


def test_fit_step_spans_nest(fit_steps):
    (_, _, events), _ = fit_steps
    step = _spans(events, "pbr.step")
    fwd = _spans(events, "pbr.step.forward")
    bwd = _spans(events, "pbr.step.backward")
    rngs = _spans(events, "pbr.rng")
    assert len(step) == len(fwd) == len(bwd) == 1
    assert _inside(fwd[0], step) and _inside(bwd[0], step)
    assert fwd[0][1] <= bwd[0][0]
    assert rngs and all(_inside(iv, fwd) for iv in rngs)
    # Outermost calls only: no pbr.rng inside another.
    for (_, b), (a, _) in zip(rngs, rngs[1:]):
        assert b <= a


def _rng_ops(events):
    """Top-level aten operators (no other aten operator encloses them)
    that start and end inside a pbr.rng span."""
    rngs = _spans(events, "pbr.rng")
    aten = sorted(((a, -b) for n, a, b in events if n.startswith("aten::")))
    count, reach = 0, -1
    for a, neg_b in aten:
        if -neg_b <= reach:
            continue
        reach = -neg_b
        count += _inside((a, reach), rngs)
    return count


def test_fit_step_rng_ops_count(fit_steps):
    """The count `rng.ops_per_step` reads is one number a step: the same
    at two image sizes and under two keys (PERF.md records it)."""
    (_, _, events), _ = fit_steps
    count = _rng_ops(events)
    assert count > 0
    assert _rng_ops(_fit_step(True, key=12345)[2]) == count
    assert _rng_ops(_fit_step(True, size=8)[2]) == count


@pytest.mark.parametrize("flagged", [True, False])
def test_kernels_leave_out_the_spans_device_side(fit_steps, flagged):
    """On the card every span also gets a device-side annotation over the
    kernels launched inside it; `tools/timing.py::kernels`, which
    chip_smoke's profiled phases and `device_ms` read, keeps the kernels
    alone (also where a torch build does not flag the annotation).  The
    step's own spans, given device twins, over two kernels."""
    (_, _, events), _ = fit_steps
    spans = [(n, a, b) for n, a, b in events if n.startswith("pbr.")]
    t0 = spans[0][1]
    kernels = [("k_a", t0 + 1000, t0 + 3000), ("k_a", t0 + 4000, t0 + 5000),
               ("k_b", t0 + 6000, t0 + 8000)]
    device = EventList([
        FunctionEvent(i, n, 1, (a - t0) / 1e3, (b - t0) / 1e3, stack=[],
                      use_device="cuda", device_type=DeviceType.CUDA,
                      is_user_annotation=flagged and n.startswith("pbr."))
        for i, (n, a, b) in enumerate(spans + kernels)], use_device="cuda")
    device._build_tree()
    got = timing.kernels(device.key_averages())
    assert sorted((e.key, e.count) for e in got) == [("k_a", 2), ("k_b", 1)]
    assert sum(e.self_device_time_total for e in got) == pytest.approx(5.0)


def test_fit_step_is_bit_equal_with_the_profiler_on_and_off(fit_steps):
    (loss_on, on, _), (loss_off, off, _) = fit_steps
    assert torch.equal(loss_on, loss_off)
    assert on.keys() == off.keys()
    for name in on:
        for x, y in zip(on[name], off[name]):
            assert torch.equal(x, y), name


def test_frame_spans_and_outputs():
    scene, cam = _cornell()
    key = rng.key(11)

    def frame():
        film, count = path.render_with_stats(scene, cam, key, FRAME_CFG)
        ldr = tonemap.tonemap(film.mean().contiguous())
        return film.hdr, int(count), ldr, fused.fused_frame(
            scene, cam, key, FRAME_CFG)

    on, events = _profiled(frame)
    off = frame()
    for name in ("pbr.frame", "pbr.tonemap", "pbr.k4.seeds", "pbr.k4.pack"):
        assert len(_spans(events, name)) == 1, name
    seeds = _spans(events, "pbr.k4.seeds")
    assert [iv for iv in _spans(events, "pbr.rng") if _inside(iv, seeds)]
    assert torch.equal(on[0], off[0]) and on[1] == off[1]
    assert torch.equal(on[2], off[2])
    for f in dataclasses.fields(fused.FusedFrame):
        x, y = getattr(on[3], f.name), getattr(off[3], f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name


def test_block_tracer_spans_and_outputs():
    """A dense frame of the spd_tetra config (1,024 triangles, so the block
    tracer): each tracer call is one `pbr.trace.phase_a` followed by one
    `pbr.trace.k1`, inside `pbr.frame`; the frame is the same with the
    profiler off."""
    scene, cam = config.build_scene(config.get("spd_tetra").scene, CPU)
    cfg = path.RenderConfig(width=8, height=8, spp=1, max_bounces=1)

    def frame():
        film, count = path.render_with_stats(scene, cam, rng.key(3), cfg)
        return film.hdr, int(count)

    on, events = _profiled(frame)
    off = frame()
    phase_a = _spans(events, "pbr.trace.phase_a")
    k1 = _spans(events, "pbr.trace.k1")
    # per sample: (bounces + 1) closest-hit calls + bounces env shadow calls
    assert len(phase_a) == len(k1) == cfg.spp * (2 * cfg.max_bounces + 1)
    for (a0, a1), (k0, k1_end) in zip(phase_a, k1):
        assert a1 <= k0
    assert all(_inside(iv, _spans(events, "pbr.frame")) for iv in k1)
    assert torch.equal(on[0], off[0]) and on[1] == off[1]


def test_device_trace_writes_the_spans(tmp_path):
    with profiling.device_trace(tmp_path):
        tonemap.tonemap(torch.full((4, 4, 3), 0.5))
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "pbr.tonemap" for e in trace["traceEvents"])


def test_timed_logs_its_section(caplog):
    with caplog.at_level("INFO", logger="pbr_torch"):
        with profiling.timed("section", sync=False):
            pass
    assert any(r.getMessage().startswith("section: ")
               for r in caplog.records)
