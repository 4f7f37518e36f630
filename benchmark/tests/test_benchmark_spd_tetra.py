"""The cell `spd_tetra.frame` on the CPU at a reduced scale: it runs through
its loop (`loops/frames_generated.py`) and comes out correct, a fault
planted under it or the control does not, a program without the scene's
function fails before its kernels load; its three readers, on hand-built
stretches and where their span or work is absent; and the files that the
earlier cells use are as they were."""

import contextlib
import dataclasses
import functools
import hashlib
import importlib
import time

import pytest
import torch

from harness import bench, port, runner, scenes, trace
from harness.trace import Stretch

import calibrate
import faults

NAME = "spd_tetra.frame"
SCALE = {"width": 24, "height": 16, "spp": 2}
SEED = 2**33 + 17
MS = 1_000_000      # ns
READERS = ("k1_roofline", "trace.phase_a_ms", "trace.k1_ms")

# sha256 over (path, sha256 of the file) of each group, in path order, as
# the cells before spd_tetra.frame left them.
FROZEN = {
    "the frames loop": (
        ["loops/frames.py"],
        "8bf6ec52986db66b165adefa436359e689da4c97d08517ab65aea99b679e80ed"),
    "the other cells' files": (
        ["configs/cornell.json", "traffic/frame.json", "traffic/fit.json",
         "limits/cornell.frame.json", "limits/cornell.fit.json",
         "loops/fit.py"],
        "99010111e3a764b456fddda9db3619d20cc83662ef2a643ece8fe71fd53afdf5"),
    "the harness": (
        ["harness/*.py"],
        "3badd18f14c9b37202f8630ee882d7a2b6a878887c7eb9327a1dc32f17305338"),
    "the frozen reference": (
        ["reference/pbr_plain/**/*.py"],
        "0c5b8df99f05b3917498466707a280c1ff03485b80976e8aaea17be7c93a3e16"),
    "the accepted metrics": (
        ["metrics/device.*.py", "metrics/dispatch.*.py", "metrics/k[245]*.py",
         "metrics/rng.*.py", "metrics/step.*.py"],
        "347db6c145a09f0818c2f3a98c7ba53d85e176685d87f7d5cfce54c246b48f81"),
    "the counters, faults and entry points": (
        ["run.py", "calibrate.py", "faults.py", "work/*.py"],
        "3b9aaa4a0ad79fd1fec0afa0ab3cc84bf965dd025e2b500503d6278f116c5dfe"),
}


def _cell():
    cell = bench.load_cell(NAME)
    mix = dict(cell.traffic)
    mix.update(warm_units=1, profile={"first": 1, "units": 2})
    return dataclasses.replace(cell, traffic=mix)


def _run(trace_on=False, program=contextlib.nullcontext, seconds=0.0):
    torch.set_num_threads(2)
    ctx = runner.Context(cell=_cell(), seed=SEED, device=torch.device("cpu"),
                         tracer=trace.Tracer(trace_on, port.counters),
                         spans={}, scale=SCALE)
    return runner.execute(ctx, time.perf_counter(), seconds, program)


def _reference_procedural():
    return importlib.import_module(f"{scenes.REFERENCE}.scene.procedural")


def test_the_cell_names_its_files():
    cell = bench.load_cell(NAME)
    assert cell.chips == 1 and cell.traffic["loop"] == "frames_generated"
    assert cell.config["scene"]["function"] == "make_spd_tetra"
    assert cell.config["reduced"] == []
    assert set(cell.limits) == {"hdr_off_pct", "ldr_off_pct"}
    assert {m["name"] for m in cell.end_to_end} == {
        "frame_ms", "frame_p95_ms", "setup_s"}
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    assert {"dispatch.launches_per_frame", "device.idle_pct.frame",
            "device.idle_in_program_pct.frame"} <= {
                m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("trace_on", (False, True))
def test_a_sound_run_is_correct(trace_on):
    """The program's frames against the reference's, which builds its scene
    from `reference/spd_tetra.py`; on the CPU no device operation runs, so
    of the three new readers only the spans read."""
    out = _run(trace_on)
    assert out["correct"] is True, out["checks"]
    for c in out["checks"].values():
        assert 0.0 <= c["value"] <= c["limit"]
    metrics = out["metrics"]
    if trace_on:
        assert metrics["trace.phase_a_ms"]["value"] > 0.0
        assert metrics["trace.k1_ms"]["value"] > 0.0
        assert "k1_roofline" not in metrics
    else:
        assert set(metrics) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert not hasattr(_reference_procedural(), "make_spd_tetra")


@pytest.mark.parametrize("kind", faults.FAULTS)
def test_a_planted_fault_is_not_correct(kind):
    out = _run(program=functools.partial(faults.frames, kind), seconds=0.5)
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct():
    out = _run(program=calibrate.control)
    assert out["correct"] is False, out["checks"]


def _altered_at(bad):
    """Frames rendered from another key at the calls (1, 2, ...) for which
    `bad(call)` holds."""
    @contextlib.contextmanager
    def planted():
        path = port.module("integrator.path")
        real, calls = path.render_with_stats, [0]

        def render(scene, camera, key, cfg):
            calls[0] += 1
            if bad(calls[0]):
                key = faults._other_key(key)
            return real(scene, camera, key, cfg)
        path.render_with_stats = render
        try:
            yield
        finally:
            path.render_with_stats = real
    return planted


def test_a_fault_of_the_window_alone_is_not_correct():
    """Frames that go wrong only after set-up's warm frames fail the check;
    a fault in the warm frames alone, which the window never shows, does
    not."""
    warm = _cell().traffic["warm_units"]
    late = _run(program=_altered_at(lambda call: call > warm), seconds=0.5)
    assert late["correct"] is False, late["checks"]
    early = _run(program=_altered_at(lambda call: call <= warm),
                 seconds=0.5)
    assert early["correct"] is True, early["checks"]


def test_a_program_without_the_scene_fails_before_its_kernels_load(
        monkeypatch):
    """As the tree before spd_tetra does: set-up stops at the missing
    function, before the kernel library."""
    procedural = port.module("scene.procedural")
    monkeypatch.delattr(procedural, "make_spd_tetra")
    loads = []
    monkeypatch.setattr(port, "load_kernels", loads.append)
    with pytest.raises(AttributeError, match="make_spd_tetra"):
        _run()
    assert loads == []
    assert not hasattr(_reference_procedural(), "make_spd_tetra")


# -- the readers -------------------------------------------------------------

def _stretch(host_ops=(), device_ops=(), units=2, t1=100 * MS):
    return Stretch(units=units, window_s=t1 / 1e9,
                   device_ops=sorted(device_ops, key=lambda e: e[1]),
                   launches=len(device_ops),
                   host_ops=sorted(host_ops, key=lambda e: e[1]),
                   t0=0, t1=t1, counters={})


def _read(name, stretch, work=None):
    readings = runner.Readings(stretch=stretch, work=work or {}, spans={})
    return bench.metric_reader(name).read(readings)


K1 = "void (anonymous namespace)::trace_blocks_kernel<false, 2>(int const*)"


def test_k1_roofline_is_the_bound_over_the_device_time():
    # Two frames of two K1 launches: 4 + 6 ms, then 2 + 8 ms on the card.
    dev = [(K1, 0, 4 * MS), (K1, 10 * MS, 16 * MS), ("other", 20 * MS,
                                                      30 * MS),
           (K1, 40 * MS, 42 * MS), (K1, 50 * MS, 58 * MS)]
    work = {"k1": {0: [1e-3, 2e-3], 1: [0.5e-3, 1.5e-3]}}
    assert _read("k1_roofline", _stretch(device_ops=dev), work) == (
        pytest.approx(100.0 * 5e-3 / 20e-3))
    # The reference counted another number of calls than the card made.
    assert _read("k1_roofline", _stretch(device_ops=dev),
                 {"k1": {0: [1e-3], 1: [1e-3]}}) is None


def test_the_span_readers_read_their_span_per_frame():
    host = [("pbr.trace.phase_a", 10 * MS, 14 * MS),
            ("pbr.trace.k1", 14 * MS, 15 * MS),
            ("pbr.trace.phase_a", 30 * MS, 36 * MS),
            ("pbr.trace.k1", 36 * MS, 39 * MS)]
    s = _stretch(host)
    assert _read("trace.phase_a_ms", s) == pytest.approx(10 / 2)
    assert _read("trace.k1_ms", s) == pytest.approx(4 / 2)


def test_the_readers_return_none_where_their_span_or_work_is_absent():
    """As on the tree before the spans, or a frame that takes K4."""
    k4_frame = _stretch([("pbr.frame", 0, 50 * MS),
                         ("pbr.k4.pack", 1 * MS, 3 * MS)],
                        [("fused_kernel", 5 * MS, 9 * MS)])
    no_k1_work = _stretch(device_ops=[(K1, 0, MS), (K1, 2 * MS, 3 * MS)])
    for name in READERS:
        assert _read(name, None) is None, name
        assert _read(name, k4_frame) is None, name
        assert _read(name, _stretch()) is None, name
    assert _read("k1_roofline", no_k1_work) is None
    assert _read("k1_roofline", no_k1_work, {"k2": {0: [1e-3]}}) is None


# -- the earlier cells' files -------------------------------------------------

@pytest.mark.parametrize("group", sorted(FROZEN))
def test_the_earlier_cells_files_are_unchanged(group):
    patterns, want = FROZEN[group]
    h = hashlib.sha256()
    files = sorted({p for pat in patterns for p in bench.HERE.glob(pat)})
    assert files, group
    for p in files:
        h.update(str(p.relative_to(bench.HERE)).encode() + b"\0")
        h.update(hashlib.sha256(p.read_bytes()).digest())
    assert h.hexdigest() == want, [str(p.relative_to(bench.HERE))
                                   for p in files]
