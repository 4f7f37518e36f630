"""The readers of the program's spans (`harness/spans.py`, the metrics
that read `pbr.*` spans): on hand-built stretches, and on a CPU traced
run of each cell."""

import pytest
from helpers import CELLS, run_tiny

from harness import bench, runner, spans
from harness.trace import Stretch

MS = 1_000_000      # ns

SPAN_METRICS = {
    "cornell.frame": ("k4.seeds_ms", "k4.pack_ms",
                      "device.idle_in_program_pct.frame"),
    "cornell.fit": ("step.forward_ms", "step.backward_ms",
                    "rng.ms_per_step", "rng.ops_per_step",
                    "device.idle_in_program_pct.fit"),
}


def _stretch(host_ops, device_ops=(), units=2, t0=0, t1=100 * MS):
    return Stretch(units=units, window_s=(t1 - t0) / 1e9,
                   device_ops=sorted(device_ops, key=lambda e: e[1]),
                   launches=len(device_ops),
                   host_ops=sorted(host_ops, key=lambda e: e[1]),
                   t0=t0, t1=t1, counters={})


def _read(name, stretch):
    readings = runner.Readings(stretch=stretch, work={}, spans={})
    return bench.metric_reader(name).read(readings)


# A step: forward [10, 60] ms with two pbr.rng calls, backward [60, 95].
STEP = [("pbr.step", 5 * MS, 98 * MS),
        ("pbr.step.forward", 10 * MS, 60 * MS),
        ("pbr.rng", 12 * MS, 20 * MS),
        ("pbr.rng", 30 * MS, 40 * MS),
        ("pbr.step.backward", 60 * MS, 95 * MS),
        ("aten::add", 13 * MS, 15 * MS),          # top-level, in pbr.rng
        ("aten::empty", 13 * MS, 14 * MS),        # inside aten::add
        ("aten::bitwise_and", 16 * MS, 17 * MS),  # top-level, in pbr.rng
        ("aten::mul", 19 * MS, 22 * MS),          # crosses pbr.rng's end
        ("Optimizer.step", 30 * MS, 36 * MS),     # not an aten operator
        ("aten::copy_", 31 * MS, 35 * MS),        # top-level, in pbr.rng
        ("aten::lt", 45 * MS, 46 * MS)]           # outside pbr.rng


def test_a_span_reads_the_union_of_its_intervals_per_unit():
    s = _stretch([("pbr.k4.pack", 10 * MS, 30 * MS),
                  ("pbr.k4.pack", 20 * MS, 40 * MS),   # overlaps
                  ("pbr.k4.pack", 22 * MS, 25 * MS),   # nested
                  ("pbr.k4.pack", 50 * MS, 60 * MS),
                  ("pbr.k4.seeds", 95 * MS, 120 * MS)])  # past the window
    assert _read("k4.pack_ms", s) == pytest.approx(40 / 2)
    assert _read("k4.seeds_ms", s) == pytest.approx(5 / 2)


def test_step_spans_per_unit():
    s = _stretch(STEP, units=1)
    assert _read("step.forward_ms", s) == pytest.approx(50.0)
    assert _read("step.backward_ms", s) == pytest.approx(35.0)
    assert _read("rng.ms_per_step", s) == pytest.approx(18.0)


def test_rng_ops_count_top_level_aten_operators_inside_the_span():
    assert _read("rng.ops_per_step", _stretch(STEP, units=1)) == 3
    assert _read("rng.ops_per_step", _stretch(STEP, units=2)) == 1.5


def test_idle_in_program_is_the_idle_time_under_a_span():
    # Busy [0, 8] (two overlapping operations) and [50, 70]; idle [8, 50]
    # and [70, 100], 72 ms.  Spans [5, 98] cover all of it but [98, 100].
    dev = [("k", 0, 5 * MS), ("k", 3 * MS, 8 * MS),
           ("k", 50 * MS, 70 * MS)]
    s = _stretch(STEP, dev)
    for name in ("device.idle_in_program_pct.fit",
                 "device.idle_in_program_pct.frame"):
        assert _read(name, s) == pytest.approx(100 * 70 / 72)
    # Only the forward's [10, 60]: idle under it [10, 50], 40 of 72 ms.
    fwd = _stretch([STEP[1]], dev)
    assert spans.idle_in_program_pct(fwd) == pytest.approx(100 * 40 / 72)


def test_readers_return_none_without_their_spans():
    bare = _stretch([("aten::add", 1 * MS, 2 * MS)], [("k", 0, MS)])
    no_device = _stretch(STEP)
    busy = _stretch(STEP, [("k", 0, 100 * MS)])
    for names in SPAN_METRICS.values():
        for name in names:
            assert _read(name, None) is None
            assert _read(name, bare) is None, name
    step_only = _stretch(STEP, [("k", 0, MS)])
    assert _read("k4.seeds_ms", step_only) is None
    assert _read("k4.pack_ms", step_only) is None
    assert _read("device.idle_in_program_pct.fit", no_device) is None
    assert _read("device.idle_in_program_pct.fit", busy) is None


@pytest.mark.parametrize("name", CELLS)
def test_cpu_traced_run_reads_the_fit_spans(name):
    """On the CPU the frame takes the dense path (no K4) and no device
    operation runs: only the fit's span times and counts read."""
    metrics = run_tiny(name, trace_on=True)["metrics"]
    cell = bench.load_cell(name)
    assert set(SPAN_METRICS[name]) <= {m["name"] for m in cell.per_layer}
    if name == "cornell.fit":
        for m in ("step.forward_ms", "step.backward_ms", "rng.ms_per_step"):
            assert metrics[m]["value"] > 0.0, m
        ops = metrics["rng.ops_per_step"]["value"]
        assert ops > 0 and ops == int(ops)
        assert "device.idle_in_program_pct.fit" not in metrics
    else:
        assert not set(SPAN_METRICS[name]) & set(metrics)
