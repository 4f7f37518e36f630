"""k4.pack_ms: host time a frame in the span `pbr.k4.pack`, K4's table and
camera packing (`ops/fused.py::fused_frame`), over the traced stretch
(harness/spans.py)."""

from harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.stretch, "pbr.k4.pack")
