"""trace.phase_a_ms: host time a frame in the span `pbr.trace.phase_a`, the
block tracer's root cull, octant sort, candidate selection and K1's inputs
(`ops/blocktrace.py::intersect_blocks_pallas`), over the traced stretch
(harness/spans.py)."""

from harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.stretch, "pbr.trace.phase_a")
