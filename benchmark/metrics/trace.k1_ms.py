"""trace.k1_ms: host time a frame in the span `pbr.trace.k1`, K1's launch
and its winner decode (`ops/blocktrace.py::intersect_blocks_pallas`), over
the traced stretch (harness/spans.py)."""

from harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.stretch, "pbr.trace.k1")
