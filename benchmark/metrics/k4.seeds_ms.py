"""k4.seeds_ms: host time a frame in the span `pbr.k4.seeds`, K4's seed
words (`fold_in(key, 0x5EED).tolist()` in `ops/fused.py::fused_frame`,
the host's wait for them included), over the traced stretch
(harness/spans.py)."""

from harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.stretch, "pbr.k4.seeds")
