"""k4.pack_tex_ms: host time a frame in the span `pbr.k4.pack.tex`, K4's
texture tables (`ops/fused.py::_pack_tex_tables`), nested in `pbr.k4.pack`,
over the traced stretch (harness/spans.py)."""

from harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.stretch, "pbr.k4.pack.tex")
