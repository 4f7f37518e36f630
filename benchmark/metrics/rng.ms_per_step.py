"""rng.ms_per_step: host time a step in the span `pbr.rng`, the outermost
calls of threefry's `fold_in`, `split`, `ray_keys` and `ray_uniform`
(`core/rng.py`), over the traced stretch (harness/spans.py)."""

from harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.stretch, "pbr.rng")
