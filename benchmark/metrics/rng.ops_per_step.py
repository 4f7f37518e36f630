"""rng.ops_per_step: top-level aten operators inside the span `pbr.rng`
(threefry, `core/rng.py`) a step, over the traced stretch
(harness/spans.py)."""

from harness.spans import top_level_ops_per_unit


def read(readings):
    return top_level_ops_per_unit(readings.stretch, "pbr.rng")
