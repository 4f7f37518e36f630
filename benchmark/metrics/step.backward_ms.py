"""step.backward_ms: host time a step in the span `pbr.step.backward`, the
train step's `loss.backward()` (`grad/inverse.py::make_train_step`), over
the traced stretch (harness/spans.py)."""

from harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.stretch, "pbr.step.backward")
