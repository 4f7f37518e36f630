"""dispatch.launches_per_step: CUDA kernel launches the host made (the
profiler's runtime launch calls) over the traced stretch, per step
(harness/trace.py, `Stretch.launches_per_unit`)."""


def read(readings):
    s = readings.stretch
    return s.launches_per_unit() if s is not None else None
