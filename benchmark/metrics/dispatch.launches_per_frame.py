"""dispatch.launches_per_frame: CUDA kernel launches the host made (the
profiler's runtime launch calls) over the traced stretch, per frame
(harness/trace.py, `Stretch.launches_per_unit`)."""


def read(readings):
    s = readings.stretch
    return s.launches_per_unit() if s is not None else None
