"""device.idle_pct.frame: the share of the traced stretch of frames in which
no operation ran on the card (harness/trace.py, `Stretch.idle_pct`)."""


def read(readings):
    s = readings.stretch
    return s.idle_pct() if s is not None else None
