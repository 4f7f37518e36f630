"""device.idle_pct.fit: the share of the traced stretch of steps in which
no operation ran on the card (harness/trace.py, `Stretch.idle_pct`)."""


def read(readings):
    s = readings.stretch
    return s.idle_pct() if s is not None else None
