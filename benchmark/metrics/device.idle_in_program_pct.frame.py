"""device.idle_in_program_pct.frame: the share of the card's idle time in
the traced stretch of frames that falls under one of the program's `pbr.*`
spans (harness/spans.py); the rest is the benchmark's own host work."""

from harness.spans import idle_in_program_pct


def read(readings):
    return idle_in_program_pct(readings.stretch)
