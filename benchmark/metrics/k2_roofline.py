"""k2_roofline: K2, the resident tracer (csrc/resident.cu)'s share of its roofline, in percent, over the traced
stretch (harness/rooflines.py)."""

from harness.rooflines import share_pct


def read(readings):
    return share_pct(readings, "k2", "resident_kernel")
