"""k4_roofline: K4, the whole-frame kernel (csrc/fused.cu)'s share of its roofline, in percent, over the traced
stretch (harness/rooflines.py)."""

from harness.rooflines import share_pct


def read(readings):
    return share_pct(readings, "k4", "fused_kernel")
