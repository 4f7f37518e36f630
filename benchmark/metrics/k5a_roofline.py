"""k5a_roofline: K5a, the row gather (csrc/gather.cu)'s share of its roofline, in percent, over the traced
stretch (harness/rooflines.py)."""

from harness.rooflines import share_pct


def read(readings):
    return share_pct(readings, "k5a", "gather_fwd_kernel")
