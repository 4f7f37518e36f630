"""k5b_roofline: K5b, the row gather's backward (csrc/gather.cu)'s share of its roofline, in percent, over the traced
stretch (harness/rooflines.py)."""

from harness.rooflines import share_pct


def read(readings):
    return share_pct(readings, "k5b", "gather_bwd_kernel")
