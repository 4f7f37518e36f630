"""k1_roofline: K1, the block tracer's kernel (csrc/trace_blocks.cu)'s share
of its roofline, in percent, over the traced stretch
(harness/rooflines.py; work/hooks.py counts its bound on the reference's
calls)."""

from harness.rooflines import share_pct


def read(readings):
    return share_pct(readings, "k1", "trace_blocks_kernel")
