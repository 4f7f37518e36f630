"""Frozen work counters: the work each of the port's kernels needs on the
reference's own inputs, for the rooflines.  They import nothing of the
port; the plain tracers they replay are the reference's copies."""
