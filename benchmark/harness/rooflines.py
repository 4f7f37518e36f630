"""A kernel's share of its roofline over a traced stretch: the least time
its calls need (the reference's work on the units it counted,
`work/hooks.py`) over the device time of the same calls.

Each unit of the stretch launches the kernel the same number of times, so
unit u's launches are the u-th run of that many in launch order.  Where
the profiler saw another number of launches than the reference made
calls, the share is not read (None)."""

from __future__ import annotations


def share_pct(readings, kernel: str, name_part: str):
    stretch = readings.stretch
    work = readings.work.get(kernel)
    if stretch is None or not work:
        return None
    ops = stretch.kernels(name_part)
    if not ops or len(ops) % stretch.units:
        return None
    per_unit = len(ops) // stretch.units
    bound = device = 0.0
    for unit, bounds in work.items():
        if len(bounds) != per_unit or not 0 <= unit < stretch.units:
            return None
        for _, a, b in ops[unit * per_unit:(unit + 1) * per_unit]:
            device += (b - a) / 1e9
        bound += sum(bounds)
    return 100.0 * bound / device if device > 0.0 else None
