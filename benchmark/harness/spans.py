"""The program's own spans in a traced stretch, for the per-layer readers.

The port names stretches of its host code with `record_function` while a
profiler records (`utils/profiling.py::span`, names `pbr.*`), so they sit
in `Stretch.host_ops` on the device's clock.  Each reader here returns
None where the stretch is missing or holds no such span:

- a span name's time is the union of its intervals, so a nested or
  repeated span is never counted twice;
- an operator is top-level when no other aten operator encloses it;
- the device's idle time is the stretch's window minus its busy
  intervals.
"""

from __future__ import annotations

PREFIX = "pbr."
ATEN = "aten::"


def _union(ivs) -> list:
    """The union of [start, end) intervals: sorted, disjoint."""
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(ivs) -> int:
    return sum(b - a for a, b in ivs)


def _intersect(xs, ys) -> list:
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def intervals(stretch, match) -> list:
    """The union of the host events whose name `match` accepts, clipped
    to the stretch's window."""
    return _union((max(a, stretch.t0), min(b, stretch.t1))
                  for name, a, b in stretch.host_ops
                  if match(name) and min(b, stretch.t1) > max(a, stretch.t0))


def ms_per_unit(stretch, name: str):
    """Milliseconds a unit inside the span `name`, or None."""
    if stretch is None:
        return None
    ivs = intervals(stretch, lambda n: n == name)
    return _length(ivs) / 1e6 / stretch.units if ivs else None


def top_level_ops_per_unit(stretch, name: str):
    """Top-level aten operators that start and end inside the span
    `name`, per unit, or None."""
    if stretch is None:
        return None
    ivs = intervals(stretch, lambda n: n == name)
    if not ivs:
        return None
    ops = sorted(((a, -b) for n, a, b in stretch.host_ops
                  if n.startswith(ATEN)))
    count, reach, k = 0, None, 0
    for a, neg_b in ops:
        b = -neg_b
        if reach is not None and b <= reach:
            continue        # an earlier operator encloses it
        reach = b
        while k < len(ivs) and ivs[k][1] < b:
            k += 1
        if k < len(ivs) and ivs[k][0] <= a:
            count += 1
    return count / stretch.units


def idle_in_program_pct(stretch):
    """100 x the device's idle time under any `pbr.*` span / all of its
    idle time in the stretch, or None where no operation ran on the
    device, the device never idled, or no span was recorded."""
    if stretch is None or not stretch.device_ops:
        return None
    spans = intervals(stretch, lambda n: n.startswith(PREFIX))
    if not spans:
        return None
    busy = stretch.busy_intervals()
    edges = [stretch.t0] + [x for iv in busy for x in iv] + [stretch.t1]
    idle = [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    total = _length(idle)
    if total <= 0:
        return None
    return 100.0 * _length(_intersect(idle, spans)) / total
