"""A bounded stretch of a run under torch.profiler, reduced to what the
per-layer readers and the result line take.

The stretch sits inside a `record_function` annotation that ends after a
device synchronise, so its span in the profiler's own clock is the traced
window.  From the kineto events: every device operation (kernel, copy,
fill) with its interval; the host's runtime launch calls; the host's
operators, by which each idle gap of the device is named.  Nothing here
knows a kernel of the program: readers pick their kernels by name.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

ANNOTATION = "benchmark.traced_stretch"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel")


@dataclasses.dataclass
class Stretch:
    """One traced stretch: `units` frames or steps, `window_s` long by the
    profiler's clock, with the device's operations in it."""

    units: int
    window_s: float
    device_ops: list      # (name, start_ns, end_ns), sorted by start
    launches: int         # runtime launch calls on the host
    host_ops: list        # (name, start_ns, end_ns), sorted by start
    t0: int               # the window's ends, ns in the profiler's clock
    t1: int
    counters: dict        # the program's launch counters over the stretch

    def kernels(self, part: str) -> list:
        """Device operations whose name holds `part`, in launch order."""
        return [e for e in self.device_ops if part in e[0]]

    def seconds(self, part: str) -> float:
        return sum(e[2] - e[1] for e in self.kernels(part)) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window: [(start_ns, end_ns)], sorted."""
        out = []
        for _, a, b in self.device_ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_pct(self):
        """100 (1 - union of the device intervals / the stretch's length),
        or None where no operation ran on the device."""
        if self.window_s <= 0.0 or not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def launches_per_unit(self):
        """Runtime launch calls of the host over the stretch, per unit, or
        None where it saw none."""
        return self.launches / self.units if self.launches else None

    def top_device_ops(self, n: int = 10) -> list:
        by_name = defaultdict(int)
        for name, a, b in self.device_ops:
            by_name[name] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time of the device summed by what the host was doing at
        each gap's middle: the innermost host operator running there, or
        "python between operators" where none ran."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        starts = [s for _, s, _ in self.host_ops]
        by_name = defaultdict(int)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            name = "python between operators"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 64, -1), -1):
                if self.host_ops[j][2] >= mid:
                    name = self.host_ops[j][0]
                    break
            by_name[name] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


class Tracer:
    """Profiles one stretch of a run when on; a no-op when off.

    `start()` and `stop(units)` bracket the stretch; `counters` is a
    callable giving the program's launch counters, read at both ends."""

    def __init__(self, on: bool, counters=None):
        self.on = on
        self.counters = counters or (lambda: {})
        self.stretch: Stretch | None = None
        self._prof = None

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        if self._prof is not None or self.stretch is not None:
            raise RuntimeError("one traced stretch a run")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._c0 = self.counters()
        self._rf = torch.profiler.record_function(ANNOTATION)
        self._rf.__enter__()

    def stop(self, units: int) -> None:
        if not self.on:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        c1 = self.counters()
        self._prof.__exit__(None, None, None)
        self.stretch = reduce(self._prof, units,
                              {k: c1[k] - self._c0[k] for k in c1})
        self._prof = None


def reduce(prof, units: int, counters: dict) -> Stretch:
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    device_ops, host_ops = [], []
    launches = 0
    t0 = t1 = None
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if name == ANNOTATION:
            if e.device_type() == DeviceType.CPU:
                t0, t1 = a, b
            continue
        if e.device_type() == DeviceType.CPU:
            if name.startswith(LAUNCH_CALLS):
                launches += 1
            elif not name.startswith(("cuda", "cu")):
                host_ops.append((name, a, b))
        elif not e.is_user_annotation() and not name.startswith(
                "ProfilerStep"):
            device_ops.append((name, a, b))
    if t0 is None:
        raise RuntimeError("the profiler lost the stretch's annotation")
    device_ops.sort(key=lambda x: x[1])
    host_ops.sort(key=lambda x: x[1])
    return Stretch(units=units, window_s=(t1 - t0) / 1e9,
                   device_ops=device_ops, launches=launches,
                   host_ops=host_ops, t0=t0, t1=t1, counters=counters)
