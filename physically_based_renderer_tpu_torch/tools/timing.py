"""Device time of a call on the card, from torch.profiler.

Shared by `chip_smoke.py` and the probe tools (probe2, probe_mosaic,
exp_subtile_dma).  Run on a CUDA device only.
"""

from __future__ import annotations


def kernels(events):
    """The kernels among torch.profiler events (`key_averages()` entries):
    the CUDA-device ones, less the device-side span that an annotation
    (`record_function`, the port's `pbr.*` spans, `ProfilerStep#n`) gets
    over every kernel launched inside it, which is no kernel."""
    import torch
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("ProfilerStep", "pbr."))]


def kernel_launches(fn, parts) -> dict:
    """{part: launches of the kernels whose names hold `part`} in one call
    of fn, as torch.profiler saw them on the card: kernels inside a CUDA
    graph's replay too, which no launch counter of the port sees.  The
    tracer now and then drops a short kernel's events (`device_ms`), so a
    caller that asserts a count reads it again before it fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and not e.is_user_annotation()]
    return {p: sum(p in n for n in names) for p in parts}


def device_ms(fn, iters: int, kernel: str | None, warmup: int = 3,
              attempts: int = 4, per_call: int = 1):
    """Device time of fn under torch.profiler: (ms per launch of the
    kernels whose name holds `kernel`, ms per call of every other kernel
    the call ran).  Where a call launches `per_call` kernels whose names
    hold `kernel` (the passes of one route, named by a shared prefix), the
    first number is ms per call over all of them.  With kernel None, every
    kernel counts as the call's own and the first number is ms per call.  The warm-up calls run in the
    profiler's warm-up step, so tracing is already on when the measured
    step starts.  The tracer on the card's machine now and then drops the
    events of a step of short launches (seen: none, 64 or 82 of 100, of a
    1-18 us kernel): a step in which it saw fewer than 90% of the launches
    of `kernel` (per_call a call) is measured again, up to `attempts` times.  The time per
    launch is averaged over the launches seen, in the step that saw the
    most.  If no step saw one (seen late in a long run, after hundreds of
    profiled steps), the calls are timed with CUDA events instead, launch
    gaps included, and a line says so.  The second number counts the
    other kernels' events seen, so drops lower it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    best = None
    for attempt in range(attempts):
        # The events of the measured step, read when it ends (the profiler
        # clears them at the end of its cycle).
        steps = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: steps.append(p.key_averages())
                     ) as prof:
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        if len(steps) != 1:
            raise AssertionError(f"profiler gave {len(steps)} measured steps")
        own_us = other_us = 0.0
        n_own = 0
        for e in kernels(steps[0]):
            if kernel is None or kernel in e.key:
                own_us += e.self_device_time_total
                n_own += e.count
            else:
                other_us += e.self_device_time_total
        if kernel is not None and n_own > iters * per_call:
            raise AssertionError(f"{n_own} launches of {kernel} in {iters} "
                                 "calls: the name matches another kernel")
        if own_us > 0.0 and (best is None or n_own > best[2]):
            best = own_us, other_us, n_own
        if own_us > 0.0 and (kernel is None
                             or n_own >= 0.9 * iters * per_call):
            break
        print(f"profiler saw {n_own} launches of {kernel} in {iters} calls "
              f"(attempt {attempt + 1} of {attempts})")
    if best is None:
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        print(f"profiler saw no launch of {kernel} in {iters} calls, "
              f"{attempts} times: CUDA events give {ms:.4f} ms a call")
        return ms, 0.0
    own_us, other_us, n_own = best
    if kernel is None:
        return own_us / 1e3 / iters, 0.0
    return own_us / 1e3 / n_own * per_call, other_us / 1e3 / iters
