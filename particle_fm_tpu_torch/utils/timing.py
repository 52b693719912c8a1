"""Device timing of a callable with CUDA events."""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_ms(fn: Callable[[], object], warmup: int = 5, reps: int = 20, rounds: int = 5) -> float:
    """Milliseconds per call of `fn` on the current CUDA stream: `reps` calls
    back to back between two events, so the host's time to issue one call
    hides behind the device's work on the previous one; the median over
    `rounds` such runs, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_reading(fn: Callable[[], object], calls: int = 20, warmup: int = 3,
                   recordings: int = 3) -> tuple[float, str]:
    """Milliseconds of device time of one call of `fn`, which launches one
    CUDA kernel, and what read it. First torch.profiler: the median duration
    of the launches it records over `calls` calls. The host's time to issue a
    call is not in it (`cuda_ms` includes it where the host is slower than
    the device). A recording may lose launches, some (late in a long
    process) or all of them: the median is taken over those it has, and a
    recording that has none is made again, up to `recordings` times. Then,
    if none had a launch, CUDA events: each call is issued behind a
    `torch.cuda._sleep` that holds the stream until it is queued, so that
    its start event fires when the device reaches it, and the median of the
    calls' event intervals is taken; the reading then holds the device's
    few microseconds between an event and a launch too. Raises if a
    recording holds launches of more than one kernel, or more than one a
    call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(recordings):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        names = {e.name for e in events}
        if len(names) > 1 or len(events) > calls:
            raise RuntimeError(f"device_ms times one kernel a call; torch.profiler recorded "
                               f"{len(events)} launches of {sorted(names)} in {calls} calls")
        if events:
            return statistics.median(e.device_time_total for e in events) / 1e3, "torch.profiler"
    pairs = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs), "cuda events"


HOLD_CYCLES = 2_000_000  # about a millisecond of the card's clock: longer than a call's issue


def device_ms(fn: Callable[[], object], calls: int = 20, warmup: int = 3) -> float:
    """`device_reading`'s milliseconds."""
    return device_reading(fn, calls, warmup)[0]
