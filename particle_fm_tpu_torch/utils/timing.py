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


def device_ms(fn: Callable[[], object], calls: int = 20, warmup: int = 3) -> float:
    """Milliseconds of device time of one call of `fn`, which launches one
    CUDA kernel: the median duration of its launches over `calls` calls, as
    torch.profiler records them. The host's time to issue a call is not in
    it (`cuda_ms` includes it where the host is slower than the device). A
    recording may lose launches (and did, late in a long process): the
    median is taken over those it has. Raises unless the recorded launches
    are of one kernel, at most one a call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {e.name for e in events}
    if not events or len(names) != 1 or len(events) > calls:
        raise RuntimeError(f"device_ms times one kernel a call; torch.profiler recorded "
                           f"{len(events)} launches of {sorted(names)} in {calls} calls")
    return statistics.median(e.device_time_total for e in events) / 1e3
