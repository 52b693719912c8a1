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
