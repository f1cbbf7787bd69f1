"""Kernel time on the card by CUDA events."""
from __future__ import annotations

import torch


def time_ms(fn, reps: int) -> float:
    """CUDA-event time of one call of ``fn``, averaged over ``reps``.  A
    device-side sleep queued first lets the host enqueue every launch
    before the start event fires, so a kernel shorter than its host-side
    launch cost is timed on the device alone (without it the events time
    the host's launch gaps).  ``fn`` that synchronises (the plain
    versions) is timed with its host cost, as a caller sees it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)  # ~5 ms of SM cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
