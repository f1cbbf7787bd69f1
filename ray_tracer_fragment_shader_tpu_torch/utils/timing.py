"""Timing on the card: CUDA events for kernels, iteration-count
differencing for steps and probes.

The counterpart of the JAX package's ``utils/timing.py``.  ``time_ms``
times a kernel by CUDA events; ``scan_diff_median`` keeps the JAX
harness's contract (the per-iteration time is the difference of an N-run
and a 1-run over N-1, the median of ``reps`` estimates with their spread);
``step_runner`` makes its two runs from a step function; ``launch_diff_s``
differences a probe kernel's ``iters`` and ``2*iters`` launches on the
device.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch


#: SM cycles a second, for sizing the device-side sleep (the H100 SXM's
#: 1980 MHz boost clock; a slower clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 1.98e9


def time_ms(fn, reps: int) -> float:
    """CUDA-event time of one call of ``fn``, averaged over ``reps``.  A
    device-side sleep queued first lets the host enqueue every launch
    before the start event fires, so a kernel shorter than its host-side
    launch cost is timed on the device alone (without it the events time
    the host's launch gaps).  The sleep lasts at least 5 ms and at least
    three times the host's enqueue time of the ``reps`` calls (measured on
    one call, up to 0.2 s).  ``fn`` that synchronises (the plain versions)
    is timed with its host cost, as a caller sees it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = min(max(5e-3, 3.0 * reps * host_s), 0.2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def scan_diff_median(run_1: Callable[[], None], run_n: Callable[[], None],
                     iters: int, reps: int = 3) -> Dict[str, object]:
    """Median-of-reps iteration-difference timing (the JAX
    ``scan_diff_median``'s contract).

    ``run_1`` / ``run_n``: zero-arg callables running the same step 1 and
    ``iters`` times and waiting for it (``step_runner``).  This function
    calls each once up front and reports that as ``warmup_s``.

    Returns a dict:
      ``dt``        -- median per-iteration seconds,
      ``dts``       -- all per-rep estimates, sorted,
      ``spread``    -- (max-min)/median of the estimates,
      ``method``    -- "scan_diff", or "avg" when the difference was
                       sub-noise (<=100ns/iter) and the average of the
                       N-run was used instead,
      ``warmup_s``  -- wall time of the initial warmup pair.
    """
    if iters < 2:
        raise ValueError("iters must be >= 2 (the per-iteration time is the "
                         "difference between a 1-iter and an N-iter run)")
    t0 = time.perf_counter()
    run_1()
    run_n()
    warmup_s = time.perf_counter() - t0

    diffs: List[float] = []
    avgs: List[float] = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        run_1()
        t1 = time.perf_counter()
        run_n()
        t2 = time.perf_counter()
        diffs.append(((t2 - t1) - (t1 - t0)) / (iters - 1))
        avgs.append((t2 - t1) / iters)
    diffs.sort()
    avgs.sort()
    dt = diffs[len(diffs) // 2]
    method = "scan_diff"
    if dt <= 1e-7:
        dt = avgs[len(avgs) // 2]
        method = "avg"
        diffs = avgs
    spread = (diffs[-1] - diffs[0]) / dt if dt > 0 else 0.0
    return dict(dt=dt, dts=diffs, spread=spread, method=method,
                warmup_s=warmup_s)


def step_runner(step: Callable[[int], object], iters: int, device):
    """The pair of zero-arg callables ``scan_diff_median`` takes: ``step(k)``
    for k = 0, and for k = 0..iters-1, each run ending in
    ``torch.cuda.synchronize()`` on a CUDA ``device`` (the host clock then
    covers the device's work).  The JAX runner jits a ``lax.scan`` over an
    iteration-dependent epsilon so that XLA cannot merge the iterations;
    PyTorch runs eagerly and merges nothing, so the step is just called N
    times (``k`` lets a step vary its inputs as the JAX bench's does)."""
    dev = torch.device(device)

    def run(n):
        for k in range(n):
            step(k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return (lambda: run(1)), (lambda: run(iters))


def launch_diff_s(launch: Callable[[int], object], iters: int,
                  reps: int) -> float:
    """Device seconds of ``iters`` iterations of a probe kernel: CUDA events
    around ``launch(iters)`` and ``launch(2*iters)``, both queued behind a
    device sleep, and the difference of the two (launch cost and the
    kernel's set-up cancel); the median of ``reps``."""
    launch(iters)
    launch(2 * iters)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    deltas = []
    for _ in range(max(reps, 1)):
        torch.cuda._sleep(10_000_000)
        ev[0].record()
        launch(iters)
        ev[1].record()
        launch(2 * iters)
        ev[2].record()
        ev[2].synchronize()
        deltas.append(max((ev[1].elapsed_time(ev[2])
                           - ev[0].elapsed_time(ev[1])) * 1e-3, 1e-12))
    deltas.sort()
    return deltas[len(deltas) // 2]
