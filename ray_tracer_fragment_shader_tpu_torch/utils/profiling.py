"""Tracing and profiling — the counterpart of the JAX package's
``utils/profiling.py`` (SURVEY.md section 5).  ``named_phase`` marks a
region for ``torch.profiler`` (and for NVTX on the card), ``trace``
captures a profiler trace as a Chrome trace file, and ``RaysMeter`` is the
BASELINE metric's rays/s meter.  ``frame_profile.py`` reads the device's
busy and idle time from such a trace."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
import torch.distributed as dist


@contextlib.contextmanager
def named_phase(name: str) -> Iterator[None]:
    """Annotates a region: a ``torch.profiler.record_function`` range,
    and on a machine with a card an NVTX range as well."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Captures a ``torch.profiler`` trace of the region (the CPU, and the
    card where there is one) into ``log_dir/trace.json``, a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RaysMeter:
    """Throughput meter for the BASELINE metric (rays/s/chip).  ``n_chips``
    defaults to the ranks of the process group when one is up, else the
    CUDA devices (one where there is none)."""

    def __init__(self, rays_per_step: int, n_chips: Optional[int] = None):
        self.rays_per_step = rays_per_step
        if n_chips is None:
            n_chips = (dist.get_world_size() if dist.is_initialized()
                       else max(torch.cuda.device_count(), 1))
        self.n_chips = n_chips
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    @property
    def rays_per_s(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps * self.rays_per_step / max(dt, 1e-9)

    @property
    def rays_per_s_per_chip(self) -> float:
        return self.rays_per_s / self.n_chips
