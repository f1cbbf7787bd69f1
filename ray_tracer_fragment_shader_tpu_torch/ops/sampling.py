"""What the kernel path and the core renderer share around the tracing
itself: the device an entry point runs on, the jitter of a supersampled
frame's samples and the adaptive supersampler's per-sample update.  Plain
PyTorch, no kernel: kernels/render.py and core/renderer.py both import it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from .rays import sample_jitter


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, and raises where
    there is none.  The port's entry points run on the card unless the
    caller asks for the CPU (``device="cpu"``), where the kernels' plain
    versions run."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs its kernels on the "
                           "GPU; pass device=\"cpu\" to run their plain "
                           "versions on the CPU")
    return torch.device("cuda")


def jitter_source(config: RenderConfig, num_points: int, dtype, device, *,
                  jitter: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """``k -> [P,3]`` jitter of sample k of a supersampled frame:
    ``jitter[k]`` of the given [S, P, 3] tensor (e.g. the JAX package's
    draws, for per-pixel parity), else a fresh draw from ``generator``
    (default: one on ``device`` seeded with ``config.seed``), one per call
    in sample order."""
    S = config.samples
    if jitter is not None:
        jitter = torch.as_tensor(jitter, dtype=dtype, device=device)
        if tuple(jitter.shape) != (S, num_points, 3):
            raise ValueError(f"jitter must be [{S}, {num_points}, 3], got "
                             f"{tuple(jitter.shape)}")
        return lambda k: jitter[k]
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(config.seed)
    return lambda k: sample_jitter(generator, num_points, config.jitter_scale,
                                   dtype=dtype).to(device)


def adaptive_step(k: int, c: torch.Tensor, accum: torch.Tensor,
                  divisor: torch.Tensor, done: torch.Tensor, small: float):
    """Sample k (image ``c`` [H,W,3]) of the reference's adaptive
    supersampler (MySdlApplication.cpp:1294-1311), emulated exactly as the
    JAX package does: the sample joins the sum while the pixel is
    unconverged; convergence tests |k*avg_after - (k+1)*avg_before| <
    SMALL*k*(k+1); the divisor is the loop variable at exit.  Returns the
    new (accum, divisor, done) and the sample's accept plane (the pixels it
    joined: ``~done`` before it)."""
    kf = float(k)
    accept = ~done
    accum_after = torch.where(done[..., None], accum, accum + c)
    d = kf * accum_after - (kf + 1.0) * accum
    diff = torch.sqrt(torch.sum(d * d, -1))
    sm = np.float32(small)
    bar = float(sm * np.float32(kf) * np.float32(kf + 1.0))
    newly_done = accept & (diff < bar)
    divisor = torch.where(newly_done, kf, divisor)
    return accum_after, divisor, done | newly_done, accept
