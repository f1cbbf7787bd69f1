"""Time the reference's OWN default workload on the kernel path: the demo
scene (initScene) at 500x500, MAX_DEPTH=5, 16-sample ADAPTIVE supersampling
(Hw4/MySdlApplication.cpp:570 the window, :48 MAX_DEPTH, :52
SUPER_SAMPLE_NUMBER, :1294-1311 the adaptive loop), through
``render_image_kernel`` (K2 a sample).  The counterpart of the JAX
package's ``scripts/bench_reference_demo.py``, with its scene, config and
output keys (``metric`` = ``reference_default_frame_ms``, ``workload``,
``frame_time_ms``, ``frame_time_ms_reps``, ``rays_per_s``,
``ray_accounting``, ``timing``), plus ``device`` and ``power_limit``.

**Ray accounting.**  JAX computes all 16 samples and masks their
accumulation, so its ``rays_per_s`` counts ``500*500*16`` rays a frame;
``rays_per_s`` keeps that accounting, for comparison with its
``artifacts/bench_reference_demo.json``.  The port's adaptive loop stops
launching once every pixel has converged (``kernels/render.py::
render_image_kernel``), so the output adds ``samples_rendered``, the
chain renders of one frame (on the card the K2 launches that frame adds
to ``render.LAUNCHES``), and ``traced_rays_per_s``, ``500*500*
samples_rendered`` a frame.

Timing (``utils/timing.py``): ``step_runner`` and ``scan_diff_median``
over ``--iters`` (8) frames, median of ``--reps`` (3); frame k moves the
eye by linspace(0, 1e-5, iters)[k], as JAX's scan and the port's
forward-only bench do.  ``--size`` (500, the reference's window) renders a
smaller frame of the same scene and camera, for tests.

    python -m ray_tracer_fragment_shader_tpu_torch.scripts.bench_reference_demo \\
        [--iters 8] [--reps 3] [--device cpu]

writes ``chiprun_out/bench_reference_demo_h100.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import torch

from ..kernels import render
from ..kernels.render import render_image_kernel, resolve_device
from ..ops.rays import Camera
from ..probes.common import write
from ..scene import presets
from ..utils.timing import scan_diff_median, step_runner
from .common import card_of, sync

SIZE = 500
OUT = os.path.join("chiprun_out", "bench_reference_demo_h100.json")


def demo_case(dev, size: int = SIZE) -> dict:
    """The reference's own frame: initScene, ``size``^2 (its window is
    500^2), depth 5, 16 samples, adaptive."""
    scene, camcfg, cfg = presets.reference_demo()
    cfg = dataclasses.replace(cfg, width=size, height=size, max_depth=5,
                              samples=16, adaptive=True)
    return dict(scene=scene, config=cfg,
                camera=Camera.from_config(camcfg, size, size, device=dev))


def frame(c: dict, dev, eps: float = 0.0,
          jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One frame with the eye moved by ``eps``; its samples jitter by
    ``jitter`` [16, P, 3] when given, else by draws seeded with the
    config's seed."""
    cam = dataclasses.replace(c["camera"], eye=c["camera"].eye + eps)
    with torch.no_grad():
        return render_image_kernel(c["scene"], cam, c["config"],
                                   jitter=jitter, device=dev)


def samples_rendered(c: dict, dev) -> int:
    """The chain renders of one frame at the scene's own eye: the calls of
    the chain wrapper (``render.render_chain``), which on the card must
    equal the K2 launches the frame adds to ``render.LAUNCHES`` (the plain
    version off the card counts nothing)."""
    chain, calls = render.render_chain, []

    def counted(*args, **kw):
        calls.append(1)
        return chain(*args, **kw)
    before = render.LAUNCHES["render_chain"]
    render.render_chain = counted
    try:
        frame(c, dev)
        sync(dev)
    finally:
        render.render_chain = chain
    launched = render.LAUNCHES["render_chain"] - before
    if dev.type == "cuda" and launched != len(calls):
        raise RuntimeError(f"{len(calls)} chain renders launched K2 "
                           f"{launched} times")
    return len(calls)


def bench(iters: int = 8, reps: int = 3, size: int = SIZE,
          device=None) -> dict:
    """Times the frame; returns the output object."""
    dev = resolve_device(device)
    c = demo_case(dev, size)
    cfg = c["config"]
    eps = torch.linspace(0.0, 1e-5, iters).tolist()
    run_1, run_n = step_runner(lambda k: frame(c, dev, eps[k]), iters, dev)
    timing = scan_diff_median(run_1, run_n, iters, reps=reps)
    dt = max(timing["dt"], 1e-9)
    rendered = samples_rendered(c, dev)
    pixels = cfg.width * cfg.height
    device_name, power_limit = card_of(dev)
    return dict(
        metric="reference_default_frame_ms",
        workload=f"initScene demo, {cfg.width}x{cfg.height}, depth 5, "
                 f"16-sample adaptive (MySdlApplication.cpp:570,48,52,"
                 f"1294-1311)",
        frame_time_ms=round(dt * 1e3, 4),
        frame_time_ms_reps=[round(d * 1e3, 4) for d in timing["dts"]],
        rays_per_s=round(pixels * cfg.samples / dt, 1),
        samples_rendered=rendered,
        traced_rays_per_s=round(pixels * rendered / dt, 1),
        ray_accounting="rays_per_s: size*size*samples primary rays, JAX's "
                       "accounting (it computes all 16 samples and masks "
                       "their accumulation); traced_rays_per_s: "
                       "size*size*samples_rendered, the samples one frame "
                       "rendered (the adaptive loop stops once every pixel "
                       "has converged)",
        device=device_name, power_limit=power_limit,
        timing=dict(iters=iters, reps=reps, method=timing["method"],
                    spread=round(timing["spread"], 4),
                    warmup_s=round(timing["warmup_s"], 3)))


def main(argv=None) -> dict:
    """Runs the bench; writes and returns its JSON object."""
    ap = argparse.ArgumentParser(
        prog="ray_tracer_fragment_shader_tpu_torch.scripts."
             "bench_reference_demo")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = bench(args.iters, args.reps, args.size, args.device)
    write(args.out, out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
