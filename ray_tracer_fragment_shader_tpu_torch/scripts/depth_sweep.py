"""Depth sweep of the port's kernels: step time and Mrays/s of the chain
forward and the fwd+bwd step at the reference's MAX_DEPTH=5
(Hw4/MySdlApplication.cpp:48) and below, and of the bounce tree at depths
2-4.  The counterpart of the JAX package's ``scripts/depth_sweep.py``, with
its three groups and row keys (``kernel``, ``depth``, ``size``, ``nodes``,
``step_ms``, ``mrays_per_s``):

* ``chain`` at depths 2, 3, 5: ``render_image_kernel`` (K2) on
  ``presets.full_reflective(size, depth)``, 1024^2;
* ``fused_fwd_bwd`` at depths 2, 3, 5: ``fit_value_and_grad`` on the same
  scenes.  As in JAX, no ``mode`` is passed, so the step reads
  ``RTFS_FIT_MODE``, whose default is "twophase" (K3 + K4) despite the
  row's name; each row names its ``mode``;
* ``tree`` at depths 2, 3, 4 (``nodes`` = 2^(depth+1) - 1):
  ``render_image_kernel`` (K5) on ``presets.fractional_glass(512,
  depth)``, JAX's inline scene (depth_sweep.py:120-126).

**No compile seconds.**  JAX compiles a kernel per depth and reports each
row's ``compile_s``.  The port's depth is a runtime argument of its kernels
(``kernels/cuda_build.py::_RENDER_ARGS``): one nvcc build serves every
depth.  So each row reports ``warmup_s`` (``scan_diff_median``'s warm-up
pair: the first 1-step and N-step runs) and the output one ``build``
record (``cuda_build.build_info``: ``seconds`` and ``built``, null off the
card).  That is the port's form of JAX's compile-latency proof at depth 5:
one build, no per-depth cost.

**Live pixels.**  JAX's fwd+bwd rows start from the scene itself and move
the centres only by the scan's epsilon; its dense TPU adjoint costs the
same either way.  The port's adjoints run on the list of pixels whose
cotangent is nonzero, so such a step would time a forward and a nearly
empty adjoint.  The rows start from the centres + ``MOVE`` (as
``parallel/multihost.py::scaling_sweep``), and each reports
``live_pixels``: the pixels whose cotangent is nonzero at that start.

Timing (``utils/timing.py``, as ``bench.py``): ``step_runner`` and
``scan_diff_median`` over ``--iters`` (32) steps, median of ``--reps``
(3); a row under 1 ms is timed again over 256 steps (JAX's
depth_sweep.py:42-46).  Step k moves the eye (forward rows) or the sphere
centres (fwd+bwd rows) by linspace(0, 1e-5, iters)[k], as JAX's scan does.

    python -m ray_tracer_fragment_shader_tpu_torch.scripts.depth_sweep \\
        [--size 1024] [--tree-size 512] [--device cpu]

writes ``chiprun_out/depth_sweep_h100.json`` (``device``, ``power_limit``,
``build``, ``rows``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

import torch

from ..diff.fit import FitParams
from ..kernels.adjoint_fused import fit_mode, fit_value_and_grad
from ..kernels.render import render_image_kernel, resolve_device
from ..ops.rays import Camera
from ..probes.common import write
from ..scene import presets
from ..utils.timing import scan_diff_median, step_runner
from .common import card_of, sync

CHAIN_DEPTHS = (2, 3, 5)
TREE_DEPTHS = (2, 3, 4)
#: how far the fwd+bwd rows move the sphere centres from the target's
#: (``parallel/multihost.py::MOVE``): the step's adjoint has live pixels
MOVE = 1.5
#: JAX's re-estimate: a row under 1 ms is timed again over 256 steps
REESTIMATE_S, REESTIMATE_ITERS = 1e-3, 256
OUT = os.path.join("chiprun_out", "depth_sweep_h100.json")


def _case(preset, dev) -> Dict[str, object]:
    scene, camcfg, config = preset
    return dict(scene=scene, config=config,
                camera=Camera.from_config(camcfg, config.width,
                                          config.height, device=dev))


def chain_case(size: int, depth: int, dev) -> Dict[str, object]:
    """A ``chain`` row's scene, camera and config: config 3's scene at
    ``depth``."""
    return _case(presets.full_reflective(size=size, depth=depth), dev)


def tree_case(size: int, depth: int, dev) -> Dict[str, object]:
    """A ``tree`` row's: the fractional glass sphere beside an opaque one."""
    return _case(presets.fractional_glass(size=size, depth=depth), dev)


def fwd_bwd_case(size: int, depth: int, dev) -> Dict[str, object]:
    """A ``fused_fwd_bwd`` row's: ``chain_case`` with its target (the
    kernel's render of the scene) and the parameters, sphere centres moved
    by ``MOVE`` (``center0`` keeps them)."""
    c = chain_case(size, depth, dev)
    c["target"] = render_image_kernel(c["scene"], c["camera"], c["config"],
                                      device=dev)
    params = FitParams.from_scene(c["scene"]).to(dev)
    with torch.no_grad():
        params.sph_center += MOVE
    c["params"], c["center0"] = params, params.sph_center.detach().clone()
    return c


def render_frame(c: dict, dev, eps: float = 0.0) -> torch.Tensor:
    """A forward row's step: the frame with the eye moved by ``eps``."""
    cam = dataclasses.replace(c["camera"], eye=c["camera"].eye + eps)
    with torch.no_grad():
        return render_image_kernel(c["scene"], cam, c["config"], device=dev)


def fwd_bwd_step(c: dict, dev, eps: float = 0.0, mode: Optional[str] = None):
    """A fwd+bwd row's step: (loss, gradients) of ``fit_value_and_grad``
    with the centres at ``center0 + eps``; ``mode`` None reads
    ``RTFS_FIT_MODE``."""
    params = c["params"]
    with torch.no_grad():
        params.sph_center.copy_(c["center0"]).add_(eps)
    return fit_value_and_grad(params, c["scene"], c["camera"], c["config"],
                              c["target"], mode=mode, device=dev)


def live_pixels(c: dict, dev) -> int:
    """Pixels whose cotangent is nonzero at a fwd+bwd row's start: the
    frame of the moved scene differs from the target there."""
    params = c["params"]
    with torch.no_grad():
        params.sph_center.copy_(c["center0"])
        img = render_image_kernel(params.into_scene(c["scene"]),
                                  c["camera"], c["config"], device=dev)
    return int((img != c["target"]).any(-1).sum())


def time_step(step: Callable[[float], object], iters: int, reps: int,
              dev) -> dict:
    """``scan_diff_median`` of ``step(eps)``, step k taking
    eps = linspace(0, 1e-5, n)[k]; again over ``REESTIMATE_ITERS`` steps
    when under ``REESTIMATE_S``."""
    def timed(n):
        eps = torch.linspace(0.0, 1e-5, n).tolist()
        run_1, run_n = step_runner(lambda k: step(eps[k]), n, dev)
        return dict(scan_diff_median(run_1, run_n, n, reps=reps), iters=n)
    t = timed(iters)
    if t["dt"] < REESTIMATE_S and iters < REESTIMATE_ITERS:
        t = timed(REESTIMATE_ITERS)
    return t


def _row(kernel: str, depth: int, size: int, t: dict, **extra) -> dict:
    dt = max(t["dt"], 1e-9)
    return dict(kernel=kernel, depth=depth, size=size, **extra,
                warmup_s=round(t["warmup_s"], 3),
                step_ms=round(dt * 1e3, 4),
                mrays_per_s=round(size * size / dt / 1e6, 2),
                iters=t["iters"], spread=round(t["spread"], 4))


def sweep(size: int = 1024, tree_size: int = 512, iters: int = 32,
          reps: int = 3, mode: Optional[str] = None, device=None,
          on_row: Callable[[dict], None] = lambda r: None) -> List[dict]:
    """The sweep's rows, in JAX's order: chain, fused_fwd_bwd, tree; each
    handed to ``on_row`` as it is measured."""
    dev = resolve_device(device)
    rows = []

    def add(row):
        rows.append(row)
        on_row(row)

    for depth in CHAIN_DEPTHS:
        c = chain_case(size, depth, dev)
        add(_row("chain", depth, size, time_step(
            lambda e: render_frame(c, dev, e), iters, reps, dev)))
    step_mode = fit_mode(mode)
    for depth in CHAIN_DEPTHS:
        c = fwd_bwd_case(size, depth, dev)
        live = live_pixels(c, dev)
        add(_row("fused_fwd_bwd", depth, size, time_step(
            lambda e: fwd_bwd_step(c, dev, e, step_mode), iters, reps, dev),
            mode=step_mode, live_pixels=live))
    for depth in TREE_DEPTHS:
        c = tree_case(tree_size, depth, dev)
        add(_row("tree", depth, tree_size, time_step(
            lambda e: render_frame(c, dev, e), iters, reps, dev),
            nodes=2 ** (depth + 1) - 1))
    sync(dev)
    return rows


def main(argv=None) -> dict:
    """Runs the sweep; writes and returns its JSON object."""
    ap = argparse.ArgumentParser(
        prog="ray_tracer_fragment_shader_tpu_torch.scripts.depth_sweep")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--tree-size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    device_name, power_limit = card_of(dev)
    build = None
    if dev.type == "cuda":
        from ..kernels import cuda_build
        cuda_build.load()
        build = dict(seconds=round(cuda_build.build_info["seconds"], 3),
                     built=cuda_build.build_info["built"])

    def show(row):
        print(json.dumps(dict(row, device=device_name,
                              power_limit=power_limit)), flush=True)

    rows = sweep(args.size, args.tree_size, args.iters, args.reps,
                 device=dev, on_row=show)
    out = dict(device=device_name, power_limit=power_limit, build=build,
               rows=rows)
    write(args.out, out)
    print(json.dumps(rows))
    return out


if __name__ == "__main__":
    main()
