"""Headline benchmark of the port: rays/s on the card, forward+backward, on
the full reflective scene at 1024^2 with depth-3 reflections (BASELINE.md
config 3), through the CUDA kernels -- the port of the root ``bench.py``.

    python -m ray_tracer_fragment_shader_tpu_torch.bench [--device cpu]
    python -m ray_tracer_fragment_shader_tpu_torch.cli bench [--size N]

Prints ONE JSON line with the JAX bench's keys and metric name
(``rays_per_s_per_chip_fwd_bwd_1024x1024_depth3``), plus ``power_limit``
(nvidia-smi's string).  ``vs_baseline`` = ``sol_fraction``: the step's
class operations (``utils/opcount.py::step_work``, counted on this step's
inputs) over the issue rate K9 measures on the card for their blend
(``utils/roofline.py``), against the measured step time.  The step is
the whole of ``fit_value_and_grad`` as a user calls it, host work
included, so the fraction is a few percent; a stderr ``#`` line gives the
kernels' own device time and their share beside it.

Knobs, as the JAX bench's: ``BENCH_SIZE`` (1024), ``BENCH_DEPTH`` (3),
``BENCH_ITERS`` (64), ``BENCH_REPS`` (5), ``BENCH_FORWARD_ONLY`` (0),
``BENCH_PRESET`` (``full_reflective`` = config 3, or
``procedural_spheres`` = config 5's 64 spheres), ``BENCH_ADJOINT``
(``twophase`` = K3 + K4, ``fused`` = K6, ``fused2`` = ``mode="split"``;
any other value the residual forward and autograd through the replay,
``kernels/adjoint.py::l2_loss_kernel``, as the JAX bench's
``l2_loss_pallas``), ``BENCH_BACKEND`` (the kernels, ``cuda`` or the JAX
name ``pallas``, by default; ``xla`` the core renderer,
``core/renderer.py``: its forward, or the ``diff/fit.py::l2_loss``
autograd step, whatever the adjoint) and ``BENCH_CHUNK`` (the core
renderer's ``chunk_size``).  ``BENCH_BLOCK_H`` and ``BENCH_BLOCK_W`` set
the TPU kernels' tile policy, which the CUDA kernels do not take (a
thread a pixel, 256 a block): each raises ``ValueError`` naming why.  The
SOL fields are null where no op count covers the step (the core renderer
and the replay: ``opcount.step_work`` counts the kernels).  On the card
the line also gives ``peak_memory_bytes``, the step's
``torch.cuda.max_memory_allocated``.

Timing (``utils/timing.py``): the per-step time is the difference of an
N-step and a 1-step run over N-1, each run ending in a synchronize, the
median of ``BENCH_REPS`` with the spread.  Step k moves the sphere centres
(forward only: the eye) by linspace(0, 1e-5, N)[k], as the JAX bench's
scan does; the target is the kernel's render of the scene, made once, and
``prep=`` is built once, as there (root bench.py:113-120).

One deliberate difference: the JAX bench catches a failure of its SOL
block and prints the timing without it; here a failure of K9 fails the
bench.  Entry points run on the card unless given ``device="cpu"`` /
``--device cpu`` (the tests' plain versions), where no device rate exists:
no SOL block, and ``vs_baseline`` is null, as JAX's is off the TPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

#: the JAX bench's knobs that name what the port does not have
UNPORTED = {
    "BENCH_BLOCK_H": "the TPU kernels' tile height; the CUDA kernels run a "
                     "thread a pixel, 256 a block, and take no tile policy",
    "BENCH_BLOCK_W": "the TPU kernels' tile width; the CUDA kernels run a "
                     "thread a pixel, 256 a block, and take no tile policy",
}
#: the kernel paths' adjoints (``fit_value_and_grad`` modes), by the JAX
#: bench's names; any other BENCH_ADJOINT runs the replay
#: (``l2_loss_kernel``)
ADJOINT_MODES = {"twophase": "twophase", "fused": "fused", "fused2": "split"}


def knobs(env) -> dict:
    """The knobs from ``env`` (a mapping like ``os.environ``); raises
    ``ValueError`` on an unported one."""
    for key, why in UNPORTED.items():
        if env.get(key):
            raise ValueError(f"{key} is not supported by the port: {why}")
    backend = env.get("BENCH_BACKEND", "cuda")
    if backend not in ("cuda", "pallas", "xla"):
        raise ValueError(f"BENCH_BACKEND={backend}: cuda (the kernels; the "
                         f"JAX bench's 'pallas') or xla (the core renderer)")
    adjoint = env.get("BENCH_ADJOINT", "twophase")
    preset = env.get("BENCH_PRESET", "full_reflective")
    if preset not in ("full_reflective", "procedural_spheres"):
        raise ValueError(f"BENCH_PRESET={preset}: full_reflective or "
                         f"procedural_spheres")
    return dict(size=int(env.get("BENCH_SIZE", "1024")),
                depth=int(env.get("BENCH_DEPTH", "3")),
                iters=int(env.get("BENCH_ITERS", "64")),
                reps=int(env.get("BENCH_REPS", "5")),
                forward_only=env.get("BENCH_FORWARD_ONLY", "0") == "1",
                preset=preset, adjoint=adjoint,
                core=backend == "xla",
                chunk=int(env["BENCH_CHUNK"]) if env.get("BENCH_CHUNK")
                else None)


def path_of(k: dict) -> str:
    """What the bench's step runs for knobs ``k``: ``core`` (the core
    renderer and its autograd), ``forward`` (the forward kernel, whatever
    the adjoint), a ``fit_value_and_grad`` mode, or ``replay``
    (``l2_loss_kernel``)."""
    if k["core"]:
        return "core"
    if k["forward_only"]:
        return "forward"
    return ADJOINT_MODES.get(k["adjoint"], "replay")


def setup(preset, forward_only: bool, dev) -> dict:
    """A bench's scene, camera and config from ``preset`` (a presets
    triple), its target (the kernel's render, made once; None forward only)
    and parameters."""
    from .diff.fit import FitParams
    from .kernels.render import render_image_kernel
    from .ops.rays import Camera
    scene, camcfg, config = preset
    camera = Camera.from_config(camcfg, config.width, config.height,
                                device=dev)
    target = None
    if not forward_only:
        target = render_image_kernel(scene, camera, config, device=dev)
    return dict(scene=scene, camera=camera, config=config, target=target,
                params=FitParams.from_scene(scene).to(dev))


def _preset(k: dict):
    from .scene import presets
    return getattr(presets, k["preset"])(size=k["size"], depth=k["depth"])


def time_steps(s: dict, *, forward_only: bool, mode: str, iters: int,
               reps: int, dev) -> dict:
    """``scan_diff_median`` of the bench's step on ``setup``'s ``s``: step
    k moves the sphere centres (forward only: the eye) by
    linspace(0, 1e-5, iters)[k]; ``prep=`` is built once.  ``mode``
    (``path_of``): a ``fit_value_and_grad`` mode, ``replay``
    (``l2_loss_kernel`` and its ``.backward()``) or ``core`` (the core
    renderer: ``render_image``, or ``l2_loss`` and its ``.backward()``)."""
    from .core.renderer import render_image
    from .diff.fit import l2_loss
    from .kernels.adjoint import l2_loss_kernel
    from .kernels.adjoint_fused import fit_value_and_grad, prepare_fit_inputs
    from .kernels.render import render_image_kernel
    from .utils.timing import scan_diff_median, step_runner
    scene, camera, config = s["scene"], s["camera"], s["config"]
    target, params = s["target"], s["params"]
    center0 = params.sph_center.detach().clone()
    eye0 = camera.eye.clone()
    prep = None
    if not forward_only and mode in ("twophase", "fused"):
        prep = prepare_fit_inputs(camera, config, target, device=dev)
    eps = torch.linspace(0.0, 1e-5, iters).tolist()

    def step(i):
        if forward_only:
            cam = dataclasses.replace(camera, eye=eye0 + eps[i])
            render = render_image if mode == "core" else render_image_kernel
            with torch.no_grad():
                return render(scene, cam, config, device=dev)
        with torch.no_grad():
            params.sph_center.copy_(center0).add_(eps[i])
        if mode in ("core", "replay"):
            params.zero_grad()
            loss_fn = l2_loss if mode == "core" else l2_loss_kernel
            loss = loss_fn(params, scene, camera, config, target, device=dev)
            loss.backward()
            return loss
        return fit_value_and_grad(params, scene, camera, config, target,
                                  prep=prep, mode=mode, device=dev)

    run_1, run_n = step_runner(step, iters, dev)
    return scan_diff_median(run_1, run_n, iters, reps=reps)


def step_work_of(s: dict, *, forward_only: bool, mode: str, dev) -> dict:
    """``utils/opcount.py::step_work`` of the last step ``time_steps``
    runs on a fresh ``setup`` ``s`` (sphere centres, or forward only the
    eye, moved by 1e-5): the class operations its SOL prices, and the
    launch of its kernels."""
    from .utils.opcount import step_work
    last = torch.linspace(0.0, 1e-5, 2).tolist()[-1]
    camera, params = s["camera"], s["params"]
    if forward_only:
        camera = dataclasses.replace(camera, eye=camera.eye + last)
    else:
        with torch.no_grad():
            params.sph_center.add_(last)
    return step_work(params.into_scene(s["scene"]), camera, s["config"],
                     s["target"], mode=mode, device=dev)


def last_step_work(k: dict, device=None) -> dict:
    """``step_work_of`` the bench's step for knobs ``k``: what its SOL
    prices (``chip_smoke.py`` and P3 take the same blends).  Only the
    kernel paths have an op count; the core renderer and the replay raise
    ``ValueError``."""
    from .kernels.render import resolve_device
    mode = path_of(k)
    if mode in ("core", "replay"):
        raise ValueError(f"no op count covers the {mode} path's step")
    dev = resolve_device(device)
    return step_work_of(setup(_preset(k), k["forward_only"], dev),
                        forward_only=k["forward_only"], mode=mode, dev=dev)


def main(argv=None, device=None) -> dict:
    """Runs the bench; prints and returns its JSON object."""
    from .kernels.render import resolve_device
    from .utils.timing import time_ms

    ap = argparse.ArgumentParser(prog="ray_tracer_fragment_shader_tpu_torch"
                                      ".bench")
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions (tests)")
    args = ap.parse_args(argv)
    k = knobs(os.environ)
    dev = resolve_device(device if device is not None else args.device)
    size, depth, iters, reps = k["size"], k["depth"], k["iters"], k["reps"]
    forward_only = k["forward_only"]
    mode = path_of(k)
    s = setup(_preset(k), forward_only, dev)
    if k["chunk"]:
        s["config"] = dataclasses.replace(s["config"], chunk_size=k["chunk"])
    config = s["config"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    timing = time_steps(s, forward_only=forward_only, mode=mode,
                        iters=iters, reps=reps, dev=dev)
    dt = max(timing["dt"], 1e-9)
    rays = size * size * config.samples
    pixels = size * size

    # no op count covers the core renderer's or the replay's step
    kernel_path = mode not in ("core", "replay")
    sol = {"sol_fraction": None, "ops_per_pixel_fwd": None,
           "ops_per_pixel_bwd": None, "mix_rate_ops_per_s": None}
    kern_line, peak = "", None
    if dev.type == "cuda":
        from .kernels.probe import gpu_query
        peak = torch.cuda.max_memory_allocated(dev)
        device_name = torch.cuda.get_device_name(dev)
        power_limit = gpu_query("power.limit", dev.index or 0)
    else:
        device_name, power_limit = "cpu", None
    if dev.type == "cuda" and kernel_path:
        from .utils.roofline import sol_report
        work = last_step_work(k, dev)
        rep = sol_report(work["fwd"], work["bwd"], pixels,
                         fwd_s=dt if forward_only else None,
                         fwd_bwd_s=None if forward_only else dt,
                         device=dev)
        key = "fwd" if forward_only else "fwd_bwd"
        sol = {"sol_fraction": rep[f"sol_fraction_{key}"],
               "ops_per_pixel_fwd": rep["ops_per_pixel_fwd"],
               "ops_per_pixel_bwd": rep["ops_per_pixel_bwd"],
               # denominator: K9's rate at this step's class blend
               "mix_rate_ops_per_s": rep[f"mix_rate_{key}_ops_per_s"]}
        kern_ms = time_ms(work["launch"], 20)
        kern_line = (f" kernels {'+'.join(work['kernels'])} {kern_ms:.4f} ms "
                     f"by CUDA events = {kern_ms / (dt * 1e3):.4f} of the "
                     f"step; their sol_fraction "
                     f"{rep[f'sol_{key}_s'] * 1e3 / kern_ms:.4f}")

    tag = "" if k["preset"] == "full_reflective" else f"_{k['preset']}"
    out = {
        "metric": f"rays_per_s_per_chip_{'fwd' if forward_only else 'fwd_bwd'}"
                  f"_{size}x{size}_depth{depth}{tag}",
        "value": round(rays / dt, 1),
        "unit": "rays/s",
        # fraction of the card's speed of light for this step's operations
        # at K9's rate; null off the card and where no op count covers
        # the step
        "vs_baseline": sol["sol_fraction"],
        "ray_accounting": "primary rays only (size*size*samples); shadow "
                          "and bounce rays are per-ray work",
        "device": device_name,
        "power_limit": power_limit,
        # the kernels (their plain versions off the card) or the core
        # renderer (the JAX bench's "xla")
        "backend": ("core" if mode == "core" else
                    "cuda" if dev.type == "cuda" else "plain"),
        "adjoint": (None if forward_only else "autograd" if mode == "core"
                    else k["adjoint"]),
        # the CUDA kernels' launch shape: a thread a pixel, 256 a block
        "block": None if mode == "core" else [1, 256],
        "chunk_size": config.chunk_size if mode == "core" else None,
        # torch.cuda.max_memory_allocated over the timed runs (null off
        # the card)
        "peak_memory_bytes": peak,
        "step_time_ms": round(dt * 1e3, 4),
        "step_time_ms_reps": [round(d * 1e3, 4) for d in timing["dts"]],
        "timing": {"iters": iters, "reps": reps,
                   "method": timing["method"],
                   "spread": round(timing["spread"], 4)},
        **sol,
    }
    print(json.dumps(out))
    print(f"# device={device_name} power_limit={power_limit} "
          f"step_time={dt * 1e3:.4f}ms (median of {reps} x {iters}-step "
          f"differences {[round(d * 1e3, 4) for d in timing['dts']]}, "
          f"warmup {timing['warmup_s']:.1f}s) "
          f"mode={'fwd' if forward_only else 'fwd+bwd'} path={mode} "
          f"peak_memory={peak}{kern_line}",
          file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
