"""Command-line interface of the PyTorch/CUDA port: the reference's stdin
scene menu and render-to-file, replacing its SDL app shell.

The reference's user surface was an interactive stdin loop asking for
object types (a-f) and board coordinates (``initScene2``,
Hw4/MySdlApplication.cpp:1430-1493), then a 500x500 SDL/OpenGL window
repainting the ray trace every frame (``onExecute``/``onRender``,
``:1631-1659``).  Here ``interactive`` replicates the menu and renders to
an image file, ``render`` renders a named preset, ``fit`` runs the
differentiable-fit workload (BASELINE config 4) and ``bench`` the headline
benchmark (``bench.py``).  They run through the kernels (on the GPU, the
CUDA kernels; with ``--cpu``, their plain PyTorch versions), but for
``fit --views > 1``, the multi-view recipe, which trains by autograd
through the core renderer (diff/multiview.py), as the JAX CLI does.
Without ``--cpu`` and without a GPU they raise.

Usage:
  python -m ray_tracer_fragment_shader_tpu_torch.cli render \
      --preset reference_demo --size 256 --out demo.png
  python -m ray_tracer_fragment_shader_tpu_torch.cli interactive --out scene.png
  python -m ray_tracer_fragment_shader_tpu_torch.cli fit --steps 100 \
      --out-dir fit_out
  python -m ray_tracer_fragment_shader_tpu_torch.cli fit --views 3 \
      --size 128 --steps 30
  python -m ray_tracer_fragment_shader_tpu_torch.cli bench --size 1024
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

import torch


def _add_common(p):
    p.add_argument("--size", type=int, default=None,
                   help="square image size (preset default if omitted)")
    p.add_argument("--depth", type=int, default=None, help="max bounce depth")
    p.add_argument("--samples", type=int, default=None, help="samples per pixel")
    p.add_argument("--adaptive", action="store_true",
                   help="the reference's adaptive supersampler")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", choices=["auto", "chain", "tree"], default="auto")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions)")
    p.add_argument("--out", default="render.png",
                   help="output image (.png/.ppm/.npy)")


def _device(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port renders on the GPU; "
                           "pass --cpu to render on the CPU with the "
                           "kernels' plain versions")
    return torch.device("cuda")


def _load_preset(args):
    from .scene import presets
    kwargs = {}
    if args.size:
        kwargs["size"] = args.size
    fn = presets.PRESETS[args.preset]
    if args.preset == "reference_demo":
        kwargs.pop("size", None)
    scene, cam, cfg = fn(**kwargs)
    if args.preset == "reference_demo" and args.size:
        cfg = dataclasses.replace(cfg, width=args.size, height=args.size)
    updates = {"seed": args.seed, "mode": args.mode}
    if args.depth is not None:
        updates["max_depth"] = args.depth
    if args.samples is not None:
        updates["samples"] = args.samples
    if args.adaptive:
        updates["adaptive"] = True
    return scene, cam, dataclasses.replace(cfg, **updates)


def _render_and_write(scene, cam, cfg, out_path, device):
    from .io.image import write_image
    from .kernels.render import render_image_kernel
    t0 = time.perf_counter()
    img = render_image_kernel(scene, cam, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    write_image(out_path, img.cpu().numpy())
    rays = cfg.width * cfg.height * cfg.samples
    print(f"rendered {cfg.width}x{cfg.height} depth={cfg.max_depth} "
          f"samples={cfg.samples} on {device.type} in {dt:.3f} s "
          f"({rays / dt / 1e6:.1f}M primary rays/s, incl. set-up) "
          f"-> {out_path}")
    return img


def cmd_render(args):
    device = _device(args)
    scene, cam, cfg = _load_preset(args)
    if args.watch:
        # Progressive preview: re-render at growing resolution, rewriting
        # --out after each pass — the headless analogue of the reference's
        # live repaint loop (MySdlApplication.cpp:1631-1659, deviation D6).
        # One common divisor for both axes (clamped so neither drops below
        # 16 pixels) and a widened pixel_scale keep every pass framing the
        # same world rectangle; equal consecutive divisors are deduplicated.
        divisors = []
        for scale in (8, 4, 2, 1):
            d = max(min(scale, cfg.width // 16, cfg.height // 16), 1)
            if not divisors or divisors[-1] != d:
                divisors.append(d)
        for d in divisors:
            w, h = cfg.width // d, cfg.height // d
            cam_s = dataclasses.replace(
                cam, pixel_scale=cam.pixel_scale * cfg.width / w)
            cfg_s = dataclasses.replace(cfg, width=w, height=h)
            img = _render_and_write(scene, cam_s, cfg_s, args.out, device)
        return img
    return _render_and_write(scene, cam, cfg, args.out, device)


def read_board_map():
    """The stdin menu of initScene2: type letter + board coordinate, repeat;
    duplicate coordinates overwrite (map<string,int> semantics).  Returns
    {coordinate: menu index}."""
    board_map = {}
    while True:
        print("Please select the type of object to add:")
        print("(a) light, (b) tetrahedron, (c) cube, (d) sphere, "
              "(e) cylinder, (f) cone")
        t = input().strip().lower()
        if not (len(t) == 1 and "a" <= t <= "f"):
            continue
        print("Please enter the position: (a1-h8)")
        coord = input().strip().lower()
        if not (len(coord) == 2 and "a" <= coord[0] <= "h"
                and "1" <= coord[1] <= "8"):
            print(f"invalid coordinate {coord!r}")
            continue
        board_map[coord] = ord(t) - ord("a")
        print("Would you like to add another object? (yes/no)")
        while True:
            a = input().strip().lower()
            if a in ("no", "n"):
                return board_map
            if a in ("yes", "y"):
                break
            print("Would you like to add another object? (yes/no)")


def cmd_interactive(args):
    from .config import CameraConfig, RenderConfig
    from .scene import MENU_TYPES, SceneBuilder
    device = _device(args)
    board_map = read_board_map()
    builder = SceneBuilder().add_checkerboard()
    builder.load_board_map(board_map)
    scene = builder.build()
    types = {c: MENU_TYPES[t] for c, t in sorted(board_map.items())}
    print(f"scene: checkerboard + {types}")
    size = args.size or 500
    cfg = RenderConfig(width=size, height=size,
                       max_depth=args.depth if args.depth is not None else 5,
                       samples=args.samples if args.samples is not None else 1,
                       adaptive=args.adaptive, seed=args.seed, mode=args.mode)
    return _render_and_write(scene, CameraConfig(), cfg, args.out, device)


def cmd_fit(args):
    """Fits sphere centres and radii and the light position of
    ``fit_target`` to its own render, from a seeded perturbation (the JAX
    CLI's recipe).  One view steps ``make_fit_step_kernel``; ``--views >
    1`` runs ``fit_multiview`` over ``orbit_views`` spanning ``--span``
    degrees, with targets from the core renderer (JAX cli.py:192-213), and
    prints its recovery report.  Returns (params, loss history)."""
    from .diff.fit import FitParams, fit
    from .io.image import write_image
    from .kernels.render import render_image_kernel
    from .ops.rays import Camera
    from .scene import presets
    from .utils.checkpoint import save_checkpoint
    device = _device(args)
    scene, camcfg, cfg = presets.fit_target(size=args.size or 128)
    # the JAX CLI's fit parses --no-prune and ignores it; here the core's
    # multi-view fit honours it (the kernels never prune)
    cfg = dataclasses.replace(cfg, prune=not args.no_prune)
    camera = Camera.from_config(camcfg, cfg.width, cfg.height, device=device)
    target = render_image_kernel(scene, camera, cfg, device=device)

    init = FitParams.from_scene(scene)
    rng = np.random.RandomState(args.seed)
    nv = int(scene.sph_valid.sum())
    dc = np.zeros((scene.num_spheres, 3), np.float32)
    dc[:nv] = rng.uniform(-8, 8, (nv, 3))
    dr = (1 + rng.uniform(-0.15, 0.15, scene.num_spheres)).astype(np.float32)
    dl = rng.uniform(-20, 20, (scene.num_lights, 3)).astype(np.float32)
    with torch.no_grad():
        init.sph_center += torch.from_numpy(dc)
        init.sph_radius *= torch.from_numpy(dr)
        init.light_pos += torch.from_numpy(dl)

    report = None
    if args.views > 1:
        # the robust config-4 recipe: orbit views + multiscale + soft-
        # silhouette annealing + restarts (diff/multiview.py)
        from .diff.multiview import (fit_multiview, orbit_views,
                                     recovery_report, render_views)
        views = orbit_views(camcfg, args.views, span_deg=args.span)
        targets = render_views(scene, views, cfg, device=device)
        full = cfg.width
        sizes = tuple(s for s in (full // 8, full // 4, full // 2)
                      if s >= 32)
        res = fit_multiview(scene, views, cfg, targets, init=init,
                            sizes=sizes,
                            steps_per_sigma=max(args.steps // 3, 10),
                            geom_lr=args.lr, seed=args.seed,
                            log_every=max(args.steps // 5, 1), device=device)
        params, history = res.params, res.history
        report = recovery_report(params, scene)
        print("recovery error (world units; board square = 40):")
        print(json.dumps(report, indent=2))
    else:
        params, history = fit(scene, camera, cfg, target, steps=args.steps,
                              learning_rate=args.lr, params=init,
                              log_every=max(args.steps // 10, 1),
                              device=device)
    print(f"loss: {history[0]:.6g} -> {history[-1]:.6g}")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        write_image(os.path.join(args.out_dir, "target.png"),
                    target.cpu().numpy())
        with torch.no_grad():
            final = render_image_kernel(params.into_scene(scene.to(device)),
                                        camera, cfg, device=device)
        write_image(os.path.join(args.out_dir, "fitted.png"),
                    final.cpu().numpy())
        save_checkpoint(os.path.join(args.out_dir, "params.npz"), params)
        with open(os.path.join(args.out_dir, "history.json"), "w") as f:
            json.dump(history, f)
        if report is not None:
            with open(os.path.join(args.out_dir, "recovery.json"), "w") as f:
                json.dump(report, f, indent=2)
        print(f"wrote target/fitted/params/history to {args.out_dir}")
    return params, history


def cmd_bench(args):
    """The port's headline benchmark (``bench.py``), with ``--size`` and
    ``--depth`` as BENCH_SIZE and BENCH_DEPTH (JAX cli.py:232-241)."""
    from . import bench
    if args.size:
        os.environ["BENCH_SIZE"] = str(args.size)
    if args.depth is not None:
        os.environ["BENCH_DEPTH"] = str(args.depth)
    return bench.main([], device="cpu" if args.cpu else None)


def main(argv=None):
    """Runs one subcommand; returns its result: the (last) rendered [H,W,3]
    image, for ``fit`` (params, loss history), for ``bench`` its JSON
    object."""
    parser = argparse.ArgumentParser(prog="ray_tracer_fragment_shader_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a named preset scene")
    p.add_argument("--preset", default="reference_demo",
                   choices=["reference_demo", "single_sphere",
                            "three_spheres_ground", "full_reflective",
                            "fit_target", "procedural_spheres"])
    _add_common(p)
    p.add_argument("--watch", action="store_true",
                   help="progressive preview: render at 1/8, 1/4, 1/2 then "
                        "full resolution, rewriting --out after each pass")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("interactive",
                       help="build a scene via the reference's stdin menu")
    _add_common(p)
    p.set_defaults(fn=cmd_interactive)

    p = sub.add_parser("fit", help="differentiable fit workload")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--views", type=int, default=1,
                   help=">1 enables the robust multi-view recipe "
                        "(orbit cameras, multiscale, soft annealing)")
    p.add_argument("--span", type=float, default=90.0,
                   help="orbit azimuth span in degrees (--views > 1)")
    p.add_argument("--no-prune", action="store_true",
                   help="disable the core renderer's bounding-sphere "
                        "pruning in the multi-view fit (--views > 1); the "
                        "kernels never prune")
    p.add_argument("--out-dir", default=None)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.add_argument("--size", type=int, default=None,
                   help="square image size (BENCH_SIZE)")
    p.add_argument("--depth", type=int, default=None,
                   help="max bounce depth (BENCH_DEPTH)")
    p.add_argument("--cpu", action="store_true",
                   help="the kernels' plain versions on the CPU (no SOL)")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
