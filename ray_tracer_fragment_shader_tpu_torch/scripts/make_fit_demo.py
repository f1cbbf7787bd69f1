"""Inverse-rendering demo: the multi-view config-4 recipe end to end
(``diff/multiview.py::fit_multiview`` on the core renderer).  Perturb the
``fit_target`` scene (sphere centres and radii, the light), recover it from
3 orbit-view hard renders, and write the evidence:

    chiprun_out/fit_demo_h100/before.png    base view, perturbed init
    chiprun_out/fit_demo_h100/target.png    base view, ground truth
    chiprun_out/fit_demo_h100/after.png     base view, recovered parameters
    chiprun_out/fit_demo_h100/triptych.png  the three side by side
    chiprun_out/fit_demo_h100/recovery.json init/final recovery errors,
                                            stage log

The counterpart of the JAX package's ``scripts/make_fit_demo.py``: the same
recipe (``RECIPE``, an 80 degree span), the same seeded perturbation
(``perturbed_init``: ``np.random.RandomState(seed)``'s draws in JAX's
order) and the same ``recovery.json`` keys, plus ``power_limit`` and
``recipe``.  No kernel runs: the core is plain PyTorch (on the card by
default).  ``--steps-per-sigma``, ``--restarts``, ``--restart-steps`` and
``--polish-steps`` default to JAX's recipe; smaller values make the short
form the tests and ``chip_smoke.py`` run.

    python -m ray_tracer_fragment_shader_tpu_torch.scripts.make_fit_demo \\
        [--size 256] [--seed 3] [--views 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..diff.fit import FitParams
from ..diff.multiview import (fit_multiview, multiview_loss, orbit_views,
                              recovery_report, render_views)
from ..io.image import write_png
from ..ops.rays import Camera
from ..ops.sampling import resolve_device
from ..probes.common import write
from ..scene import presets
from ..scene.flat import FlatScene
from .common import card_of, sync

#: JAX's ``fit_multiview`` arguments (make_fit_demo.py:77-80); the light
#: polish keeps ``fit_multiview``'s default of 120 steps
RECIPE = dict(sizes=(64, 128), sigmas=(1.5, 1.0, None), steps_per_sigma=60,
              restarts=4, restart_steps=40, geom_lr=0.6, light_lr=1.0,
              light_polish_steps=120)
SPAN_DEG = 80.0
OUT = os.path.join("chiprun_out", "fit_demo_h100")


def perturbed_init(scene: FlatScene, seed: int) -> FitParams:
    """The problem the fit has to solve: ``scene``'s parameters with the
    valid spheres' centres moved by uniform(-8, 8), the lights by
    uniform(-10, 10) and every radius scaled by 1 + uniform(-0.1, 0.1), drawn
    from ``np.random.RandomState(seed)`` in that order, in float32 as JAX's
    script adds them (make_fit_demo.py:64-74)."""
    rng = np.random.RandomState(seed)
    nv = int(scene.sph_valid.sum())
    dc = np.zeros((scene.num_spheres, 3), np.float32)
    dc[:nv] = rng.uniform(-8, 8, (nv, 3))
    dl = rng.uniform(-10, 10, tuple(scene.light_pos.shape)).astype(np.float32)
    scale = np.asarray(1 + rng.uniform(-0.1, 0.1, scene.num_spheres),
                       np.float32)
    init = FitParams.from_scene(scene)
    with torch.no_grad():
        init.sph_center.copy_(scene.sph_center + torch.from_numpy(dc))
        init.sph_radius.copy_(scene.sph_radius * torch.from_numpy(scale))
        init.light_pos.copy_(scene.light_pos + torch.from_numpy(dl))
    return init


def fit_demo(size: int = 256, seed: int = 3, views: int = 3,
             out: str = OUT, device=None, **recipe) -> dict:
    """Runs the recipe (``RECIPE``, updated by ``recipe``) on ``device``;
    writes the five files under ``out`` and returns the report."""
    dev = resolve_device(device)
    recipe = dict(RECIPE, **recipe)
    scene, camcfg, cfg = presets.fit_target(size=size)
    view_cfgs = orbit_views(camcfg, views, span_deg=SPAN_DEG)
    cams = [Camera.from_config(v, size, size, device=dev) for v in view_cfgs]
    t0 = time.perf_counter()
    with torch.no_grad():
        targets = render_views(scene, view_cfgs, cfg, device=dev)
    init = perturbed_init(scene, seed)
    err0 = recovery_report(init, scene)
    res = fit_multiview(scene, view_cfgs, cfg, targets, init=init,
                        seed=seed, device=dev, **recipe)
    err1 = recovery_report(res.params, scene)
    sync(dev)
    fit_s = time.perf_counter() - t0

    with torch.no_grad():
        l_init = float(multiview_loss(init, scene, cams, cfg, targets, None,
                                      device=dev))
        l_fit = float(multiview_loss(res.params, scene, cams, cfg, targets,
                                     None, device=dev))
        before, after = (render_views(p.into_scene(scene), view_cfgs[:1],
                                      cfg, device=dev)[0].cpu().numpy()
                         for p in (init, res.params))
    target_img = targets[0].cpu().numpy()
    os.makedirs(out, exist_ok=True)
    write_png(os.path.join(out, "before.png"), before)
    write_png(os.path.join(out, "target.png"), target_img)
    write_png(os.path.join(out, "after.png"), after)
    gap = np.ones((size, 4, 3), np.float32)
    write_png(os.path.join(out, "triptych.png"),
              np.concatenate([before, gap, target_img, gap, after], 1))

    device_name, power_limit = card_of(dev)
    report = dict(
        size=size, views=views, seed=seed, device=device_name,
        power_limit=power_limit, board_square_world_units=40.0,
        init_errors=err0, final_errors=err1, loss_init=l_init,
        loss_fit=l_fit, restart_losses=res.restart_losses,
        stage_log=res.stage_log, fit_wall_s=round(fit_s, 3),
        recipe={k: list(v) if isinstance(v, tuple) else v
                for k, v in recipe.items()})
    write(os.path.join(out, "recovery.json"), report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="ray_tracer_fragment_shader_tpu_torch.scripts.make_fit_demo")
    ap.add_argument("--size", type=int, default=256,
                    help="full-resolution stage (BASELINE config 4 is 512; "
                         "JAX's demo runs 256)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--steps-per-sigma", type=int,
                    default=RECIPE["steps_per_sigma"])
    ap.add_argument("--restarts", type=int, default=RECIPE["restarts"])
    ap.add_argument("--restart-steps", type=int,
                    default=RECIPE["restart_steps"])
    ap.add_argument("--polish-steps", type=int,
                    default=RECIPE["light_polish_steps"])
    ap.add_argument("--device", default=None,
                    help="cpu runs the recipe on the CPU")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    report = fit_demo(args.size, args.seed, args.views, args.out,
                      args.device, steps_per_sigma=args.steps_per_sigma,
                      restarts=args.restarts,
                      restart_steps=args.restart_steps,
                      light_polish_steps=args.polish_steps)
    e0, e1 = report["init_errors"], report["final_errors"]
    print(json.dumps(dict(
        center_err=(e0["center_err_max"], e1["center_err_max"]),
        light_err=(e0["light_err_max"], e1["light_err_max"]),
        loss=(report["loss_init"], report["loss_fit"]),
        wall_s=report["fit_wall_s"], device=report["device"],
        power_limit=report["power_limit"])))
    return report


if __name__ == "__main__":
    main()
