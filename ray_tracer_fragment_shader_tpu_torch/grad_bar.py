"""The BASELINE gradient bar on the port's kernel arithmetic: candidate
gradients against central finite differences through the float64 numpy
oracle (oracle/gradcheck.py: stable interior pixels, an O(1)-scaled
functional), bar max-abs-err <= 1e-4 (BASELINE.md).  The counterpart of the
JAX package's ``scripts/grad_bar_tpu.py``, with the same three checks:

* ``chain_fit_target``: ``fit_target`` at 128², the residual chain forward
  (K2's residual form) picks the stable pixels, K8 (``fit_grads_kernel``)
  gives the gradients;
* ``tree_two_lights``: a fractional-transparency scene with two lights at
  64², depth 2, the residual tree forward (K5's) picks the pixels, the tree
  form of K7 (``recompute_grads_kernel``) gives the gradients;
* ``camera_eye``: ``fit_target`` at 64², eye gradients through
  ``render_image_diff`` (the residual forward, then the replay's autograd).

On the card (the default) the kernels run; ``--cpu`` runs their plain
versions.  Writes chiprun_out/grad_bar_h100.json and exits non-zero if a
check misses the bar:

    python -m ray_tracer_fragment_shader_tpu_torch.grad_bar [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import Any, Callable, Dict

import numpy as np
import torch

from .kernels.adjoint import render_image_diff
from .kernels.adjoint_fused import fit_grads_kernel, recompute_grads_kernel
from .kernels.render import (compact_scene, render_forward_with_residuals,
                             resolve_device)
from .ops.rays import Camera
from .oracle.gradcheck import (fd_eye, make_functional, param_checks,
                               stable_interior_pixels, stratified_pick,
                               summarize)
from .scene import Material, SceneBuilder, presets

BAR = 1e-4  # BASELINE.md: grad max-abs-err against the reference
OUT = os.path.join("chiprun_out", "grad_bar_h100.json")


def _picked(scene, camcfg, cfg, device, n_each: int, seed: int):
    """The residual forward on the compacted scene, then the stable
    interior pixels it picks (``stratified_pick``) and random RGB weights
    for them: (scene, camera, residuals, pixels, weights)."""
    scene = compact_scene(scene)
    cam = Camera.from_config(camcfg, cfg.width, cfg.height, device=device)
    _, res = render_forward_with_residuals(scene, cam, cfg, device=device)
    pix = stable_interior_pixels(res, cfg, scene, camcfg)
    pix, _ = stratified_pick(pix, res, scene, n_each=n_each)
    w_rgb = np.random.RandomState(seed).uniform(0.25, 1.0,
                                                size=(len(pix), 3))
    return scene, cam, res, pix, w_rgb


def _param_bar(scene, camcfg, cfg, device, n_each: int,
               grads_fn: Callable) -> Dict[str, Any]:
    """The FitParams gradients of ``grads_fn(scene, camera, residuals, g)``
    under the functional's cotangent plane, against finite differences."""
    scene, cam, res, pix, w_rgb = _picked(scene, camcfg, cfg, device, n_each,
                                          seed=0)
    g = np.zeros((cfg.height, cfg.width, 3), np.float32)
    for k, (j, i) in enumerate(pix):
        g[j, i] = w_rgb[k] / len(pix)
    grads = grads_fn(scene, cam, res, torch.from_numpy(g).to(device))
    grads = {k: v.detach().double().cpu().numpy() for k, v in grads.items()}
    J = make_functional(scene, cfg, camcfg, pix, w_rgb)
    return summarize(param_checks(J, scene, grads))


def run_chain(size: int = 128, device=None) -> Dict[str, Any]:
    """K8 on ``fit_target``: the split mode's backward."""
    scene, camcfg, cfg = presets.fit_target(size=size)
    return _param_bar(
        scene, camcfg, cfg, resolve_device(device), 16,
        lambda s, c, res, g: fit_grads_kernel(s, c, cfg, res, g,
                                              device=g.device))


def tree_scene():
    """A glass sphere of fractional transparency beside an opaque one, lit
    by two lights (scripts/grad_bar_tpu.py::run_tree's scene)."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    return (SceneBuilder().add_checkerboard()
            .add_sphere("d5", material=glass).add_sphere("c3")
            .add_light("b6").add_light("f7", color=(0.8, 0.9, 1.0))
            .build())


def run_tree(size: int = 64, device=None) -> Dict[str, Any]:
    """K7's tree form on the two-light fractional scene, depth 2."""
    camcfg = presets._cam(size)
    cfg = dataclasses.replace(presets.fit_target(size=size)[2], max_depth=2)
    return _param_bar(
        tree_scene(), camcfg, cfg, resolve_device(device), 8,
        lambda s, c, res, g: recompute_grads_kernel(s, c, cfg, g,
                                                    device=g.device))


def run_camera(size: int = 64, device=None) -> Dict[str, Any]:
    """Eye gradients of ``render_image_diff`` on ``fit_target``."""
    device = resolve_device(device)
    scene, camcfg, cfg = presets.fit_target(size=size)
    scene, cam, _, pix, w_rgb = _picked(scene, camcfg, cfg, device, 8,
                                        seed=1)
    cam = dataclasses.replace(cam, eye=cam.eye.clone().requires_grad_())
    jj = torch.tensor([p[0] for p in pix], device=device)
    ii = torch.tensor([p[1] for p in pix], device=device)
    w = torch.as_tensor(w_rgb, dtype=torch.float32, device=device)
    img = render_image_diff(scene, cam, cfg, device=device)
    (torch.sum(w * img[jj, ii]) / len(pix)).backward()
    g_eye = cam.eye.grad.double().cpu().numpy()
    J = make_functional(scene, cfg, camcfg, pix, w_rgb)
    return summarize([(f"eye[{a}]", float(g_eye[a]), fd_eye(J, a, 1e-3))
                      for a in range(3)])


CHECKS = (("chain_fit_target", run_chain, 128),
          ("tree_two_lights", run_tree, 64),
          ("camera_eye", run_camera, 64))


def run_all(device=None, size: int = 128,
            bar: float = BAR) -> Dict[str, Dict[str, Any]]:
    """The three checks, each printed; each summary gains ``pass``
    (max_abs_err <= ``bar``).  ``size`` is the chain check's."""
    out = {}
    for name, fn, n in CHECKS:
        s = fn(size if name == "chain_fit_target" else n, device=device)
        s["pass"] = bool(s["max_abs_err"] <= bar)
        out[name] = s
        print(f"grad bar {name}: {json.dumps(s)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--bar", type=float, default=BAR)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip()
    else:
        card = "cpu (the kernels' plain versions)"
    out = dict(device=card, size=args.size, bar=args.bar,
               checks=run_all(device, args.size, args.bar))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    ok = all(s["pass"] for s in out["checks"].values())
    print(json.dumps(dict(device=card, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
