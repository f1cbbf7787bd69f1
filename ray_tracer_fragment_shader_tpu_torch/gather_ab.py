"""A/B of the plain replay's row gathers on the card, at config 3 (1024²,
depth 3): autograd's own backward of ``table[idx]`` (an accumulating
``index_put_``) against ``ops/gather.py::GatherRows`` (one-hot
products over fixed chunks of pixels).  Each side times K8's plain version
(``fit_grads_ref``) and ``render_image_diff``'s fwd+bwd
(``l2_loss_kernel(...).backward()``), alternated index, one-hot, one-hot,
index in one process, and the two sides' gradient tables are held within
1e-5 of max of each other.  Prints one JSON line; exits non-zero without a
GPU or when the sides disagree:

    python -m ray_tracer_fragment_shader_tpu_torch.gather_ab
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from .diff.fit import FitParams
from .kernels import adjoint as A
from .kernels import adjoint_fused as AF
from .kernels import render as K
from .ops.rays import Camera, primary_rays, screen_points
from .scene import presets
from .utils.timing import time_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    scene, cam, cfg = presets.full_reflective(size=1024, depth=3)
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    target = K.render_image_kernel(scene, camera, cfg, device=dev)
    params = FitParams.from_scene(scene).to(dev)
    with torch.no_grad():
        params.sph_center += 1.5
    _, tables, kw = AF.scene_tables(params.into_scene(scene), cfg, dev)
    _, v = primary_rays(camera, screen_points(camera, cfg.width, cfg.height))
    v, eye = v.contiguous(), camera.eye.tolist()
    img, res = K.render_residuals(tables, v, eye, tree=False, **kw)
    g = (2.0 / (v.shape[0] * 3)) * (img - target.reshape(-1, 3))
    fkw = {k: kw[k] for k in ("nl", "depth", "atten", "want_trans")}

    def plain():
        return AF.fit_grads_ref(tables, v, eye, g, res, **fkw)

    def diff_step():
        params.zero_grad()
        A.l2_loss_kernel(params, scene, camera, cfg, target,
                         device=dev).backward()

    onehot = A._gather_rows
    sides = {"index": lambda t, i: t[i], "onehot": onehot}
    times = {s: {"fit_grads_ref": [], "render_image_diff": []}
             for s in sides}
    tabs = {}
    for side in ("index", "onehot", "onehot", "index"):
        A._gather_rows = sides[side]
        tabs[side] = plain()
        times[side]["fit_grads_ref"].append(time_ms(plain, 1))
        times[side]["render_image_diff"].append(time_ms(diff_step, 1))
    A._gather_rows = onehot
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(tabs["onehot"], tabs["index"]))
    print(json.dumps(dict(card=card, cell="config 3 1024^2 d3", ms=times,
                          max_rel_diff=rel)))
    return 0 if rel <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
