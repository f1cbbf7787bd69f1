"""A/B of ``RenderConfig.bf16_shading`` on the card at config 3
(full_reflective 1024², depth 3): the counterpart of the JAX package's
``scripts/bf16_shading_ab.py``.

    python -m ray_tracer_fragment_shader_tpu_torch.bf16_ab [--out PATH]

Measures, f32 and bf16 interleaved (f32, bf16, bf16, f32) in one process:

* ``fwd``: one ``render_image_kernel`` call (the chain kernel, K2) and
  ``fwd_bwd``: one ``fit_value_and_grad`` step with a prepared target (K3 +
  K4), each on the host clock by iteration-count differencing
  (``utils/timing.py::scan_diff_median``), as the JAX script times them;
* the device time of the kernels alone by CUDA events (``time_ms``): K2,
  and K3 + K4;
* parity of the bf16 image against the f32 one: p99 of the per-pixel max
  channel difference, and the fractions past 3e-2
  (tests/test_bf16_shading.py's bars) and past 1e-3.

Prints the card's name and power limit, then one JSON line, and writes it
to ``--out`` (default ``chiprun_out/bf16_shading_ab_h100.json``).  Needs
one CUDA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

from .diff.fit import FitParams
from .kernels import adjoint_fused as AF
from .kernels import render as K
from .ops.rays import Camera
from .scene import presets
from .utils.timing import scan_diff_median, step_runner, time_ms

OUT = os.path.join("chiprun_out", "bf16_shading_ab_h100.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    scene, cam, config = presets.full_reflective(size=1024, depth=3)
    cfgs = {"f32": config,
            "bf16": dataclasses.replace(config, bf16_shading=True)}
    camera = Camera.from_config(cam, config.width, config.height, device=dev)
    imgs = {k: K.render_image_kernel(scene, camera, c, device=dev)
            for k, c in cfgs.items()}
    d = (imgs["bf16"] - imgs["f32"]).abs().amax(-1)
    parity = dict(p99=torch.quantile(d.flatten(), 0.99).item(),
                  frac_gt_3e2=(d > 3e-2).float().mean().item(),
                  frac_gt_1e3=(d > 1e-3).float().mean().item())
    target = imgs["bf16"]
    params = FitParams.from_scene(scene).to(dev)
    with torch.no_grad():
        params.sph_center += 1.5

    def steps(name):
        cfg = cfgs[name]
        prep = AF.prepare_fit_inputs(camera, cfg, target, device=dev)
        _, t, kw, akw = AF.kernel_inputs(params.into_scene(scene), cfg,
                                         prep["v"].shape[0], device=dev)
        v, eye = prep["v"], prep["eye"]

        def k3k4():
            img, pk = K.render_packed(t, v, eye, pack=akw["pack"], **kw)
            return AF.adjoint_packed(t, v, eye, img, prep["target"],
                                     prep["mask"], pk, **akw)
        return dict(
            fwd=lambda k: K.render_image_kernel(scene, camera, cfg,
                                                device=dev),
            fwd_bwd=lambda k: AF.fit_value_and_grad(
                params, scene, camera, cfg, target, prep=prep, mode="twophase",
                device=dev),
            k2=lambda: K.render_chain(t, v, eye, **kw), k3k4=k3k4)

    out = dict(card=card, device=torch.cuda.get_device_name(0),
               cell="config 3 full_reflective 1024^2 d3", parity=parity,
               order=["f32", "bf16", "bf16", "f32"], ms={})
    for name in out["order"]:
        s = steps(name)
        row = out["ms"].setdefault(name, {k: [] for k in
                                          ("fwd", "fwd_bwd", "k2", "k3k4")})
        for key in ("fwd", "fwd_bwd"):
            r1, rn = step_runner(s[key], args.iters, dev)
            row[key].append(scan_diff_median(r1, rn, args.iters,
                                             args.reps)["dt"] * 1e3)
        row["k2"].append(time_ms(s["k2"], 20))
        row["k3k4"].append(time_ms(s["k3k4"], 20))
    out["bf16_over_f32"] = {
        key: (sum(out["ms"]["bf16"][key]) / sum(out["ms"]["f32"][key]))
        for key in ("fwd", "fwd_bwd", "k2", "k3k4")}
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
