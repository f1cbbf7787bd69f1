"""The roofline model against measured times on the card -- the port of the
JAX package's ``scripts/roofline_validate.py``.

For configurations spanning scene size (4 and 64 spheres), depth (2/3/5),
resolution (512^2 to 2048^2) and mode (forward, fwd+bwd), this measures
the bench's step time (``bench.time_steps``: iteration-count differencing
on the host clock, each run synchronized), the device time of the step's
kernels alone (``utils/timing.py::time_ms``), and the model's speed-of-light
time: the step's class operations (``utils/opcount.py::step_work``) over
K9's rate for that row's own blend (every row's K9 library built at once
first).

The model is a lower bound, so its *shape* is tested: if the efficiency
eff = SOL time / measured time is one constant, t_pred = SOL time /
median(eff) predicts every measured time.  The residuals of the step times
and of the kernels' times are both reported; the step includes the host's
work, which the model does not price.

Usage (on the card):
    python -m ray_tracer_fragment_shader_tpu_torch.probes.roofline_validate \\
        [--iters 32] [--reps 3]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..kernels import cuda_build
from ..kernels import probe as PR
from . import common


def rows():
    """(label, preset triple, mode): the JAX script's configurations."""
    from ..scene import presets
    fr3 = presets.full_reflective(size=1024, depth=3)
    c5 = presets.procedural_spheres(n=64, size=2048, depth=3)
    s, c, cf = presets.fit_target(size=512)
    ft = (s, c, dataclasses.replace(cf, samples=1, force_jitter=False))
    return [
        ("full_reflective 1024^2 d3", fr3, "fwd"),
        ("full_reflective 1024^2 d3", fr3, "fwd_bwd"),
        ("full_reflective 1024^2 d2",
         presets.full_reflective(size=1024, depth=2), "fwd_bwd"),
        ("full_reflective 1024^2 d5",
         presets.full_reflective(size=1024, depth=5), "fwd_bwd"),
        ("full_reflective 512^2 d3",
         presets.full_reflective(size=512, depth=3), "fwd_bwd"),
        ("procedural_64sph 2048^2 d3", c5, "fwd"),
        ("procedural_64sph 2048^2 d3", c5, "fwd_bwd"),
        (f"fit_target 512^2 d{ft[2].max_depth}", ft, "fwd_bwd"),
    ]


def _residuals(out, key):
    effs = sorted(r[f"eff_{key}"] for r in out)
    med = effs[len(effs) // 2]
    for r in out:
        pred = r["sol_ms"] / med
        r[f"pred_{key}_ms"] = pred
        r[f"residual_{key}_pct"] = 100 * (pred - r[f"{key}_ms"]) / r[
            f"{key}_ms"]
    return med


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="roofline_validate")
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(common.OUT_DIR,
                                                  "model_vs_measured.json"))
    args = ap.parse_args(argv)

    from .. import bench
    from ..kernels.render import resolve_device
    from ..utils.roofline import (_rewrite_schedule, flat_slots,
                                  mix_rate_details, mix_schedule)
    from ..utils.timing import time_ms
    dev = resolve_device(None)
    todo = []
    for label, preset, mode in rows():
        fwd = mode == "fwd"
        work = bench.step_work_of(bench.setup(preset, fwd, dev),
                                  forward_only=fwd, mode="twophase", dev=dev)
        counts = dict(work["fwd"])
        for k, v in work["bwd"].items():
            counts[k] = counts.get(k, 0.0) + v
        todo.append((label, preset, mode, work, counts))
    cuda_build.build_probes([("mix_probe.cu", PR.mix_defines(
        _rewrite_schedule(mix_schedule(c))[0])) for *_, c in todo])

    out = []
    with PR.ClockSampler() as clk:
        for label, preset, mode, work, counts in todo:
            fwd = mode == "fwd"
            cfg = preset[2]
            timing = bench.time_steps(bench.setup(preset, fwd, dev),
                                      forward_only=fwd, mode="twophase",
                                      iters=args.iters, reps=args.reps,
                                      dev=dev)
            kern_ms = time_ms(work["launch"], 10)
            rate = mix_rate_details(counts, device=dev)
            sol_ms = flat_slots(counts) / rate["rate"] * 1e3
            step_ms = timing["dt"] * 1e3
            pixels = cfg.width * cfg.height
            out.append(dict(label=label, mode=mode, pixels=pixels,
                            depth=cfg.max_depth,
                            kernels="+".join(work["kernels"]),
                            ops_per_pixel=flat_slots(counts) / pixels,
                            mix_rate=rate["rate"], step_ms=step_ms,
                            step_spread=timing["spread"],
                            kernel_ms=kern_ms, sol_ms=sol_ms,
                            eff_step=sol_ms / step_ms,
                            eff_kernel=sol_ms / kern_ms))
            print(json.dumps(out[-1]), flush=True)
    med_step = _residuals(out, "step")
    med_kernel = _residuals(out, "kernel")
    res = dict(card=common.card(clk.samples), iters=args.iters,
               reps=args.reps, median_eff_step=med_step,
               median_eff_kernel=med_kernel, rows=out)
    common.write(args.out, res)
    print("\n| config | mode | step ms | kernels ms | SOL ms | eff step | "
          "eff kernels | resid step | resid kernels |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in out:
        print(f"| {r['label']} | {r['mode']} | {r['step_ms']:.4f} | "
              f"{r['kernel_ms']:.4f} | {r['sol_ms']:.5f} | "
              f"{r['eff_step']:.4f} | {r['eff_kernel']:.4f} | "
              f"{r['residual_step_pct']:.1f}% | "
              f"{r['residual_kernel_pct']:.1f}% |")
    print(f"\nmedian efficiency: step {med_step:.4f}, kernels "
          f"{med_kernel:.4f} [{res['card']['nvidia_smi']}]")
    return res


if __name__ == "__main__":
    main()
