#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the device (name and power limit as nvidia-smi reports them, torch and
   CUDA versions) and the kernels' build from ``kernels/csrc/`` (nvcc);
2. each kernel against its plain PyTorch version on the card, same inputs,
   at 128x128: the fraction of pixels whose max-channel difference exceeds
   1e-3 must stay within 1% (2% for reference_demo, whose horizon row is
   checker-parity noise), and the image means must agree within 1%;
3. the main path through the port's CLI (``cli.main(["render", ...])``,
   writing PNGs under chiprun_out/chip_smoke/): BASELINE config 3
   (full_reflective, 1024^2, depth 3), reference_demo at its own 500^2,
   depth 5, 16-sample adaptive, config 5 (procedural_spheres n=64, 4096^2,
   depth 3) and full_reflective at 1024^2 forced to the tree kernel.  The
   launch counters, zeroed just before, must show every kernel launched;
   every image must be finite and non-black.  Each single-sample image
   (1024^2 chain, 4096^2 chain, 1024^2 tree) must match its kernel's plain
   version on the same rays within phase 2's budget; the jittered adaptive
   demo is checked for finite, non-black pixels only;
4. each timed kernel's output against its plain version (phase 2's
   budget), then CUDA-event times of the kernel and its plain version
   (plain, kernel, kernel, plain), beside the card's name and power limit.

A kernel's ``max_abs_err`` in the ``kernels`` line is the largest over
every check of phases 2-4, and ``max_mismatch_frac`` the largest fraction
of pixels over 1e-3.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port's package beside this file, it fails before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
FRAC_TOL = 1e-3      # per-pixel max-channel difference counted as a mismatch
MEAN_REL_TOL = 0.01  # relative difference of the image means
KERNEL_SOURCES = {
    "render_chain": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                     "render_chain.cu",
                     "ray_tracer_fragment_shader_tpu/kernels/render_pallas.py"
                     ":737"),
    "render_tree": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                    "render_tree.cu",
                    "ray_tracer_fragment_shader_tpu/kernels/render_pallas.py"
                    ":901"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def compare(img, ref, budget):
    """Mismatch fraction, max abs error and mean agreement of two images."""
    import torch
    d = (img - ref).abs().amax(-1)
    frac = (d > FRAC_TOL).float().mean().item()
    mi, mr = img.mean().item(), ref.mean().item()
    rel = abs(mi - mr) / max(abs(mr), 1e-12)
    ok = (frac <= budget and rel <= MEAN_REL_TOL
          and bool(torch.isfinite(img).all()))
    return dict(frac=frac, max_abs_err=d.max().item(), mean=mi,
                plain_mean=mr, mean_rel=rel, budget=budget, ok=ok)


def time_ms(fn, reps):
    """CUDA-event time of one call of ``fn``, averaged over ``reps``.  A
    device-side sleep queued first lets the host enqueue every launch
    before the start event fires, so a kernel shorter than its host-side
    launch cost is timed on the device alone (without it the events time
    the host's launch gaps).  ``fn`` that synchronises (the plain
    versions) is timed with its host cost, as a caller sees it."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)  # ~5 ms of SM cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ray_tracer_fragment_shader_tpu_torch import cli
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
        Camera, primary_rays, screen_points)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    dev = torch.device("cuda", 0)

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    cuda_build.load()
    info = cuda_build.build_info
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s, built={info['built']}) "
          f"-> {os.path.relpath(info['path'], REPO)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernels against their plain versions at 128^2 ---------------
    def rays(scene, cam, cfg):
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        _, v = primary_rays(camera, screen_points(camera, cfg.width,
                                                  cfg.height))
        return (K.pack_scene(scene.to(dev)), v.contiguous(),
                camera.eye.tolist(), K.render_kwargs(scene, cfg))

    n = 128
    demo, demo_cam, demo_cfg = presets.reference_demo()
    fr, fr_cam, fr_cfg = presets.full_reflective(size=n, depth=3)
    cases = [
        ("full_reflective d3", "render_chain", fr, fr_cam, fr_cfg, 0.01),
        ("reference_demo d5 1spp", "render_chain", demo, demo_cam,
         dataclasses.replace(demo_cfg, width=n, height=n, samples=1), 0.02),
        ("procedural_spheres n64 d3", "render_chain",
         *presets.procedural_spheres(n=64, size=n, depth=3), 0.01),
        ("fractional_glass d2 (tree)", "render_tree",
         *presets.fractional_glass(size=n, depth=2), 0.01),
        ("full_reflective d3 forced tree", "render_tree", fr, fr_cam, fr_cfg,
         0.01),
    ]
    wrappers = {"render_chain": (K.render_chain, K.render_chain_ref),
                "render_tree": (K.render_tree, K.render_tree_ref)}
    errs = {k: [] for k in wrappers}
    fracs = {k: [] for k in wrappers}

    def hold(phase, kname, label, img, plain_img, budget):
        """Holds a kernel's image against its plain version's."""
        r = compare(img, plain_img.reshape(img.shape), budget)
        errs[kname].append(r["max_abs_err"])
        fracs[kname].append(r["frac"])
        h, w = img.shape[:2]
        print(f"{phase} {kname:12s} {label:38s} {h}x{w}: "
              f"{r['frac']:.5f} of pixels > {FRAC_TOL} (budget {budget}), "
              f"max abs err {r['max_abs_err']:.4g}, mean {r['mean']:.6f} vs "
              f"plain {r['plain_mean']:.6f} (rel {r['mean_rel']:.2e})")
        check(r["ok"], f"{kname} disagrees with its plain version on {label}")

    for label, kname, scene, cam, cfg, budget in cases:
        tables, v, eye, kw = rays(scene, cam, cfg)
        kern, plain = wrappers[kname]
        img = kern(tables, v, eye, **kw).reshape(n, n, 3)
        torch.cuda.synchronize()
        hold("check", kname, label, img, plain(tables, v, eye, **kw), budget)

    # ---- 3. the main path through the CLI -------------------------------
    os.makedirs(OUT_DIR, exist_ok=True)
    # (label, output file, CLI arguments, kernel the image is held against
    # and the preset call that gives its scene, or None for the jittered
    # adaptive demo)
    runs = [
        ("full_reflective 1024^2 d3", "full_reflective_1024_d3.png",
         ["--preset", "full_reflective", "--size", "1024", "--depth", "3"],
         ("render_chain", lambda: presets.full_reflective(size=1024,
                                                          depth=3))),
        ("reference_demo 500^2 d5 16spp adaptive", "reference_demo_500.png",
         ["--preset", "reference_demo", "--adaptive"], None),
        ("procedural_spheres n64 4096^2 d3", "procedural_spheres_4096.png",
         ["--preset", "procedural_spheres", "--size", "4096", "--depth", "3"],
         ("render_chain", lambda: presets.procedural_spheres(
             n=64, size=4096, depth=3))),
        ("full_reflective 1024^2 d3 tree", "full_reflective_1024_tree.png",
         ["--preset", "full_reflective", "--size", "1024", "--depth", "3",
          "--mode", "tree"],
         ("render_tree", lambda: presets.full_reflective(size=1024,
                                                         depth=3))),
    ]
    K.reset_launch_counts()
    images = {}
    for label, fname, args, _ in runs:
        images[label] = cli.main(["render", *args, "--out",
                                  os.path.join(OUT_DIR, fname)])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"main path launches: {launches}")
    for kname, count in launches.items():
        check(count > 0, f"the main path never launched {kname}")
    for label, img in images.items():
        check(img.is_cuda, f"{label}: rendered off the GPU")
        check(bool(torch.isfinite(img).all()), f"{label}: non-finite pixels")
        check(img.mean().item() > 0.01, f"{label}: black image")
        print(f"main {label:40s} shape {tuple(img.shape)} "
              f"mean {img.mean().item():.6f} finite")
    for label, _, _, against in runs:
        if against is None:
            continue
        kname, preset = against
        tables, v, eye, kw = rays(*preset())
        hold("main", kname, label, images.pop(label),
             wrappers[kname][1](tables, v, eye, **kw), 0.01)
        del tables, v
        torch.cuda.empty_cache()

    # ---- 4. times --------------------------------------------------------
    timed = {
        "render_chain": ("full_reflective 1024^2 d3",
                         rays(*presets.full_reflective(size=1024, depth=3))),
        "render_tree": ("fractional_glass 1024^2 d3",
                        rays(*presets.fractional_glass(size=1024, depth=3))),
    }
    times = {}
    for kname, (label, (tables, v, eye, kw)) in timed.items():
        kern, plain = wrappers[kname]
        hold("timed", kname, label,
             kern(tables, v, eye, **kw).reshape(1024, 1024, 3),
             plain(tables, v, eye, **kw), 0.01)
        pk = lambda: kern(tables, v, eye, **kw)
        pp = lambda: plain(tables, v, eye, **kw)
        t_p1 = time_ms(pp, 3)
        t_k1 = time_ms(pk, 20)
        t_k2 = time_ms(pk, 20)
        t_p2 = time_ms(pp, 3)
        tk, tp = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
        P = v.shape[0]
        times[kname] = (tk, tp)
        print(f"time {kname:12s} {label}: kernel {tk:.4f} ms "
              f"({t_k1:.4f}, {t_k2:.4f}) = {P / tk / 1e3:.1f} M rays/s; "
              f"plain {tp:.2f} ms ({t_p1:.2f}, {t_p2:.2f}) = "
              f"{P / tp / 1e3:.2f} M rays/s; speed-up {tp / tk:.1f}x "
              f"[{card}]")

    kernels = [dict(name=k, route="cuda", source=KERNEL_SOURCES[k][0],
                    replaces=KERNEL_SOURCES[k][1], launches=launches[k],
                    max_abs_err=max(errs[k]),
                    max_mismatch_frac=max(fracs[k]), ms=times[k][0],
                    plain_ms=times[k][1]) for k in wrappers]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
