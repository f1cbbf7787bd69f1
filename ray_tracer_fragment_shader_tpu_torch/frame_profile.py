"""Where a frame's time goes on the GPU, cell by cell.

    python -m ray_tracer_fragment_shader_tpu_torch.frame_profile [--out FILE]

A frame is ``render_image_kernel`` on a scene already on the card, timed on
the host clock up to a ``torch.cuda.synchronize()``: two timed runs of
``frames`` frames each, after a warm-up frame.  One more run under
``torch.profiler`` gives the device's busy time (the union of its kernel,
copy and set intervals), the render kernels' own time, and the host's
costliest calls.  Per frame:

* ``frame_ms``: mean of the two runs (``frame_runs_ms``);
* ``busy_ms`` and ``render_kernel_ms``: from the profiled run;
* ``idle_share``: 1 - busy_ms / frame_ms;
* ``launches``: the wrappers' launch counts over the timed runs.

Prints the card's name and power limit, then one JSON line per cell, and
writes all cells to ``--out`` when given.  Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from collections import defaultdict

import torch

from .kernels import render as K
from .scene import presets

#: name -> (preset call, RenderConfig changes, frames per timed run)
CELLS = {
    "config3_full_reflective_1024_d3":
        (lambda: presets.full_reflective(size=1024, depth=3), {}, 20),
    "config3_forced_tree":
        (lambda: presets.full_reflective(size=1024, depth=3),
         {"mode": "tree"}, 20),
    "demo_500_d5_16spp_adaptive":
        (presets.reference_demo, {"adaptive": True}, 20),
    "demo_500_d5_1spp": (presets.reference_demo, {"samples": 1}, 20),
    "config5_procedural_spheres_4096_d3":
        (lambda: presets.procedural_spheres(n=64, size=4096, depth=3), {}, 5),
    "fractional_glass_1024_d3_tree":
        (lambda: presets.fractional_glass(size=1024, depth=3), {}, 20),
}


def _union_us(intervals):
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_cell(preset, changes, frames, device):
    scene, cam, cfg = preset()
    cfg = dataclasses.replace(cfg, **changes)
    scene = scene.to(device)

    def frame():
        return K.render_image_kernel(scene, cam, cfg, device=device)

    frame()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / frames)
    launches = {k: n / (2 * frames) for k, n in K.LAUNCHES.items()}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_device:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in on_device)
    by_name = defaultdict(float)
    for e in on_device:
        by_name[e.name] += e.time_range.elapsed_us()
    render_us = sum(t for name, t in by_name.items() if "rtfs::" in name)
    host = sorted(((a.key, a.self_cpu_time_total, a.count)
                   for a in prof.key_averages()
                   if a.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[1])[:6]
    frame_ms = sum(runs) / len(runs)
    busy_ms = busy_us / 1e3 / frames
    return {
        "frame_ms": frame_ms, "frame_runs_ms": runs,
        "busy_ms": busy_ms, "render_kernel_ms": render_us / 1e3 / frames,
        "idle_share": 1.0 - busy_ms / frame_ms,
        "launches": launches,
        "device_kernels_per_frame": len(on_device) / frames,
        "top_device_us_per_frame": [
            [name[:72], t / frames] for name, t in
            sorted(by_name.items(), key=lambda r: -r[1])[:5]],
        "top_host_self_ms_per_frame": [
            [key[:40], t / 1e3 / frames, n / frames] for key, t, n in host],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(prog="frame_profile")
    parser.add_argument("--out", default=None, help="JSON file for all cells")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("frame_profile needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    result = {"card": card, "cells": {}}
    for name, spec in CELLS.items():
        cell = profile_cell(*spec, device)
        result["cells"][name] = cell
        print(name, json.dumps(cell))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
