"""Orbit frames: a closed loop of frames on one chip
(``kernels.render.render_image_kernel``), the eye turning about the
vertical axis through the look-at point by ``step_deg`` a frame from a
seeded start.  A frame's latency runs from the call to its
``torch.cuda.synchronize()``; the image stays on the card.

``checked_frames`` frames of the window, drawn from the seed as they come
(a reservoir sample), are copied into buffers made in set-up; ``judge``
compares them and the window's last frame with the reference's frames of
the same eyes.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, inputs, opcount, program, reference

KIND = "frame"
#: the faults of ``faults.py`` a frame cell can have, and those read on
#: the chip
FAULTS = ("half_batch", "answer_altered", "nan_pixels")
CHIP_FAULTS = FAULTS
#: a pixel is off when a channel differs from the reference by more than
#: this (the repo's image-parity rule), or is not finite
PIXEL_TOL = 1e-3


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, log=print) -> dict:
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    config, traffic = cell.config, cell.traffic
    W, H, depth = config["width"], config["height"], config["max_depth"]
    camera = config["camera"]
    stamp = harness.stamper(t_start)
    stamp("set-up starts")
    arrays = inputs.scene_arrays(config["scene"], seed, cell.bench_dir)
    scene = program.scene(arrays, inputs.scene_meta(arrays), device)
    cfg = program.render_config(config, control)
    start = inputs.orbit_start(seed)
    step_deg = float(traffic["step_deg"])
    eye = lambda k: inputs.orbit_eye(camera, start, step_deg, k)
    render = K.render_image_kernel

    def frame(k: int):
        return render(scene, program.camera_config(camera, eye(k)), cfg,
                      device=device)

    for k in range(int(traffic["warmup_frames"])):
        frame(-1 - k)
    harness.sync(device)
    # the frames kept for the check are copied into buffers made here, so
    # that keeping one costs the window no allocation; the peak is read
    # without them
    peak0 = harness.memory_peak(device)
    harness.reset_memory_peak(device)
    slots = [torch.empty((H, W, 3), dtype=torch.float32, device=device)
             for _ in range(int(traffic["checked_frames"]))]
    slot_bytes = sum(s.numel() * s.element_size() for s in slots)
    held: List[int] = [-1] * len(slots)
    g = inputs.rng(seed, inputs.SAMPLE)
    setup_s = time.perf_counter() - t_start
    stamp("warm-up frames done")

    lat: List[float] = []
    with harness.traced(trace, device) as box:
        t0 = time.perf_counter()
        k = 0
        while True:
            cam = program.camera_config(camera, eye(k))
            ts = time.perf_counter()
            img = render(scene, cam, cfg, device=device)
            harness.sync(device)
            te = time.perf_counter()
            lat.append(te - ts)
            # reservoir sampling: every frame so far is kept with the same
            # chance
            j = k if k < len(slots) else int(g.integers(k + 1))
            if j < len(slots):
                slots[j].copy_(img)
                held[j] = k
                harness.sync(device)
            k += 1
            if te - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = max(peak0, harness.memory_peak(device) - slot_bytes)
    last = k - 1
    kept: Dict[int, torch.Tensor] = {f: s for f, s in zip(held, slots)
                                     if f >= 0}
    kept[last] = img

    def work(f: int) -> dict:
        """K2's work in frame ``f``."""
        _, _, counts = reference.render(
            arrays, reference.scene_leaves(arrays, device),
            dict(camera, eye=list(eye(f))), W, H, depth=depth,
            device=device, count=True)
        nl = int(np.asarray(arrays["light_pos"]).shape[0])
        k2 = opcount.forward_work(counts, W * H, depth=depth, lights=nl,
                                  packed=False)
        return dict(k2=k2, ops=k2["ops"])

    record = harness.Record(
        cell=cell, kind=KIND, chips=cell.chips, width=W, height=H,
        setup_s=setup_s, window_s=window_s, units=len(lat), latencies_s=lat,
        trace=box.get("trace"),
        probes={f: (lambda f=f: work(f)) for f in sorted(kept)})
    return dict(units=len(lat), window_s=window_s, memory_peak=peak,
                failed=0, record=record, release=lambda: None,
                judge=lambda: judge(cell, arrays, camera, eye, kept, device))


def judge(cell, arrays, camera, eye, kept: Dict[int, torch.Tensor],
          device) -> dict:
    """The number that decides ``correct`` in a frame cell: of the kept
    frames and the last, the largest share of pixels off the reference's
    frame of the same eye (a channel off by more than ``PIXEL_TOL``, or not
    finite); and the count of those frames holding a pixel that is not
    finite (``failed``)."""
    config, traffic = cell.config, cell.traffic
    W, H, depth = config["width"], config["height"], config["max_depth"]
    leaves = reference.scene_leaves(arrays, device)
    worst, bad = 0.0, 0
    for f in sorted(kept):
        img = kept[f].reshape(-1, 3)
        ref = reference.render(arrays, leaves, dict(camera, eye=list(eye(f))),
                               W, H, depth=depth, device=device)[0]
        finite = torch.isfinite(img).all(-1)
        off = ~finite | ((img - ref).abs().amax(-1) > PIXEL_TOL)
        worst = max(worst, float(off.double().mean()))
        bad += int(not bool(finite.all()))
        del ref
    limit = traffic["limits"]["off_pixels"]
    return dict(checks=dict(off_pixels=dict(value=worst, limit=limit)),
                failed=bad, checked_frames=sorted(kept))
