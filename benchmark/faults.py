"""Faults planted under the timed path, to show that the check catches
them: each is a patch of the program's own functions for the length of a
``with planted(name):`` block, in the process that runs it.

* ``state_unchanged``: the fit step computes its loss and gradients, but
  leaves the parameters as they were;
* ``half_batch``: the fit step's loss and gradients are those of half of
  the frame's rows, the mean taken over the rest; a frame renders half of
  its rows and leaves the others black;
* ``answer_altered``: the sphere radii's gradient is doubled where the
  program forms it; a frame is the one of the previous eye;
* ``nan_pixels``: a frame comes back with a few pixels not a number.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Optional

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "nan_pixels")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged(make):
    def make_step(*args, **kw):
        step = make(*args, **kw)

        def kept(params):
            before = [p.detach().clone() for p in params.parameters()]
            loss = step(params)
            with torch.no_grad():
                for p, b in zip(params.parameters(), before):
                    p.copy_(b)
            return loss
        return kept
    return make_step


@contextlib.contextmanager
def planted(name: Optional[str]):
    """Plants fault ``name`` (None: none) in the program for the block."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    F = importlib.import_module(
        "ray_tracer_fragment_shader_tpu_torch.diff.fit")
    from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as A
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import screen_points
    render = K.render_image_kernel
    with contextlib.ExitStack() as stack:
        if name == "state_unchanged":
            stack.enter_context(_patched(
                F, "make_fit_step_kernel", _unchanged(F.make_fit_step_kernel)))
        elif name == "half_batch":
            value_and_grad = F.fit_value_and_grad

            def half_vg(params, scene, camera, config, target, *, prep=None,
                        device=None, **kw):
                h = config.height // 2
                cfg = dataclasses.replace(config, height=h)
                pts = screen_points(camera.to(device), config.width,
                                    config.height)[:h * config.width]
                tgt = torch.as_tensor(target).reshape(
                    config.height, config.width, 3)[:h]
                return value_and_grad(
                    params, scene, camera, cfg, tgt, device=device,
                    prep=A.prepare_fit_inputs(camera, cfg, tgt, pts=pts,
                                              device=device))

            def half_frame(scene, camera, config, **kw):
                img = render(scene, camera, config, **kw).clone()
                img[config.height // 2:] = 0.0
                return img
            stack.enter_context(_patched(F, "fit_value_and_grad", half_vg))
            stack.enter_context(_patched(K, "render_image_kernel",
                                         half_frame))
        elif name == "answer_altered":
            to_params = A.grads_to_fitparams
            last = {}

            def doubled(*args, **kw):
                g = dict(to_params(*args, **kw))
                g["sph_radius"] = 2.0 * g["sph_radius"]
                return g

            def stale(scene, camera, config, **kw):
                img = render(scene, last.get("camera", camera), config, **kw)
                last["camera"] = camera
                return img
            stack.enter_context(_patched(A, "grads_to_fitparams", doubled))
            stack.enter_context(_patched(K, "render_image_kernel", stale))
        else:
            def nan_frame(scene, camera, config, **kw):
                img = render(scene, camera, config, **kw)
                img.view(-1, 3)[::max(1, img.numel() // 9)] = float("nan")
                return img
            stack.enter_context(_patched(K, "render_image_kernel",
                                         nan_frame))
        yield
