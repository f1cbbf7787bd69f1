"""Differentiable fitting: recover scene parameters from a target image
(BASELINE config 4) — the counterpart of the JAX package's ``diff/fit.py``.

L2 photometric loss plus Adam over sphere centres and radii, light
positions and material colours, with gradients defined through fixed hit
topology.  The parameters are ``nn.Parameter``s that ``torch.optim``
updates; two routes compute their gradients:

* the kernel path (``make_fit_step_kernel``, ``fit``): each step runs the
  fit kernels (kernels/adjoint_fused.py: the packed forward and the adjoint
  for chain scenes, K6's tree form for fractional-transparency scenes)
  inside a ``torch.autograd.Function``;
* core autodiff (``l2_loss``, ``make_fit_step``): ``torch.autograd``
  through the core renderer (core/renderer.py), as the JAX package's
  ``jax.value_and_grad(l2_loss)``; no kernel runs.  It is the naive
  baseline the kernel path is measured against.

``fit`` keeps the kernel route where the JAX package's ``fit`` steps core
autodiff (ROADMAP.md queue 3).  The sharded steps wait for ``parallel/``
(ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from ..config import CameraConfig, RenderConfig
from ..core.renderer import render_image
from ..kernels.adjoint_fused import fit_value_and_grad, prepare_fit_inputs
from ..ops.rays import Camera
from ..ops.sampling import resolve_device
from ..scene.flat import FlatScene


class FitParams(nn.Module):
    """The differentiable subset of the scene (BASELINE: sphere geometry
    and light positions; material colour tables too), one ``nn.Parameter``
    per scene leaf, padding rows included."""

    FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
              "mat_specular", "mat_ambient")

    def __init__(self, sph_center, sph_radius, light_pos, mat_diffuse,
                 mat_specular, mat_ambient):
        super().__init__()
        for name, value in zip(self.FIELDS, (sph_center, sph_radius,
                                             light_pos, mat_diffuse,
                                             mat_specular, mat_ambient)):
            setattr(self, name, nn.Parameter(
                torch.as_tensor(value, dtype=torch.float32).detach().clone()))

    @classmethod
    def from_scene(cls, scene: FlatScene) -> "FitParams":
        return cls(**{f: getattr(scene, f) for f in cls.FIELDS})

    def into_scene(self, scene: FlatScene) -> FlatScene:
        """``scene`` with these leaves in place of its own (the parameters
        themselves, so autograd reaches them)."""
        return scene.replace(**{f: getattr(self, f) for f in self.FIELDS})


def default_fit_optimizer(params: FitParams, geom_lr: float = 0.5,
                          light_lr: float = 1.0,
                          mat_lr: float = 0.01) -> torch.optim.Adam:
    """Adam with per-group learning rates matched to parameter scales:
    world-space geometry (~1e2 units) against material colours (~1e-1).
    Three parameter groups stand in for optax's ``multi_transform``.
    torch's Adam rounds apart from optax's: it divides by
    ``sqrt(v) / sqrt(1 - b2^t) + eps`` and scales the step by
    ``lr / (1 - b1^t)``, where optax adds ``eps`` to ``sqrt(v_hat)`` of the
    bias-corrected moments, so parameters part in the last bits per step."""
    return torch.optim.Adam([
        {"params": [params.sph_center, params.sph_radius], "lr": geom_lr},
        {"params": [params.light_pos], "lr": light_lr},
        {"params": [params.mat_diffuse, params.mat_specular,
                    params.mat_ambient], "lr": mat_lr},
    ])


def l2_loss(params: FitParams, scene: FlatScene, camera,
            config: RenderConfig, target, *, device=None) -> torch.Tensor:
    """``mean((render_image(params.into_scene(scene)) - target)^2)`` through
    the core renderer on ``device`` (default: the GPU); ``.backward()``
    reaches the ``FitParams`` leaves by autograd (JAX diff/fit.py::l2_loss
    under ``jax.value_and_grad``)."""
    img = render_image(params.into_scene(scene), camera, config,
                       device=device)
    target = torch.as_tensor(target, dtype=img.dtype,
                             device=img.device).reshape(img.shape)
    return torch.mean((img - target) ** 2)


def make_fit_step(scene: FlatScene, camera, config: RenderConfig, target,
                  optimizer: torch.optim.Optimizer, *, device=None
                  ) -> Callable[[FitParams], torch.Tensor]:
    """An Adam step by core autodiff: ``step(params) -> loss`` (the loss
    at the parameters before the update), on ``device`` (default: the GPU).
    ``params`` must live there and be what ``optimizer`` updates (JAX
    diff/fit.py::make_fit_step)."""
    device = resolve_device(device)
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, config.width, config.height,
                                    device=device)
    camera = camera.to(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)

    def step(params: FitParams) -> torch.Tensor:
        optimizer.zero_grad()
        loss = l2_loss(params, scene, camera, config, target, device=device)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class _KernelLoss(torch.autograd.Function):
    """The L2 loss of the fit kernels as an autograd node: ``forward``
    runs them once (``fit_value_and_grad``) and returns the loss;
    ``backward`` hands back their gradient tables, scaled by the incoming
    cotangent."""

    @staticmethod
    def forward(ctx, value_and_grad: Callable, *leaves):
        loss, grads = value_and_grad()
        ctx.grads = [grads[f] for f in FitParams.FIELDS]
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        return (None,) + tuple(g * grad_output for g in ctx.grads)


def make_fit_step_kernel(scene: FlatScene, camera: Camera,
                         config: RenderConfig, target,
                         optimizer: torch.optim.Optimizer, *, device=None
                         ) -> Callable[[FitParams], torch.Tensor]:
    """An Adam step on the kernel path: ``step(params) -> loss``.  The
    step-invariant inputs (primary rays, target, mask) are prepared once,
    here, on ``device`` (default: the GPU; ``"cpu"`` runs the kernels'
    plain versions).  ``params`` must live on that device and be what
    ``optimizer`` updates (JAX: diff/fit.py::make_fit_step_pallas).
    Chain scenes step through K3 + K4, fractional-transparency scenes
    through K6's tree form; under ``config.bf16_shading`` their forwards
    are the bf16 ones and the adjoints replay in f32 on the topology those
    recorded.  As in the JAX package, the prepared inputs
    serve single-sample configs only: with a supersampled or jittered
    config the step raises ``ValueError`` (ROADMAP.md queue 3); such fits
    go through ``fit_value_and_grad``."""
    device = resolve_device(device)
    camera = camera.to(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    prep = prepare_fit_inputs(camera, config, target, device=device)

    def step(params: FitParams) -> torch.Tensor:
        optimizer.zero_grad()
        loss = _KernelLoss.apply(
            lambda: fit_value_and_grad(params, scene, camera, config, target,
                                       prep=prep, device=device),
            *(getattr(params, f) for f in FitParams.FIELDS))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit(scene: FlatScene, camera: Camera, config: RenderConfig, target,
        steps: int = 200, learning_rate: float = 0.5,
        params: Optional[FitParams] = None,
        optimizer: Optional[torch.optim.Optimizer] = None,
        log_every: int = 0, device=None) -> Tuple[FitParams, List[float]]:
    """Adam-fit the scene to a target image through the kernel step;
    returns (params, loss history).  ``params`` (default: the scene's own)
    is moved to ``device`` (default: the GPU) before the optimizer is
    built."""
    device = resolve_device(device)
    params = FitParams.from_scene(scene) if params is None else params
    params = params.to(device)
    if optimizer is None:
        optimizer = default_fit_optimizer(params, geom_lr=learning_rate)
    step = make_fit_step_kernel(scene, camera, config, target, optimizer,
                                device=device)
    history = []
    for i in range(steps):
        loss = float(step(params))
        history.append(loss)
        if log_every and i % log_every == 0:
            print(f"fit step {i}: loss {loss:.6g}")
    return params, history
