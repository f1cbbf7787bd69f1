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
autodiff (ROADMAP.md queue 3).

The sharded steps split the pixels over the ranks of a ``parallel.mesh.
Mesh`` and sum the loss and gradients with one ``all_reduce``:
``make_sharded_fit_step`` on core autodiff (flat pixel shards),
``make_sharded_fit_step_kernel`` on the fit kernels (row bands).  Each
rank's share is a function of ``(rank, world)`` that issues no collective
(``shard_loss_grads``, ``band_loss_grads``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import CameraConfig, RenderConfig
from ..core.renderer import render_image, render_pixels
from ..kernels.adjoint_fused import (fit_mode, fit_value_and_grad,
                                     fused_loss_grads_kernel,
                                     grads_to_fitparams, prepare_fit_inputs,
                                     twophase_loss_grads_kernel)
from ..ops.rays import Camera
from ..parallel.mesh import Mesh, all_reduce_sum, make_mesh, shard_bounds
from ..parallel.shard import (_pixel_index_arrays, band_points, band_rows,
                              band_split, flatten_grads, unflatten_grads)
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
    Chain scenes step through ``fit_value_and_grad``'s mode, read from
    ``RTFS_FIT_MODE`` (default: K3 + K4; "fused": K6), fractional-
    transparency scenes through K6's tree form.  The step passes
    ``prep=``, so under ``RTFS_FIT_MODE=split`` a chain scene's step
    raises ``ValueError``, as JAX's ``make_fit_step_pallas`` does
    (ADVICE.md): split fits go through ``fit_value_and_grad(mode=
    "split")``.  Under ``config.bf16_shading`` their forwards
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


def _apply_grads(params: FitParams, grads: Dict[str, torch.Tensor]) -> None:
    """Sets each ``FitParams`` leaf's ``.grad`` to ``grads[name]``."""
    for f in FitParams.FIELDS:
        getattr(params, f).grad = grads[f].reshape(
            getattr(params, f).shape).clone()


def _grad_like(params: FitParams) -> Dict[str, torch.Tensor]:
    return {f: getattr(params, f) for f in FitParams.FIELDS}


def shard_loss_grads(params: FitParams, scene: FlatScene, camera,
                     config: RenderConfig, target_flat, rank: int,
                     world: int, *, device=None) -> torch.Tensor:
    """Rank ``rank``'s share of the core-autodiff loss over ``world``
    ranks, as one flat buffer ``[loss, *grads]`` (``parallel.shard.
    flatten_grads`` in ``FitParams.FIELDS`` order): ``sum(valid * (img -
    target)^2) / (H*W*3)`` over its flat pixel shard
    (``_pixel_index_arrays``) and its gradients by autograd.  Padding
    pixels get weight 0, and the normaliser is the whole image's, so the
    ranks' buffers SUM to the unsharded ``l2_loss`` and its gradients.
    ``target_flat``: [H*W padded to a multiple of ``world``, 3].  No
    collective."""
    device = resolve_device(device)
    w, h = config.width, config.height
    ii, jj, total = _pixel_index_arrays(w, h, world, device=device)
    target_flat = torch.as_tensor(target_flat, dtype=torch.float32,
                                  device=device)
    if target_flat.shape[0] != ii.shape[0]:
        raise ValueError(f"target_flat must hold {ii.shape[0]} pixels (H*W "
                         f"padded to a multiple of {world}), got "
                         f"{target_flat.shape[0]}")
    start, stop = shard_bounds(ii.shape[0], rank, world)
    valid = (torch.arange(start, stop, device=device) < total).float()
    leaves = list(_grad_like(params).values())
    with torch.enable_grad():
        flat = render_pixels(params.into_scene(scene), camera, w, h, config,
                             ij=(ii[start:stop], jj[start:stop]),
                             device=device)
        d = flat - target_flat[start:stop]
        loss = torch.sum(valid[:, None] * d * d) / float(total * 3)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {f: torch.zeros_like(p) if g is None else g
             for f, p, g in zip(FitParams.FIELDS, leaves, got)}
    return flatten_grads(loss, grads, FitParams.FIELDS)


def _finish_step(params: FitParams, optimizer: torch.optim.Optimizer,
                 flat: torch.Tensor, mesh: Mesh,
                 denom: float = 1.0) -> torch.Tensor:
    """The rank's buffer summed over ``mesh`` (one ``all_reduce``), its
    gradients set on the leaves, one ``optimizer`` step; the loss (the
    summed value over ``denom``)."""
    loss, grads = unflatten_grads(all_reduce_sum(flat, mesh),
                                  _grad_like(params))
    _apply_grads(params, grads)
    optimizer.step()
    return (loss / denom).detach()


def make_sharded_fit_step(scene: FlatScene, camera, config: RenderConfig,
                          target_flat, optimizer: torch.optim.Optimizer,
                          mesh: Optional[Mesh] = None
                          ) -> Callable[[FitParams], torch.Tensor]:
    """The multi-rank Adam step by core autodiff: ``step(params) -> loss``
    (the loss before the update).  Each rank renders its flat pixel shard
    and differentiates its share of the globally normalised loss
    (``shard_loss_grads``); one ``all_reduce`` (SUM) gives every rank the
    global loss and gradients, and ``optimizer`` steps alike on every rank
    (JAX diff/fit.py::make_sharded_fit_step).  ``target_flat``: [H*W
    padded to a multiple of the mesh size, 3]; ``params`` live on
    ``mesh.device`` (default mesh: ``make_mesh()``)."""
    mesh = make_mesh() if mesh is None else mesh
    device = mesh.device
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, config.width, config.height,
                                    device=device)
    camera = camera.to(device)
    target_flat = torch.as_tensor(target_flat, dtype=torch.float32,
                                  device=device)

    def step(params: FitParams) -> torch.Tensor:
        flat = shard_loss_grads(params, scene, camera, config, target_flat,
                                mesh.rank, mesh.size, device=device)
        return _finish_step(params, optimizer, flat, mesh)

    return step


def band_fit_inputs(camera: Camera, config: RenderConfig, target_img,
                    rank: int, world: int, *, device=None) -> dict:
    """The step-invariant inputs of rank ``rank``'s row band over
    ``world`` ranks: the band's config (``height`` = rows per band), its
    target rows (zero past the image), its mask (0 on the padding rows),
    its screen points, their ``prepare_fit_inputs`` and the whole image's
    loss normaliser ``denom`` = H*W*3."""
    device = resolve_device(device)
    camera = camera.to(device)
    h, w = config.height, config.width
    h_pad, h_shard = band_split(h, world)
    tgt = torch.zeros((h_pad, w, 3), dtype=torch.float32, device=device)
    tgt[:h] = torch.as_tensor(target_img, dtype=torch.float32,
                              device=device).reshape(h, w, 3)
    rows = tgt[rank * h_shard:(rank + 1) * h_shard]
    _, jj = band_rows(w, h_shard, rank, device=device)
    mask = (jj < h).reshape(h_shard, w).float()
    pts = band_points(camera, w, h_shard, rank)
    cfg_s = dataclasses.replace(config, height=h_shard)
    return dict(config=cfg_s, target=rows, mask=mask, pts=pts,
                denom=float(h * w * 3),
                prep=prepare_fit_inputs(camera, cfg_s, rows, mask=mask,
                                        pts=pts, device=device))


def band_twophase(scene: FlatScene) -> bool:
    """Whether a band step runs K3+K4: a chain scene under
    ``RTFS_FIT_MODE=twophase`` (the default); "fused" and "split", and
    every tree scene, take K6 (JAX diff/fit.py:216-219).  An unknown value
    raises, as in ``fit_value_and_grad`` (``kernels.adjoint_fused.
    fit_mode``)."""
    return scene.chain_exact and fit_mode() == "twophase"


def band_loss_grads(params: FitParams, scene: FlatScene, camera: Camera,
                    band: dict, *, twophase: bool,
                    device=None) -> torch.Tensor:
    """Rank's row band through the fit kernels (``band``:
    ``band_fit_inputs``), as one flat buffer ``[sq_err_sum, *grads]``: the
    band's masked squared-error sum and its gradient tables of
    ``sq_err_sum / denom`` scattered onto the ``FitParams`` leaves.  The
    ranks' buffers sum to the unsharded sum and gradients.  ``twophase``
    runs K3+K4 (chain scenes), else K6.  No collective."""
    scene_full = params.into_scene(scene)
    impl = (twophase_loss_grads_kernel if twophase
            else fused_loss_grads_kernel)
    sq_sum, grads_c = impl(scene_full, camera, band["config"], band["target"],
                           mask=band["mask"], denom=band["denom"],
                           pts=band["pts"], prep=band["prep"], device=device)
    return flatten_grads(sq_sum, grads_to_fitparams(params, scene_full,
                                                    grads_c),
                         FitParams.FIELDS)


def make_sharded_fit_step_kernel(scene: FlatScene, camera: Camera,
                                 config: RenderConfig, target_img,
                                 optimizer: torch.optim.Optimizer,
                                 mesh: Optional[Mesh] = None
                                 ) -> Callable[[FitParams], torch.Tensor]:
    """The multi-rank Adam step on the fit kernels: ``step(params) ->
    loss``.  Each rank renders its contiguous row band of the [H,W,3]
    ``target_img`` frame and differentiates it in-kernel
    (``band_loss_grads``: K3+K4 on chain scenes under
    ``RTFS_FIT_MODE=twophase``, else K6, chain or tree), with the padding
    rows masked and the cotangent scaled by the whole image's H*W*3; one
    ``all_reduce`` (SUM) of ``[sq_err_sum, grads]`` gives every rank the
    global loss and gradients, and ``optimizer`` steps alike on every rank
    (JAX diff/fit.py::make_sharded_fit_step_pallas, which also returns
    the padded target: here the band's inputs are built once, inside).
    ``params`` live on ``mesh.device`` (default mesh: ``make_mesh()``)."""
    mesh = make_mesh() if mesh is None else mesh
    device = mesh.device
    camera = camera.to(device)
    band = band_fit_inputs(camera, config, target_img, mesh.rank, mesh.size,
                           device=device)
    twophase = band_twophase(scene)

    def step(params: FitParams) -> torch.Tensor:
        flat = band_loss_grads(params, scene, camera, band,
                               twophase=twophase, device=device)
        return _finish_step(params, optimizer, flat, mesh,
                            denom=band["denom"])

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
