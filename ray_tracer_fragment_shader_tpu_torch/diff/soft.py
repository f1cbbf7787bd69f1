"""Soft-silhouette rendering for differentiable fitting, in PyTorch: the
counterpart of the JAX package's ``diff/soft.py``.

Fixed-hit-topology gradients (the convention of every renderer here, see
SEMANTICS.md) carry **no occupancy term**: moving a sphere never changes
which pixels it covers, in the gradient's view.  An L2 photometric loss on
a hard render is therefore dominated near silhouettes by discrete pixel
flips the optimizer cannot see: geometry fits stall or random-walk.

``render_soft`` is the standard remedy (SoftRas-style): each primary ray
alpha-blends the nearest-by-silhouette sphere over the scene-without-it,
with ``alpha = sigmoid(-(b - r)/sigma)`` where ``b`` is the ray's
closest-approach distance to the sphere center.  Alpha depends smoothly on
centers and radii, so occupancy gradients exist; as sigma -> 0 the image
converges to the hard render away from edges.  The two hard renders are
core-renderer chains (core/renderer.py), differentiated by autograd: no
kernel runs.

Intended use: optimize the soft loss with annealed sigma, then (optionally)
polish with the hard loss inside the converged basin.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..config import CameraConfig, RenderConfig
from ..core.renderer import render_rays_chain
from ..ops.rays import Camera, primary_rays, screen_points
from ..ops.sampling import resolve_device
from ..scene.flat import FlatScene
from ..utils.jmath import dot3, safe_div, safe_sqrt


def render_soft(scene: FlatScene, camera, config: RenderConfig,
                sigma: float = 2.0, occupancy_only_geometry: bool = False,
                *, device=None) -> torch.Tensor:
    """[H,W,3] soft-silhouette render on ``device`` (default: the GPU);
    ``sigma`` is the silhouette softness in world units (~ pixel_scale
    units on screen).

    ``occupancy_only_geometry``: route sphere-geometry gradients
    exclusively through the silhouette alpha, cutting the fixed-topology
    shading path (hit point/normal/reflection as functions of
    center/radius).  For mirror-like spheres that shading path is rugged
    (reflected checkerboard) and systematically biased, while the alpha
    path is smooth and well-signed.  Light and material gradients still
    flow through shading."""
    device = resolve_device(device)
    w, h = config.width, config.height
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, w, h, device=device)
    scene, camera = scene.to(device), camera.to(device)
    if occupancy_only_geometry:
        shade_scene = scene.replace(sph_center=scene.sph_center.detach(),
                                    sph_radius=scene.sph_radius.detach())
    else:
        shade_scene = scene
    o, v = primary_rays(camera, screen_points(camera, w, h))

    vlen2 = dot3(v, v)
    u = v * safe_div(torch.ones_like(vlen2), safe_sqrt(vlen2, vlen2 > 0),
                     vlen2 > 0)[:, None]

    # --- per-sphere signed silhouette distance along each ray
    c, r = scene.sph_center, scene.sph_radius          # [Ns,3],[Ns]
    delta = c[None, :, :] - o[:, None, :]              # [P,Ns,3]
    ud = torch.sum(u[:, None, :] * delta, -1)          # [P,Ns]
    b2 = torch.sum(delta * delta, -1) - ud * ud
    b = safe_sqrt(b2, b2 > 0)
    d_sil = b - r[None, :]                             # <0 inside silhouette
    in_front = (ud > 0.0) & scene.sph_valid[None, :]
    d_masked = torch.where(in_front, d_sil, 3e38)

    j = torch.argmin(d_masked, dim=1)                  # nearest silhouette
    d_j = torch.gather(d_masked, 1, j[:, None])[:, 0]
    have_sphere = d_j < 1e37
    alpha = torch.sigmoid(-d_j / sigma) * have_sphere.to(u.dtype)

    # --- the two hard renders: the normal image (exact inside the sphere,
    # reflections and shadows included) and the scene-without-the-sphere
    # background; the alpha blend makes the occupancy gradient
    # d out / d alpha = hard - background in the silhouette band
    kw = dict(max_depth=config.max_depth, small=config.small_number,
              attenuation_factor=config.attenuation_factor,
              prune=config.prune)
    c_hard = render_rays_chain(shade_scene, o, v, **kw)
    excl = torch.where(have_sphere, scene.num_triangles + j, -1)
    c_bg = render_rays_chain(shade_scene, o, v, exclude0=excl, **kw)

    out = alpha[:, None] * c_hard + (1.0 - alpha)[:, None] * c_bg
    return out.reshape(h, w, 3)


def soft_l2_loss(params, scene: FlatScene, camera, config: RenderConfig,
                 target, sigma: float = 2.0, *, device=None) -> torch.Tensor:
    img = render_soft(params.into_scene(scene), camera, config, sigma=sigma,
                      device=device)
    target = torch.as_tensor(target, dtype=img.dtype,
                             device=img.device).reshape(img.shape)
    return torch.mean((img - target) ** 2)


def fit_soft(scene: FlatScene, camera, config: RenderConfig, target,
             params=None, steps: int = 300, sigmas=(4.0, 2.0, 1.0),
             geom_lr: float = 0.3, light_lr: float = 0.5,
             mat_lr: float = 0.0, log_every: int = 0, *, device=None
             ) -> Tuple[object, List[float]]:
    """Annealed soft fit: optimize the soft loss over a sigma schedule,
    ``steps // len(sigmas)`` Adam steps each, one optimizer state
    throughout.  ``target`` should be the *hard* target image (the soft
    render converges to it as sigma shrinks).  ``params`` (default: the
    scene's own) is moved to ``device``; returns (params, loss history),
    each loss at the parameters before its step."""
    from .fit import FitParams, default_fit_optimizer

    device = resolve_device(device)
    params = FitParams.from_scene(scene) if params is None else params
    params = params.to(device)
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, config.width, config.height,
                                    device=device)
    camera = camera.to(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    opt = default_fit_optimizer(params, geom_lr=geom_lr, light_lr=light_lr,
                                mat_lr=mat_lr)
    history: List[float] = []
    for sigma in sigmas:
        for i in range(steps // len(sigmas)):
            opt.zero_grad()
            loss = soft_l2_loss(params, scene, camera, config, target,
                                sigma=sigma, device=device)
            loss.backward()
            opt.step()
            history.append(loss.item())
            if log_every and i % log_every == 0:
                print(f"sigma={sigma} step {i}: loss {history[-1]:.6g}")
    return params, history
