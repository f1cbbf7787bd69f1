"""Multi-view differentiable fitting, the robust config-4 recipe, in
PyTorch: the counterpart of the JAX package's ``diff/multiview.py``.

Single-view recovery of mirror-like sphere geometry (BASELINE config 4) is
ill-conditioned: translation along the viewing ray barely changes the
image, and reflections make the photometric loss rugged.  The recipe:

* **Multi-view targets**: a handful of cameras orbiting the look-at point,
  so the depth direction of one view is the lateral direction of another.
* **Multiscale loss pyramid**: fit coarse-to-fine; a coarse stage's
  silhouette band is wide in world units, so the soft-silhouette gradient
  (diff/soft.py) has a wide basin.
* **Soft-silhouette annealing within each stage** (sigma schedule), ending
  with hard-render polish at the finest scale.
* **Stochastic restarts**: jittered initializations race through the
  coarsest stage; the best continues.

Every render is the core renderer's (core/renderer.py) or its soft blend,
differentiated by ``torch.autograd``: no kernel runs.  optax's
``multi_transform`` is ``default_fit_optimizer``'s three parameter groups;
torch's Adam rounds apart from optax's (``eps`` added to the
bias-corrected root in optax, to the uncorrected root scaled in torch), so
parameters part from the JAX package's in the last bits of every step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CameraConfig, RenderConfig
from ..core.renderer import render_image
from ..ops.rays import Camera
from ..ops.sampling import resolve_device
from ..scene.flat import FlatScene
from .fit import FitParams, default_fit_optimizer
from .soft import render_soft


# ---------------------------------------------------------------------------
# Views
# ---------------------------------------------------------------------------

def orbit_views(base: CameraConfig, n_views: int,
                span_deg: float = 90.0) -> List[CameraConfig]:
    """``n_views`` cameras obtained by rotating the eye about the vertical
    axis through the look-at point, spanning ``span_deg`` degrees centred
    on the base azimuth.  View 0 is the base camera when n_views is odd."""
    if n_views == 1:
        return [base]
    eye = np.asarray(base.eye, np.float64)
    look = np.asarray(base.look_at, np.float64)
    rel = eye - look
    out = []
    offsets = np.linspace(-span_deg / 2.0, span_deg / 2.0, n_views)
    # keep the base view first so single-view comparisons share view 0
    order = np.argsort(np.abs(offsets), kind="stable")
    for k in order:
        th = math.radians(float(offsets[k]))
        c, s = math.cos(th), math.sin(th)
        rot = np.array([c * rel[0] + s * rel[2], rel[1],
                        -s * rel[0] + c * rel[2]])
        out.append(dataclasses.replace(base, eye=tuple(look + rot)))
    return out


def render_views(scene: FlatScene, views: Sequence[CameraConfig],
                 config: RenderConfig, *, device=None) -> torch.Tensor:
    """Hard render per view -> [V,H,W,3] (the fit targets)."""
    return torch.stack([render_image(scene, v, config, device=device)
                        for v in views], 0)


# ---------------------------------------------------------------------------
# Multiscale pyramid
# ---------------------------------------------------------------------------

def downsample(img: torch.Tensor, size: int) -> torch.Tensor:
    """Decimate an [H,W,3] (or [V,H,W,3]) image to size^2 by strided point
    sampling; H must be a multiple of ``size``.

    Decimation, not box filtering, on purpose: a coarse render at pixel
    scale ``f*s`` samples **exactly** the full-res pixel grid strided by
    ``f`` (screen points are ``base + i*scale*right``, ops/rays.py), so the
    decimated target makes the coarse loss exactly zero at the true
    parameters."""
    h = img.shape[-3]
    if h == size:
        return img
    if h % size:
        raise ValueError(f"size {size} must divide image height {h}")
    f = h // size
    return img[..., ::f, ::f, :]


def _stage_config(config: RenderConfig, size: int) -> RenderConfig:
    return dataclasses.replace(config, width=size, height=size)


def _stage_views(views: Sequence[CameraConfig], full_size: int,
                 size: int) -> List[CameraConfig]:
    """Same world-space frame at a coarser resolution: scale world units
    per pixel so frame width (pixels * pixel_scale) is preserved."""
    scale = full_size / size
    return [dataclasses.replace(v, pixel_scale=v.pixel_scale * scale)
            for v in views]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def multiview_loss(params: FitParams, scene: FlatScene,
                   cameras: Sequence[Camera], config: RenderConfig,
                   targets: torch.Tensor, sigma: Optional[float], *,
                   device=None) -> torch.Tensor:
    """Mean L2 over views; soft-silhouette render when sigma is given
    (world units), hard render when sigma is None.

    Geometry must be fit in soft mode: the hard render's fixed-topology
    gradients carry no occupancy term, so hard mode holds the geometry
    (its gradient is cut) and serves light and material polish.  In soft
    mode centers and radii get occupancy gradients through the silhouette
    alpha (d_sil = b - r, diff/soft.py)."""
    s = params.into_scene(scene)
    if sigma is None:
        s = s.replace(sph_radius=s.sph_radius.detach(),
                      sph_center=s.sph_center.detach())
    total = 0.0
    for k, cam in enumerate(cameras):
        if sigma is None:
            img = render_image(s, cam, config, device=device)
        else:
            img = render_soft(s, cam, config, sigma=sigma,
                              occupancy_only_geometry=True, device=device)
        total = total + torch.mean((img - targets[k]) ** 2)
    return total / len(cameras)


# ---------------------------------------------------------------------------
# The fit driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiviewFitResult:
    params: FitParams
    history: List[float]
    stage_log: List[Dict]
    restart_losses: List[float]


def _copy(params: FitParams) -> FitParams:
    """A detached copy of ``params`` on their device."""
    return FitParams(*(getattr(params, f) for f in FitParams.FIELDS))


def _make_step(scene, cameras, config, targets, sigma, device):
    """(step(params, opt) -> the loss before the update, loss_fn(params)
    -> float) of one stage."""
    def step(params, opt):
        opt.zero_grad()
        loss = multiview_loss(params, scene, cameras, config, targets, sigma,
                              device=device)
        loss.backward()
        opt.step()
        return loss.item()

    def loss_fn(params):
        with torch.no_grad():
            return float(multiview_loss(params, scene, cameras, config,
                                        targets, sigma, device=device))
    return step, loss_fn


def _run_stage(params, step, loss_fn, make_opt, steps, history):
    """Run one pyramid stage with a FRESH optimizer (``make_opt(params)``)
    and best-params tracking: every evaluated loss (each step's pre-update
    loss plus one final evaluation) is a candidate, and the stage returns
    the best, so a stage never ends worse than it started under its own
    objective.  Returns (params, entry_loss, best_loss)."""
    opt = make_opt(params)
    best_p, best_l, entry_l = params, None, None
    for _ in range(steps):
        before = _copy(params)
        loss = step(params, opt)     # loss at `before`, then the update
        history.append(loss)
        if entry_l is None:
            entry_l = loss
        if best_l is None or loss < best_l:
            best_p, best_l = before, loss
    loss = loss_fn(params)           # the last iterate is also a candidate
    history.append(loss)
    if best_l is None or loss < best_l:
        best_p, best_l = params, loss
    return best_p, entry_l if entry_l is not None else loss, best_l


def _jitter_params(params: FitParams, rng: np.random.RandomState,
                   center_scale: float, radius_scale: float,
                   light_scale: float) -> FitParams:
    """``params`` with the sphere centres, radii and lights jittered by
    ``rng``'s draws, in the JAX package's order (so a seed draws what it
    draws there)."""
    ns = params.sph_center.shape[0]
    nl = params.light_pos.shape[0]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                    device=params.sph_center.device)
    with torch.no_grad():
        out = _copy(params)
        out.sph_center += f32(rng.uniform(-center_scale, center_scale,
                                          (ns, 3)))
        out.sph_radius *= f32(1.0 + rng.uniform(-radius_scale, radius_scale,
                                                ns))
        out.light_pos += f32(rng.uniform(-light_scale, light_scale, (nl, 3)))
    return out


def fit_multiview(scene: FlatScene, views: Sequence[CameraConfig],
                  config: RenderConfig, targets,
                  init: Optional[FitParams] = None,
                  sizes: Sequence[int] = (64, 128),
                  sigmas: Sequence[Optional[float]] = (1.5, 1.0, None),
                  steps_per_sigma: int = 60,
                  restarts: int = 4, restart_steps: int = 40,
                  restart_jitter: Tuple[float, float, float] = (15.0, 0.1,
                                                                20.0),
                  geom_lr: float = 0.6, light_lr: float = 1.0,
                  mat_lr: float = 0.0, seed: int = 0,
                  light_polish_steps: int = 120,
                  log_every: int = 0, *, device=None) -> MultiviewFitResult:
    """Coarse-to-fine, sigma-annealed, restarted multi-view fit on
    ``device`` (default: the GPU).

    ``targets``: [V,H,W,3] hard renders at the *full* config resolution.
    ``sizes``: pyramid stages, coarse->fine; the full resolution is
    appended when absent.  Each stage runs the whole ``sigmas`` schedule;
    sigma is in **pixels of the current stage** (converted to world units
    via the stage pixel scale).  ``None`` = hard-render polish: geometry
    held (see multiview_loss), lights and materials refined.

    Every stage starts from a FRESH optimizer and keeps its best iterate
    (``_run_stage``): ``stage_log`` records ``loss_entry`` and ``loss``
    (the best) per stage, ``loss <= loss_entry`` by construction.  After
    the pyramid, ``light_polish_steps`` of a LIGHT-ONLY hard-render stage
    run at the full resolution.  ``init`` is copied, never updated."""
    device = resolve_device(device)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
    full = config.width
    if config.height != full:
        raise ValueError("multiview fit assumes square images")
    sizes = [s for s in sizes if s < full] + [full]
    init = FitParams.from_scene(scene) if init is None else init
    init = _copy(init).to(device)

    def make_opt(p, geom=geom_lr, light=light_lr, mat=mat_lr):
        return default_fit_optimizer(p, geom_lr=geom, light_lr=light,
                                     mat_lr=mat)

    def stage_pieces(size):
        cfg_s = _stage_config(config, size)
        svs = _stage_views(views, full, size)
        cams = [Camera.from_config(v, size, size, device=device)
                for v in svs]
        return cfg_s, cams, downsample(targets, size), float(
            svs[0].pixel_scale)

    # --- restart race through the coarsest stage, first sigma ---
    cfg0, cams0, tgt0, px0 = stage_pieces(sizes[0])
    sigma0 = None if sigmas[0] is None else sigmas[0] * px0
    race_step, _ = _make_step(scene, cams0, cfg0, tgt0, sigma0, device)
    rng = np.random.RandomState(seed)
    candidates = [init] + [
        _jitter_params(init, rng, *restart_jitter)
        for _ in range(max(restarts - 1, 0))]
    restart_losses: List[float] = []
    best_params, best_loss = None, np.inf
    for cand in candidates:
        p = _copy(cand)
        opt = make_opt(p)
        loss = np.inf
        for _ in range(restart_steps):
            loss = race_step(p, opt)
        restart_losses.append(loss)
        if loss < best_loss:
            best_params, best_loss = p, loss

    # --- pyramid with sigma annealing ---
    params = best_params
    history: List[float] = []
    stage_log: List[Dict] = []
    for size in sizes:
        cfg_s, cams, tgts, px = stage_pieces(size)
        for sigma_px in sigmas:
            sigma = None if sigma_px is None else sigma_px * px
            step, loss_fn = _make_step(scene, cams, cfg_s, tgts, sigma,
                                       device)
            params, l_entry, l_best = _run_stage(params, step, loss_fn,
                                                 make_opt, steps_per_sigma,
                                                 history)
            if log_every:
                print(f"size={size} sigma_px={sigma_px}: "
                      f"loss {l_entry:.6g} -> {l_best:.6g}")
            stage_log.append(dict(size=size, sigma_px=sigma_px,
                                  sigma_world=sigma, loss_entry=l_entry,
                                  loss=l_best))

    # --- light-only polish: hard render, full size, fresh Adam ---
    if (light_polish_steps > 0 and light_lr > 0
            and params.light_pos.shape[0] > 0):
        cfg_f, cams_f, tgts_f, _ = stage_pieces(sizes[-1])
        step_l, loss_l = _make_step(scene, cams_f, cfg_f, tgts_f, None,
                                    device)
        params, l_entry, l_best = _run_stage(
            params, step_l, loss_l,
            lambda p: make_opt(p, geom=0.0, mat=0.0),
            light_polish_steps, history)
        if log_every:
            print(f"light polish: loss {l_entry:.6g} -> {l_best:.6g}")
        stage_log.append(dict(size=sizes[-1], sigma_px=None,
                              sigma_world=None, stage="light_polish",
                              loss_entry=l_entry, loss=l_best))
    return MultiviewFitResult(params=params, history=history,
                              stage_log=stage_log,
                              restart_losses=restart_losses)


# ---------------------------------------------------------------------------
# Recovery metrics
# ---------------------------------------------------------------------------

def recovery_report(params: FitParams,
                    true_scene: FlatScene) -> Dict[str, float]:
    """Recovery error against the scene that generated the targets:
    worst-sphere center distance, worst relative radius error, worst light
    distance (world units; one board square = 40).  Only *valid* spheres
    count: FlatScene pads the sphere table, and padding rows are invisible
    to the renderer and hence to every gradient."""
    a = lambda t: t.detach().cpu().numpy()
    valid = a(true_scene.sph_valid).astype(bool)
    c_err = np.linalg.norm(a(params.sph_center) - a(true_scene.sph_center),
                           axis=-1)[valid]
    r_err = np.abs(a(params.sph_radius) - a(true_scene.sph_radius))[valid]
    r_rel = r_err / np.maximum(a(true_scene.sph_radius)[valid], 1e-9)
    l_err = np.linalg.norm(a(params.light_pos) - a(true_scene.light_pos),
                           axis=-1)
    return dict(center_err_max=float(c_err.max()),
                center_err_mean=float(c_err.mean()),
                radius_err_max=float(r_err.max()),
                radius_rel_err_max=float(r_rel.max()),
                light_err_max=float(l_err.max()) if l_err.size else 0.0)
