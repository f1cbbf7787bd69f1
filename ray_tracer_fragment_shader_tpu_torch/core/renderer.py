"""The core renderer in plain PyTorch: the counterpart of the JAX package's
``core/renderer.py``, its semantics oracle and autodiff baseline.

The reference's recursive ``rayTraceRay`` (Hw4/MySdlApplication.cpp:
1184-1249) branches into at most two child rays per hit: a transmitted ray
weighted by the material transparency T and a reflected ray weighted by the
opacity 1-T.  Two realisations:

* ``chain``: a loop over bounce levels carrying one ray and throughput per
  pixel (JAX: a ``lax.scan``).  Exact whenever every material traces at
  most one child (T all-zeros or all-ones: every reference material, see
  Material.chain_exact).
* ``tree``: the literal binary recursion, unrolled in Python.  Cost
  O(2^depth) traversals; for fractional-T scenes and parity tests.

Both shade at every level including depth 0, like the reference (shading
happens before the depth>0 recursion gate, ``:1213-1230``).

These functions launch no kernel: every step is a PyTorch operation on the
tensors' device, and ``torch.autograd`` differentiates them (the naive
autodiff the hand-written adjoints of kernels/ exist to beat).  They run on
``device`` (None: the GPU, raising where there is none; ``"cpu"`` for the
tests), with no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import CameraConfig, RenderConfig
from ..ops.intersect import intersect_scene
from ..ops.rays import Camera, primary_rays, screen_points
from ..ops.sampling import adaptive_step, jitter_source, resolve_device
from ..ops.shading import shade_local
from ..scene.flat import FlatScene
from ..utils.jmath import dot3, norm3, safe_div, safe_sqrt


def _unit(v):
    l2 = dot3(v, v)
    inv = safe_div(torch.ones_like(l2), safe_sqrt(l2, l2 > 0), l2 > 0)
    return v * inv[:, None]


def _next_branch(hit, small: float):
    """Child-ray selection for the chain renderer: transmitted if the
    reference would trace it (T nonzero and |T| > SMALL, ``:1238``), else
    reflected if opacity is nonzero (``:1243``)."""
    T = hit.transparency
    opacity = 1.0 - T
    t_nonzero = torch.any(T != 0.0, dim=-1)
    take_trans = t_nonzero & (norm3(T) > small)
    refl_ok = torch.any(opacity != 0.0, dim=-1)
    next_v = torch.where(take_trans[:, None], hit.trans_dir, hit.refl_dir)
    weight = torch.where(take_trans[:, None], T, opacity)
    branch_ok = torch.where(take_trans,
                            dot3(hit.trans_dir, hit.trans_dir) > 0.0,
                            refl_ok)
    return next_v, weight, branch_ok


def render_rays_chain(scene: FlatScene, o, v, *, max_depth: int,
                      small: float, attenuation_factor: float, prune: bool,
                      exclude0=None):
    """Iterative single-path bounce loop over ``max_depth + 1`` levels;
    [P,3] colour.

    ``exclude0``: optional [P] primitive ids excluded from the *primary*
    intersection (the soft-silhouette renderer's behind-a-sphere
    background)."""
    dtype = o.dtype
    color = torch.zeros_like(o)
    thr = torch.zeros_like(o) + 1.0
    alive = torch.zeros_like(o[:, 0]) == 0.0
    if exclude0 is None:
        excl = torch.full((o.shape[0],), -1, dtype=torch.int32,
                          device=o.device)
    else:
        excl = exclude0.to(torch.int32)
    for _ in range(max_depth + 1):
        hit = intersect_scene(scene, o, v, small=small, prune=prune,
                              exclude_id=excl)
        valid = hit.valid & alive
        local = shade_local(scene, hit, _unit(v), small=small,
                            attenuation_factor=attenuation_factor,
                            prune=prune)
        color = color + thr * local * valid[:, None].to(dtype)
        next_v, weight, branch_ok = _next_branch(hit, small)
        thr = thr * weight
        alive = valid & branch_ok
        o, v, excl = hit.point, next_v, hit.prim_id
    return color


def render_rays_tree(scene: FlatScene, o, v, *, max_depth: int,
                     small: float, attenuation_factor: float, prune: bool):
    """Full binary bounce tree (transmitted + reflected children at every
    hit), the literal ``rayTraceRay`` semantics, unrolled by recursion."""

    def trace(o, v, depth, excl=None):
        hit = intersect_scene(scene, o, v, small=small, prune=prune,
                              exclude_id=excl)
        color = shade_local(scene, hit, _unit(v), small=small,
                            attenuation_factor=attenuation_factor,
                            prune=prune)
        if depth > 0:
            T = hit.transparency
            opacity = 1.0 - T
            take_trans = (torch.any(T != 0.0, dim=-1)
                          & (norm3(T) > small))[:, None]
            refl_ok = torch.any(opacity != 0.0, dim=-1)[:, None]
            # child rays of misses and dead branches have zero direction
            # and contribute nothing; the masks make that explicit
            ct = trace(hit.point, torch.where(take_trans, hit.trans_dir, 0.0),
                       depth - 1, excl=hit.prim_id)
            cr = trace(hit.point, torch.where(refl_ok, hit.refl_dir, 0.0),
                       depth - 1, excl=hit.prim_id)
            color = color + torch.where(take_trans, T * ct, 0.0)
            color = color + torch.where(refl_ok, opacity * cr, 0.0)
        return torch.where(hit.valid[:, None], color, torch.zeros_like(color))

    return trace(o, v, max_depth)


def render_rays(scene: FlatScene, o, v, *, max_depth: int, mode: str = "auto",
                small: float = 1e-4, attenuation_factor: float = 1e5,
                prune: bool = True):
    resolved = mode if mode != "auto" else ("chain" if scene.chain_exact
                                            else "tree")
    fn = render_rays_chain if resolved == "chain" else render_rays_tree
    return fn(scene, o, v, max_depth=max_depth, small=small,
              attenuation_factor=attenuation_factor, prune=prune)


def _chunked(fn, o, v, chunk_size: int):
    """Apply fn over [P,...] rays in chunks of ``chunk_size`` (the last one
    zero-padded, as JAX's ``lax.map`` over equal chunks) to bound the peak
    [rays, primitives] working set."""
    P = o.shape[0]
    if P <= chunk_size:
        return fn(o, v)
    pad = (-P) % chunk_size
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))], 0)
        v = torch.cat([v, v.new_zeros((pad, 3))], 0)
    out = [fn(o[s:s + chunk_size], v[s:s + chunk_size])
           for s in range(0, o.shape[0], chunk_size)]
    return torch.cat(out, 0)[:P]


def render_pixels(scene: FlatScene, camera, width: int, height: int,
                  config: RenderConfig, ij=None, *,
                  jitter: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Render a flat pixel set (all pixels when ij is None) -> [P,3], on
    ``device``.

    Supersampling averages ``config.samples`` jittered renders; with one
    sample and no ``force_jitter`` the ray goes through the exact screen
    point (the reference's jitter exists only for its supersampler,
    MySdlApplication.cpp:1294-1311).  Sample k is jittered by ``jitter[k]``
    of an [S, P, 3] tensor when given (e.g. the JAX package's draws, for
    per-pixel parity), else by a draw from ``generator`` (default: seeded
    with ``config.seed``), exactly as ``render_image_kernel`` draws them
    (kernels/render.py::jitter_source)."""
    device = resolve_device(device)
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, width, height, device=device)
    # .to keeps autograd's path back to leaves on another device
    scene, camera = scene.to(device), camera.to(device)
    pts = screen_points(camera, width, height, ij=ij)
    P = pts.shape[0]
    mode = config.resolved_mode(scene.chain_exact)

    def traced(o, v):
        return _chunked(lambda a, b: render_rays(
            scene, a, b, max_depth=config.max_depth, mode=mode,
            small=config.small_number,
            attenuation_factor=config.attenuation_factor,
            prune=config.prune), o, v, config.chunk_size)

    if not (config.samples > 1 or config.force_jitter):
        return traced(*primary_rays(camera, pts))

    jitter_k = jitter_source(config, P, pts.dtype, device, jitter=jitter,
                             generator=generator)
    if not config.adaptive:
        total = torch.zeros_like(pts)
        for k in range(config.samples):
            total = total + traced(*primary_rays(camera, pts,
                                                 jitter=jitter_k(k)))
        return total / config.samples

    # Adaptive supersampler emulation (MySdlApplication.cpp:1294-1311):
    # sample k joins the sum while the pixel is unconverged; the divisor is
    # the loop variable at exit (the reference divides the k+1 accumulated
    # samples by k when it breaks early).  Every sample is rendered, as in
    # the JAX package; convergence only masks accumulation.
    accum = torch.zeros_like(pts)
    divisor = torch.full((P,), float(config.samples), dtype=pts.dtype,
                         device=device)
    done = torch.zeros((P,), dtype=torch.bool, device=device)
    for k in range(config.samples):
        c = traced(*primary_rays(camera, pts, jitter=jitter_k(k)))
        accum, divisor, done, _ = adaptive_step(k, c, accum, divisor, done,
                                                config.small_number)
    return accum / divisor[:, None]


def render_image(scene: FlatScene, camera, config: RenderConfig, *,
                 jitter: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Full-frame render -> [H,W,3], row j=0 the bottom scanline (GL screen
    coordinates, like the reference's gluOrtho2D window), on ``device``
    (None: the GPU).  Differentiable by ``torch.autograd`` in every float
    tensor of the scene and the camera."""
    flat = render_pixels(scene, camera, config.width, config.height, config,
                         jitter=jitter, generator=generator, device=device)
    return flat.reshape(config.height, config.width, 3)


def render_image_jit(scene: FlatScene, camera, config: RenderConfig, *,
                     device=None) -> torch.Tensor:
    """``render_image``, as the JAX package's jitted entry point.  The same
    eager function, compiled by nothing (no ``torch.compile``): the port's
    compiled paths are the hand-written kernels (kernels/render.py)."""
    return render_image(scene, camera, config, device=device)
