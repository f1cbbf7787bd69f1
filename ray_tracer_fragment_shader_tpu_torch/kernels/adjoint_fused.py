"""Loss and gradients of the L2 fit through two hand-written CUDA kernels —
the counterpart of the JAX package's ``kernels/adjoint_fused.py``, its
packed two-phase path.

Phase 1 is the packed forward (``render.render_packed``, csrc/
render_chain.cu): the image plus one packed residual plane per bounce level.
Phase 2 is ``adjoint_packed`` (csrc/adjoint_packed.cu): it forms the L2
cotangent and the squared-error sum in its prologue, unpacks the residuals,
and runs the hand-written replay adjoint of the chain, one thread per pixel.
Each block writes one row of per-entity partial sums, and a second kernel
adds the rows in a fixed order, so two launches give bit-identical tables.

``adjoint_packed_ref``, the plain version, differentiates the replay of
``kernels/adjoint.py`` with ``torch.autograd``; it shares no code with the
kernel's adjoint.  Gradients are taken through fixed hit topology (hit/miss,
checker parity and shadow edges carry none), w.r.t. the ``FitParams``
leaves: sphere centres and radii, light positions, material colours.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.rays import Camera, primary_rays, screen_points
from ..scene.flat import FlatScene
from .adjoint import replay_chain
from .render import (LAUNCHES, SMEM_LIMIT_BYTES, _check, _flat_tables,
                     compact_scene, pack_scene, pack_widths, render_kwargs,
                     render_packed, resolve_device, unpack_residuals)

# Diff-table layouts (rows = entity, cols = packed fields)
SPHD_COLS = 8    # cx cy cz r - - - -
MATD_COLS = 16   # amb(3) dif(3) spe(3) - - - - - - -
LIGHTD_COLS = 8  # pos(3) - - - - -

#: deepest chain and most lights the adjoint kernel's per-thread records
#: hold (csrc/adjoint_packed.cu::kMaxLevels, kMaxLights)
ADJOINT_MAX_DEPTH = 15
ADJOINT_MAX_LIGHTS = 16
#: threads a block of the adjoint kernel (csrc/adjoint_packed.cu::kThreads)
ADJOINT_THREADS = 256


def diff_tables(tables: Dict[str, torch.Tensor], nl: int):
    """(sphd, matd, lightd): the differentiable parameter tables, read from
    the forward tables, which hold the same values (sph[:, 0:4],
    mat[:, 0:9], light[:, 0:3])."""
    sph, mat, light = tables["sph"], tables["mat"], tables["light"]
    sphd = sph.new_zeros((sph.shape[0], SPHD_COLS))
    sphd[:, 0:4] = sph[:, 0:4]
    matd = mat.new_zeros((mat.shape[0], MATD_COLS))
    matd[:, 0:9] = mat[:, 0:9]
    lightd = light.new_zeros((max(nl, 1), LIGHTD_COLS))
    lightd[:nl, 0:3] = light[:nl, 0:3]
    return sphd, matd, lightd


def _pack_diff_tables(scene: FlatScene):
    """The differentiable parameter tables of a compacted scene, in the
    JAX package's layouts (adjoint_fused.py::_pack_diff_tables)."""
    return diff_tables(pack_scene(scene), scene.num_lights)


# ------------------------------------------------------------ plain version

def table_geom(tables, nl: int, params=None) -> Dict[str, torch.Tensor]:
    """The replay's inputs (kernels/adjoint.py::_node_math's ``geom``) from
    the kernels' tables, with ``params`` = (sphd, matd, lightd) as the
    parameter tables (default: the tables' own values)."""
    sphd, matd, lightd = (diff_tables(tables, nl) if params is None
                          else params)
    mat, light = tables["mat"], tables["light"]
    return dict(tri_n=tables["tri"][:, 3:6], tri_nv0=tables["tri"][:, 16],
                sph_center=sphd[:, 0:3], sph_radius=sphd[:, 3],
                mat_ambient=matd[:, 0:3], mat_diffuse=matd[:, 3:6],
                mat_specular=matd[:, 6:9], mat_transparency=mat[:, 9:12],
                mat_refraction=mat[:, 12], take_t=mat[:, 13] > 0.5,
                light_pos=lightd[:nl, 0:3], light_color=light[:nl, 3:6])


def replay_packed(tables, v, eye, pk, *, pack: Tuple[float, float], nl: int,
                  depth: int, atten: float, params=None) -> torch.Tensor:
    """[P,3] radiance of the chain replayed from packed residuals ``pk``
    (kernels/adjoint.py::replay_chain), with ``params`` as in
    ``table_geom``; in the dtype of ``v``."""
    res = unpack_residuals(pk, nl, pack)
    o = torch.tensor(eye, dtype=v.dtype, device=v.device).expand(v.shape)
    return replay_chain(table_geom(tables, nl, params), o, v, res["bi"],
                        res["mid"], res["lit"], depth=depth, atten=atten)


def adjoint_packed_ref(tables, v, eye, img, target, mask, pk, *,
                       pack: Tuple[float, float], g_scale: float, nl: int,
                       depth: int, atten: float, want_trans: bool):
    """Plain PyTorch version of the phase-2 kernel: the masked squared-error
    sum ``sum(mask*(img-target)^2)`` and the gradient tables (dsph [ns,8],
    dmat [m,16], dlight [max(nl,1),8]) of the replayed chain under the
    cotangent ``g_scale*mask*(img-target)``, by autograd through
    ``replay_packed``."""
    d_raw = img - target
    d = d_raw * mask[:, None]
    loss = torch.sum(d * d_raw)
    leaves = tuple(t.detach().clone().requires_grad_()
                   for t in diff_tables(tables, nl))
    with torch.enable_grad():  # also inside an autograd.Function's forward
        color = replay_packed(tables, v, eye, pk, pack=pack, nl=nl,
                              depth=depth, atten=atten, params=leaves)
        grads = torch.autograd.grad(color, leaves, grad_outputs=g_scale * d,
                                    allow_unused=True)
    return (loss.detach(),) + tuple(
        torch.zeros_like(t) if g is None else g
        for t, g in zip(leaves, grads))


# ------------------------------------------------------------------ wrapper

def adjoint_packed(tables, v, eye, img, target, mask, pk, *,
                   pack: Tuple[float, float], g_scale: float, nl: int,
                   depth: int, atten: float, want_trans: bool):
    """Phase 2 of the fit path: (loss_sum, dsph, dmat, dlight) from the
    packed forward's image ``img`` [P,3] and residuals ``pk`` [depth+1, P],
    the primary-ray directions ``v`` [P,3], the ``target`` [P,3] and the
    pixel ``mask`` [P].  CUDA tensors launch csrc/adjoint_packed.cu (the
    adjoint, then the fixed-order reduction of its per-block partial
    tables); CPU tensors run ``adjoint_packed_ref``."""
    _check(tables, v, depth, nl)
    P = v.shape[0]
    for name, t, shape in (("img", img, (P, 3)), ("target", target, (P, 3)),
                           ("mask", mask, (P,)), ("pk", pk, (depth + 1, P))):
        if t.device != v.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {list(shape)} "
                             f"on {v.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    kw = dict(pack=pack, g_scale=g_scale, nl=nl, depth=depth, atten=atten,
              want_trans=want_trans)
    if v.device.type == "cpu":
        return adjoint_packed_ref(tables, v, eye, img, target, mask, pk, **kw)
    if v.device.type != "cuda":
        raise ValueError(f"adjoint_packed: kernels run on CUDA tensors, got "
                         f"{v.device}")
    if depth > ADJOINT_MAX_DEPTH or nl > ADJOINT_MAX_LIGHTS:
        raise ValueError(f"adjoint_packed holds depth <= {ADJOINT_MAX_DEPTH} "
                         f"and <= {ADJOINT_MAX_LIGHTS} lights, got depth "
                         f"{depth}, {nl} lights")
    from . import cuda_build
    lib = cuda_build.load()
    flat = _flat_tables(tables, nl)
    ns, nt, m = (tables[k].shape[0] for k in ("sph", "tri", "mat"))
    ncols = 1 + 4 * ns + 9 * m + 3 * nl
    smem = 4 * (flat.numel() + ADJOINT_THREADS // 32 * ncols)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"adjoint_packed: tables and partial sums take "
                         f"{smem} B, over the {SMEM_LIMIT_BYTES} B of shared "
                         f"memory a block may use")
    blocks = max(-(-P // ADJOINT_THREADS), 1)
    partial = torch.empty((blocks, ncols), dtype=torch.float32,
                          device=v.device)
    out = torch.empty(ncols, dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(v.device).cuda_stream)
        rc = lib.rtfs_adjoint_packed(
            flat.data_ptr(), ns, nt, m, nl, v.data_ptr(), img.data_ptr(),
            target.data_ptr(), mask.data_ptr(), pk.data_ptr(), P,
            *(float(e) for e in eye), depth, atten, g_scale,
            float(pack[0]), float(pack[1]), int(want_trans),
            partial.data_ptr(), blocks, stream)
        cuda_build.check(lib, rc, "adjoint_packed")
        rc = lib.rtfs_adjoint_reduce(partial.data_ptr(), blocks, ncols,
                                     out.data_ptr(), stream)
        cuda_build.check(lib, rc, "adjoint_reduce")
    LAUNCHES["adjoint_packed"] += 1
    sphd = out.new_zeros((ns, SPHD_COLS))
    sphd[:, 0:4] = out[1:1 + 4 * ns].view(ns, 4)
    matd = out.new_zeros((m, MATD_COLS))
    matd[:, 0:9] = out[1 + 4 * ns:1 + 4 * ns + 9 * m].view(m, 9)
    lightd = out.new_zeros((max(nl, 1), LIGHTD_COLS))
    lightd[:nl, 0:3] = out[1 + 4 * ns + 9 * m:].view(nl, 3)
    return out[0], sphd, matd, lightd


# ------------------------------------------------------------- host side

def prepare_fit_inputs(camera: Camera, config: RenderConfig, target,
                       device=None) -> Dict[str, Any]:
    """The step-invariant per-pixel inputs of the fit kernels, on
    ``device`` (default: the GPU): primary-ray directions ``v`` [P,3], the
    ``target`` RGB [P,3] and the pixel ``mask`` [P] (all 1), flat over
    P = H*W with no padding.  Build once and pass as ``prep=``; it
    remembers the target it was built from (``_check_prep``)."""
    device = resolve_device(device)
    w, h = config.width, config.height
    camera = camera.to(device)
    _, v = primary_rays(camera, screen_points(camera, w, h))
    tgt = torch.as_tensor(target, dtype=torch.float32, device=device)
    return dict(v=v.contiguous(), target=tgt.reshape(-1, 3).contiguous(),
                mask=torch.ones(h * w, dtype=torch.float32, device=device),
                eye=camera.eye.tolist(), src=target)


def _check_prep(prep, target) -> None:
    """Raises if ``prep`` was built from a different target object than this
    call passes (identity check: rebuild the prep when the target
    changes)."""
    if prep["src"] is not target:
        raise ValueError("prep= was built from a different `target` object "
                         "than this call passes; prepare_fit_inputs() again "
                         "for the new target")


def kernel_inputs(scene: FlatScene, config: RenderConfig, num_pixels: int,
                  device=None):
    """The fit kernels' per-step inputs from a chain-exact scene:
    ``(scene_c, tables, kw, akw)``, the compacted and detached scene on
    ``device`` (default: the GPU), its tables, the packed forward's render
    keywords (``render_packed(tables, v, eye, pack=akw["pack"], **kw)``)
    and the adjoint's keywords (``adjoint_packed(..., **akw)``), whose
    cotangent scale is that of ``mean((img - target)^2)`` over
    ``num_pixels`` RGB pixels."""
    scene = compact_scene(scene.to(resolve_device(device)))
    scene = scene.replace(**{k: t.detach()
                             for k, t in scene.tensors().items()})
    tables = pack_scene(scene)
    kw = render_kwargs(scene, config)
    pack = pack_widths(tables["tri"].shape[0], scene.num_spheres,
                       scene.num_materials, scene.num_lights)
    akw = dict(pack=pack, g_scale=2.0 / (num_pixels * 3), nl=kw["nl"],
               depth=kw["depth"], atten=kw["atten"],
               want_trans=kw["want_trans"])
    return scene, tables, kw, akw


def twophase_loss_grads_kernel(scene: FlatScene, camera: Camera,
                               config: RenderConfig, target,
                               prep: Optional[Dict[str, Any]] = None,
                               device=None):
    """The two-phase fwd+bwd of a chain-exact scene: the packed forward,
    then the adjoint with its cotangent prologue.  Returns ``(sq_err_sum,
    grads_c)``: the squared-error sum and the compacted scene's gradient
    tables (sph_center [ns,3], sph_radius [ns], mat_ambient/diffuse/
    specular [m,3], light_pos [nl,3]) of ``sq_err_sum / (H*W*3)``, as
    adjoint_fused.py::twophase_loss_grads_pallas."""
    if not scene.chain_exact:
        raise ValueError("the packed two-phase backward replays the bounce "
                         "chain; fractional-transparency scenes need the "
                         "fused tree kernel (K6), not ported yet")
    device = resolve_device(device)
    if prep is None:
        prep = prepare_fit_inputs(camera, config, target, device=device)
    else:
        _check_prep(prep, target)
    v, eye = prep["v"], prep["eye"]
    scene, tables, kw, akw = kernel_inputs(scene, config, v.shape[0],
                                           device=device)
    ns, m, nl = scene.num_spheres, scene.num_materials, scene.num_lights
    img, pk = render_packed(tables, v, eye, pack=akw["pack"], **kw)
    loss, dsph, dmat, dlight = adjoint_packed(
        tables, v, eye, img, prep["target"], prep["mask"], pk, **akw)
    return loss, dict(sph_center=dsph[:ns, 0:3], sph_radius=dsph[:ns, 3],
                      mat_ambient=dmat[:m, 0:3], mat_diffuse=dmat[:m, 3:6],
                      mat_specular=dmat[:m, 6:9], light_pos=dlight[:nl, 0:3])


def _sphere_take(scene: FlatScene):
    """Indices of the compacted sphere rows in the scene's arrays (None
    when nothing is compacted away)."""
    sv = scene.sph_valid.cpu().numpy()
    tv = scene.tri_valid.cpu().numpy()
    if sv.all() and tv.all():
        return None
    return np.nonzero(sv)[0]


def grads_to_fitparams(params, scene_full: FlatScene,
                       grads_c: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The compacted scene's gradient tables scattered back onto the
    (possibly padded) ``FitParams`` leaves, by field name."""
    take = _sphere_take(scene_full)
    d_center, d_radius = grads_c["sph_center"], grads_c["sph_radius"]
    if take is not None:
        idx = torch.as_tensor(take, device=d_center.device)
        d_center = d_center.new_zeros(params.sph_center.shape).index_copy(
            0, idx, d_center)
        d_radius = d_radius.new_zeros(params.sph_radius.shape).index_copy(
            0, idx, d_radius)
    return dict(sph_center=d_center, sph_radius=d_radius,
                light_pos=grads_c["light_pos"],
                mat_diffuse=grads_c["mat_diffuse"],
                mat_specular=grads_c["mat_specular"],
                mat_ambient=grads_c["mat_ambient"])


def fit_value_and_grad(params, scene: FlatScene, camera: Camera,
                       config: RenderConfig, target, *,
                       prep: Optional[Dict[str, Any]] = None,
                       mode: str = "twophase", device=None):
    """(loss, d loss / d params) of the L2 photometric loss
    ``mean((img - target)^2)``, through the packed forward and the adjoint
    kernel, on ``device`` (default: the GPU; ``"cpu"`` runs their plain
    versions).  ``params`` is a ``diff.fit.FitParams``; the gradients come
    back as a dict keyed by its field names.

    Only the two-phase path of adjoint_fused.py::fit_value_and_grad is
    ported: ``mode="fused"`` (K6), ``mode="split"`` (K8), supersampled or
    adaptive configs (K7) and fractional-transparency scenes (the tree
    kernel of K6) raise ``NotImplementedError`` (ROADMAP.md queue 1
    item 6)."""
    if mode == "fused":
        raise NotImplementedError("mode='fused' needs the one-dispatch "
                                  "kernel K6 (ROADMAP.md queue 1 item 6)")
    if mode == "split":
        raise NotImplementedError("mode='split' needs the residual forward "
                                  "and K8 (ROADMAP.md queue 1 item 6)")
    if mode != "twophase":
        raise ValueError(f"unknown fit mode {mode!r}")
    if config.samples > 1 or config.force_jitter or config.adaptive:
        raise NotImplementedError("supersampled and adaptive fits need the "
                                  "per-sample backward K7 (ROADMAP.md "
                                  "queue 1 item 6)")
    scene_full = params.into_scene(scene)
    if not scene_full.chain_exact:
        raise NotImplementedError("fractional-transparency scenes need the "
                                  "fused tree kernel K6 (ROADMAP.md queue 1 "
                                  "item 6)")
    sq_sum, grads_c = twophase_loss_grads_kernel(
        scene_full, camera, config, target, prep=prep, device=device)
    denom = float(config.height * config.width * 3)
    return sq_sum / denom, grads_to_fitparams(params, scene_full, grads_c)
