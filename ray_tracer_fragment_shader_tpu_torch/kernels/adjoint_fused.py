"""Loss and gradients of the L2 fit through hand-written CUDA kernels — the
counterpart of the JAX package's ``kernels/adjoint_fused.py``.

Four kernels, each behind a wrapper that counts its launches
(``render.LAUNCHES``):

* ``adjoint_packed`` (K4, csrc/adjoint_packed.cu): phase 2 of the two-phase
  path, after the packed forward (``render.render_packed``, K3).  It forms
  the L2 cotangent and the squared-error sum in its prologue, unpacks the
  residuals and runs the hand-written replay adjoint of the chain.
* ``fused_adjoint`` (K6, csrc/adjoint_fused.cu): forward, L2 cotangent and
  loss, and adjoint behind one entry, with unpacked residuals (no pack, so
  no 2^24 limit).  On the bounce chain: the chain forward writing each hit
  level's topology record, K4's live list, and the adjoint over it on the
  records; its tables equal K3+K4's bit for bit.  For
  fractional-transparency scenes the full tree, in one dispatch that keeps
  the residuals in each thread.  ``mode="fused"``, and the only fit path
  of tree scenes.
* ``recompute_adjoint`` (K7, the same source): the forward re-traced and
  the adjoint run under a cotangent given from outside; the per-sample
  backward of supersampled and adaptive fits.  No pack either.
* ``fit_grads`` (K8, csrc/fit_grads.cu): the chain adjoint from the
  unpacked residual planes of ``render.render_residuals`` under a
  cotangent given from outside; ``mode="split"``, and the only fit path of
  chain scenes whose packed residual word would overflow 2^24.

One thread runs one pixel.  K4, K7 and K8 run on the list of the pixels
whose cotangent is nonzero, built on the device first (``_live_list``,
with no host synchronisation), so a warp holds 32 pixels that add
something; K6's chain builds the same list in its forward, its tree runs
on every pixel.  Each warp sums only the per-entity columns its pixels
touch, each block writes one row of partial sums, and a last kernel adds
the rows in a fixed order, so two launches give bit-identical tables.

Under ``RenderConfig.bf16_shading`` (``render_kwargs``'s ``bf16``) the
forwards of K3, K6 and K7 run in their bf16 form, and K4, K8 and the
adjoint halves of K6/K7 replay in f32 on the topology that forward
recorded, as the JAX package does; the loss and cotangent are the bf16
image's.

The plain versions (``adjoint_packed_ref``, ``fused_adjoint_ref``,
``recompute_adjoint_ref``, ``fit_grads_ref``) differentiate the replays of
``kernels/adjoint.py`` with ``torch.autograd``; they share no code with the
kernels' adjoint.  Gradients are taken through fixed hit topology (hit/miss,
checker parity and shadow edges carry none), w.r.t. the ``FitParams``
leaves: sphere centres and radii, light positions, material colours.
"""
from __future__ import annotations

import ctypes
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.rays import Camera, primary_rays, screen_points
from ..scene.flat import FlatScene
from .adjoint import replay_chain, replay_tree
from .render import (LAUNCHES, SMEM_LIMIT_BYTES, TREE_MAX_DEPTH, _check,
                     _flat_tables,
                     adaptive_step, compact_scene, jitter_source, launch_key,
                     pack_scene, pack_widths, render_chain,
                     render_forward_with_residuals, render_kwargs,
                     render_packed, render_residuals_ref, render_tree,
                     resolve_device, unpack_residuals)

# Diff-table layouts (rows = entity, cols = packed fields)
SPHD_COLS = 8    # cx cy cz r - - - -
MATD_COLS = 16   # amb(3) dif(3) spe(3) - - - - - - -
LIGHTD_COLS = 8  # pos(3) - - - - -

#: deepest chain and most lights the adjoint kernels' per-thread records
#: hold (csrc/adjoint_ops.cuh::kMaxLevels, kMaxLights)
ADJOINT_MAX_DEPTH = 15
ADJOINT_MAX_LIGHTS = 16
#: the tree depths K6's and K7's tree forms are built for (csrc/
#: adjoint_fused.cu::kTreeAdjDepthCaps): 5, the reference's depth (63
#: preorder nodes a thread), 7, and 10, the tree forward's own limit
#: (``TREE_MAX_DEPTH``); a launch takes the smallest that holds the scene,
#: since CUDA reserves a kernel's local memory for every thread the card
#: holds
TREE_ADJOINT_DEPTH_CAPS = (5, 7, 10)
TREE_ADJOINT_MAX_DEPTH = TREE_ADJOINT_DEPTH_CAPS[-1]
assert TREE_ADJOINT_MAX_DEPTH == TREE_MAX_DEPTH
#: threads a block of the adjoint kernels (csrc/adjoint_ops.cuh::kAdjThreads)
ADJOINT_THREADS = 256
#: most blocks an adjoint launch runs (csrc/adjoint_ops.cuh::kAdjGridCap):
#: a constant, so every sum's order is the same on every launch
ADJOINT_GRID_CAP = 1024
#: floats of shared memory an adjoint block stages node records in
#: (csrc/adjoint_ops.cuh::BlockSums: 8 warps x 32 lanes x 13)
ADJOINT_STAGE_FLOATS = 8 * 32 * 13


def adjoint_blocks(num_pixels: int) -> int:
    """Blocks of an adjoint launch over ``num_pixels`` pixels, each walking
    chunks of 256 (csrc/adjoint_ops.cuh::adjoint_blocks)."""
    return min(max(-(-num_pixels // ADJOINT_THREADS), 1), ADJOINT_GRID_CAP)


def resident_threads(device) -> int:
    """Threads the card ``device`` holds at once, for each of which CUDA
    reserves a kernel's local memory."""
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * p.max_threads_per_multi_processor


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
                refl_ok=mat[:, 14] > 0.5,
                light_pos=lightd[:nl, 0:3], light_color=light[:nl, 3:6])


def replay_grads(tables, v, eye, res: Dict[str, torch.Tensor], g, *,
                 tree: bool, nl: int, depth: int, atten: float):
    """Gradient tables (dsph [ns,8], dmat [m,16], dlight [max(nl,1),8]) of
    ``sum(g * replay)`` by autograd, where ``replay`` is the [P,3] radiance
    of the chain (``replay_chain``) or the tree (``replay_tree``) replayed
    from the residual planes ``res`` (bi, mid, lit) along the primary
    directions ``v`` from ``eye``.  Without a light the radiance is 0 and
    depends on no leaf: every table is 0."""
    leaves = tuple(t.detach().clone().requires_grad_()
                   for t in diff_tables(tables, nl))
    replay = replay_tree if tree else replay_chain
    o = torch.tensor(eye, dtype=v.dtype, device=v.device).expand(v.shape)
    with torch.enable_grad():  # also inside an autograd.Function's forward
        color = replay(table_geom(tables, nl, leaves), o, v, res["bi"],
                       res["mid"], res["lit"], depth=depth, atten=atten)
        grads = ((None,) * len(leaves) if not color.requires_grad
                 else torch.autograd.grad(color, leaves, grad_outputs=g,
                                          allow_unused=True))
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip(leaves, grads))


def _l2_terms(img, target, mask, g_scale: float):
    """(masked squared-error sum, cotangent ``g_scale*mask*(img-target)``)."""
    d_raw = img - target
    d = d_raw * mask[:, None]
    return torch.sum(d * d_raw), g_scale * d


def adjoint_packed_ref(tables, v, eye, img, target, mask, pk, *,
                       pack: Tuple[float, float], g_scale: float, nl: int,
                       depth: int, atten: float, want_trans: bool):
    """Plain PyTorch version of the phase-2 kernel: the masked squared-error
    sum ``sum(mask*(img-target)^2)`` and the gradient tables (dsph [ns,8],
    dmat [m,16], dlight [max(nl,1),8]) of the replayed chain under the
    cotangent ``g_scale*mask*(img-target)``, by autograd through
    ``replay_chain`` on the unpacked ``pk``."""
    loss, g = _l2_terms(img, target, mask, g_scale)
    return (loss,) + replay_grads(tables, v, eye,
                                  unpack_residuals(pk, nl, pack), g,
                                  tree=False, nl=nl, depth=depth, atten=atten)


def fused_adjoint_ref(tables, v, eye, target, mask, *, tree: bool,
                      g_scale: float, **kw):
    """Plain PyTorch version of K6: the plain forward with its unpacked
    residuals (``render_residuals_ref``, no pack), the masked squared-error
    sum and the gradient tables under the cotangent
    ``g_scale*mask*(img-target)`` by autograd through the chain or tree
    replay.  Returns (loss, dsph, dmat, dlight) as ``adjoint_packed_ref``.
    The keyword arguments are ``render_kwargs``'s."""
    img, res = render_residuals_ref(tables, v, eye, tree=tree, **kw)
    loss, g = _l2_terms(img, target, mask, g_scale)
    return (loss,) + replay_grads(tables, v, eye, res, g, tree=tree,
                                  nl=kw["nl"], depth=kw["depth"],
                                  atten=kw["atten"])


def recompute_adjoint_ref(tables, v, eye, g, *, tree: bool, **kw):
    """Plain PyTorch version of K7: the plain forward's unpacked residuals
    (``render_residuals_ref``), then the gradient tables (dsph, dmat,
    dlight) under the [P,3] cotangent ``g`` by autograd through the chain or
    tree replay."""
    _, res = render_residuals_ref(tables, v, eye, tree=tree, **kw)
    return replay_grads(tables, v, eye, res, g, tree=tree, nl=kw["nl"],
                        depth=kw["depth"], atten=kw["atten"])


def fit_grads_ref(tables, v, eye, g, res: Dict[str, torch.Tensor], *,
                  nl: int, depth: int, atten: float, want_trans: bool):
    """Plain PyTorch version of K8: the gradient tables (dsph, dmat,
    dlight) of ``sum(g * replay)`` by autograd through the chain replay of
    the residual planes ``res`` (bi, mid [depth+1, P], lit [nl, depth+1,
    P]) along the primary directions ``v`` [P,3] under the cotangent ``g``
    [P,3].  ``want_trans`` is K8's launch flag; the replay reads the
    material rows for it."""
    return replay_grads(tables, v, eye, res, g, tree=False, nl=nl,
                        depth=depth, atten=atten)


# ----------------------------------------------------------------- wrappers

def _check_planes(v, *planes) -> None:
    """Raises unless each (name, tensor, shape) is contiguous f32 of that
    shape on ``v``'s device."""
    for name, t, shape in planes:
        if t.device != v.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {list(shape)} "
                             f"on {v.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check_caps(entry: str, depth: int, nl: int, tree: bool) -> None:
    cap = TREE_ADJOINT_MAX_DEPTH if tree else ADJOINT_MAX_DEPTH
    if depth > cap or nl > ADJOINT_MAX_LIGHTS:
        why = (" (the tree forward's own limit, TREE_MAX_DEPTH)" if tree
               else "")
        raise ValueError(f"{entry} holds {'tree' if tree else 'chain'} depth "
                         f"<= {cap}{why} and <= {ADJOINT_MAX_LIGHTS} lights, "
                         f"got depth {depth}, {nl} lights (ROADMAP.md, port "
                         f"decisions)")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _live_list(lib, stream, num_pixels: int, device, loss_rows, *, g=None,
               img=None, target=None, mask=None, g_scale: float = 0.0):
    """Builds on the device the list of the pixels whose cotangent is
    nonzero (csrc/adjoint_packed.cu::rtfs_live_list): their ids in
    increasing order, and their count.  The cotangent is ``g`` [P,3], or
    ``g_scale * mask * (img - target)``, whose squared-error sums per block
    of 256 pixels then go to the pointer ``loss_rows``.  Returns (scratch
    tensor, ids pointer, count pointer); nothing is read back: the adjoint
    and the reduction read the count themselves."""
    from . import cuda_build
    nb = max(-(-num_pixels // ADJOINT_THREADS), 1)
    words = nb * ADJOINT_THREADS // 32
    # ballots | counts | offsets | ids | count, int32
    buf = torch.empty(words + 2 * nb + max(num_pixels, 1) + 1,
                      dtype=torch.int32, device=device)
    base = buf.data_ptr()
    ids = base + 4 * (words + 2 * nb)
    count = ids + 4 * max(num_pixels, 1)
    rc = lib.rtfs_live_list(_ptr(img), _ptr(target), _ptr(mask), _ptr(g),
                            g_scale, num_pixels, base, base + 4 * words,
                            base + 4 * (words + nb), loss_rows, ids, count,
                            stream)
    cuda_build.check(lib, rc, "live_list")
    return buf, ids, count


def _records_scratch(num_pixels: int, nodes: int, device):
    """The scratch of K6's chain (csrc/adjoint_fused.cu::rtfs_fused_adjoint):
    the image [P,3] f32 and the counts [P] int32 of its live pixels, the
    8-byte records [nodes, P], and the live list's buffers as
    ``_live_list``'s (ballots, counts, offsets, ids, count).  Returns (the
    tensors, their pointers: img, rec, rec_n, ballots, counts, offsets, ids,
    count)."""
    nb = max(-(-num_pixels // ADJOINT_THREADS), 1)
    words = nb * ADJOINT_THREADS // 32
    rec = torch.empty((nodes, num_pixels), dtype=torch.int64, device=device)
    # img | rec_n | ballots | counts | offsets | ids | count, 4-byte words
    buf = torch.empty(4 * num_pixels + words + 2 * nb + max(num_pixels, 1)
                      + 1, dtype=torch.int32, device=device)
    base = buf.data_ptr()
    ballots = base + 16 * num_pixels
    ids = ballots + 4 * (words + 2 * nb)
    return (rec, buf), (base, rec.data_ptr(), base + 12 * num_pixels,
                        ballots, ballots + 4 * words,
                        ballots + 4 * (words + nb), ids,
                        ids + 4 * max(num_pixels, 1))


def _launch_adjoint(entry: str, tables, v, nl: int, pre, post, *,
                    live: Optional[Dict[str, Any]] = None, records: int = 0,
                    bf16: bool = False):
    """Launches the C entry ``rtfs_<entry>`` on (flat tables, ns, nt, m, nl,
    *pre, [ids, count,] *post, [K6's scratch,] partial, num_blocks,
    stream), then ``rtfs_adjoint_reduce`` over its per-block rows, and
    counts the launch (its bf16 variant's with ``bf16``).  With ``live``
    (``_live_list``'s keywords) the live list is built first and the kernel
    runs on it; with ``records`` (K6's chain: the levels a pixel) the entry
    takes ``_records_scratch``'s pointers and its loss rows, and builds the
    list itself.  Returns the column sums as (loss, dsph [ns,8], dmat
    [m,16], dlight [max(nl,1),8]), views of the reduction's one output."""
    if v.device.type != "cuda":
        raise ValueError(f"{entry}: kernels run on CUDA tensors, got "
                         f"{v.device}")
    from . import cuda_build
    lib = cuda_build.load()
    flat = _flat_tables(tables, nl)
    ns, nt, m = (tables[k].shape[0] for k in ("sph", "tri", "mat"))
    ncols = 1 + 4 * ns + 9 * m + 3 * nl
    smem = 4 * (flat.numel() + ADJOINT_THREADS // 32 * ncols
                + ADJOINT_STAGE_FLOATS)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"{entry}: tables and partial sums take {smem} B, "
                         f"over the {SMEM_LIMIT_BYTES} B of shared memory a "
                         f"block may use")
    P = v.shape[0]
    blocks = adjoint_blocks(P)
    nb = max(-(-P // ADJOINT_THREADS), 1)
    n_out = 1 + SPHD_COLS * ns + MATD_COLS * m + LIGHTD_COLS * max(nl, 1)
    # out | partial [blocks, ncols] | loss rows [nb], f32
    buf = torch.empty(n_out + blocks * ncols + nb, dtype=torch.float32,
                      device=v.device)
    out = buf[:n_out]
    partial = buf.data_ptr() + 4 * n_out
    loss_rows = partial + 4 * blocks * ncols
    with torch.cuda.device(v.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(v.device).cuda_stream)
        lst, count, extra = (), None, ()
        if live is not None:
            scratch, ids, count = _live_list(lib, stream, P, v.device,
                                             loss_rows, **live)
            lst = (ids, count)
        elif records:
            scratch, ptrs = _records_scratch(P, records, v.device)
            extra = (*ptrs[:6], loss_rows, *ptrs[6:])
            count = ptrs[7]
        rc = getattr(lib, f"rtfs_{entry}")(flat.data_ptr(), ns, nt, m, nl,
                                            *pre, *lst, *post, *extra,
                                            partial, blocks, stream)
        cuda_build.check(lib, rc, entry)
        with_loss = bool(records) or (live is not None and "img" in live)
        rc = lib.rtfs_adjoint_reduce(partial, blocks, ns, m, nl, count,
                                     loss_rows if with_loss else None,
                                     nb if with_loss else 0, out.data_ptr(),
                                     stream)
        cuda_build.check(lib, rc, "adjoint_reduce")
    LAUNCHES[launch_key(entry, bf16)] += 1
    o_m = 1 + SPHD_COLS * ns
    o_l = o_m + MATD_COLS * m
    return (out[0], out[1:o_m].view(ns, SPHD_COLS),
            out[o_m:o_l].view(m, MATD_COLS),
            out[o_l:].view(max(nl, 1), LIGHTD_COLS))


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
    _check_planes(v, ("img", img, (P, 3)), ("target", target, (P, 3)),
                  ("mask", mask, (P,)), ("pk", pk, (depth + 1, P)))
    kw = dict(pack=pack, g_scale=g_scale, nl=nl, depth=depth, atten=atten,
              want_trans=want_trans)
    if v.device.type == "cpu":
        return adjoint_packed_ref(tables, v, eye, img, target, mask, pk, **kw)
    _check_caps("adjoint_packed", depth, nl, False)
    return _launch_adjoint(
        "adjoint_packed", tables, v, nl,
        (v.data_ptr(), img.data_ptr(), target.data_ptr(), mask.data_ptr(),
         pk.data_ptr()),
        (P, *(float(e) for e in eye), depth, atten, g_scale, float(pack[0]),
         float(pack[1]), int(want_trans)),
        live=dict(img=img, target=target, mask=mask, g_scale=g_scale))


def _forward_args(eye, kw, tree: bool):
    """The forward's launch scalars of the K6/K7 C entries: eye, depth,
    small, atten, white_id, black_id, want_trans, tree, bf16."""
    return (*(float(e) for e in eye), kw["depth"], kw["small"], kw["atten"],
            int(kw["checker_mats"][0]), int(kw["checker_mats"][1]),
            int(kw["want_trans"]), int(tree), int(kw["bf16"]))


def fused_adjoint(tables, v, eye, target, mask, *, tree: bool,
                  g_scale: float, **kw):
    """K6, forward + L2 loss + adjoint behind one entry: (loss_sum, dsph,
    dmat, dlight) from the primary-ray directions ``v`` [P,3], the
    ``target`` [P,3] and the pixel ``mask`` [P], with cotangent
    ``g_scale*mask*(img-target)``.  ``tree`` runs the full bounce tree
    (depth <= ``TREE_ADJOINT_MAX_DEPTH``) in place of the chain.  CUDA
    tensors launch csrc/adjoint_fused.cu::rtfs_fused_adjoint (the chain:
    the records forward with the live list's marks, the rest of the live
    list, the adjoint over it, ``fused_records_ref`` the records' plain
    model; the tree: one dispatch), then the reduction; CPU tensors run
    ``fused_adjoint_ref``.  The other keyword arguments are
    ``render_kwargs``'s (``bf16`` runs the bf16 forward)."""
    _check(tables, v, kw["depth"], kw["nl"])
    P = v.shape[0]
    _check_planes(v, ("target", target, (P, 3)), ("mask", mask, (P,)))
    _check_caps("fused_adjoint", kw["depth"], kw["nl"], tree)
    if v.device.type == "cpu":
        return fused_adjoint_ref(tables, v, eye, target, mask, tree=tree,
                                 g_scale=g_scale, **kw)
    post = (P, *_forward_args(eye, kw, tree), g_scale)
    if tree:  # one dispatch: no scratch
        post += (None,) * 9
    return _launch_adjoint(
        "fused_adjoint", tables, v, kw["nl"],
        (v.data_ptr(), target.data_ptr(), mask.data_ptr()), post,
        records=0 if tree else kw["depth"] + 1, bf16=kw["bf16"])


def fused_records_ref(tables, v, eye, **kw):
    """Plain model of the record scratch of K6's chain (csrc/tile_ops.cuh::
    RecordWriter, records_forward) from the plain residual forward: (rec_n
    [P] int32, rec [depth+1, P, 4] int64 of (bi, mid, lit bits, level)).
    Pixel p writes rec[k, p] for its levels k < rec_n[p], each of which
    hits (bi >= 0); the rest of its slot is never written and holds -1
    here.  Every pixel writes its records, whatever its cotangent; the
    kernel writes rec_n[p] for a live pixel only, and the adjoint reads
    only the live ones'.  The keyword arguments are ``render_kwargs``'s."""
    _, res = render_residuals_ref(tables, v, eye, tree=False, **kw)
    bi, mid, lit = res["bi"], res["mid"], res["lit"]
    K, P = bi.shape
    bits = torch.zeros((K, P), dtype=torch.int64, device=v.device)
    for li in range(lit.shape[0]):
        bits |= lit[li].long() << li
    hit = bi >= 0
    rec = torch.full((K, P, 4), -1, dtype=torch.int64, device=v.device)
    k_idx, p_idx = torch.nonzero(hit, as_tuple=True)
    rec[k_idx, p_idx] = torch.stack([bi[k_idx, p_idx].long(),
                                     mid[k_idx, p_idx].long(),
                                     bits[k_idx, p_idx], k_idx], -1)
    return hit.sum(0).to(torch.int32), rec


def recompute_adjoint(tables, v, eye, g, *, tree: bool, **kw):
    """K7, forward re-trace + adjoint under the cotangent ``g`` [P,3]: the
    gradient tables (dsph, dmat, dlight) of ``sum(g * img)`` along the
    primary-ray directions ``v`` [P,3].  Pixels whose ``g`` is 0 add
    nothing and are not traced.  ``tree`` and the other keyword arguments
    as ``fused_adjoint``'s.  CUDA tensors launch csrc/adjoint_fused.cu; CPU
    tensors run ``recompute_adjoint_ref``."""
    _check(tables, v, kw["depth"], kw["nl"])
    P = v.shape[0]
    _check_planes(v, ("g", g, (P, 3)))
    _check_caps("recompute_adjoint", kw["depth"], kw["nl"], tree)
    if v.device.type == "cpu":
        return recompute_adjoint_ref(tables, v, eye, g, tree=tree, **kw)
    return _launch_adjoint(
        "recompute_adjoint", tables, v, kw["nl"], (v.data_ptr(), g.data_ptr()),
        (P, *_forward_args(eye, kw, tree)), live=dict(g=g),
        bf16=kw["bf16"])[1:]


def fit_grads(tables, v, eye, g, res: Dict[str, torch.Tensor], *, nl: int,
              depth: int, atten: float, want_trans: bool):
    """K8, the split-mode backward: the gradient tables (dsph [ns,8], dmat
    [m,16], dlight [max(nl,1),8]) of ``sum(g * img)`` by the chain adjoint,
    from the primary-ray directions ``v`` [P,3] from ``eye``, the cotangent
    ``g`` [P,3] and the residual planes ``res`` of ``render_residuals``
    (bi, mid [depth+1, P], lit [nl, depth+1, P]).  Pixels whose ``g`` is 0
    add nothing and read no residual.  Depth at most
    ``ADJOINT_MAX_DEPTH``, at most ``ADJOINT_MAX_LIGHTS`` lights, on every
    device.  CUDA tensors launch csrc/fit_grads.cu; CPU tensors run
    ``fit_grads_ref``."""
    _check(tables, v, depth, nl)
    P = v.shape[0]
    _check_planes(v, ("g", g, (P, 3)), ("bi", res["bi"], (depth + 1, P)),
                  ("mid", res["mid"], (depth + 1, P)),
                  ("lit", res["lit"], (nl, depth + 1, P)))
    _check_caps("fit_grads", depth, nl, False)
    kw = dict(nl=nl, depth=depth, atten=atten, want_trans=want_trans)
    if v.device.type == "cpu":
        return fit_grads_ref(tables, v, eye, g, res, **kw)
    return _launch_adjoint(
        "fit_grads", tables, v, nl,
        (v.data_ptr(), g.data_ptr(), res["bi"].data_ptr(),
         res["mid"].data_ptr(), res["lit"].data_ptr()),
        (P, *(float(e) for e in eye), depth, atten, int(want_trans)),
        live=dict(g=g))[1:]


# ------------------------------------------------------------- host side

def prepare_fit_inputs(camera: Camera, config: RenderConfig, target,
                       mask=None, pts=None, device=None) -> Dict[str, Any]:
    """The step-invariant per-pixel inputs of the fit kernels, on
    ``device`` (default: the GPU): primary-ray directions ``v`` [P,3], the
    ``target`` RGB [P,3] and the pixel ``mask`` [P], flat over P = H*W
    with no padding.  ``mask``: an [H,W] weight plane (default all 1; a
    row band passes 0 on its padding rows), applied once to the loss and
    the cotangent.  ``pts``: screen points [H*W,3] in place of the
    camera's own (a row band's).  Build once and pass as ``prep=``; it
    remembers the target, mask and points it was built from
    (``_check_prep``)."""
    device = resolve_device(device)
    w, h = config.width, config.height
    camera = camera.to(device)
    pts_v = (screen_points(camera, w, h) if pts is None
             else torch.as_tensor(pts, dtype=torch.float32, device=device))
    if tuple(pts_v.shape) != (h * w, 3):
        raise ValueError(f"pts must be [{h * w}, 3] for a {h}x{w} config, "
                         f"got {tuple(pts_v.shape)}")
    _, v = primary_rays(camera, pts_v)
    tgt = torch.as_tensor(target, dtype=torch.float32, device=device)
    m = (torch.ones(h * w, dtype=torch.float32, device=device)
         if mask is None else torch.as_tensor(
             mask, dtype=torch.float32, device=device).reshape(h * w))
    return dict(v=v.contiguous(), target=tgt.reshape(-1, 3).contiguous(),
                mask=m.contiguous(), eye=camera.eye.tolist(),
                src=dict(target=target, mask=mask, pts=pts))


def _check_prep(prep, target, mask=None, pts=None) -> None:
    """Raises if ``prep`` was built from a different target object than this
    call passes, or from another mask or points object than a given one
    (identity checks: rebuild the prep when they change)."""
    for name, got in (("target", target), ("mask", mask), ("pts", pts)):
        if (got is not None or name == "target") \
                and prep["src"][name] is not got:
            raise ValueError(f"prep= was built from a different `{name}` "
                             f"object than this call passes; "
                             f"prepare_fit_inputs() again for the new {name}")


def scene_tables(scene: FlatScene, config: RenderConfig, device=None):
    """``(scene_c, tables, kw)``: the compacted and detached scene on
    ``device`` (default: the GPU), its tables and the forwards' render
    keywords."""
    scene = compact_scene(scene.to(resolve_device(device)))
    scene = scene.replace(**{k: t.detach()
                             for k, t in scene.tensors().items()})
    return scene, pack_scene(scene), render_kwargs(scene, config)


def kernel_inputs(scene: FlatScene, config: RenderConfig, num_pixels,
                  device=None):
    """The fit kernels' per-step inputs from a scene:
    ``(scene_c, tables, kw, akw)``, the compacted and detached scene on
    ``device`` (default: the GPU), its tables, the forwards' render
    keywords (``render_packed(tables, v, eye, pack=akw["pack"], **kw)``)
    and the adjoint's keywords (``adjoint_packed(..., **akw)``), whose
    cotangent scale is that of ``mean((img - target)^2)`` over
    ``num_pixels`` RGB pixels, the caller's: a row band's call passes the
    whole image's.  Raises where the scene overflows the pack
    (``pack_widths``), which only K3/K4 take: K6 and K7 take
    ``scene_tables``'s keywords."""
    scene, tables, kw = scene_tables(scene, config, device)
    pack = pack_widths(tables["tri"].shape[0], scene.num_spheres,
                       scene.num_materials, scene.num_lights)
    akw = dict(pack=pack, g_scale=2.0 / (num_pixels * 3), nl=kw["nl"],
               depth=kw["depth"], atten=kw["atten"],
               want_trans=kw["want_trans"])
    return scene, tables, kw, akw


def _grads_c(scene_c: FlatScene, dsph, dmat, dlight
             ) -> Dict[str, torch.Tensor]:
    """The compacted scene's gradient tables by field: sph_center [ns,3],
    sph_radius [ns], mat_ambient/diffuse/specular [m,3], light_pos [nl,3]."""
    ns, m, nl = scene_c.num_spheres, scene_c.num_materials, scene_c.num_lights
    return dict(sph_center=dsph[:ns, 0:3], sph_radius=dsph[:ns, 3],
                mat_ambient=dmat[:m, 0:3], mat_diffuse=dmat[:m, 3:6],
                mat_specular=dmat[:m, 6:9], light_pos=dlight[:nl, 0:3])


def _prep_for(camera, config, target, prep, device, mask=None, pts=None):
    """``prep``, checked against ``target``, ``mask`` and ``pts``, or a new
    one from them."""
    if prep is None:
        return prepare_fit_inputs(camera, config, target, mask=mask, pts=pts,
                                  device=device)
    _check_prep(prep, target, mask, pts)
    return prep


def _denom(config: RenderConfig, denom: Optional[float]) -> float:
    """The loss normaliser: ``denom``, or H*W*3 of the call's config."""
    return float(config.height * config.width * 3) if denom is None \
        else float(denom)


def twophase_loss_grads_kernel(scene: FlatScene, camera: Camera,
                               config: RenderConfig, target, mask=None,
                               denom: Optional[float] = None, pts=None,
                               prep: Optional[Dict[str, Any]] = None,
                               device=None):
    """The two-phase fwd+bwd of a chain-exact scene: the packed forward,
    then the adjoint with its cotangent prologue.  Returns ``(sq_err_sum,
    grads_c)``: the masked squared-error sum ``sum(mask*(img-target)^2)``
    and the compacted scene's gradient tables (``_grads_c``) of
    ``sq_err_sum / denom``, as adjoint_fused.py::twophase_loss_grads_pallas.
    ``mask`` [H,W] weighs the pixels (a row band's padding rows 0);
    ``denom`` (default H*W*3 of ``config``) is the loss normaliser, so the
    cotangent is ``(2/denom)*mask*(img-target)``: a row band passes the
    whole image's, and the bands' tables sum to the image's.  ``pts``:
    the band's screen points [H*W,3] in place of the camera's."""
    if not scene.chain_exact:
        raise ValueError("the packed two-phase backward replays the bounce "
                         "chain; fractional-transparency scenes take the "
                         "fused tree kernel (fused_loss_grads_kernel)")
    device = resolve_device(device)
    prep = _prep_for(camera, config, target, prep, device, mask, pts)
    v, eye = prep["v"], prep["eye"]
    scene, tables, kw, akw = kernel_inputs(scene, config,
                                           _denom(config, denom) / 3,
                                           device=device)
    img, pk = render_packed(tables, v, eye, pack=akw["pack"], **kw)
    loss, dsph, dmat, dlight = adjoint_packed(
        tables, v, eye, img, prep["target"], prep["mask"], pk, **akw)
    return loss, _grads_c(scene, dsph, dmat, dlight)


def fused_loss_grads_kernel(scene: FlatScene, camera: Camera,
                            config: RenderConfig, target, mask=None,
                            denom: Optional[float] = None, pts=None,
                            prep: Optional[Dict[str, Any]] = None,
                            device=None):
    """The fused fwd+loss+bwd (K6): returns ``(sq_err_sum, grads_c)`` as
    ``twophase_loss_grads_kernel``, with the same ``mask``, ``denom`` and
    ``pts``.  Fractional-transparency scenes take the tree form (forward
    and adjoint over the preorder nodes of the full bounce tree), as
    adjoint_fused.py::fused_loss_grads_pallas does."""
    device = resolve_device(device)
    prep = _prep_for(camera, config, target, prep, device, mask, pts)
    v, eye = prep["v"], prep["eye"]
    scene, tables, kw = scene_tables(scene, config, device)
    loss, dsph, dmat, dlight = fused_adjoint(
        tables, v, eye, prep["target"], prep["mask"],
        tree=not scene.chain_exact, g_scale=2.0 / _denom(config, denom),
        **kw)
    return loss, _grads_c(scene, dsph, dmat, dlight)


def recompute_grads_kernel(scene: FlatScene, camera: Camera,
                           config: RenderConfig, g, *, pts=None,
                           device=None) -> Dict[str, torch.Tensor]:
    """The backward under an external cotangent ``g`` [H,W,3] (K7): the
    forward re-traced into each thread and the replay adjoint run at once.
    Returns the compacted scene's gradient tables (``_grads_c``).
    ``pts``: screen points [H*W,3] in place of the camera's own (a jittered
    sample's).  Fractional-transparency scenes take the tree form
    (adjoint_fused.py::recompute_grads_pallas)."""
    device = resolve_device(device)
    camera = camera.to(device)
    w, h = config.width, config.height
    if pts is None:
        pts = screen_points(camera, w, h)
    _, v = primary_rays(camera, torch.as_tensor(pts, device=device))
    scene, tables, kw = scene_tables(scene, config, device)
    g = torch.as_tensor(g, dtype=torch.float32, device=device)
    dsph, dmat, dlight = recompute_adjoint(
        tables, v.contiguous(), camera.eye.tolist(),
        g.reshape(-1, 3).contiguous(), tree=not scene.chain_exact, **kw)
    return _grads_c(scene, dsph, dmat, dlight)


def fit_grads_kernel(scene: FlatScene, camera: Camera, config: RenderConfig,
                     residuals: Dict[str, torch.Tensor], g, *, pts=None,
                     device=None) -> Dict[str, torch.Tensor]:
    """The split-mode backward (K8) under the cotangent ``g`` [H,W,3] from
    the residual planes of ``render_forward_with_residuals`` (bi, mid
    [depth+1,H,W], lit [nl,depth+1,H,W], from the same scene): the
    compacted scene's gradient tables (``_grads_c``), as
    adjoint_fused.py::fit_grads_pallas.  ``pts``: the screen points the
    forward used, when not the camera's own.  Chain-exact scenes only, as
    in the JAX package."""
    if not scene.chain_exact:
        raise ValueError(
            "the fused in-kernel adjoint replays the bounce *chain*; "
            "fractional-transparency scenes take the tree replay "
            "(kernels/adjoint.py::l2_loss_kernel)")
    device = resolve_device(device)
    camera = camera.to(device)
    w, h = config.width, config.height
    if pts is None:
        pts = screen_points(camera, w, h)
    _, v = primary_rays(camera, torch.as_tensor(pts, device=device))
    scene, tables, kw = scene_tables(scene, config, device)
    K, P = config.max_depth + 1, w * h

    def flat(t, *shape):
        return torch.as_tensor(t, dtype=torch.float32,
                               device=device).reshape(shape).contiguous()
    res = dict(bi=flat(residuals["bi"], K, P),
               mid=flat(residuals["mid"], K, P),
               lit=flat(residuals["lit"], kw["nl"], K, P))
    dsph, dmat, dlight = fit_grads(
        tables, v.detach().contiguous(), camera.eye.tolist(), flat(g, P, 3),
        res, nl=kw["nl"], depth=kw["depth"], atten=kw["atten"],
        want_trans=kw["want_trans"])
    return _grads_c(scene, dsph, dmat, dlight)


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


def sampled_forward(scene_full: FlatScene, camera: Camera,
                    config: RenderConfig, target, *, jitter=None,
                    generator=None, device=None) -> Dict[str, Any]:
    """The forward of a supersampled or adaptive fit
    (adjoint_fused.py:1689-1765): S single-sample renders of the jittered
    screen points on the chain or tree kernel, averaged, or run through the
    adaptive emulation, which records each sample's accept plane and the
    divisor (discrete outcomes, pinned like hit ids); then the L2 loss and
    each rendered sample's cotangent, ``g/S`` or ``g * accept_k /
    divisor``.  Samples after every pixel has converged add exactly zero
    and are not rendered.  Returns dict(loss, rays, cots (each rendered
    sample's directions and cotangent, [P,3]), accepts (adaptive only),
    scene_c, tables, kw, eye, tree): what the per-sample backward
    (``recompute_adjoint``) takes."""
    device = resolve_device(device)
    camera = camera.to(device)
    h, w, S = config.height, config.width, config.samples
    pts0 = screen_points(camera, w, h)
    P = pts0.shape[0]
    scene_c, tables, kw = scene_tables(scene_full, config, device)
    tree = not scene_c.chain_exact
    render = render_tree if tree else render_chain
    eye = camera.eye.tolist()
    jitter_k = jitter_source(config, P, pts0.dtype, device, jitter=jitter,
                             generator=generator)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=device).reshape(h, w, 3)

    rays, accepts = [], []   # each rendered sample's directions and accepts
    accum = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    if config.adaptive:
        divisor = torch.full((h, w), float(S), dtype=torch.float32,
                             device=device)
        done = torch.zeros((h, w), dtype=torch.bool, device=device)
    for k in range(S):
        _, v = primary_rays(camera, pts0 + jitter_k(k))
        v = v.contiguous()
        c = render(tables, v, eye, **kw).reshape(h, w, 3)
        rays.append(v)
        if not config.adaptive:
            accum = accum + c
            continue
        accum, divisor, done, accept = adaptive_step(
            k, c, accum, divisor, done, config.small_number)
        accepts.append(accept)
        if bool(done.all()):
            break
    img = accum / (divisor[..., None] if config.adaptive else S)
    diff = img - target
    if config.adaptive:
        g = (2.0 / diff.numel()) * diff
        cots = [g * (a.float() / divisor)[..., None] for a in accepts]
    else:
        cots = [(2.0 / (diff.numel() * S)) * diff] * len(rays)
    return dict(loss=torch.mean(diff * diff), rays=rays,
                cots=[c.reshape(P, 3).contiguous() for c in cots],
                accepts=accepts, scene_c=scene_c, tables=tables, kw=kw,
                eye=eye, tree=tree)


def _sampled_value_and_grad(params, scene_full: FlatScene, camera: Camera,
                            config: RenderConfig, target, *, jitter,
                            generator, device):
    """The supersampled and adaptive branches of ``fit_value_and_grad``:
    ``sampled_forward``, then one K7 per rendered sample, the tables summed
    in sample order (adjoint_fused.py:1739-1788)."""
    fw = sampled_forward(scene_full, camera, config, target, jitter=jitter,
                         generator=generator, device=device)
    sums = None
    for v, g in zip(fw["rays"], fw["cots"]):
        tabs = recompute_adjoint(fw["tables"], v, fw["eye"], g,
                                 tree=fw["tree"], **fw["kw"])
        sums = tabs if sums is None else tuple(a + b
                                               for a, b in zip(sums, tabs))
    return fw["loss"], grads_to_fitparams(params, scene_full,
                                          _grads_c(fw["scene_c"], *sums))


def fit_mode(mode: Optional[str] = None, single_kernel: bool = True) -> str:
    """The fit kernels' shape for single-sample chain scenes: ``mode``, or
    with ``None`` the environment's ``RTFS_FIT_MODE`` (default
    "twophase"); ``single_kernel=False`` means "split"
    (adjoint_fused.py:1651-1653).  Raises on any other value."""
    if mode is None:
        mode = ("split" if not single_kernel
                else os.environ.get("RTFS_FIT_MODE", "twophase"))
    if mode not in ("twophase", "fused", "split"):
        raise ValueError(f"unknown fit mode {mode!r}")
    return mode


def fit_value_and_grad(params, scene: FlatScene, camera: Camera,
                       config: RenderConfig, target, *,
                       single_kernel: bool = True,
                       prep: Optional[Dict[str, Any]] = None,
                       mode: Optional[str] = None,
                       jitter: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       device=None):
    """(loss, d loss / d params) of the L2 photometric loss
    ``mean((img - target)^2)`` through the fit kernels, on ``device``
    (default: the GPU; ``"cpu"`` runs their plain versions).  ``params`` is
    a ``diff.fit.FitParams``; the gradients come back as a dict keyed by
    its field names (adjoint_fused.py::fit_value_and_grad).

    Single-sample configs: ``mode="twophase"`` runs the packed forward (K3)
    and the adjoint (K4); ``mode="fused"`` K6 (the records forward, the
    live list and the adjoint behind one entry);
    ``mode="split"`` the residual forward (the chain kernel's unpacked
    planes), the L2 cotangent in PyTorch and K8, with no pack and so no
    2^24 limit on primitives, materials and lights.  ``mode=None`` (the
    default) reads the environment's ``RTFS_FIT_MODE`` (default
    "twophase"), and ``single_kernel=False`` means "split", as in the JAX
    package (``fit_mode``).  Fractional-transparency scenes always take
    K6's tree form.

    Supersampled configs (``samples > 1`` or ``force_jitter``), adaptive or
    not: per sample one forward render (the chain or tree kernel) and one
    K7 (``_sampled_value_and_grad``), whatever the mode.  Sample k's screen
    points move by ``jitter[k]`` when the [S, H*W, 3] ``jitter`` is given
    (e.g. the JAX package's draws), else by draws from ``generator``
    (default: seeded with ``config.seed``), as in ``render_image_kernel``.
    ``prep=`` (``prepare_fit_inputs``) serves the twophase and fused paths
    only: with a jittered config, or in split mode on a chain scene, it
    raises ``ValueError``, as in the JAX package."""
    mode = fit_mode(mode, single_kernel)
    scene_full = params.into_scene(scene)
    use_jitter = config.samples > 1 or config.force_jitter
    if prep is not None and (use_jitter
                             or (mode == "split" and scene_full.chain_exact)):
        raise ValueError("prep= is only supported on the twophase/fused "
                         "paths (no supersampling)")
    if use_jitter:
        return _sampled_value_and_grad(params, scene_full, camera, config,
                                       target, jitter=jitter,
                                       generator=generator, device=device)
    if not scene_full.chain_exact:
        mode = "fused"  # tree scenes: the bounce tree's fwd+adjoint, K6
    denom = _denom(config, None)
    if mode == "split":
        # adjoint_fused.py:1678-1687: the cotangent is XLA's there, outside
        # any kernel; here PyTorch's, in the same order as K4's prologue
        img, res = render_forward_with_residuals(scene_full, camera, config,
                                                 device=device)
        diff = img - torch.as_tensor(target, dtype=torch.float32,
                                     device=img.device).reshape(img.shape)
        grads_c = fit_grads_kernel(scene_full, camera, config, res,
                                   (2.0 / denom) * diff, device=device)
        return (torch.mean(diff * diff),
                grads_to_fitparams(params, scene_full, grads_c))
    impl = (twophase_loss_grads_kernel if mode == "twophase"
            else fused_loss_grads_kernel)
    sq_sum, grads_c = impl(scene_full, camera, config, target, denom=denom,
                           prep=prep, device=device)
    return sq_sum / denom, grads_to_fitparams(params, scene_full, grads_c)
