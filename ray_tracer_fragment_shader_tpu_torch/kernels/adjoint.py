"""Fixed-topology replay of the bounce chain and tree, in plain PyTorch,
and the differentiable render built on it — the counterpart of the JAX
package's ``kernels/adjoint.py`` (``_node_math``, ``replay_render``,
``replay_render_tree``, ``render_image_diff``, ``l2_loss_pallas``).

The forward kernel's per-level residuals — hit primitive id, resolved
material id, per-light lit flag — pin the discrete topology (closest-hit
winners, shadow occlusion, checker parity, branch selection).  Given them,
the radiance is a small closed-form function of the scene parameters, which
``replay_chain`` recomputes with no intersection sweeps.  Differentiated by
``torch.autograd`` it gives the fixed-hit-topology gradient: the plain
version of the hand-written adjoint kernels (csrc/adjoint_packed.cu,
csrc/adjoint_fused.cu), with which it shares no code.

Rows are gathered by id (``ops/gather.py::gather_rows``), not by [P, N]
one-hot products, so a 2048² frame of a 66-primitive scene fits in memory;
only the gather's backward forms one-hot blocks, a chunk of pixels at a
time.

``render_image_diff`` is a ``torch.autograd.Function`` whose forward is the
residual forward kernel (kernels/render.py::render_forward_with_residuals,
the chain or the tree) and whose backward is autograd through the replay of
its residuals, as the JAX package's backward is the XLA replay VJP (no
Pallas kernel): gradients reach every float field of the scene and the
camera.  ``l2_loss_kernel`` is the L2 loss on it (JAX ``l2_loss_pallas``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..config import CameraConfig, RenderConfig
from ..ops.gather import gather_rows as _gather_rows
from ..ops.rays import Camera, primary_rays, screen_points
from ..scene.flat import FlatScene, tri_derived
from ..utils.jmath import safe_div, safe_sqrt
from .render import (compact_scene, render_forward_with_residuals,
                     resolve_device)


def _take(table: torch.Tensor, idx: torch.Tensor,
          sel: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` where ``sel``, else 0 (rows [P, ...]); ``idx`` is an
    f32 id plane, clamped so unselected lanes read row 0."""
    if table.shape[0] == 0:
        return table.new_zeros((idx.shape[0], *table.shape[1:]))
    rows = _gather_rows(table, idx.clamp(0, table.shape[0] - 1).long())
    mask = sel.reshape(-1, *([1] * (table.dim() - 1)))
    return torch.where(mask, rows, torch.zeros_like(rows))


def scene_geom(scene: FlatScene,
               config: RenderConfig) -> Dict[str, torch.Tensor]:
    """The replay's inputs from a (compacted) scene: triangle planes and the
    parameter tables, with the material's transmit and reflect flags as
    ``_node_math`` in the JAX package derives them."""
    der = tri_derived(scene.tri_v0, scene.tri_v1, scene.tri_v2,
                      config.small_number)
    T = scene.mat_transparency
    t_any = torch.any(T != 0.0, -1)
    t_len = torch.sqrt(torch.sum(T * T, -1))
    return dict(tri_n=der["n"], tri_nv0=torch.sum(der["n"] * scene.tri_v0, -1),
                sph_center=scene.sph_center, sph_radius=scene.sph_radius,
                mat_ambient=scene.mat_ambient, mat_diffuse=scene.mat_diffuse,
                mat_specular=scene.mat_specular, mat_transparency=T,
                mat_refraction=scene.mat_refraction,
                take_t=t_any & (t_len > config.small_number),
                refl_ok=torch.any((1.0 - T) != 0.0, -1),
                light_pos=scene.light_pos, light_color=scene.light_color)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a.b of [P,3] rows, summed x, y, z in that order: the order
    of the adjoint kernel (csrc/adjoint_ops.cuh), where ``torch.sum``'s
    order is the library's to choose.  Along a chain of convex mirrors a
    last-bit difference in a hit point grows from bounce to bounce."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _node_math(geom, o, v, bik, midl, lits, atten: float):
    """Pinned-topology math of one bounce node over [P] rays: the local
    shading colour (throughput not included), the hit point, the secondary
    directions, the material transparency, transmit and reflect flags, the
    hit mask, and the unit direction and normal (adjoint.py::_node_math)."""
    nt = geom["tri_n"].shape[0]
    hitm = bik >= 0.0
    is_tri = bik < nt
    is_s = bik >= nt

    vlen2 = _dot(v, v)
    ray_ok = vlen2 > 0.0
    vlen = safe_sqrt(vlen2, ray_ok)
    u = v * safe_div(torch.ones_like(vlen), vlen, ray_ok)[:, None]

    # hit distance for the known primitive
    n_sel = _take(geom["tri_n"], bik, hitm & is_tri)
    nv0_sel = _take(geom["tri_nv0"], bik, hitm & is_tri)
    ndv = _dot(n_sel, v)
    m_par = safe_div(nv0_sel - _dot(n_sel, o), ndv,
                     torch.abs(ndv) > 0.0)

    c_sel = _take(geom["sph_center"], bik - nt, is_s)
    r_sel = _take(geom["sph_radius"], bik - nt, is_s)
    d = c_sel - o
    ud = _dot(u, d)
    disc = ud * ud - _dot(d, d) + r_sel * r_sel
    dist_sph = ud - safe_sqrt(disc, disc > 0.0)

    # a triangle's point is o + m*v, as the forwards form it
    # (render.py::_PlainOps.hit_attrs), a sphere's o + s*u
    k = torch.where(hitm, torch.where(is_tri, m_par, dist_sph), 0.0)
    p = o + k[:, None] * torch.where(is_tri[:, None], v, u)

    d0 = p - c_sel
    d0sq = _dot(d0, d0)
    n_sph = d0 * safe_div(torch.ones_like(d0sq),
                          safe_sqrt(d0sq, d0sq > 0.0), d0sq > 0.0)[:, None]
    n = torch.where(is_tri[:, None], n_sel, n_sph)
    n = torch.where(hitm[:, None], n, torch.zeros_like(n))

    # material fields by the resolved id (0 on a miss, as the blend gives)
    mi = midl.long()
    amb, dif, spe, trn, rho = (
        _gather_rows(geom[k], mi)
        for k in ("mat_ambient", "mat_diffuse", "mat_specular",
                  "mat_transparency", "mat_refraction"))
    take_t = geom["take_t"][mi]
    refl_ok = geom["refl_ok"][mi]

    # secondary directions
    cosi = _dot(u, n)
    refl = u - (2.0 * cosi)[:, None] * n
    modulus = 1.0 - rho * rho * (1.0 - cosi * cosi)
    mod_ok = modulus > 0.0
    cosr = safe_sqrt(modulus, mod_ok)
    trans = rho[:, None] * u - (cosr + rho * cosi)[:, None] * n
    trans = torch.where(mod_ok[:, None], trans, torch.zeros_like(trans))

    # shading with pinned lit flags
    local = torch.zeros_like(p)
    udotr = torch.abs(_dot(u, refl))
    for li in range(geom["light_pos"].shape[0]):
        sv = geom["light_pos"][li][None, :] - p
        d2 = _dot(sv, sv)
        att = atten / (atten + d2)
        inv_sl = safe_div(torch.ones_like(d2), safe_sqrt(d2, d2 > 0.0),
                          d2 > 0.0)
        ndots = torch.abs(_dot(n, sv)) * inv_sl
        wgt = torch.where((lits[li] > 0.5) & hitm, att, 0.0)
        contrib = amb + ndots[:, None] * dif + udotr[:, None] * spe
        local = local + (wgt[:, None] * contrib
                         * geom["light_color"][li][None, :])
    return dict(local=local, p=p, refl=refl, trans=trans, trn=trn,
                take_t=take_t, refl_ok=refl_ok, hitm=hitm, u=u, n=n)


def replay_chain(geom, o, v, bi, mid, lit, *, depth: int,
                 atten: float) -> torch.Tensor:
    """Differentiable radiance of the bounce chain -> [P,3], from the rays
    (o, v) [P,3] and residual planes ``bi``/``mid`` [depth+1, P] and ``lit``
    [L, depth+1, P] (adjoint.py::replay_render's loop)."""
    color = torch.zeros_like(v)
    thr = torch.ones_like(v)
    for level in range(depth + 1):
        nm = _node_math(geom, o, v, bi[level], mid[level], lit[:, level],
                        atten)
        color = color + thr * nm["local"]
        if level < depth:
            take_t, hitm = nm["take_t"][:, None], nm["hitm"][:, None]
            nxt = torch.where(take_t, nm["trans"], nm["refl"])
            weight = torch.where(take_t, nm["trn"], 1.0 - nm["trn"])
            thr = thr * torch.where(hitm, weight, torch.ones_like(weight))
            o = nm["p"]
            v = torch.where(hitm, nxt, torch.zeros_like(nxt))
    return color


def replay_tree(geom, o, v, bi, mid, lit, *, depth: int,
                atten: float) -> torch.Tensor:
    """Differentiable radiance of the full bounce tree -> [P,3], from the
    rays (o, v) [P,3] and the residual planes ``bi``/``mid`` [K, P] and
    ``lit`` [L, K, P] of the K = 2^(depth+1)-1 preorder nodes, transmitted
    subtree before reflected (adjoint.py::replay_render_tree's recursion).
    A node's colour counts only where it hits; its transmitted child is
    traced where the material transmits (``take_t``), weighted T, its
    reflected child where it is not fully transparent (``refl_ok``),
    weighted 1-T."""
    counter = [0]
    # whether each node hits on some ray, read back once (one host sync)
    live = (bi >= 0.0).any(dim=1).tolist()

    def node(o, v, level):
        idx = counter[0]
        if not live[idx]:
            # the node misses on every ray, so does its subtree: zero
            counter[0] += 2 ** (depth - level + 1) - 1
            return torch.zeros_like(v)
        counter[0] += 1
        nm = _node_math(geom, o, v, bi[idx], mid[idx], lit[:, idx], atten)
        color = nm["local"]
        if level < depth:
            take_t = nm["take_t"][:, None]
            refl_ok = nm["refl_ok"][:, None]
            zero = torch.zeros_like(color)
            ct = node(nm["p"], torch.where(take_t, nm["trans"], zero),
                      level + 1)
            cr = node(nm["p"], torch.where(refl_ok, nm["refl"], zero),
                      level + 1)
            color = color + torch.where(take_t, nm["trn"] * ct, zero)
            color = color + torch.where(refl_ok, (1.0 - nm["trn"]) * cr, zero)
        return torch.where(nm["hitm"][:, None], color, torch.zeros_like(color))

    return node(o, v, 0)


def replay_render(scene: FlatScene, camera: Camera, config: RenderConfig,
                  residuals: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Differentiable radiance replay of the bounce chain -> [H,W,3], on
    the scene's device.  ``residuals``: ``bi`` [D+1,H,W] (hit primitive id
    in triangles-then-spheres order, -1 = miss), ``mid`` [D+1,H,W]
    (resolved material id), ``lit`` [L,D+1,H,W] — from the same compacted
    scene the forward used."""
    scene = compact_scene(scene)
    w, h = config.width, config.height
    depth = config.max_depth
    o, v = primary_rays(camera, screen_points(camera, w, h))
    P = v.shape[0]
    color = replay_chain(
        scene_geom(scene, config), o, v,
        residuals["bi"].reshape(depth + 1, P),
        residuals["mid"].reshape(depth + 1, P),
        residuals["lit"].reshape(scene.num_lights, depth + 1, P),
        depth=depth, atten=config.attenuation_factor)
    return color.reshape(h, w, 3)


def replay_render_tree(scene: FlatScene, camera: Camera,
                       config: RenderConfig,
                       residuals: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Differentiable radiance replay of the full bounce tree -> [H,W,3]
    (fractional-transparency scenes), on the scene's device.
    ``residuals``: ``bi``/``mid`` [K,H,W] and ``lit`` [L,K,H,W] over the
    K = 2^(depth+1)-1 preorder nodes, as the tree forward's residual mode
    gives them (kernels/render.py::render_tree_ref), from the same
    compacted scene."""
    scene = compact_scene(scene)
    w, h = config.width, config.height
    depth = config.max_depth
    K = 2 ** (depth + 1) - 1
    o, v = primary_rays(camera, screen_points(camera, w, h))
    P = v.shape[0]
    color = replay_tree(
        scene_geom(scene, config), o, v, residuals["bi"].reshape(K, P),
        residuals["mid"].reshape(K, P),
        residuals["lit"].reshape(scene.num_lights, K, P),
        depth=depth, atten=config.attenuation_factor)
    return color.reshape(h, w, 3)


_CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))
_SCENE_META = ("checker_mats", "chain_exact", "has_transmission")


class _RenderDiff(torch.autograd.Function):
    """The residual forward as an autograd node over the scene's and the
    camera's tensors (``leaves``: the scene's in ``FlatScene.tensors()``
    order, then the camera's six)."""

    @staticmethod
    def forward(ctx, scene, camera, config, device, *leaves):
        img, res = render_forward_with_residuals(scene, camera, config,
                                                 device=device)
        ctx.config = config
        ctx.meta = {k: getattr(scene, k) for k in _SCENE_META}
        ctx.names = tuple(scene.tensors())
        ctx.res_keys = tuple(res)
        ctx.save_for_backward(*leaves, *res.values())
        return img

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        n = len(ctx.names) + len(_CAMERA_FIELDS)
        res = dict(zip(ctx.res_keys, saved[n:]))
        wants = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(saved[:n], wants)]
            scene = FlatScene(**dict(zip(ctx.names, leaves)), **ctx.meta)
            camera = Camera(**dict(zip(_CAMERA_FIELDS,
                                       leaves[len(ctx.names):])))
            replay = replay_render if scene.chain_exact else replay_render_tree
            img = replay(scene, camera, ctx.config, res)
            diff = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(img, diff, grad_outputs=g,
                                             allow_unused=True)
                         if diff else ())
        out = []
        for t in leaves:
            if not t.requires_grad:
                out.append(None)
                continue
            d = next(grads)
            out.append(torch.zeros_like(t) if d is None else d)
        return (None, None, None, None, *out)


def render_image_diff(scene: FlatScene, camera, config: RenderConfig, *,
                      device=None) -> torch.Tensor:
    """Differentiable render -> [H,W,3], on ``device`` (the GPU by default;
    ``"cpu"`` runs the plain versions): the forward is the residual kernel
    (the chain or, for fractional transparency, the tree), the backward
    autograd through the fixed-topology replay of its residuals
    (adjoint.py::render_image_diff, a ``jax.custom_vjp`` there).  Every
    float tensor of ``scene`` and of ``camera`` that requires grad receives
    one (zero where the image does not depend on it: the prune groups, the
    board's placement); integer and bool fields receive none.  The inputs
    are moved with ``.to(device)``, so leaves on the CPU receive their
    gradients while the render runs on the card.  The image is the
    kernel's; the replay recomputes it only inside the backward."""
    device = resolve_device(device)
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, config.width, config.height,
                                    device=device)
    scene, camera = scene.to(device), camera.to(device)
    return _RenderDiff.apply(
        scene, camera, config, device, *scene.tensors().values(),
        *(getattr(camera, f) for f in _CAMERA_FIELDS))


def l2_loss_kernel(params, scene: FlatScene, camera, config: RenderConfig,
                   target, *, device=None) -> torch.Tensor:
    """``mean((render_image_diff(params.into_scene(scene)) - target)^2)``:
    the L2 photometric loss on the differentiable render, gradients to the
    ``FitParams`` leaves (and the camera's, where they require grad) by
    ``.backward()`` (adjoint.py::l2_loss_pallas)."""
    img = render_image_diff(params.into_scene(scene), camera, config,
                            device=device)
    target = torch.as_tensor(target, dtype=img.dtype,
                             device=img.device).reshape(img.shape)
    return torch.mean((img - target) ** 2)
