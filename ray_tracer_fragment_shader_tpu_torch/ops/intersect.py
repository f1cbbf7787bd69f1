"""Batched, branchless closest hit over the flattened scene, in PyTorch: the
counterpart of the JAX package's ``ops/intersect.py``.

Every ray is tested against *all* primitives with masked tensor math, then
one argmin picks the nearest hit (the reference's virtual-dispatch
traversal, ``Shape::intersection`` / ``Triangle::intersection``,
Hw4/MySdlApplication.cpp:611-823).  Semantic parity notes, each mirroring a
reference behaviour:

  * sphere hit iff ``disc >= 0 && s >= eps`` with ``s`` the *near* root
    only (``:747-771``): rays starting inside a sphere never hit it;
  * triangle epsilons applied to the raw (unnormalized) ray parameter
    ``m`` (``:651-663``);
  * nearest hit by Euclidean distance from the ray origin with strict
    ``<`` (``:811-815``): ties keep the earliest primitive (triangles
    before spheres), as ``torch.argmin`` returns the first minimum;
  * hierarchical bounding-sphere pruning with the reference's rejection
    test ``disc < 0 || |s| < eps`` (``:749-758``), optional;
  * the checkerboard's material override by square parity with C-style
    truncation (``CheckerBoard::intersection``, ``:1084-1113``);
  * reflected/transmitted directions from the *geometric* normal, never
    flipped toward the ray (``:677-699``).

Where the JAX package selects a hit's attributes by one-hot reductions over
[P, N] (a TPU idiom), the port gathers them directly: ``torch.gather`` on
the per-ray [P, N] planes and ``ops/gather.py::gather_rows`` on the
per-primitive tables.  A one-hot sum adds only zeros, so the values are
the same, and a miss lane selects primitive 0 in both.
"""
from __future__ import annotations

import dataclasses

import torch

from ..scene.flat import FlatScene, tri_derived
from ..utils.jmath import dot3, norm3, safe_div, safe_sqrt
from .gather import gather_rows

#: distance of a miss (a Python float, so it takes the tensors' dtype)
BIG = 3.0e38


@dataclasses.dataclass(frozen=True)
class Hit:
    valid: torch.Tensor         # [P] bool: any primitive hit
    prim_id: torch.Tensor       # [P] i32: the hit primitive in the unified
    #                             [triangles, spheres] order (-1 on a miss);
    #                             passed back as ``exclude_id`` for
    #                             secondary rays
    dist: torch.Tensor          # [P] Euclidean distance origin->hit (BIG)
    point: torch.Tensor         # [P,3] hit point (the origin on a miss)
    normal: torch.Tensor        # [P,3] geometric unit normal (unflipped)
    refl_dir: torch.Tensor      # [P,3] unit reflected direction
    trans_dir: torch.Tensor     # [P,3] transmitted direction (0 on TIR)
    ambient: torch.Tensor       # [P,3] material of the hit (checker-resolved)
    diffuse: torch.Tensor       # [P,3]
    specular: torch.Tensor      # [P,3]
    transparency: torch.Tensor  # [P,3]
    refraction: torch.Tensor    # [P]


def _matdot(a, b_t):
    """[P,3] x [N,3] -> [P,N] inner products as three broadcast products
    and two adds, in that order.  Not a matmul: on the card a matmul may
    run in TF32 or reassociate, and either destroys the ray-geometry
    cancellations (hit points land far off the surface: shadow acne)."""
    return (a[:, 0, None] * b_t[None, :, 0]
            + a[:, 1, None] * b_t[None, :, 1]
            + a[:, 2, None] * b_t[None, :, 2])


def _pick(plane, col, sel):
    """``plane[p, col[p]]`` of a [P,N] plane where ``sel``, else 0 (the
    JAX package's ``sum(plane * onehot)``); ``col`` is clamped into the
    plane so unselected lanes read a real column."""
    if plane.shape[1] == 0:
        return plane.new_zeros(plane.shape[0])
    got = torch.gather(plane, 1, col.clamp(0, plane.shape[1] - 1)[:, None])
    return torch.where(sel, got[:, 0], torch.zeros_like(got[:, 0]))


def _rows(table, idx, sel):
    """``table[idx]`` of an [N,k] table where ``sel``, else 0 (the JAX
    package's ``_onehot_rows``), through ``gather_rows``."""
    if table.shape[0] == 0:
        return table.new_zeros((idx.shape[0], *table.shape[1:]))
    rows = gather_rows(table, idx.clamp(0, table.shape[0] - 1))
    return torch.where(sel[:, None], rows, torch.zeros_like(rows))


def group_prune_mask(scene: FlatScene, o, u, small: float):
    """[P,G] True where the reference's bounding-sphere test rejects the ray
    for that group (Shape::intersection, MySdlApplication.cpp:747-758):
    reject iff ``disc < 0 || |s| < SMALL_NUMBER`` using the *normalized*
    direction.  Groups with radius <= 0 never prune."""
    gc, gr = scene.grp_center, scene.grp_radius
    u_dot_c = _matdot(u, gc)
    o_dot_c = _matdot(o, gc)
    u_delta = u_dot_c - dot3(u, o)[:, None]
    dd = dot3(gc, gc)[None, :] - 2.0 * o_dot_c + dot3(o, o)[:, None]
    disc = u_delta * u_delta - dd + (gr * gr)[None, :]
    # strict > 0 in the sqrt mask: at disc == 0 the value is the same
    # (sqrt 0 = 0) but the masked branch has no inf gradient
    s = u_delta - safe_sqrt(disc, disc > 0)
    rejected = (disc < 0.0) | (torch.abs(s) < small)
    return rejected & (gr > 0.0)[None, :]


def intersect_scene(scene: FlatScene, o, v, *, small: float = 1e-4,
                    prune: bool = True, exclude_id=None) -> Hit:
    """Closest hit of rays (o, v) against the whole scene.

    o, v: [P,3]; v is the raw (unnormalized) direction, the reference's
    ``Line`` convention (endpoint - startpoint).

    ``exclude_id`` ([P] i32, -1 for none) removes one primitive per ray
    from consideration: secondary rays start *on* a primitive.  In exact
    arithmetic that is the reference's rejection of such hits
    (MySdlApplication.cpp:752-767, :657-659); unlike an epsilon test it
    stays robust in float32, where hit points land ~1e-3 world units off
    the surface.
    """
    dtype = o.dtype
    P = o.shape[0]
    nt = scene.num_triangles
    ns = scene.num_spheres

    vlen2 = dot3(v, v)
    ray_ok = vlen2 > 0.0
    vlen = safe_sqrt(vlen2, ray_ok)
    inv_vlen = safe_div(torch.ones_like(vlen), vlen, ray_ok)
    u = v * inv_vlen[:, None]

    if prune:
        pruned = group_prune_mask(scene, o, u, small)  # [P,G]
        # each primitive takes its group's column (JAX: a [P,G] x [G,N]
        # one-hot product; every primitive is in exactly one group)
        tri_pruned = pruned[:, scene.tri_group.long()]
        sph_pruned = pruned[:, scene.sph_group.long()]
    else:
        tri_pruned = torch.zeros((P, nt), dtype=torch.bool, device=o.device)
        sph_pruned = torch.zeros((P, ns), dtype=torch.bool, device=o.device)

    # --- spheres: disc = (u.dP)^2 - dP.dP + r^2, near root s = u.dP - sqrt
    c, r = scene.sph_center, scene.sph_radius
    u_dot_c = _matdot(u, c)
    o_dot_c = _matdot(o, c)
    u_delta = u_dot_c - dot3(u, o)[:, None]
    dd = dot3(c, c)[None, :] - 2.0 * o_dot_c + dot3(o, o)[:, None]
    disc = u_delta * u_delta - dd + (r * r)[None, :]
    disc_ok = disc >= 0.0
    # sqrt masked on strict > 0: the same values, and no inf gradient when a
    # dead secondary ray starts exactly on a sphere (disc == 0)
    s_sph = u_delta - safe_sqrt(disc, disc > 0.0)
    sph_hit = (disc_ok & (s_sph >= small) & scene.sph_valid[None, :]
               & ray_ok[:, None] & ~sph_pruned)
    sph_dist = torch.where(sph_hit, s_sph, BIG)

    # --- triangles: plane parameter m on the raw ray, then barycentric s,t
    der = tri_derived(scene.tri_v0, scene.tri_v1, scene.tri_v2, small)
    n, ue, ve = der["n"], der["u"], der["v"]
    n_dot_v = _matdot(v, n)
    n_dot_o = _matdot(o, n)
    n_dot_v0 = dot3(n, scene.tri_v0)
    plane_ok = torch.abs(n_dot_v) >= small
    m = safe_div(n_dot_v0[None, :] - n_dot_o, n_dot_v, plane_ok)
    m_ok = m >= small
    o_u = _matdot(o, ue)
    v_u = _matdot(v, ue)
    o_v = _matdot(o, ve)
    v_v = _matdot(v, ve)
    wu = o_u + m * v_u - dot3(scene.tri_v0, ue)[None, :]
    wv = o_v + m * v_v - dot3(scene.tri_v0, ve)[None, :]
    inv_den = 1.0 / der["denominator"]  # degenerate tris are masked out
    inv_den = torch.where(der["degenerate"], 0.0, inv_den)[None, :]
    sb = (der["uv"][None, :] * wv - der["vv"][None, :] * wu) * inv_den
    tb = (der["uv"][None, :] * wu - der["uu"][None, :] * wv) * inv_den
    inside = (sb >= 0.0) & (tb >= 0.0) & (sb + tb <= 1.0)
    tri_hit = (plane_ok & m_ok & inside & ~der["degenerate"][None, :]
               & scene.tri_valid[None, :] & ray_ok[:, None] & ~tri_pruned)
    tri_dist = torch.where(tri_hit, m * vlen[:, None], BIG)

    # --- nearest across [triangles, spheres]: strict <, the earliest
    # primitive on a tie (torch.argmin returns the first minimum)
    all_dist = torch.cat([tri_dist, sph_dist], dim=1)
    if exclude_id is not None:
        col = torch.arange(nt + ns, device=o.device)[None, :]
        all_dist = torch.where(col == exclude_id[:, None], BIG, all_dist)
    best = torch.argmin(all_dist, dim=1)
    best_dist = torch.gather(all_dist, 1, best[:, None])[:, 0]
    valid = best_dist < BIG
    is_tri = best < nt

    # --- the winning primitive's hit point and normal
    m_best = _pick(m, best, is_tri)
    point_tri = o + m_best[:, None] * v
    n_tri = _rows(n, best, is_tri)

    s_best = _pick(s_sph, best - nt, ~is_tri)
    point_sph = o + s_best[:, None] * u
    d0 = point_sph - _rows(c, best - nt, ~is_tri)
    d0_len = norm3(d0)
    n_sph = d0 * safe_div(torch.ones_like(d0_len), d0_len,
                          d0_len > 0)[:, None]

    point = torch.where(is_tri[:, None], point_tri, point_sph)
    point = torch.where(valid[:, None], point, o)
    normal = torch.where(is_tri[:, None], n_tri, n_sph)
    normal = torch.where(valid[:, None], normal, torch.zeros_like(normal))

    # --- per-primitive material rows (small gathers from the material
    # table), then the winner's row
    tri_mat, sph_mat = scene.tri_mat.long(), scene.sph_mat.long()

    def prim_rows(table):
        return torch.cat([table[tri_mat], table[sph_mat]], 0)

    ambient = gather_rows(prim_rows(scene.mat_ambient), best)
    diffuse = gather_rows(prim_rows(scene.mat_diffuse), best)
    specular = gather_rows(prim_rows(scene.mat_specular), best)
    transparency = gather_rows(prim_rows(scene.mat_transparency), best)
    refraction = gather_rows(prim_rows(scene.mat_refraction), best)
    refraction = torch.where(valid, refraction, 1.0)
    prim_chk = torch.cat([scene.tri_checker,
                          torch.zeros(ns, dtype=torch.bool,
                                      device=o.device)], 0)

    # --- checkerboard override (CheckerBoard::intersection): square parity
    # of the board-local hit point with C-style int() truncation; Python's
    # % on the integers, which is non-negative as jnp's is
    is_checker = prim_chk[best] & valid
    prel = point - scene.board_pos[None, :]
    px = prel[:, 0] + scene.board_half
    pz = prel[:, 2] + scene.board_half
    sq_sum = (torch.trunc(px / scene.board_square).to(torch.int32)
              + torch.trunc(pz / scene.board_square).to(torch.int32))
    white_id, black_id = scene.checker_mats
    even = sq_sum % 2 == 0

    def _chk(table):
        sel = torch.where(even[:, None], table[white_id][None, :],
                          table[black_id][None, :])
        return torch.where(is_checker[:, None], sel, 0.0)

    chk = is_checker[:, None]
    ambient = torch.where(chk, 0.0, ambient) + _chk(scene.mat_ambient)
    diffuse = torch.where(chk, 0.0, diffuse) + _chk(scene.mat_diffuse)
    specular = torch.where(chk, 0.0, specular) + _chk(scene.mat_specular)
    transparency = (torch.where(chk, 0.0, transparency)
                    + _chk(scene.mat_transparency))
    rho_chk = torch.where(even, scene.mat_refraction[white_id],
                          scene.mat_refraction[black_id])
    refraction = torch.where(is_checker, rho_chk, refraction)

    # --- secondary directions from the unit incoming direction and the
    # geometric (unflipped) normal: r = u - 2(u.n)n; Snell with TIR -> zero
    # vector (a zero ray then misses everything: the reference's dead
    # transmitted ray, SEMANTICS.md)
    cosi = dot3(u, normal)
    refl_dir = u - (2.0 * cosi)[:, None] * normal
    rho = refraction
    modulus = 1.0 - rho * rho * (1.0 - cosi * cosi)
    mod_ok = modulus > 0.0
    cosr = safe_sqrt(modulus, mod_ok)
    trans_dir = rho[:, None] * u - (cosr + rho * cosi)[:, None] * normal
    trans_dir = torch.where((mod_ok & valid)[:, None], trans_dir,
                            torch.zeros_like(trans_dir))
    refl_dir = torch.where(valid[:, None], refl_dir,
                           torch.zeros_like(refl_dir))

    zero3 = torch.zeros((P, 3), dtype=dtype, device=o.device)
    mask3 = valid[:, None]
    return Hit(
        valid=valid,
        prim_id=torch.where(valid, best.to(torch.int32), -1),
        dist=torch.where(valid, best_dist, BIG),
        point=point,
        normal=normal,
        refl_dir=refl_dir,
        trans_dir=trans_dir,
        ambient=torch.where(mask3, ambient, zero3),
        diffuse=torch.where(mask3, diffuse, zero3),
        specular=torch.where(mask3, specular, zero3),
        transparency=torch.where(mask3, transparency, zero3),
        refraction=torch.where(valid, refraction,
                               torch.ones_like(refraction)),
    )
