"""Forward render through the hand-written CUDA kernels — the counterpart of
the JAX package's ``kernels/render_pallas.py``.

Host side: ``compact_scene`` and ``pack_scene`` turn a FlatScene into five
small f32 tables, column for column the JAX package's layouts (the
reference's never-finished fragment shader's "uniform arrays of structs",
Hw4/TODO.txt:13-33).  ``render_image_kernel`` generates primary rays and
runs the single-sample, multi-sample and adaptive loops on the host.

Device side, one wrapper per kernel:

* ``render_chain`` — the chain forward (csrc/render_chain.cu), for scenes
  whose materials are all-0 or all-1 transparent (every preset);
* ``render_tree`` — the full bounce tree (csrc/render_tree.cu), for
  fractional transparency;
* ``render_packed`` — the chain forward plus one packed residual plane per
  bounce level (``pack_widths``): phase 1 of the fit path
  (kernels/adjoint_fused.py);
* ``render_residuals`` — the chain or tree forward plus the unpacked
  residual planes ``bi``, ``mid`` and ``lit`` of every level or preorder
  node (csrc/render_chain.cu, csrc/render_tree.cu): the forward of the
  split-mode fit and of ``kernels/adjoint.py::render_image_diff``
  (``render_forward_with_residuals``), with no pack and so no 2^24 limit.

A wrapper given CUDA tensors launches its kernel, or raises; given CPU
tensors it runs its plain PyTorch version (``render_chain_ref``,
``render_tree_ref``, ``render_packed_ref``, ``render_residuals_ref``),
which the CPU tests hold against the JAX package and ``chip_smoke.py``
holds the kernels against on the card.  ``LAUNCHES`` counts kernel
launches per wrapper.

Every kernel has a ``bf16_shading`` instantiation (``render_kwargs``'s
``bf16``, counted under ``launch_key``): the any-hit shadow sweep and the
Phong blend in bfloat16, as ``_make_tile_ops`` computes them.

As in the JAX kernels, bounding-sphere pruning is skipped (no image effect
for well-formed scenes) and the origin-primitive exclusion (SEMANTICS.md D1)
is kept exactly.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CameraConfig, RenderConfig
from ..ops.rays import Camera, primary_rays, screen_points
from ..ops.sampling import adaptive_step, jitter_source, resolve_device
from ..scene.flat import FlatScene, tri_derived

BIG = 3.0e38

# Table layouts (one row per primitive/material/light); the kernels'
# csrc/tile_ops.cuh repeats them.
SPH_COLS = 8    # cx cy cz r mat valid transp_any -
TRI_COLS = 24   # v0(3) n(3) u(3) v(3) uv uu vv denom ndotv0 mat checker ok transp_any - - -
MAT_COLS = 20   # amb(3) dif(3) spe(3) trn(3) rho take_trans refl_ok transp_any - - - -
LIGHT_COLS = 8  # pos(3) color(3) - -
MISC_COLS = 16  # eye(3) board_pos(3) board_half board_square - -

#: deepest bounce tree the tree kernel's per-thread stack holds
#: (csrc/render_tree.cu::kTreeMaxDepth)
TREE_MAX_DEPTH = 10
#: most lights the residual forwards hold: the shadow sweep's lit flags
#: travel in a 32-bit word (csrc/tile_ops.cuh::kResidualMaxLights)
RESIDUAL_MAX_LIGHTS = 32
#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT_BYTES = 232448

#: the wrappers whose kernels have a ``bf16_shading`` variant
#: (``launch_key``)
BF16_KERNELS = ("render_chain", "render_tree", "render_packed",
                "render_chain_residuals", "render_tree_residuals",
                "fused_adjoint", "recompute_adjoint")
#: kernel launches per wrapper, counted where each launches its kernel
#: (``adjoint_packed``, ``fused_adjoint``, ``recompute_adjoint`` and
#: ``fit_grads`` live in kernels/adjoint_fused.py, the probes ``mix_chain``,
#: ``op_chain`` and ``bf16_chain`` in kernels/probe.py); a bf16 variant
#: counts under its own key, ``<wrapper>_bf16``
LAUNCHES: Dict[str, int] = {"render_chain": 0, "render_tree": 0,
                             "render_packed": 0, "render_chain_residuals": 0,
                             "render_tree_residuals": 0, "adjoint_packed": 0,
                             "fused_adjoint": 0, "recompute_adjoint": 0,
                             "fit_grads": 0, "mix_chain": 0, "op_chain": 0,
                             "bf16_chain": 0,
                             **{f"{k}_bf16": 0 for k in BF16_KERNELS}}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_key(entry: str, bf16: bool) -> str:
    """The ``LAUNCHES`` key of wrapper ``entry``'s kernel: its bf16 variant
    counts apart."""
    return f"{entry}_bf16" if bf16 else entry


# ------------------------------------------------------------------ tables

def compact_scene(scene: FlatScene) -> FlatScene:
    """Drop padding primitives (valid mask False).  Deterministic, so
    primitive ids agree between every caller that packs the same scene."""
    tv, sv = scene.tri_valid, scene.sph_valid
    if bool(tv.all()) and bool(sv.all()):
        return scene
    take_t = torch.nonzero(tv).flatten()
    take_s = torch.nonzero(sv).flatten()
    return scene.replace(
        tri_v0=scene.tri_v0[take_t], tri_v1=scene.tri_v1[take_t],
        tri_v2=scene.tri_v2[take_t], tri_mat=scene.tri_mat[take_t],
        tri_checker=scene.tri_checker[take_t],
        tri_group=scene.tri_group[take_t],
        tri_valid=scene.tri_valid[take_t],
        sph_center=scene.sph_center[take_s],
        sph_radius=scene.sph_radius[take_s],
        sph_mat=scene.sph_mat[take_s],
        sph_group=scene.sph_group[take_s],
        sph_valid=scene.sph_valid[take_s])


def pack_scene(scene: FlatScene) -> Dict[str, torch.Tensor]:
    """FlatScene -> the kernels' f32 tables ``sph``, ``tri``, ``mat``,
    ``light``, ``misc`` (on the scene's device), padding compacted away.
    ``misc[0:3]`` (the eye) is left 0: the wrappers take the eye apart."""
    scene = compact_scene(scene)
    f32 = torch.float32
    dev = scene.device
    ns, nt, m, nl = (scene.num_spheres, scene.num_triangles,
                     scene.num_materials, scene.num_lights)
    zeros = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)

    # per-material "any transparency" flag, denormalized onto each primitive
    # so the shadow sweep can carry the occluder's transparency directly
    # (shadow test semantics: MySdlApplication.cpp:1221)
    T = scene.mat_transparency.to(f32)
    t_any = torch.any(T != 0.0, -1)
    t_any_mat = t_any.to(f32)

    sph = zeros(max(ns, 1), SPH_COLS)
    sph[:ns, 0:3] = scene.sph_center.to(f32)
    sph[:ns, 3] = scene.sph_radius.to(f32)
    sph[:ns, 4] = scene.sph_mat.to(f32)
    sph[:ns, 5] = scene.sph_valid.to(f32)
    sph[:ns, 6] = t_any_mat[scene.sph_mat.long()]

    v0 = scene.tri_v0.to(f32)
    der = tri_derived(v0, scene.tri_v1.to(f32), scene.tri_v2.to(f32))
    tri = zeros(max(nt, 1), TRI_COLS)
    tri[:nt, 0:3] = v0
    tri[:nt, 3:6] = der["n"]
    tri[:nt, 6:9] = der["u"]
    tri[:nt, 9:12] = der["v"]
    tri[:nt, 12] = der["uv"]
    tri[:nt, 13] = der["uu"]
    tri[:nt, 14] = der["vv"]
    tri[:nt, 15] = der["denominator"]
    tri[:nt, 16] = torch.sum(der["n"] * v0, -1)
    tri[:nt, 17] = scene.tri_mat.to(f32)
    tri[:nt, 18] = scene.tri_checker.to(f32)
    tri[:nt, 19] = torch.logical_and(scene.tri_valid,
                                     ~der["degenerate"]).to(f32)
    # checker squares are both opaque, so the material row's flag is right
    # for checker-overridden triangles too
    tri[:nt, 20] = t_any_mat[scene.tri_mat.long()]

    small = 1e-4  # |T| > SMALL check of the transmit gate (:1238)
    t_len = torch.sqrt(torch.sum(T * T, -1))
    take_trans = torch.logical_and(t_any, t_len > small)
    refl_ok = torch.any((1.0 - T) != 0.0, -1)
    mat = zeros(max(m, 1), MAT_COLS)
    mat[:m, 0:3] = scene.mat_ambient.to(f32)
    mat[:m, 3:6] = scene.mat_diffuse.to(f32)
    mat[:m, 6:9] = scene.mat_specular.to(f32)
    mat[:m, 9:12] = T
    mat[:m, 12] = scene.mat_refraction.to(f32)
    mat[:m, 13] = take_trans.to(f32)
    mat[:m, 14] = refl_ok.to(f32)
    mat[:m, 15] = t_any_mat

    light = zeros(max(nl, 1), LIGHT_COLS)
    light[:nl, 0:3] = scene.light_pos.to(f32)
    light[:nl, 3:6] = scene.light_color.to(f32)

    misc = zeros(MISC_COLS)
    misc[3:6] = scene.board_pos.to(f32)
    misc[6] = scene.board_half.to(f32)
    misc[7] = scene.board_square.to(f32)
    return dict(sph=sph, tri=tri, mat=mat, light=light, misc=misc)


# --------------------------------------------------------- plain versions

def _f32(x) -> float:
    """A Python float holding the f32 value of ``x``."""
    return float(np.float32(x))


def _bf16(x) -> torch.Tensor:
    """The table scalar ``x`` cast to bfloat16 (a 0-dim CPU tensor, which
    combines with tensors on any device), as the TPU kernel splats an SMEM
    scalar to a bf16 plane."""
    return torch.tensor(x, dtype=torch.bfloat16)


class _PlainOps:
    """The per-pixel device functions of the kernels (csrc/tile_ops.cuh),
    vectorised over a flat [P] pixel axis: the plain PyTorch version the
    CPU path runs and the card's kernels are checked against.  Sweeps loop
    over primitives in Python, in the op order of the JAX package's
    ``render_pallas.py::_make_tile_ops``; table entries are Python floats
    (the TPU kernel's SMEM scalars), ids are f32 planes.

    ``bf16`` is ``RenderConfig.bf16_shading``: the any-hit shadow sweep
    (``_tri_hit_bf16``, ``_sph_hit_bf16``) and the Phong blend of ``shade``
    multiply and add in bfloat16 where ``_make_tile_ops`` does, each op
    rounded to nearest even on its own (PyTorch's bf16 ops, the TPU's
    per-op rounding); compares, reciprocals, square roots and the rest of
    the node stay f32."""

    def __init__(self, tables, *, num_pixels: int, nl: int, small: float,
                 atten: float, checker_mats: Tuple[int, int],
                 all_opaque: bool, bf16: bool = False):
        # the table columns hit_attrs and mat_attrs load by id
        self.t_tri_attr = tables["tri"][:, [3, 4, 5, 17, 18]]
        self.t_sph_attr = tables["sph"][:, [0, 1, 2, 4]]
        self.t_mat = tables["mat"]
        self.sph = tables["sph"].tolist()
        self.tri = tables["tri"].tolist()
        self.light = tables["light"].tolist()[:nl]
        misc = tables["misc"].tolist()
        self.ns, self.nt = len(self.sph), len(self.tri)
        self.P = num_pixels
        self.device = tables["sph"].device
        self.small, self.atten = small, atten
        self.white_id, self.black_id = (float(c) for c in checker_mats)
        self.all_opaque = all_opaque
        self.bf16 = bf16
        self.board_x, self.board_z = misc[3], misc[5]
        self.board_half = misc[6]
        self.inv_sq = _f32(np.float32(1.0) / np.float32(misc[7]))
        with np.errstate(divide="ignore"):
            self.inv_den = [_f32(np.float32(1.0) / np.float32(t[15]))
                            for t in self.tri]
        self.rr = [_f32(np.float32(c[3]) * np.float32(c[3]))
                   for c in self.sph]

    def full(self, x):
        return torch.full((self.P,), x, dtype=torch.float32,
                          device=self.device)

    def _tri_hit(self, i, ox, oy, oz, vx, vy, vz, ok, excl):
        t = self.tri[i]
        small = self.small
        ndv = t[3] * vx + t[4] * vy + t[5] * vz
        plane_ok = torch.abs(ndv) >= small
        ndo = t[3] * ox + t[4] * oy + t[5] * oz
        mm = (t[16] - ndo) * (1.0 / torch.where(plane_ok, ndv, 1.0))
        px = ox + mm * vx - t[0]
        py = oy + mm * vy - t[1]
        pz = oz + mm * vz - t[2]
        wu = px * t[6] + py * t[7] + pz * t[8]
        wv = px * t[9] + py * t[10] + pz * t[11]
        sb = (t[12] * wv - t[14] * wu) * self.inv_den[i]
        tb = (t[12] * wu - t[13] * wv) * self.inv_den[i]
        hit = (plane_ok & (mm >= small) & (sb >= 0.0) & (tb >= 0.0)
               & (sb + tb <= 1.0) & ok & (excl != float(i)))
        return hit, mm

    def _sph_hit(self, i, ox, oy, oz, ux, uy, uz, ok, excl):
        c = self.sph[i]
        dx = c[0] - ox
        dy = c[1] - oy
        dz = c[2] - oz
        ud = ux * dx + uy * dy + uz * dz
        disc = ud * ud - (dx * dx + dy * dy + dz * dz) + self.rr[i]
        disc_ok = disc > 0.0
        s = ud - torch.sqrt(torch.where(disc_ok, disc, 1.0)) * disc_ok.float()
        hit = ((disc >= 0.0) & (s >= self.small) & ok
               & (excl != float(i + self.nt)))
        return hit, s

    # -- the bf16 forms (render_pallas.py:310-371), on rays cast once --

    def _tri_hit_bf16(self, i, ob, vb, ok, excl):
        """Triangle i's hit predicate: the dot products, hit point and
        barycentrics in bf16, ``mm`` and every compare in f32."""
        t, b, small = self.tri[i], _bf16, self.small
        oxb, oyb, ozb = ob
        vxb, vyb, vzb = vb
        nx, ny, nz = b(t[3]), b(t[4]), b(t[5])
        ndv = (nx * vxb + ny * vyb + nz * vzb).float()
        plane_ok = torch.abs(ndv) >= small
        ndo = (nx * oxb + ny * oyb + nz * ozb).float()
        mm = (t[16] - ndo) * (1.0 / torch.where(plane_ok, ndv, 1.0))
        mmb = mm.bfloat16()
        px = oxb + mmb * vxb - b(t[0])
        py = oyb + mmb * vyb - b(t[1])
        pz = ozb + mmb * vzb - b(t[2])
        wu = px * b(t[6]) + py * b(t[7]) + pz * b(t[8])
        wv = px * b(t[9]) + py * b(t[10]) + pz * b(t[11])
        uv, uu, vv = b(t[12]), b(t[13]), b(t[14])
        inv_den = b(self.inv_den[i])
        sb = ((uv * wv - vv * wu) * inv_den).float()
        tb = ((uv * wu - uu * wv) * inv_den).float()
        return (plane_ok & (mm >= small) & (sb >= 0.0) & (tb >= 0.0)
                & (sb + tb <= 1.0) & ok & (excl != float(i)))

    def _sph_hit_bf16(self, i, ob, ub, ok, excl):
        """Sphere i's hit predicate: the offsets and dot products in bf16,
        ``disc`` around them, the root and the compares in f32."""
        c, b = self.sph[i], _bf16
        dx, dy, dz = (b(c[k]) - o for k, o in enumerate(ob))
        uxb, uyb, uzb = ub
        ud = (uxb * dx + uyb * dy + uzb * dz).float()
        disc = ud * ud - (dx * dx + dy * dy + dz * dz).float() + self.rr[i]
        disc_ok = disc > 0.0
        s = ud - torch.sqrt(torch.where(disc_ok, disc, 1.0)) * disc_ok.float()
        return ((disc >= 0.0) & (s >= self.small) & ok
                & (excl != float(i + self.nt)))

    def intersect_all(self, ox, oy, oz, vx, vy, vz, excl, ray_ok,
                      carry_transp=False, any_hit=False):
        """Closest hit, triangles first with strict < — (bd, bi, mm, ux, uy,
        uz), ``mm`` the winning triangle's plane parameter — or with
        ``carry_transp`` (bd, winner's transparency flag), or with
        ``any_hit`` only the occluded mask."""
        vlen2 = vx * vx + vy * vy + vz * vz
        ok = ray_ok & (vlen2 > 0.0)
        inv_vlen = torch.rsqrt(torch.where(ok, vlen2, 1.0))
        vlen = vlen2 * inv_vlen
        ux, uy, uz = vx * inv_vlen, vy * inv_vlen, vz * inv_vlen
        tris = [i for i in range(self.nt) if self.tri[i][19] > 0.5]
        sphs = [i for i in range(self.ns) if self.sph[i][5] > 0.5]
        if any_hit and self.bf16:
            ob = tuple(x.bfloat16() for x in (ox, oy, oz))
            vb = tuple(x.bfloat16() for x in (vx, vy, vz))
            ub = tuple(x.bfloat16() for x in (ux, uy, uz))
            occ = torch.zeros_like(ok)
            for i in tris:
                occ = occ | self._tri_hit_bf16(i, ob, vb, ok, excl)
            for i in sphs:
                occ = occ | self._sph_hit_bf16(i, ob, ub, ok, excl)
            return occ
        if any_hit:
            occ = torch.zeros_like(ok)
            for i in tris:
                occ = occ | self._tri_hit(i, ox, oy, oz, vx, vy, vz, ok,
                                          excl)[0]
            for i in sphs:
                occ = occ | self._sph_hit(i, ox, oy, oz, ux, uy, uz, ok,
                                          excl)[0]
            return occ
        bd, bi, bm = self.full(BIG), self.full(-1.0), self.full(0.0)
        for i in tris:
            hit, mm = self._tri_hit(i, ox, oy, oz, vx, vy, vz, ok, excl)
            dist = torch.where(hit, mm * vlen, BIG)
            upd = dist < bd
            win = self.tri[i][20] if carry_transp else float(i)
            bd, bi = torch.where(upd, dist, bd), torch.where(upd, win, bi)
            if not carry_transp:
                bm = torch.where(upd, mm, bm)
        for i in sphs:
            hit, s = self._sph_hit(i, ox, oy, oz, ux, uy, uz, ok, excl)
            dist = torch.where(hit, s, BIG)
            upd = dist < bd
            win = self.sph[i][6] if carry_transp else float(i + self.nt)
            bd, bi = torch.where(upd, dist, bd), torch.where(upd, win, bi)
        if carry_transp:
            return bd, bi
        return bd, bi, bm, ux, uy, uz

    def hit_attrs(self, bd, bi, mm, hitm, ox, oy, oz, vx, vy, vz, ux, uy,
                  uz):
        """Hit point, shading normal and material id (checker override) of
        the winning primitive, loaded by id.  A miss (bi = -1) gives what
        the TPU kernel's mask blend gives: zero normal, material 0.  A
        triangle's point is o + mm*v (the core's and the oracle's; through
        bd*u it rounds off the plane, and a ray meeting the board on a
        checker edge lands in the neighbouring square), a sphere's
        o + bd*u (csrc/tile_ops.cuh::hit_attrs)."""
        nt = self.nt
        is_t = (bi >= 0.0) & (bi < nt)
        is_s = bi >= nt
        trow = self.t_tri_attr[torch.where(is_t, bi, 0.0).long()]
        srow = self.t_sph_attr[torch.where(is_s, bi - nt, 0.0).long()]
        tnx, tny, tnz, tmid, tchk = torch.where(is_t[:, None], trow,
                                                0.0).unbind(1)
        scx, scy, scz, smid = torch.where(is_s[:, None], srow, 0.0).unbind(1)

        is_tri = bi < nt
        k = torch.where(hitm, torch.where(is_tri, mm, bd), 0.0)
        px = ox + k * torch.where(is_tri, vx, ux)
        py = oy + k * torch.where(is_tri, vy, uy)
        pz = oz + k * torch.where(is_tri, vz, uz)
        d0x, d0y, d0z = px - scx, py - scy, pz - scz
        d0sq = d0x * d0x + d0y * d0y + d0z * d0z
        inv_d0 = torch.rsqrt(torch.where(d0sq > 0.0, d0sq, 1.0))
        nx = torch.where(hitm, torch.where(is_tri, tnx, d0x * inv_d0), 0.0)
        ny = torch.where(hitm, torch.where(is_tri, tny, d0y * inv_d0), 0.0)
        nz = torch.where(hitm, torch.where(is_tri, tnz, d0z * inv_d0), 0.0)

        mid = torch.where(is_tri, tmid, smid)
        # checkerboard override: square parity with C truncation
        # (:1101-1111), trunc(s/2)*2 == s on the exact small integer s
        fx = torch.trunc((px - self.board_x + self.board_half) * self.inv_sq)
        fz = torch.trunc((pz - self.board_z + self.board_half) * self.inv_sq)
        s_par = fx + fz
        parity_even = torch.trunc(s_par * 0.5) * 2.0 == s_par
        is_chk = is_tri & (tchk > 0.5)
        mid = torch.where(is_chk, torch.where(parity_even, self.white_id,
                                              self.black_id), mid)
        return px, py, pz, nx, ny, nz, mid

    def mat_attrs(self, mid):
        """The hit material's row, [P, MAT_COLS], loaded by id."""
        return self.t_mat[mid.long()]

    @staticmethod
    def secondary_dirs(ux, uy, uz, nx, ny, nz, rho, want_trans=True):
        """Reflected + transmitted (Snell, TIR-guarded) unit-scale dirs;
        zero transmitted dirs when no material transmits."""
        cosi = ux * nx + uy * ny + uz * nz
        rx = ux - 2.0 * cosi * nx
        ry = uy - 2.0 * cosi * ny
        rz = uz - 2.0 * cosi * nz
        if not want_trans:
            zero = torch.zeros_like(rx)
            return rx, ry, rz, zero, zero, zero
        modulus = 1.0 - rho * rho * (1.0 - cosi * cosi)
        mod_ok = modulus > 0.0
        mod_f = mod_ok.float()
        cosr = torch.sqrt(torch.where(mod_ok, modulus, 1.0)) * mod_f
        coef = cosr + rho * cosi
        tx = (rho * ux - coef * nx) * mod_f
        ty = (rho * uy - coef * ny) * mod_f
        tz = (rho * uz - coef * nz) * mod_f
        return rx, ry, rz, tx, ty, tz

    def shade(self, px, py, pz, nx, ny, nz, ux, uy, uz, rx, ry, rz, mats,
              bi, hitm, thr, col, lits=None):
        """Per-light shadow sweep + Phong accumulation
        (MySdlApplication.cpp:1213-1228); returns the new (r, g, b).  Each
        light's shadow-sweep boolean (before the ``hitm`` mask) is appended
        to ``lits`` when a list is given (the packed residual's lit
        bits)."""
        col_r, col_g, col_b = col
        thr_r, thr_g, thr_b = thr
        amb = [mats[:, k] for k in range(0, 3)]
        dif = [mats[:, k] for k in range(3, 6)]
        spe = [mats[:, k] for k in range(6, 9)]
        for lx, ly, lz, lr, lg, lb, _, _ in self.light:
            svx, svy, svz = lx - px, ly - py, lz - pz
            if self.all_opaque:
                lit = ~self.intersect_all(px, py, pz, svx, svy, svz, bi,
                                          hitm, any_hit=True)
            else:
                sd, occ_transp = self.intersect_all(
                    px, py, pz, svx, svy, svz, bi, hitm, carry_transp=True)
                lit = (sd >= BIG) | (occ_transp > 0.5)
            if lits is not None:
                lits.append(lit)
            d2 = svx * svx + svy * svy + svz * svz
            att = self.atten / (self.atten + d2)
            inv_sl = torch.rsqrt(torch.where(d2 > 0.0, d2, 1.0))
            ndots = torch.abs(nx * svx + ny * svy + nz * svz) * inv_sl
            udotr = torch.abs(ux * rx + uy * ry + uz * rz)
            w = torch.where(lit & hitm, att, 0.0)
            if self.bf16:
                # render_pallas.py:540-555: the light colour folds into w in
                # f32, the blend runs in bf16, the sum stays f32
                nb, ub = ndots.bfloat16(), udotr.bfloat16()
                col_r, col_g, col_b = (
                    c + (t.bfloat16() * (w * lc).bfloat16()
                         * (a.bfloat16() + nb * d.bfloat16()
                            + ub * sp.bfloat16())).float()
                    for c, t, lc, a, d, sp in zip(
                        (col_r, col_g, col_b), (thr_r, thr_g, thr_b),
                        (lr, lg, lb), amb, dif, spe))
                continue
            col_r = col_r + (thr_r * w * (amb[0] + ndots * dif[0]
                                          + udotr * spe[0]) * lr)
            col_g = col_g + (thr_g * w * (amb[1] + ndots * dif[1]
                                          + udotr * spe[1]) * lg)
            col_b = col_b + (thr_b * w * (amb[2] + ndots * dif[2]
                                          + udotr * spe[2]) * lb)
        return col_r, col_g, col_b

    def node(self, ox, oy, oz, vx, vy, vz, excl, alive, thr, col,
             want_trans, lits=None):
        """One bounce level/node: closest hit, attributes, secondary
        directions and shading.  Returns (hitm, bi, p, mats, dirs, col,
        mid); ``lits`` as in ``shade``."""
        bd, bi, mm, ux, uy, uz = self.intersect_all(ox, oy, oz, vx, vy, vz,
                                                    excl, alive)
        hitm = (bd < BIG) & alive
        px, py, pz, nx, ny, nz, mid = self.hit_attrs(
            bd, bi, mm, hitm, ox, oy, oz, vx, vy, vz, ux, uy, uz)
        mats = self.mat_attrs(mid)
        dirs = self.secondary_dirs(ux, uy, uz, nx, ny, nz, mats[:, 12],
                                   want_trans=want_trans)
        col = self.shade(px, py, pz, nx, ny, nz, ux, uy, uz, *dirs[:3],
                         mats, bi, hitm, thr, col, lits)
        return hitm, bi, (px, py, pz), mats, dirs, col, mid


def _chain_ref(tables, v, eye, *, nl: int, depth: int, small: float,
               atten: float, checker_mats: Tuple[int, int], want_trans: bool,
               bf16: bool = False,
               pack: Optional[Tuple[float, float]] = None,
               residuals: bool = False):
    """The chain over depth+1 levels (render_pallas.py::_chain_forward):
    ([P,3] RGB, [depth+1, P] packed residuals with ``pack``, the unpacked
    planes dict(bi, mid, lit) with ``residuals``, else None).  ``bf16``:
    ``_PlainOps``'s."""
    P = v.shape[0]
    ops = _PlainOps(tables, num_pixels=P, nl=nl, small=small, atten=atten,
                    checker_mats=checker_mats, all_opaque=not want_trans,
                    bf16=bf16)
    ox, oy, oz = (ops.full(_f32(e)) for e in eye)
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    thr = (ops.full(1.0),) * 3
    col = (ops.full(0.0),) * 3
    excl = ops.full(-1.0)
    alive = torch.ones(P, dtype=torch.bool, device=v.device)
    pks = []
    res = dict(bi=[], mid=[], lit=[])
    for _ in range(depth + 1):
        lits = [] if pack is not None or residuals else None
        hitm, bi, p, mats, dirs, col, mid = ops.node(
            ox, oy, oz, vx, vy, vz, excl, alive, thr, col, want_trans, lits)
        if residuals:
            # where(hitm, bi, -1), as the JAX kernel stores it; a dead
            # level's mid is 0 and its lit flags 1 (no occluder is tested)
            res["bi"].append(torch.where(hitm, bi, -1.0))
            res["mid"].append(mid)
            res["lit"].append([lit.float() for lit in lits])
        if pack is not None:
            # (bi+1) + mid*bw_bi + sum_li lit_li * bw_bi*bw_mid*2^li, every
            # term an exact f32 integer (render_pallas.py:690-695)
            bw_bi, bw_mid = pack
            pk = (torch.where(hitm, bi, -1.0) + 1.0) + mid * bw_bi
            for li, lit in enumerate(lits):
                pk = pk + lit.float() * (bw_bi * bw_mid * float(1 << li))
            pks.append(pk)
        rx, ry, rz, tx, ty, tz = dirs
        take_t = mats[:, 13] > 0.5
        vx = torch.where(take_t, tx, rx)
        vy = torch.where(take_t, ty, ry)
        vz = torch.where(take_t, tz, rz)
        thr = tuple(t * torch.where(take_t, mats[:, 9 + c], 1.0 - mats[:, 9 + c])
                    for c, t in enumerate(thr))
        branch = torch.where(take_t, vx * vx + vy * vy + vz * vz > 0.0,
                             mats[:, 14] > 0.5)
        alive = hitm & branch
        (ox, oy, oz), excl = p, bi
    img = torch.stack(col, -1)
    if residuals:
        return img, _stack_residuals(res, nl, depth + 1, P, v)
    return img, (torch.stack(pks) if pks else None)


def _stack_residuals(res, nl: int, K: int, P: int,
                     v) -> Dict[str, torch.Tensor]:
    """Per-node lists -> ``bi``/``mid`` [K, P] and ``lit`` [nl, K, P]."""
    lit = (torch.stack([torch.stack([res["lit"][k][li] for k in range(K)])
                        for li in range(nl)]) if nl
           else v.new_zeros((0, K, P)))
    return dict(bi=torch.stack(res["bi"]), mid=torch.stack(res["mid"]),
                lit=lit)


def render_chain_ref(tables, v, eye, **kw) -> torch.Tensor:
    """Plain PyTorch version of the chain kernel: [P,3] directions -> [P,3]
    RGB over depth+1 levels (render_pallas.py::_chain_forward).  The
    keyword arguments are ``render_kwargs``'s."""
    return _chain_ref(tables, v, eye, **kw)[0]


def render_packed_ref(tables, v, eye, *, pack: Tuple[float, float], **kw):
    """Plain PyTorch version of the packed forward: ([P,3] RGB, [depth+1, P]
    packed residuals) — ``render_chain_ref`` plus the per-level pack of
    render_pallas.py::_chain_forward.  Levels at and after a lane's miss
    hold ``(2^nl - 1)*bw_bi*bw_mid``: bi + 1 = 0, mid = 0, and every lit
    bit set (a dead lane's shadow sweep finds no occluder)."""
    return _chain_ref(tables, v, eye, pack=pack, **kw)


def n_tree_nodes(depth: int) -> int:
    """Preorder nodes of the full bounce tree of ``depth``: 2^(depth+1)-1
    (render_pallas.py::n_tree_nodes)."""
    return 2 ** (depth + 1) - 1


def render_tree_ref(tables, v, eye, *, nl: int, depth: int, small: float,
                    atten: float, checker_mats: Tuple[int, int],
                    want_trans: bool, bf16: bool = False,
                    residuals: bool = False):
    """Plain PyTorch version of the tree kernel: the full binary bounce tree
    in preorder, transmitted child (weight T) before reflected (weight 1-T)
    (render_pallas.py::_tree_forward) -> [P,3] RGB.  With ``residuals``
    returns (RGB, residuals): ``bi`` (hit primitive id, -1 where the node's
    ray misses or is masked to zero) and ``mid`` [K, P], ``lit`` [nl, K, P],
    over the K = ``n_tree_nodes(depth)`` preorder nodes, as f32 (the layout
    kernels/adjoint.py::replay_render_tree reads; ``_tree_forward``'s
    ``res_refs``).  A node whose ray is masked to zero holds what a dead
    TPU lane stores: bi = -1, mid = 0 and every lit flag 1.  ``bf16``:
    ``_PlainOps``'s."""
    P = v.shape[0]
    ops = _PlainOps(tables, num_pixels=P, nl=nl, small=small, atten=atten,
                    checker_mats=checker_mats, all_opaque=not want_trans,
                    bf16=bf16)
    res = dict(bi=[], mid=[], lit=[]) if residuals else None

    def node(o, d, thr, excl, alive, level, col):
        if not bool(alive.any()):
            # every ray of the subtree is masked to zero: it adds nothing,
            # and its nodes hold the dead values (a host sync a node on a
            # CUDA tensor, where this plain version runs only as a check)
            if residuals:
                dead_bi, mid0, lit1 = ops.full(-1.0), ops.full(0.0), \
                    ops.full(1.0)
                for _ in range(n_tree_nodes(depth - level)):
                    res["bi"].append(dead_bi)
                    res["mid"].append(mid0)
                    res["lit"].append([lit1] * nl)
            return col
        lits = [] if residuals else None
        hitm, bi, p, mats, dirs, col, mid = ops.node(*o, *d, excl, alive, thr,
                                                     col, want_trans, lits)
        if residuals:
            res["bi"].append(torch.where(hitm, bi, -1.0))
            res["mid"].append(mid)
            res["lit"].append([lit.float() for lit in lits])
        if level == depth:
            return col
        hit_f = hitm.float()
        trn = [mats[:, 9 + c] for c in range(3)]
        take_f = mats[:, 13] * hit_f
        col = node(p, tuple(x * take_f for x in dirs[3:]),
                   tuple(t * trn[c] * take_f for c, t in enumerate(thr)),
                   bi, hitm, level + 1, col)
        refl_f = mats[:, 14] * hit_f
        col = node(p, tuple(x * refl_f for x in dirs[:3]),
                   tuple(t * (1.0 - trn[c]) * refl_f
                         for c, t in enumerate(thr)),
                   bi, hitm, level + 1, col)
        return col

    col = node(tuple(ops.full(_f32(e)) for e in eye),
               (v[:, 0], v[:, 1], v[:, 2]), (ops.full(1.0),) * 3,
               ops.full(-1.0), torch.ones(P, dtype=torch.bool,
                                          device=v.device),
               0, (ops.full(0.0),) * 3)
    img = torch.stack(col, -1)
    if not residuals:
        return img
    return img, _stack_residuals(res, nl, n_tree_nodes(depth), P, v)


def render_residuals_ref(tables, v, eye, *, tree: bool, **kw):
    """Plain PyTorch version of the residual forwards: ([P,3] RGB,
    dict(bi, mid [K, P], lit [nl, K, P])) over the K = depth+1 chain levels
    (``_chain_ref`` in its residual mode, written out level by level, not
    through the pack, so no scene is too large for it) or the K =
    ``n_tree_nodes(depth)`` preorder nodes of the tree
    (``render_tree_ref``'s).  ``bi`` is the hit primitive id (sphere ids
    offset by the packed triangle row count), -1 where the level or node
    misses or is not traced; those hold mid 0 and every lit flag 1, what a
    dead TPU lane stores.  The keyword arguments are ``render_kwargs``'s."""
    if tree:
        return render_tree_ref(tables, v, eye, residuals=True, **kw)
    return _chain_ref(tables, v, eye, residuals=True, **kw)


# ---------------------------------------------------------------- wrappers

def _check(tables, v, depth: int, nl: int) -> None:
    want = {"sph": SPH_COLS, "tri": TRI_COLS, "mat": MAT_COLS,
            "light": LIGHT_COLS}
    for name, t in tables.items():
        if t.device != v.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"table {name!r} must be contiguous f32 on "
                             f"{v.device}")
        cols = want.get(name, MISC_COLS)
        if (t.shape[-1] if name in want else t.numel()) != cols:
            raise ValueError(f"table {name!r} has shape {tuple(t.shape)}")
    if v.dtype != torch.float32 or v.dim() != 2 or v.shape[1] != 3 \
            or not v.is_contiguous():
        raise ValueError(f"v must be contiguous f32 [P, 3], got "
                         f"{v.dtype} {tuple(v.shape)}")
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    if not 0 <= nl <= tables["light"].shape[0]:
        raise ValueError(f"nl={nl} lights but the light table has "
                         f"{tables['light'].shape[0]} rows")


def _flat_tables(tables, nl: int) -> torch.Tensor:
    """misc | sph | tri | mat | light[:nl] as one buffer (the kernels'
    shared-memory image)."""
    return torch.cat([tables["misc"].reshape(-1), tables["sph"].reshape(-1),
                      tables["tri"].reshape(-1), tables["mat"].reshape(-1),
                      tables["light"][:nl].reshape(-1)])


def _render(entry: str, plain, tables, v, eye, *, nl: int, depth: int,
            small: float, atten: float, checker_mats: Tuple[int, int],
            want_trans: bool, bf16: bool = False,
            extra_shape: Optional[Tuple[int, ...]] = None,
            extra_args: Sequence[float] = (), plain_kw: Optional[dict] = None):
    """Checks the inputs; runs ``plain`` (with ``plain_kw`` too) on CPU
    tensors, and launches the C entry ``rtfs_<entry>`` on CUDA tensors (its
    bf16 instantiation with ``bf16``).  With ``extra_shape`` the entry also
    writes an f32 buffer of that shape (its pointer, then ``extra_args``,
    follow the common arguments), and (rgb, buffer) is returned."""
    _check(tables, v, depth, nl)
    kw = dict(nl=nl, depth=depth, small=small, atten=atten,
              checker_mats=checker_mats, want_trans=want_trans, bf16=bf16)
    if v.device.type == "cpu":
        return plain(tables, v, eye, **kw, **(plain_kw or {}))
    if v.device.type != "cuda":
        raise ValueError(f"{entry}: kernels run on CUDA tensors, got "
                         f"{v.device}")
    from . import cuda_build
    lib = cuda_build.load()
    flat = _flat_tables(tables, nl)
    if flat.numel() * 4 > SMEM_LIMIT_BYTES:
        raise ValueError(f"{entry}: scene tables take {flat.numel() * 4} B, "
                         f"over the {SMEM_LIMIT_BYTES} B of shared memory "
                         f"a block may use")
    P = v.shape[0]
    out = torch.empty((P, 3), dtype=torch.float32, device=v.device)
    buf = (torch.empty(extra_shape, dtype=torch.float32, device=v.device)
           if extra_shape is not None else None)
    if P == 0:
        return out if buf is None else (out, buf)
    extra = ([buf.data_ptr(), *(float(a) for a in extra_args)]
             if buf is not None else [])
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = getattr(lib, f"rtfs_{entry}")(
            flat.data_ptr(), tables["sph"].shape[0], tables["tri"].shape[0],
            tables["mat"].shape[0], nl, v.data_ptr(), out.data_ptr(), P,
            *(float(e) for e in eye), depth, small, atten,
            int(checker_mats[0]), int(checker_mats[1]), int(want_trans),
            int(bf16), *extra, ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, entry)
    LAUNCHES[launch_key(entry, bf16)] += 1
    return out if buf is None else (out, buf)


def render_chain(tables, v, eye: Sequence[float], **kw) -> torch.Tensor:
    """Chain forward: [P,3] primary-ray directions from ``eye`` -> [P,3]
    RGB.  CUDA tensors launch csrc/render_chain.cu; CPU tensors run
    ``render_chain_ref``.  The keyword arguments are ``render_kwargs``'s;
    ``want_trans`` is the scene's ``has_transmission`` (False also selects
    the any-hit shadow sweep)."""
    return _render("render_chain", render_chain_ref, tables, v, eye, **kw)


def render_tree(tables, v, eye: Sequence[float], **kw) -> torch.Tensor:
    """Bounce-tree forward, as ``render_chain`` (csrc/render_tree.cu /
    ``render_tree_ref``).  ``depth`` is at most ``TREE_MAX_DEPTH``."""
    if kw["depth"] > TREE_MAX_DEPTH:
        raise ValueError(f"tree depth {kw['depth']} > TREE_MAX_DEPTH "
                         f"({TREE_MAX_DEPTH})")
    return _render("render_tree", render_tree_ref, tables, v, eye, **kw)


def render_packed(tables, v, eye: Sequence[float], *,
                  pack: Tuple[float, float], **kw):
    """Packed forward, phase 1 of the fit path: [P,3] primary-ray
    directions -> ([P,3] RGB, [depth+1, P] packed residuals, the layout of
    ``pack_widths``).  CUDA tensors launch csrc/render_chain.cu's packed
    instantiation (the chain kernel's image code); CPU tensors run
    ``render_packed_ref``.  ``pack`` is ``pack_widths(tables["tri"].shape[0],
    ns, m, nl)``; the other keyword arguments are ``render_kwargs``'s."""
    return _render("render_packed", render_packed_ref, tables, v, eye,
                   extra_shape=(kw["depth"] + 1, v.shape[0]),
                   extra_args=pack, plain_kw=dict(pack=pack), **kw)


def render_residuals(tables, v, eye: Sequence[float], *, tree: bool, **kw):
    """Residual forward: [P,3] primary-ray directions -> ([P,3] RGB,
    dict(bi, mid [K, P], lit [nl, K, P])), the unpacked residual planes of
    the K = depth+1 chain levels or, with ``tree``, the K =
    ``n_tree_nodes(depth)`` preorder tree nodes (``render_residuals_ref``
    says what they hold).  CUDA tensors launch the residual instantiation
    of csrc/render_chain.cu or csrc/render_tree.cu (each its image code);
    CPU tensors run ``render_residuals_ref``.  At most
    ``RESIDUAL_MAX_LIGHTS`` lights, on every device; the other keyword
    arguments are ``render_kwargs``'s."""
    nl, depth = kw["nl"], kw["depth"]
    if nl > RESIDUAL_MAX_LIGHTS:
        raise ValueError(f"the residual forward holds at most "
                         f"{RESIDUAL_MAX_LIGHTS} lights (a 32-bit lit "
                         f"word), got {nl}")
    if tree and depth > TREE_MAX_DEPTH:
        raise ValueError(f"tree depth {depth} > TREE_MAX_DEPTH "
                         f"({TREE_MAX_DEPTH})")
    K = n_tree_nodes(depth) if tree else depth + 1
    entry = "render_tree_residuals" if tree else "render_chain_residuals"
    out = _render(entry, render_residuals_ref, tables, v, eye,
                  extra_shape=(2 + nl, K, v.shape[0]),
                  plain_kw=dict(tree=tree), **kw)
    if v.device.type == "cpu":
        return out
    img, buf = out
    return img, dict(bi=buf[0], mid=buf[1], lit=buf[2:])


def _pack_fields(nt: int, ns: int, m: int) -> Tuple[int, int]:
    """(bw_bi, bw_mid): the powers of two above the primitive ids + 2 and
    the material ids + 1."""
    bw_bi = 1
    while bw_bi < nt + ns + 2:
        bw_bi *= 2
    bw_mid = 1
    while bw_mid < m + 1:
        bw_mid *= 2
    return bw_bi, bw_mid


def pack_fits(nt: int, ns: int, m: int, nl: int) -> bool:
    """Whether ``pack_widths`` holds the scene (no 2^24 overflow)."""
    bw_bi, bw_mid = _pack_fields(nt, ns, m)
    return bw_bi * bw_mid * (2 ** nl) <= 2 ** 24


def pack_widths(nt: int, ns: int, m: int, nl: int) -> Tuple[float, float]:
    """Field widths (bw_bi, bw_mid) of the single-plane packed residual: one
    f32 holds ``(bi+1) + mid*bw_bi + lit_bits*bw_bi*bw_mid`` exactly (every
    field a small integer; powers of two, so unpacking multiplies exactly).
    Raises if the scene exceeds the 2^24 f32 exact-integer budget
    (render_pallas.py::pack_widths).  Only K3/K4 (``render_packed``,
    ``adjoint_packed``) take the pack."""
    bw_bi, bw_mid = _pack_fields(nt, ns, m)
    if not pack_fits(nt, ns, m, nl):
        raise ValueError(
            f"packed residual overflows f32 exact integers: "
            f"{nt + ns} primitives x {m} materials x {nl} lights")
    return float(bw_bi), float(bw_mid)


def unpack_residuals(pk: torch.Tensor, nl: int,
                     pack: Tuple[float, float]) -> Dict[str, torch.Tensor]:
    """[depth+1, ...] packed residuals -> ``bi`` (hit primitive id, -1 on a
    miss), ``mid`` (resolved material id) and ``lit`` ([nl, depth+1, ...]
    0/1 shadow flags) planes, as f32 — the arithmetic of
    adjoint_fused.py::_unpack_residuals, exact by construction."""
    bw_bi, bw_mid = pack
    hi = torch.trunc(pk * (1.0 / (bw_bi * bw_mid)))   # the lit bit field
    rem = pk - hi * (bw_bi * bw_mid)
    mid = torch.trunc(rem * (1.0 / bw_bi))
    biq = rem - mid * bw_bi
    lits = []
    for _ in range(nl):
        nxt = torch.trunc(hi * 0.5)
        lits.append(hi - nxt * 2.0)
        hi = nxt
    lit = torch.stack(lits) if lits else pk.new_zeros((0, *pk.shape))
    return dict(bi=biq - 1.0, mid=mid, lit=lit)


# ------------------------------------------------------------- full frame

def render_kwargs(scene: FlatScene, config: RenderConfig) -> dict:
    """The scene- and config-derived keyword arguments of ``render_chain``
    and ``render_tree``: ``bf16`` is ``config.bf16_shading``."""
    return dict(nl=scene.num_lights, depth=config.max_depth,
                small=config.small_number, atten=config.attenuation_factor,
                checker_mats=scene.checker_mats,
                want_trans=bool(scene.has_transmission),
                bf16=bool(config.bf16_shading))


def render_forward_with_residuals(scene: FlatScene, camera,
                                  config: RenderConfig, *, pts=None,
                                  device=None):
    """Single-sample forward with the fixed-topology residuals the replay
    adjoints read: ``(img [H,W,3], dict(bi, mid [K,H,W], lit [nl,K,H,W]))``,
    on ``device`` (the GPU by default; ``"cpu"`` runs the plain version).
    The counterpart of render_pallas.py::render_forward_with_residuals.
    Chain-exact scenes take the chain kernel (K = depth+1 levels), the
    others the tree kernel (K = 2^(depth+1)-1 preorder nodes).  ``pts``:
    screen points [H*W,3] in place of the camera's own.  Nothing here is
    differentiated: the scene and camera are read as constants.  Under
    ``config.bf16_shading`` the forward is the bf16 one, so the residuals
    are its topology."""
    if config.samples != 1 or config.force_jitter:
        raise ValueError("residual forward supports exactly one sample")
    device = resolve_device(device)
    w, h = config.width, config.height
    with torch.no_grad():
        scene = compact_scene(scene.to(device))
        if isinstance(camera, CameraConfig):
            camera = Camera.from_config(camera, w, h, device=device)
        else:
            camera = camera.to(device)
        if pts is None:
            pts = screen_points(camera, w, h)
        _, v = primary_rays(camera, torch.as_tensor(pts, device=device))
        img, res = render_residuals(pack_scene(scene), v.contiguous(),
                                    camera.eye.tolist(),
                                    tree=not scene.chain_exact,
                                    **render_kwargs(scene, config))
    return img.reshape(h, w, 3), {k: t.reshape(*t.shape[:-1], h, w)
                                  for k, t in res.items()}


def render_image_kernel(scene: FlatScene, camera, config: RenderConfig, *,
                        generator: Optional[torch.Generator] = None,
                        jitter: Optional[torch.Tensor] = None,
                        pts=None, device=None) -> torch.Tensor:
    """Full-frame render -> [H,W,3] f32 (row j=0 the bottom scanline), on
    ``device``: the GPU by default (raising where there is none);
    ``device="cpu"`` runs the kernels' plain versions.  The counterpart of
    ``render_pallas.py::render_image_pallas``.

    Chain-exact scenes take the chain kernel, the others the tree kernel
    (``config.mode`` "chain"/"tree" forces one).  With ``samples > 1`` or
    ``force_jitter`` each sample jitters the screen points: by
    ``jitter[k]`` when the [S, H*W, 3] ``jitter`` is given (e.g. the JAX
    package's draws, for per-pixel parity), else by draws from
    ``generator`` (default: seeded with ``config.seed``).  ``adaptive``
    emulates the reference's adaptive supersampler
    (MySdlApplication.cpp:1294-1311) exactly as the JAX package does.
    ``config.bf16_shading`` runs the kernels' bf16 instantiations (the
    any-hit shadow sweep and the Phong blend in bfloat16, ``_PlainOps``).
    ``pts``: screen points [H*W,3] in place of the camera's own; a row
    band (parallel/shard.py) passes its rows' points with a config whose
    ``height`` is the band's, and its samples jitter those points."""
    device = resolve_device(device)
    scene = scene.to(device)
    w, h = config.width, config.height
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, w, h, device=device)
    else:
        camera = camera.to(device)
    tree = config.resolved_mode(scene.chain_exact) == "tree"
    render = render_tree if tree else render_chain
    tables = pack_scene(scene)
    eye = camera.eye.tolist()
    kw = render_kwargs(scene, config)
    if pts is None:
        pts = screen_points(camera, w, h)
    else:
        pts = torch.as_tensor(pts, dtype=torch.float32, device=device)
        if tuple(pts.shape) != (h * w, 3):
            raise ValueError(f"pts must be [{h * w}, 3] for a {h}x{w} "
                             f"config, got {tuple(pts.shape)}")
    P = pts.shape[0]

    def one_sample(pts_s):
        _, v = primary_rays(camera, pts_s)
        return render(tables, v.contiguous(), eye, **kw).reshape(h, w, 3)

    if not (config.samples > 1 or config.force_jitter):
        return one_sample(pts)
    S = config.samples
    jitter_k = jitter_source(config, P, pts.dtype, device, jitter=jitter,
                             generator=generator)
    if not config.adaptive:
        total = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
        for k in range(S):
            total = total + one_sample(pts + jitter_k(k))
        return total / S

    # Once every pixel has converged the later samples change nothing and
    # are not rendered.
    accum = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    divisor = torch.full((h, w), float(S), dtype=torch.float32,
                         device=device)
    done = torch.zeros((h, w), dtype=torch.bool, device=device)
    for k in range(S):
        accum, divisor, done, _ = adaptive_step(
            k, one_sample(pts + jitter_k(k)), accum, divisor, done,
            config.small_number)
        if bool(done.all()):
            break
    return accum / divisor[..., None]
