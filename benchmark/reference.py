"""The plain reference that decides ``correct``: the bounce chain's forward,
its fixed-topology replay differentiated by ``torch.autograd``, the L2 loss
and gradients of a fit step, and the Adam update, in plain PyTorch float32.

It is a frozen copy of the program's plain versions as they stood when the
benchmark was written (the per-pixel device functions of the chain forward
and the replay of its residuals), so a later change to the program cannot
move it, and it imports nothing of the program: it makes every table, ray
and target again from the benchmark's own arrays.  Sums over pixels (the
loss, the gradient tables) accumulate in float64.

Semantics: a ray's nearest hit over the scene's triangles then spheres
(strict <, the primitive it starts on excluded), Phong shading with
distance attenuation and any-hit hard shadows, the reflected child of each
hit (the scenes here are chain-exact and opaque), no bounding-sphere prune
(as the program's kernels).  Gradients are those of the loss with the hit
topology fixed: hit or miss, shadows and checker parity carry none.

The forward runs in blocks of pixels and loops over primitives, so its
memory is a few [block] planes; the replay runs on the live pixels only
(those whose colour differs from the target), in blocks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

BIG = 3.0e38
#: pixels a block of the forward, and of the replay
BLOCK = 1 << 22
#: the fit's parameter leaves, in order
LEAVES = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient")


def _f32(x) -> float:
    return float(np.float32(x))


# ------------------------------------------------------------------ camera

def _normalize(v: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(v * v, dim=-1)
    ok = sq > 0.0
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, sq, 1.0)),
                      torch.zeros_like(sq))
    return v * inv.unsqueeze(-1)


def primary_rays(camera: dict, width: int, height: int, device,
                 rows: Optional[Tuple[int, int]] = None):
    """(eye [3] as Python floats of its float32 values, directions [P,3]):
    the screen anchored at ``look_at``, ``pixel_scale`` world units a pixel,
    row 0 the bottom scanline; ``rows`` (start, stop) a band of rows."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    scale = camera["pixel_scale"]
    eye, look_at, up = f(camera["eye"]), f(camera["look_at"]), f(camera["up"])
    bx = f(-width * scale / 2.0)
    by = f(-height * scale / 2.0)
    look = look_at - eye
    right = _normalize(torch.linalg.cross(look, up, dim=-1))
    up2 = _normalize(torch.linalg.cross(right, look, dim=-1))
    base = look_at + bx * right + by * up2
    r0, r1 = rows if rows is not None else (0, height)
    j = torch.arange(r0, r1, dtype=torch.float32, device=device)
    i = torch.arange(width, dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    s = f(scale)
    pts = (base[None, :] + (ii.reshape(-1) * s)[:, None] * right[None, :]
           + (jj.reshape(-1) * s)[:, None] * up2[None, :])
    return [_f32(e) for e in eye.tolist()], (pts - eye).contiguous()


# ------------------------------------------------------------------ tables

def tables(arrays: Dict[str, np.ndarray], leaves: Dict[str, torch.Tensor],
           device) -> dict:
    """The forward's tables: the scene's valid triangles (their planes and
    barycentric terms) and valid spheres, materials and lights, with the
    fit's leaves (``LEAVES``, float32 tensors) in place of the scene's."""
    tv = np.asarray(arrays["tri_valid"], bool)
    sv = np.asarray(arrays["sph_valid"], bool)
    t = lambda k: torch.as_tensor(np.asarray(arrays[k])[tv],
                                  dtype=torch.float32, device=device)
    v0, v1, v2 = t("tri_v0"), t("tri_v1"), t("tri_v2")
    u, v = v1 - v0, v2 - v0
    n_raw = torch.linalg.cross(u, v, dim=-1)
    n_len = torch.sqrt(torch.clamp(torch.sum(n_raw * n_raw, -1), min=1e-30))
    n = n_raw / n_len[..., None]
    uv, uu, vv = (torch.sum(a * b, -1) for a, b in ((u, v), (u, u), (v, v)))
    den = uv * uv - uu * vv
    degenerate = (n_len < 1e-4) | (torch.abs(den) < 1e-4)
    nv0 = torch.sum(n * v0, -1)
    tri = torch.cat([v0, n, u, v, uv[:, None], uu[:, None], vv[:, None],
                     den[:, None], nv0[:, None]], 1).tolist()
    with np.errstate(divide="ignore"):
        inv_den = [_f32(np.float32(1.0) / np.float32(r[15])) for r in tri]
    tri_ok = (~degenerate).tolist()
    tri_mat = np.asarray(arrays["tri_mat"])[tv].tolist()
    tri_chk = np.asarray(arrays["tri_checker"])[tv].tolist()

    lv = {k: leaves[k].detach().to(device=device, dtype=torch.float32)
          for k in LEAVES}
    sidx = torch.as_tensor(np.nonzero(sv)[0], device=device)
    center = lv["sph_center"][sidx].tolist()
    radius = lv["sph_radius"][sidx].tolist()
    rr = [_f32(np.float32(r) * np.float32(r)) for r in radius]
    sph_mat = np.asarray(arrays["sph_mat"])[sv].tolist()

    T = torch.as_tensor(arrays["mat_transparency"], dtype=torch.float32,
                        device=device)
    rho = torch.as_tensor(arrays["mat_refraction"], dtype=torch.float32,
                          device=device)
    t_any = torch.any(T != 0.0, -1)
    take_t = t_any & (torch.sqrt(torch.sum(T * T, -1)) > 1e-4)
    refl_ok = torch.any((1.0 - T) != 0.0, -1)
    mat = torch.cat([lv["mat_ambient"], lv["mat_diffuse"], lv["mat_specular"],
                     T, rho[:, None], take_t[:, None].float(),
                     refl_ok[:, None].float()], 1)
    board = np.asarray(arrays["board_pos"], np.float32)
    half = float(np.float32(arrays["board_half"]))
    sq = np.float32(arrays["board_square"])
    nl = int(np.asarray(arrays["light_pos"]).shape[0])
    return dict(
        tri=tri, inv_den=inv_den, tri_ok=tri_ok, tri_mat=tri_mat,
        tri_chk=tri_chk, sph=center, rad=radius, rr=rr, sph_mat=sph_mat,
        nt=len(tri), ns=len(center), mat=mat, nl=nl,
        light=lv["light_pos"].tolist(),
        light_color=np.asarray(arrays["light_color"], np.float32).tolist(),
        want_trans=bool(t_any.any()), board_x=float(board[0]),
        board_z=float(board[2]), board_half=half,
        inv_sq=_f32(np.float32(1.0) / sq))


# ------------------------------------------------------------ the forward

class _Sweeps:
    """The forward's per-pixel functions over a block of P pixels."""

    def __init__(self, tab: dict, P: int, device, small: float,
                 atten: float):
        self.t, self.P, self.dev = tab, P, device
        self.small, self.atten = small, atten
        f = lambda rows, k: torch.tensor(rows or [[0.0] * k],
                                         dtype=torch.float32, device=device)
        self.tri_attr = f([[r[3], r[4], r[5], m, c] for r, m, c in
                           zip(tab["tri"], tab["tri_mat"], tab["tri_chk"])], 5)
        self.sph_attr = f([[*c, m] for c, m in
                           zip(tab["sph"], tab["sph_mat"])], 4)
        #: with ``count``: primitive tests per sweep kind, on the device
        self.tests: Optional[Dict[str, torch.Tensor]] = None

    def full(self, x) -> torch.Tensor:
        return torch.full((self.P,), x, dtype=torch.float32, device=self.dev)

    def tri_hit(self, i, ox, oy, oz, vx, vy, vz, ok, excl):
        t, small = self.t["tri"][i], self.small
        ndv = t[3] * vx + t[4] * vy + t[5] * vz
        plane_ok = torch.abs(ndv) >= small
        ndo = t[3] * ox + t[4] * oy + t[5] * oz
        mm = (t[16] - ndo) * (1.0 / torch.where(plane_ok, ndv, 1.0))
        px = ox + mm * vx - t[0]
        py = oy + mm * vy - t[1]
        pz = oz + mm * vz - t[2]
        wu = px * t[6] + py * t[7] + pz * t[8]
        wv = px * t[9] + py * t[10] + pz * t[11]
        inv = self.t["inv_den"][i]
        sb = (t[12] * wv - t[14] * wu) * inv
        tb = (t[12] * wu - t[13] * wv) * inv
        hit = (plane_ok & (mm >= small) & (sb >= 0.0) & (tb >= 0.0)
               & (sb + tb <= 1.0) & ok & (excl != float(i)))
        return hit, mm

    def sph_hit(self, i, ox, oy, oz, ux, uy, uz, ok, excl):
        c = self.t["sph"][i]
        dx, dy, dz = c[0] - ox, c[1] - oy, c[2] - oz
        ud = ux * dx + uy * dy + uz * dz
        disc = ud * ud - (dx * dx + dy * dy + dz * dz) + self.t["rr"][i]
        disc_ok = disc > 0.0
        s = ud - torch.sqrt(torch.where(disc_ok, disc, 1.0)) * disc_ok.float()
        hit = ((disc >= 0.0) & (s >= self.small) & ok
               & (excl != float(i + self.t["nt"])))
        return hit, s

    def _unit(self, vx, vy, vz, ray_ok):
        vlen2 = vx * vx + vy * vy + vz * vz
        ok = ray_ok & (vlen2 > 0.0)
        inv = torch.rsqrt(torch.where(ok, vlen2, 1.0))
        return ok, vlen2 * inv, vx * inv, vy * inv, vz * inv

    def closest(self, ox, oy, oz, vx, vy, vz, excl, ray_ok):
        ok, vlen, ux, uy, uz = self._unit(vx, vy, vz, ray_ok)
        nt = self.t["nt"]
        if self.tests is not None:
            n = ray_ok.sum()
            self.tests["visits"] += n
            self.tests["tri"] += sum(self.t["tri_ok"]) * n - (
                ray_ok & (excl >= 0) & (excl < nt)).sum()
            self.tests["sph"] += self.t["ns"] * n - (
                ray_ok & (excl >= nt)).sum()
        bd, bi, bm = self.full(BIG), self.full(-1.0), self.full(0.0)
        for i in range(nt):
            if not self.t["tri_ok"][i]:
                continue
            hit, mm = self.tri_hit(i, ox, oy, oz, vx, vy, vz, ok, excl)
            dist = torch.where(hit, mm * vlen, BIG)
            upd = dist < bd
            bd = torch.where(upd, dist, bd)
            bi = torch.where(upd, float(i), bi)
            bm = torch.where(upd, mm, bm)
        for i in range(self.t["ns"]):
            hit, s = self.sph_hit(i, ox, oy, oz, ux, uy, uz, ok, excl)
            dist = torch.where(hit, s, BIG)
            upd = dist < bd
            bd = torch.where(upd, dist, bd)
            bi = torch.where(upd, float(i + nt), bi)
        return bd, bi, bm, ux, uy, uz

    def occluded(self, ox, oy, oz, vx, vy, vz, excl, ray_ok):
        """Any hit before the end of the list; with ``tests``, the tests
        up to each lane's first occluder (triangles first)."""
        ok, _, ux, uy, uz = self._unit(vx, vy, vz, ray_ok)
        occ = torch.zeros_like(ok)
        nt = self.t["nt"]
        for i in range(nt):
            if not self.t["tri_ok"][i]:
                continue
            if self.tests is not None:
                self.tests["shadow_tri"] += (ok & ~occ
                                             & (excl != float(i))).sum()
            occ = occ | self.tri_hit(i, ox, oy, oz, vx, vy, vz, ok, excl)[0]
        for i in range(self.t["ns"]):
            if self.tests is not None:
                self.tests["shadow_sph"] += (ok & ~occ
                                             & (excl != float(i + nt))).sum()
            occ = occ | self.sph_hit(i, ox, oy, oz, ux, uy, uz, ok, excl)[0]
        return occ

    def hit_attrs(self, bd, bi, mm, hitm, ox, oy, oz, vx, vy, vz, ux, uy,
                  uz):
        t, nt = self.t, self.t["nt"]
        is_t = (bi >= 0.0) & (bi < nt)
        is_s = bi >= nt
        trow = self.tri_attr[torch.where(is_t, bi, 0.0).long()]
        srow = self.sph_attr[torch.where(is_s, bi - nt, 0.0).long()]
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
        fx = torch.trunc((px - t["board_x"] + t["board_half"]) * t["inv_sq"])
        fz = torch.trunc((pz - t["board_z"] + t["board_half"]) * t["inv_sq"])
        s_par = fx + fz
        even = torch.trunc(s_par * 0.5) * 2.0 == s_par
        is_chk = is_tri & (tchk > 0.5)
        mid = torch.where(is_chk, torch.where(even, 0.0, 1.0), mid)
        return px, py, pz, nx, ny, nz, mid

    def node(self, o, d, excl, alive, thr, col):
        """One bounce level: (hitm, bi, point, material rows, reflected
        direction, colour, mid, lit flags)."""
        ox, oy, oz = o
        vx, vy, vz = d
        bd, bi, mm, ux, uy, uz = self.closest(ox, oy, oz, vx, vy, vz, excl,
                                              alive)
        hitm = (bd < BIG) & alive
        if self.tests is not None:
            self.tests["hits"] += hitm.sum()
        px, py, pz, nx, ny, nz, mid = self.hit_attrs(
            bd, bi, mm, hitm, ox, oy, oz, vx, vy, vz, ux, uy, uz)
        mats = self.t["mat"][mid.long()]
        cosi = ux * nx + uy * ny + uz * nz
        rx, ry, rz = (ux - 2.0 * cosi * nx, uy - 2.0 * cosi * ny,
                      uz - 2.0 * cosi * nz)
        cr, cg, cb = col
        tr, tg, tb = thr
        lits = []
        for (lx, ly, lz), (lr, lg, lb) in zip(self.t["light"],
                                              self.t["light_color"]):
            svx, svy, svz = lx - px, ly - py, lz - pz
            lit = ~self.occluded(px, py, pz, svx, svy, svz, bi, hitm)
            lits.append(lit)
            d2 = svx * svx + svy * svy + svz * svz
            att = self.atten / (self.atten + d2)
            inv_sl = torch.rsqrt(torch.where(d2 > 0.0, d2, 1.0))
            ndots = torch.abs(nx * svx + ny * svy + nz * svz) * inv_sl
            udotr = torch.abs(ux * rx + uy * ry + uz * rz)
            w = torch.where(lit & hitm, att, 0.0)
            cr = cr + (tr * w * (mats[:, 0] + ndots * mats[:, 3]
                                 + udotr * mats[:, 6]) * lr)
            cg = cg + (tg * w * (mats[:, 1] + ndots * mats[:, 4]
                                 + udotr * mats[:, 7]) * lg)
            cb = cb + (tb * w * (mats[:, 2] + ndots * mats[:, 5]
                                 + udotr * mats[:, 8]) * lb)
        return hitm, bi, (px, py, pz), mats, (rx, ry, rz), (cr, cg, cb), \
            mid, lits


def trace(tab: dict, eye, v: torch.Tensor, *, depth: int,
          small: float = 1e-4, atten: float = 1e5, count: bool = False):
    """The bounce chain over depth+1 levels for the primary directions
    ``v`` [P,3] from ``eye``, in blocks of ``BLOCK`` pixels: (image [P,3],
    topology dict(bi [D+1,P] int16, -1 where the level misses or is not
    traced; mid [D+1,P] int16; lit [L,D+1,P] bool), counts or None).
    ``count`` adds the primitive tests the sweeps run (``opcount``'s
    inputs)."""
    if tab["want_trans"]:
        raise ValueError("the reference traces opaque chain scenes only")
    P, dev = v.shape[0], v.device
    imgs, bis, mids, lits_all = [], [], [], []
    tests = None
    if count:
        tests = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in
                 ("visits", "tri", "sph", "hits", "shadow_tri",
                  "shadow_sph")}
    for s in range(0, P, BLOCK):
        vb = v[s:s + BLOCK]
        n = vb.shape[0]
        sw = _Sweeps(tab, n, dev, small, atten)
        sw.tests = tests
        o = tuple(sw.full(e) for e in eye)
        d = (vb[:, 0], vb[:, 1], vb[:, 2])
        thr = (sw.full(1.0),) * 3
        col = (sw.full(0.0),) * 3
        excl = sw.full(-1.0)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        bl, ml, ll = [], [], []
        for _ in range(depth + 1):
            hitm, bi, p, mats, refl, col, mid, lits = sw.node(
                o, d, excl, alive, thr, col)
            bl.append(torch.where(hitm, bi, -1.0).to(torch.int16))
            ml.append(mid.to(torch.int16))
            ll.append(torch.stack(lits) if lits else
                      torch.zeros((0, n), dtype=torch.bool, device=dev))
            # opaque materials: the reflected child, weighted 1 - T
            thr = tuple(t * (1.0 - mats[:, 9 + c]) for c, t in enumerate(thr))
            alive = hitm & (mats[:, 14] > 0.5)
            o, d, excl = p, refl, bi
        imgs.append(torch.stack(col, -1))
        bis.append(torch.stack(bl))
        mids.append(torch.stack(ml))
        lits_all.append(torch.stack(ll, 1))
    topo = dict(bi=torch.cat(bis, 1), mid=torch.cat(mids, 1),
                lit=torch.cat(lits_all, 2))
    counts = ({k: int(t) for k, t in tests.items()} if tests is not None
              else None)
    return torch.cat(imgs, 0), topo, counts


def render(arrays, leaves, camera: dict, width: int, height: int, *,
           depth: int, device, rows: Optional[Tuple[int, int]] = None,
           count: bool = False):
    """A frame (or the band of ``rows``) of the scene ``arrays`` with the
    fit ``leaves``: (image [P,3], topology, counts), P = rows x width."""
    tab = tables(arrays, leaves, device)
    eye, v = primary_rays(camera, width, height, device, rows)
    with torch.no_grad():
        return trace(tab, eye, v, depth=depth, count=count)


def scene_leaves(arrays, device) -> Dict[str, torch.Tensor]:
    """The scene's own values of the fit's leaves, float32 on ``device``."""
    return {k: torch.as_tensor(np.asarray(arrays[k]), dtype=torch.float32,
                               device=device) for k in LEAVES}


# ------------------------------------------------------------- the replay

class _Rows(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's cotangents in float64."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=torch.float64, device=g.device)
        out.index_add_(0, idx, g.double())
        return out.to(g.dtype), None


class _Spread(torch.autograd.Function):
    """A row broadcast over [P, k], its backward summed in float64."""

    @staticmethod
    def forward(ctx, row, P):
        return row[None, :].expand(P, row.shape[0]).clone()

    @staticmethod
    def backward(ctx, g):
        return g.double().sum(0).to(g.dtype), None


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _take(table, idx, sel):
    rows = _Rows.apply(table, idx.clamp(0, table.shape[0] - 1).long())
    mask = sel.reshape(-1, *([1] * (table.dim() - 1)))
    return torch.where(mask, rows, torch.zeros_like(rows))


def _safe_sqrt(x, ok):
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)),
                       torch.zeros_like(x))


def _safe_div(a, b, ok):
    q = a / torch.where(ok, b, torch.ones_like(b))
    return torch.where(ok, q, torch.zeros_like(q))


def replay_geom(arrays, leaves: Dict[str, torch.Tensor], device) -> dict:
    """The replay's tables, differentiable in ``leaves``: triangle planes,
    the valid spheres' centres and radii, the materials, the lights."""
    tv = np.asarray(arrays["tri_valid"], bool)
    sv = np.asarray(arrays["sph_valid"], bool)
    t = lambda k: torch.as_tensor(np.asarray(arrays[k])[tv],
                                  dtype=torch.float32, device=device)
    v0, v1, v2 = t("tri_v0"), t("tri_v1"), t("tri_v2")
    n_raw = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    n = n_raw / torch.sqrt(torch.clamp(torch.sum(n_raw * n_raw, -1),
                                       min=1e-30))[..., None]
    sidx = torch.as_tensor(np.nonzero(sv)[0], device=device)
    return dict(tri_n=n, tri_nv0=torch.sum(n * v0, -1),
                sph_center=leaves["sph_center"][sidx],
                sph_radius=leaves["sph_radius"][sidx],
                mat_ambient=leaves["mat_ambient"],
                mat_diffuse=leaves["mat_diffuse"],
                mat_specular=leaves["mat_specular"],
                mat_transparency=torch.as_tensor(
                    arrays["mat_transparency"], dtype=torch.float32,
                    device=device),
                light_pos=leaves["light_pos"],
                light_color=torch.as_tensor(arrays["light_color"],
                                            dtype=torch.float32,
                                            device=device))


def _node(geom, o, v, bik, midl, lits, atten: float):
    """One level's colour, hit point and reflected direction with the
    level's topology pinned (a level that misses adds nothing)."""
    nt = geom["tri_n"].shape[0]
    hitm = bik >= 0.0
    is_tri = bik < nt
    is_s = bik >= nt
    vlen2 = _dot(v, v)
    ray_ok = vlen2 > 0.0
    vlen = _safe_sqrt(vlen2, ray_ok)
    u = v * _safe_div(torch.ones_like(vlen), vlen, ray_ok)[:, None]
    n_sel = _take(geom["tri_n"], bik, hitm & is_tri)
    nv0_sel = _take(geom["tri_nv0"], bik, hitm & is_tri)
    ndv = _dot(n_sel, v)
    m_par = _safe_div(nv0_sel - _dot(n_sel, o), ndv, torch.abs(ndv) > 0.0)
    c_sel = _take(geom["sph_center"], bik - nt, is_s)
    r_sel = _take(geom["sph_radius"], bik - nt, is_s)
    d = c_sel - o
    ud = _dot(u, d)
    disc = ud * ud - _dot(d, d) + r_sel * r_sel
    dist_sph = ud - _safe_sqrt(disc, disc > 0.0)
    k = torch.where(hitm, torch.where(is_tri, m_par, dist_sph), 0.0)
    p = o + k[:, None] * torch.where(is_tri[:, None], v, u)
    d0 = p - c_sel
    d0sq = _dot(d0, d0)
    n_sph = d0 * _safe_div(torch.ones_like(d0sq),
                           _safe_sqrt(d0sq, d0sq > 0.0), d0sq > 0.0)[:, None]
    n = torch.where(is_tri[:, None], n_sel, n_sph)
    n = torch.where(hitm[:, None], n, torch.zeros_like(n))
    mi = midl.long()
    amb, dif, spe, trn = (_Rows.apply(geom[k], mi) for k in
                          ("mat_ambient", "mat_diffuse", "mat_specular",
                           "mat_transparency"))
    cosi = _dot(u, n)
    refl = u - (2.0 * cosi)[:, None] * n
    local = torch.zeros_like(p)
    udotr = torch.abs(_dot(u, refl))
    for li in range(geom["light_pos"].shape[0]):
        sv = _Spread.apply(geom["light_pos"][li], p.shape[0]) - p
        d2 = _dot(sv, sv)
        att = atten / (atten + d2)
        inv_sl = _safe_div(torch.ones_like(d2), _safe_sqrt(d2, d2 > 0.0),
                           d2 > 0.0)
        ndots = torch.abs(_dot(n, sv)) * inv_sl
        wgt = torch.where(lits[li] & hitm, att, 0.0)
        contrib = amb + ndots[:, None] * dif + udotr[:, None] * spe
        local = local + (wgt[:, None] * contrib
                         * geom["light_color"][li][None, :])
    return local, p, refl, trn, hitm


def replay(geom, eye, v, bi, mid, lit, *, depth: int, atten: float = 1e5):
    """Differentiable colour [Q,3] of the chain from ``eye`` along ``v``
    [Q,3], its topology pinned by ``bi``/``mid`` [D+1,Q] and ``lit``
    [L,D+1,Q]."""
    o = torch.tensor(eye, dtype=torch.float32,
                     device=v.device)[None, :].expand(v.shape[0], 3)
    color = torch.zeros_like(v)
    thr = torch.ones_like(v)
    for level in range(depth + 1):
        local, p, refl, trn, hitm = _node(geom, o, v, bi[level].float(),
                                          mid[level], lit[:, level], atten)
        color = color + thr * local
        if level < depth:
            thr = thr * torch.where(hitm[:, None], 1.0 - trn,
                                    torch.ones_like(trn))
            o = p
            v = torch.where(hitm[:, None], refl, torch.zeros_like(refl))
    return color


def loss_and_grads(arrays, leaves: Dict[str, torch.Tensor], camera: dict,
                   width: int, height: int, target: torch.Tensor, *,
                   depth: int, rows: Optional[Tuple[int, int]] = None,
                   denom: Optional[float] = None):
    """(loss, gradients by leaf as float64, live pixels) of ``sum((image -
    target)^2) / denom`` (default: the frame's 3 H W) at ``leaves``:
    the forward gives the image and its topology, the replay of the live
    pixels (whose colour differs from the target) the gradients.  ``rows``
    restricts the image to a band of rows (``target`` is then the band's)."""
    device = target.device
    tab = tables(arrays, leaves, device)
    eye, v = primary_rays(camera, width, height, device, rows)
    with torch.no_grad():
        img, topo, _ = trace(tab, eye, v, depth=depth)
    tgt = target.reshape(-1, 3).to(torch.float32)
    diff = img - tgt
    denom = float(3 * width * height) if denom is None else float(denom)
    loss = float((diff.double() ** 2).sum()) / denom
    live = torch.nonzero((diff != 0.0).any(-1)).flatten()
    lv = {k: leaves[k].detach().to(device=device, dtype=torch.float32)
          .clone().requires_grad_(True) for k in LEAVES}
    scale = 2.0 / denom
    for s in range(0, live.shape[0], BLOCK):
        ids = live[s:s + BLOCK]
        geom = replay_geom(arrays, lv, device)
        color = replay(geom, eye, v[ids], topo["bi"][:, ids],
                       topo["mid"][:, ids], topo["lit"][:, :, ids],
                       depth=depth)
        color.backward(scale * diff[ids])
    grads = {k: (lv[k].grad if lv[k].grad is not None
                 else torch.zeros_like(lv[k])).double() for k in LEAVES}
    return loss, grads, int(live.shape[0])


# ---------------------------------------------------------------- Adam

class Adam:
    """``torch.optim.Adam``'s update with its defaults (betas 0.9, 0.999,
    eps 1e-8, no decay), a learning rate a leaf, in float32."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lrs: Dict[str, float]):
        self.lrs = lrs
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.t += 1
        out = {}
        bc1 = 1.0 - self.B1 ** self.t
        bc2 = 1.0 - self.B2 ** self.t
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m = self.m.get(k, torch.zeros_like(p))
            v = self.v.get(k, torch.zeros_like(p))
            m = m + (g - m) * (1.0 - self.B1)
            v = v * self.B2 + g * g * (1.0 - self.B2)
            self.m[k], self.v[k] = m, v
            den = torch.sqrt(v) / (bc2 ** 0.5) + self.EPS
            out[k] = p - (self.lrs[k] / bc1) * (m / den)
        return out
