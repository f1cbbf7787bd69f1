"""NumPy/CPU oracle renderer, the port's own copy.

An *independent* float64 implementation of the reference ray tracer's
semantics (recursive per-ray, same call structure as ``rayTraceRay`` /
``rayTraceScreen``, Hw4/MySdlApplication.cpp:1184-1324), used as the
correctness oracle for the renderers and, through ``gradcheck.py``, the
referee of the BASELINE gradient bar.  Deliberately written with
per-primitive deltaP vector math, so the oracle and the kernels only share
the FlatScene data, not code paths.

The JAX package's ``oracle/numpy_ref.py``, line for line, reading the
port's ``FlatScene`` (torch tensors, on any device) instead of JAX's: it
imports numpy and the port's config only, so it runs where there is no JAX
(the card's machine; ``grad_bar.py``).  It adds ``oracle_pixels`` and
``trace_ray``'s walk of the later bounces that meet the board on a
checker square's edge, where a float32 render may take either square.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np

from ..config import CameraConfig, RenderConfig
from ..scene.flat import FlatScene


def as_numpy(x) -> np.ndarray:
    """A tensor (on any device, grad or not) or an array as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class OracleScene:
    sph_center: np.ndarray
    sph_radius: np.ndarray
    sph_mat: np.ndarray
    sph_group: np.ndarray
    tri_v0: np.ndarray
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_mat: np.ndarray
    tri_checker: np.ndarray
    tri_group: np.ndarray
    grp_center: np.ndarray
    grp_radius: np.ndarray
    mat_ambient: np.ndarray
    mat_diffuse: np.ndarray
    mat_specular: np.ndarray
    mat_transparency: np.ndarray
    mat_refraction: np.ndarray
    light_pos: np.ndarray
    light_color: np.ndarray
    board_pos: np.ndarray
    board_half: float
    board_square: float
    checker_mats: tuple
    # triangle derived (Triangle ctor, MySdlApplication.cpp:406-433)
    tri_u: np.ndarray = None
    tri_v: np.ndarray = None
    tri_n: np.ndarray = None
    tri_uv: np.ndarray = None
    tri_uu: np.ndarray = None
    tri_vv: np.ndarray = None
    tri_den: np.ndarray = None
    tri_degenerate: np.ndarray = None

    @classmethod
    def from_flat(cls, scene: FlatScene, dtype=np.float64,
                  small: float = 1e-4) -> "OracleScene":
        f = lambda x: as_numpy(x).astype(dtype)  # noqa: E731
        tv = as_numpy(scene.tri_valid)
        sv = as_numpy(scene.sph_valid)
        sc = cls(
            sph_center=f(scene.sph_center)[sv], sph_radius=f(scene.sph_radius)[sv],
            sph_mat=as_numpy(scene.sph_mat)[sv], sph_group=as_numpy(scene.sph_group)[sv],
            tri_v0=f(scene.tri_v0)[tv], tri_v1=f(scene.tri_v1)[tv],
            tri_v2=f(scene.tri_v2)[tv], tri_mat=as_numpy(scene.tri_mat)[tv],
            tri_checker=as_numpy(scene.tri_checker)[tv],
            tri_group=as_numpy(scene.tri_group)[tv],
            grp_center=f(scene.grp_center), grp_radius=f(scene.grp_radius),
            mat_ambient=f(scene.mat_ambient), mat_diffuse=f(scene.mat_diffuse),
            mat_specular=f(scene.mat_specular),
            mat_transparency=f(scene.mat_transparency),
            mat_refraction=f(scene.mat_refraction),
            light_pos=f(scene.light_pos), light_color=f(scene.light_color),
            board_pos=f(scene.board_pos), board_half=float(scene.board_half),
            board_square=float(scene.board_square),
            checker_mats=scene.checker_mats,
        )
        u = sc.tri_v1 - sc.tri_v0
        v = sc.tri_v2 - sc.tri_v0
        n = np.cross(u, v)
        nlen = np.linalg.norm(n, axis=-1)
        degenerate = nlen < small
        n = n / np.where(nlen > 0, nlen, 1.0)[:, None]
        uv = np.sum(u * v, -1); uu = np.sum(u * u, -1); vv = np.sum(v * v, -1)
        den = uv * uv - uu * vv
        degenerate |= np.abs(den) < small
        sc.tri_u, sc.tri_v, sc.tri_n = u, v, n
        sc.tri_uv, sc.tri_uu, sc.tri_vv, sc.tri_den = uv, uu, vv, den
        sc.tri_degenerate = degenerate
        return sc


@dataclasses.dataclass
class OracleHit:
    point: np.ndarray
    normal: np.ndarray
    mat_id: int
    refl_dir: np.ndarray
    trans_dir: np.ndarray
    checker: bool = False  # a board triangle's (its material by square)


def _intersect(sc: OracleScene, o: np.ndarray, v: np.ndarray, small: float,
               prune: bool) -> Optional[OracleHit]:
    """Nearest hit, mirroring the composite traversal flattened: strict-<
    nearest with triangles visited before spheres (scene insertion order)."""
    vlen = np.linalg.norm(v)
    if vlen == 0.0 or not np.isfinite(vlen):
        return None
    u = v / vlen

    # bounding-sphere prune (Shape::intersection, :747-758)
    pruned = np.zeros(len(sc.grp_radius), bool)
    if prune:
        for g in range(len(sc.grp_radius)):
            if sc.grp_radius[g] <= 0:
                continue
            delta = sc.grp_center[g] - o
            ud = float(u @ delta)
            disc = ud * ud - float(delta @ delta) + sc.grp_radius[g] ** 2
            s = ud - math.sqrt(disc) if disc >= 0 else math.nan
            pruned[g] = disc < 0 or abs(s) < small

    best = None
    best_dist = math.inf

    for i in range(len(sc.tri_mat)):
        if sc.tri_degenerate[i] or pruned[sc.tri_group[i]]:
            continue
        n = sc.tri_n[i]
        ndv = float(n @ v)
        if abs(ndv) < small:
            continue
        m = float(n @ (sc.tri_v0[i] - o)) / ndv
        if m < small:
            continue
        p = o + m * v
        w = p - sc.tri_v0[i]
        wu = float(w @ sc.tri_u[i]); wv = float(w @ sc.tri_v[i])
        s = (sc.tri_uv[i] * wv - sc.tri_vv[i] * wu) / sc.tri_den[i]
        t = (sc.tri_uv[i] * wu - sc.tri_uu[i] * wv) / sc.tri_den[i]
        if not (s >= 0 and t >= 0 and s + t <= 1):
            continue
        dist = np.linalg.norm(p - o)
        if dist < best_dist:
            best_dist = dist
            mat_id = int(sc.tri_mat[i])
            if sc.tri_checker[i]:
                prel = p - sc.board_pos
                px = prel[0] + sc.board_half
                pz = prel[2] + sc.board_half
                sq = int(px / sc.board_square) + int(pz / sc.board_square)
                mat_id = sc.checker_mats[0] if sq % 2 == 0 else sc.checker_mats[1]
            best = _finish(sc, p, n, mat_id, u)
            best.checker = bool(sc.tri_checker[i])

    for i in range(len(sc.sph_mat)):
        if pruned[sc.sph_group[i]]:
            continue
        delta = sc.sph_center[i] - o
        ud = float(u @ delta)
        disc = ud * ud - float(delta @ delta) + sc.sph_radius[i] ** 2
        if disc < 0:
            continue
        s = ud - math.sqrt(disc)
        if abs(s) < small or s < small:
            continue
        p = o + s * u
        if s < best_dist:
            best_dist = s
            d0 = p - sc.sph_center[i]
            n = d0 / np.linalg.norm(d0)
            best = _finish(sc, p, n, int(sc.sph_mat[i]), u)

    return best


def _finish(sc: OracleScene, p, n, mat_id: int, u) -> OracleHit:
    cosi = float(u @ n)
    refl = u - 2.0 * cosi * n
    rho = float(sc.mat_refraction[mat_id])
    modulus = 1.0 - rho * rho * (1.0 - cosi * cosi)
    if modulus > 0:
        trans = rho * u - (math.sqrt(modulus) + rho * cosi) * n
    else:
        trans = np.zeros(3)
    return OracleHit(point=p, normal=n, mat_id=mat_id, refl_dir=refl,
                     trans_dir=trans)


#: how close to a square's edge (in squares) a board hit counts as on it
EDGE_TOL = 1e-6


def on_checker_edge(sc: OracleScene, hit: OracleHit) -> bool:
    """Whether ``hit`` meets the board within ``EDGE_TOL`` squares of a
    square's edge: there the square turns on the last bits of the ray that
    found it, in float32 as in float64."""
    if not hit.checker:
        return False
    q = (hit.point - sc.board_pos + sc.board_half) / sc.board_square
    return bool(np.min(np.abs(q[[0, 2]] - np.round(q[[0, 2]]))) < EDGE_TOL)


def trace_ray(sc: OracleScene, o, v, depth: int, small: float = 1e-4,
              attenuation_factor: float = 1e5, prune: bool = True, *,
              edges: Optional[list] = None, flip=frozenset(),
              path: tuple = ()) -> np.ndarray:
    """Recursive single-ray trace, the ``rayTraceRay`` stack (SURVEY.md 3.3).

    A bounce is named by its ``path`` from the primary hit, one ``"t"``
    (transmitted) or ``"r"`` (reflected) a level.  ``edges``, a list, takes
    the path of every bounce after the primary hit that meets the board on
    a square's edge (``on_checker_edge``); the bounces named in ``flip``
    take the other square's material there."""
    color = np.zeros(3)
    hit = _intersect(sc, np.asarray(o, np.float64), np.asarray(v, np.float64),
                     small, prune)
    if hit is None:
        return color

    vlen = np.linalg.norm(v)
    u = v / vlen
    if path and (edges is not None or flip) and on_checker_edge(sc, hit):
        if edges is not None:
            edges.append(path)
        if path in flip:
            a, b = sc.checker_mats
            hit = _finish(sc, hit.point, hit.normal,
                          b if hit.mat_id == a else a, u)
    for l in range(len(sc.light_pos)):
        sv = sc.light_pos[l] - hit.point
        occ = _intersect(sc, hit.point, sv, small, prune)
        if occ is None or np.any(sc.mat_transparency[occ.mat_id] != 0.0):
            d = np.linalg.norm(sv)
            att = attenuation_factor / (attenuation_factor + d * d)
            lc = att * sc.light_color[l]
            s_hat = sv / d
            amb = sc.mat_ambient[hit.mat_id]
            dif = sc.mat_diffuse[hit.mat_id]
            spe = sc.mat_specular[hit.mat_id]
            color += (amb * lc
                      + abs(float(hit.normal @ s_hat)) * dif * lc
                      + abs(float(u @ hit.refl_dir)) * spe * lc)

    if depth > 0:
        T = sc.mat_transparency[hit.mat_id]
        opacity = 1.0 - T
        if np.any(T != 0.0) and np.linalg.norm(T) > small:
            ct = trace_ray(sc, hit.point, hit.trans_dir, depth - 1, small,
                           attenuation_factor, prune, edges=edges, flip=flip,
                           path=path + ("t",))
            color += T * ct
        if np.any(opacity != 0.0):
            cr = trace_ray(sc, hit.point, hit.refl_dir, depth - 1, small,
                           attenuation_factor, prune, edges=edges, flip=flip,
                           path=path + ("r",))
            color += opacity * cr
    return color


def _screen(camera: CameraConfig, w: int, h: int):
    """(eye, base, right, up2) of the reference's screen in float64: pixel
    (j, i) looks through base + (i*scale)*right + (j*scale)*up2."""
    eye = np.asarray(camera.eye, np.float64)
    look_at = np.asarray(camera.look_at, np.float64)
    up = np.asarray(camera.up, np.float64)
    look = look_at - eye
    right = np.cross(look, up); right /= np.linalg.norm(right)
    up2 = np.cross(right, look); up2 /= np.linalg.norm(up2)
    bx, by = camera.bottom(w, h)
    return eye, look_at + bx * right + by * up2, right, up2


def oracle_render(scene: FlatScene, camera: CameraConfig, config: RenderConfig,
                  dtype=np.float64) -> np.ndarray:
    """Full-frame oracle render -> [H,W,3] float64, j=0 = bottom scanline.
    One centered sample per pixel (no jitter): the deterministic limit of the
    reference supersampler."""
    sc = OracleScene.from_flat(scene, dtype=dtype, small=config.small_number)
    w, h = config.width, config.height
    eye, base, right, up2 = _screen(camera, w, h)
    scale = camera.pixel_scale
    img = np.zeros((h, w, 3))
    for j in range(h):
        for i in range(w):
            pt = base + (i * scale) * right + (j * scale) * up2
            img[j, i] = trace_ray(sc, eye, pt - eye, config.max_depth,
                                  config.small_number,
                                  config.attenuation_factor, config.prune)
    return img


def oracle_pixels(scene: FlatScene, camera: CameraConfig,
                  config: RenderConfig, pixels, ties: bool = False):
    """Pixels ``[(j, i), ...]`` of the frame, traced as ``oracle_render``
    traces them: ``(colours [N,3] float64, primary hits)``, each hit an
    ``OracleHit`` or None on a miss.  With ``ties``, also each pixel's
    other colours [A,3]: one for each nonempty set of its later bounces
    that meet the board on a square's edge, traced with those bounces on
    the other square (A = 0 where no bounce does); a float32 render may
    take any of them."""
    sc = OracleScene.from_flat(scene, small=config.small_number)
    eye, base, right, up2 = _screen(camera, config.width, config.height)
    scale = camera.pixel_scale
    args = (config.max_depth, config.small_number, config.attenuation_factor,
            config.prune)
    colours, hits, others = [], [], []
    for j, i in pixels:
        v = base + (i * scale) * right + (j * scale) * up2 - eye
        edges = [] if ties else None
        colours.append(trace_ray(sc, eye, v, *args, edges=edges))
        hits.append(_intersect(sc, eye, v, config.small_number,
                               config.prune))
        if ties:
            sets = itertools.chain.from_iterable(
                itertools.combinations(edges, k)
                for k in range(1, len(edges) + 1))
            others.append(np.asarray(
                [trace_ray(sc, eye, v, *args, flip=frozenset(f))
                 for f in sets]).reshape(-1, 3))
    if ties:
        return np.stack(colours), hits, others
    return np.stack(colours), hits
