"""Gradient-bar harness: candidate gradients vs central finite differences
through the float64 NumPy oracle (oracle/numpy_ref.py — an independent
implementation sharing no kernel code).

This is the machinery behind the BASELINE bar "grad max-abs-err <= 1e-4 vs
reference" (BASELINE.md), used by ``grad_bar.py`` (the CUDA kernels'
arithmetic on the card, or their plain versions with ``--cpu``) and the
port's CPU tests.  The JAX package's ``oracle/gradcheck.py``, line for
line, on the port's ``FlatScene`` and residual tensors.

The functional is J(params) = mean_k w_k . rgb_k over *interior* pixels:
hit topology (primitive/material/lit flags at every bounce node) constant
over each pixel's 3x3 neighborhood, grazing-angle kinks (|n.s|, |u.r| near
0, for EVERY light) excluded — the fixed-topology convention under which
the adjoints are defined (SURVEY.md §7 "Hard parts").  J and the
parameters are O(1)-scaled (mean of unit-range pixel values; world-unit
geometry), so the raw max-abs-err is the BASELINE metric, not a rel-err
proxy.  Works for chain-exact and fractional-transparency (bounce-tree)
scenes alike: the oracle's ``trace_ray`` is the literal recursive
``rayTraceRay`` (both branches), and the stable-pixel test uses whichever
residual planes (per level / per preorder node) the kernel emitted.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from .numpy_ref import OracleScene, _intersect, as_numpy, trace_ray


def camera_f64(camcfg, w: int, h: int):
    """(eye, base, right, up2, pixel_scale) in float64, mirroring
    ops/rays.py::Camera.basis in intent."""
    eye = np.asarray(camcfg.eye, np.float64)
    look_at = np.asarray(camcfg.look_at, np.float64)
    up = np.asarray(camcfg.up, np.float64)
    look = look_at - eye
    right = np.cross(look, up); right /= np.linalg.norm(right)
    up2 = np.cross(right, look); up2 /= np.linalg.norm(up2)
    bx, by = camcfg.bottom(w, h)
    base = look_at + bx * right + by * up2
    return eye, base, right, up2, camcfg.pixel_scale


def stable_interior_pixels(res: Dict[str, Any], cfg, scene, camcfg,
                           kink: float = 0.05) -> List[Tuple[int, int]]:
    """Pixels whose residual topology is constant over a 3x3 neighborhood
    and whose level-0 shading sits away from the |.| kinks for every
    light."""
    bi = as_numpy(res["bi"])              # [K,H,W] (levels or tree nodes)
    mid = as_numpy(res["mid"])
    lit = as_numpy(res["lit"])            # [L,K,H,W]
    planes = np.concatenate([bi, mid, lit.reshape(-1, *bi.shape[1:])], 0)
    h, w = bi.shape[1:]
    ok = np.ones((h, w), bool)
    ok[0, :] = ok[-1, :] = ok[:, 0] = ok[:, -1] = False
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == di == 0:
                continue
            shifted = np.roll(planes, (dj, di), axis=(1, 2))
            ok &= np.all(planes == shifted, axis=0)
    ok &= bi[0] >= 0.0  # primary hit

    sc = OracleScene.from_flat(scene, small=cfg.small_number)
    eye, base, right, up2, scale = camera_f64(camcfg, cfg.width, cfg.height)
    pix = []
    for j, i in np.argwhere(ok):
        pt = base + (i * scale) * right + (j * scale) * up2
        v = pt - eye
        hit = _intersect(sc, eye, v, cfg.small_number, cfg.prune)
        if hit is None:
            continue
        u = v / np.linalg.norm(v)
        udotr = abs(float(u @ hit.refl_dir))
        if udotr <= kink:
            continue
        good = True
        for li in range(sc.light_pos.shape[0]):
            sv = sc.light_pos[li] - hit.point
            ndots = abs(float(hit.normal @ (sv / np.linalg.norm(sv))))
            if ndots <= kink:
                good = False
                break
        if good:
            pix.append((int(j), int(i)))
    return pix


def stratified_pick(pix, res, scene, n_each: int = 16):
    """Up to ``n_each`` direct-sphere-hit and board-hit pixels, spread out:
    sphere hits carry the geometry gradients, board hits the material/light
    ones."""
    bi0 = as_numpy(res["bi"])[0]
    nt = int(as_numpy(scene.tri_valid).sum())
    sph_pix = [p for p in pix if bi0[p] >= nt]
    brd_pix = [p for p in pix if bi0[p] < nt]
    pick = lambda lst, n: lst[:: max(1, len(lst) // n)][:n]
    return pick(sph_pix, n_each) + pick(brd_pix, n_each), len(sph_pix)


def make_functional(scene, cfg, camcfg, pix: Sequence[Tuple[int, int]],
                    w_rgb: np.ndarray):
    """J(flat_scene_override, eye_override) -> float, through the f64
    oracle.  ``eye_override`` perturbs the camera eye with the basis
    recomputed (matching autodiff through Camera.eye -> basis())."""
    K = len(pix)

    def J(flat=None, eye_d=np.zeros(3)):
        flat = scene if flat is None else flat
        sc = OracleScene.from_flat(flat, small=cfg.small_number)
        eye0 = np.asarray(camcfg.eye, np.float64) + eye_d

        look_at = np.asarray(camcfg.look_at, np.float64)
        up = np.asarray(camcfg.up, np.float64)
        look = look_at - eye0
        right = np.cross(look, up); right /= np.linalg.norm(right)
        up2 = np.cross(right, look); up2 /= np.linalg.norm(up2)
        bx, by = camcfg.bottom(cfg.width, cfg.height)
        base = look_at + bx * right + by * up2
        scale = camcfg.pixel_scale

        total = 0.0
        for k, (j, i) in enumerate(pix):
            pt = base + (i * scale) * right + (j * scale) * up2
            rgb = trace_ray(sc, eye0, pt - eye0, cfg.max_depth,
                            cfg.small_number, cfg.attenuation_factor,
                            cfg.prune)
            total += float(w_rgb[k] @ rgb)
        return total / K

    return J


def fd_param(J, scene, field: str, idx, eps: float) -> float:
    arr = as_numpy(getattr(scene, field)).astype(np.float64)
    hi, lo = arr.copy(), arr.copy()
    hi[idx] += eps
    lo[idx] -= eps
    return (J(scene.replace(**{field: hi}))
            - J(scene.replace(**{field: lo}))) / (2.0 * eps)


def fd_eye(J, axis: int, eps: float) -> float:
    d = np.zeros(3)
    d[axis] = eps
    return (J(eye_d=d) - J(eye_d=-d)) / (2.0 * eps)


def param_checks(J, scene, grads: Dict[str, np.ndarray],
                 eps=dict(sph_center=1e-3, sph_radius=1e-3, light_pos=1e-2,
                          mat=1e-4)) -> List[Tuple[str, float, float]]:
    """[(label, candidate, fd_truth)] over every FitParams component."""
    checks = []
    for i in range(scene.num_spheres):
        for a in range(3):
            checks.append((f"sph_center[{i},{a}]",
                           grads["sph_center"][i, a],
                           fd_param(J, scene, "sph_center", (i, a),
                                    eps["sph_center"])))
        checks.append((f"sph_radius[{i}]", grads["sph_radius"][i],
                       fd_param(J, scene, "sph_radius", (i,),
                                eps["sph_radius"])))
    for li in range(scene.num_lights):
        for a in range(3):
            checks.append((f"light_pos[{li},{a}]",
                           grads["light_pos"][li, a],
                           fd_param(J, scene, "light_pos", (li, a),
                                    eps["light_pos"])))
    for j in range(scene.num_materials):
        for a in range(3):
            for field in ("mat_ambient", "mat_diffuse", "mat_specular"):
                checks.append((f"{field}[{j},{a}]", grads[field][j, a],
                               fd_param(J, scene, field, (j, a),
                                        eps["mat"])))
    return checks


def summarize(checks) -> Dict[str, Any]:
    cand = np.array([c[1] for c in checks], np.float64)
    truth = np.array([c[2] for c in checks], np.float64)
    err = np.abs(cand - truth)
    worst = int(np.argmax(err))
    return dict(max_abs_err=float(err.max()),
                worst=checks[worst][0],
                worst_candidate=float(cand[worst]),
                worst_fd=float(truth[worst]),
                grad_scale=float(np.abs(truth).max()),
                n_checks=len(checks))
