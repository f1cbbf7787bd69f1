"""Phong shading with distance attenuation and transparency-aware hard
shadows, in PyTorch: the per-hit lighting loop of ``rayTraceRay``
(Hw4/MySdlApplication.cpp:1213-1228), the counterpart of the JAX package's
``ops/shading.py``.

Reference semantics preserved exactly:
  * attenuation ``A/(A + d^2)`` with d the hit->light distance
    (``:1171-1182``);
  * shadow ray = full nearest-hit query; the point is lit if nothing is hit
    OR the *nearest* occluder has any non-zero transparency
    (``:1216-1221``): a transparent occluder passes all light, and an
    occluder beyond the light still blocks (the reference's Line is an
    infinite ray);
  * contribution = ambient (.) lC + |n . s_hat| diffuse (.) lC
    + |u_ray . r_hat| specular (.) lC: Phong with no exponent, both
    cosines unsigned (``:1224-1226``).
"""
from __future__ import annotations

import torch

from ..scene.flat import FlatScene
from ..utils.jmath import dot3, safe_div, safe_sqrt
from .intersect import Hit, intersect_scene


def shade_local(scene: FlatScene, hit: Hit, u_incoming, *,
                small: float = 1e-4, attenuation_factor: float = 1e5,
                prune: bool = True):
    """Direct lighting at the hit points.  ``u_incoming`` is the unit
    direction of the incoming ray.  Returns [P,3], zero on rays with no
    hit.  Each light's shadow query runs without autograd: only its hit
    flag and the occluder's transparency test reach the colour, and
    neither carries a gradient."""
    color = torch.zeros_like(hit.point)
    for li in range(scene.num_lights):
        lpos = scene.light_pos[li]
        lcol = scene.light_color[li]
        sv = lpos[None, :] - hit.point  # raw shadow direction (Line to light)
        with torch.no_grad():
            occ = intersect_scene(scene, hit.point, sv, small=small,
                                  prune=prune, exclude_id=hit.prim_id)
            occluder_transparent = torch.any(occ.transparency != 0.0, dim=-1)
            lit = ~occ.valid | occluder_transparent

        d2 = dot3(sv, sv)
        att = attenuation_factor / (attenuation_factor + d2)
        lc = att[:, None] * lcol[None, :]

        slen = safe_sqrt(d2, d2 > 0)
        s_hat = sv * safe_div(torch.ones_like(slen), slen, d2 > 0)[:, None]
        ndots = torch.abs(dot3(hit.normal, s_hat))
        udotr = torch.abs(dot3(u_incoming, hit.refl_dir))

        contrib = (hit.ambient * lc
                   + ndots[:, None] * hit.diffuse * lc
                   + udotr[:, None] * hit.specular * lc)
        mask = (lit & hit.valid)[:, None]
        color = color + torch.where(mask, contrib, 0.0)
    return color
