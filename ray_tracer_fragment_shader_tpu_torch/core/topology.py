"""The core chain's fixed topology, in the terms in which the residual
forward records the kernel's (kernels/render.py::
render_forward_with_residuals): per pixel and bounce level, the primitive
shaded, its material and each light's shadow outcome.

A gradient of the core renderer and one of the replay adjoint
(kernels/adjoint.py::render_image_diff) are the same function's only where
the two forwards took the same topology: where one hits another primitive,
another checker square, or sees another shadow, each differentiates its
own branch.  ``same_topology`` marks the pixels where they agree, so a
cotangent restricted to them compares the two gradients alone.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import RenderConfig
from ..kernels.render import compact_scene
from ..ops.intersect import intersect_scene
from ..ops.rays import Camera, primary_rays, screen_points
from ..scene.flat import FlatScene
from .renderer import _next_branch


def core_topology(scene: FlatScene, camera: Camera, config: RenderConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain's topology over the frame, on the scene's compacted
    padding-free form (the residual forward's, so primitive ids agree):
    ``bi`` [D+1,P] i32, the primitive each level shades (-1 where it does
    not), ``mid`` [D+1,P] i32, its material (the checker square's on the
    board), and ``lit`` [L,D+1,P] bool, each light's shadow outcome on the
    levels that shade.  The queries of renderer.py::render_rays_chain and
    ops/shading.py::shade_local, without autograd, ``config.chunk_size``
    rays at a time; the square parity as ops/intersect.py::intersect_scene
    takes it.  Runs on the camera's device."""
    scene = compact_scene(scene.to(camera.eye.device))
    kw = dict(small=config.small_number, prune=config.prune)
    D, L = config.max_depth, scene.num_lights
    prim_mat = torch.cat([scene.tri_mat, scene.sph_mat]).to(torch.int32)
    prim_chk = torch.cat([scene.tri_checker, torch.zeros_like(
        scene.sph_mat, dtype=torch.bool)])
    white, black = scene.checker_mats

    def material(hit, valid):
        idx = hit.prim_id.clamp(min=0).long()
        prel = hit.point - scene.board_pos[None, :]
        sq = sum(torch.trunc((prel[:, a] + scene.board_half)
                             / scene.board_square).to(torch.int32)
                 for a in (0, 2))
        chk = torch.where(sq % 2 == 0, white, black).to(torch.int32)
        return torch.where(valid, torch.where(prim_chk[idx], chk,
                                              prim_mat[idx]), -1)

    bis, mids, lits = [], [], []
    with torch.no_grad():
        o_all, v_all = primary_rays(camera, screen_points(
            camera, config.width, config.height))
        chunk = config.chunk_size
        for s in range(0, o_all.shape[0], chunk):
            o, v = o_all[s:s + chunk], v_all[s:s + chunk]
            excl = torch.full((o.shape[0],), -1, dtype=torch.int32,
                              device=o.device)
            alive = torch.ones_like(excl, dtype=torch.bool)
            bi, mid, lit = [], [], []
            for _ in range(D + 1):
                hit = intersect_scene(scene, o, v, exclude_id=excl, **kw)
                valid = hit.valid & alive
                bi.append(torch.where(valid, hit.prim_id.to(torch.int32),
                                      -1))
                mid.append(material(hit, valid))
                for li in range(L):
                    occ = intersect_scene(
                        scene, hit.point, scene.light_pos[li][None, :]
                        - hit.point, exclude_id=hit.prim_id, **kw)
                    lit.append(valid & (~occ.valid | torch.any(
                        occ.transparency != 0.0, dim=-1)))
                next_v, _, ok = _next_branch(hit, config.small_number)
                alive = valid & ok
                o, v, excl = hit.point, next_v, hit.prim_id
            bis.append(torch.stack(bi))
            mids.append(torch.stack(mid))
            lits.append(torch.stack(lit).reshape(D + 1, L, -1)
                        .transpose(0, 1))
    return torch.cat(bis, -1), torch.cat(mids, -1), torch.cat(lits, -1)


def same_topology(scene: FlatScene, camera: Camera, config: RenderConfig,
                  residuals: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[H,W] bool: the pixels where the core chain (``core_topology``) and
    the residual forward's ``residuals`` (``bi``, ``mid`` [D+1,H,W],
    ``lit`` [L,D+1,H,W]) shade the same primitive in the same material on
    every level and see the same shadow from every light there.  Chain
    scenes only: the tree's residuals are per node."""
    if not scene.chain_exact:
        raise ValueError("same_topology compares the chain's levels")
    bi_c, mid_c, lit_c = core_topology(scene, camera, config)
    D1, L = config.max_depth + 1, lit_c.shape[0]
    bi_k = residuals["bi"].reshape(D1, -1).round().to(torch.int32)
    mid_k = residuals["mid"].reshape(D1, -1).round().to(torch.int32)
    lit_k = residuals["lit"].reshape(L, D1, -1) > 0.5
    shades = bi_k >= 0
    same = ((bi_c == bi_k).all(0)
            & ((mid_c == mid_k) | ~shades).all(0)
            & ((lit_c == lit_k) | ~shades[None]).all(0).all(0))
    return same.reshape(config.height, config.width)
