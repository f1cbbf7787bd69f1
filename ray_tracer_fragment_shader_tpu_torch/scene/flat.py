"""FlatScene — the structure-of-arrays scene as a dataclass of tensors.

The reference's pointer-based composite of ``RayObject`` subclasses
(``Hw4/MySdlApplication.cpp:361-567``) compiles at build time into a
triangle soup plus analytic spheres; the composite's bounding-sphere prune
hierarchy (``Shape::intersection``, ``:747-758``) flattens into per-primitive
*group* ids indexing a small table of bounding spheres (group 0 is the
whole-scene sphere, ``g_scene`` at ``:590``).  Coordinates are absolute
world coordinates.

Field for field the same as the JAX package's ``FlatScene``;
``FlatScene.from_numpy`` carries one across as numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import SMALL_NUMBER


@dataclasses.dataclass(frozen=True)
class FlatScene:
    # --- spheres (Shape with _amSphere, MySdlApplication.cpp:747-793) ------
    sph_center: torch.Tensor  # [Ns,3] f32 — world-space centers
    sph_radius: torch.Tensor  # [Ns]   f32
    sph_mat: torch.Tensor     # [Ns]   i32 — row into materials table
    sph_group: torch.Tensor   # [Ns]   i32 — bounding-sphere prune group
    sph_valid: torch.Tensor   # [Ns]   bool — padding mask

    # --- triangles (Triangle, MySdlApplication.cpp:380-437,611-707) --------
    tri_v0: torch.Tensor       # [Nt,3] f32 — world-space vertices
    tri_v1: torch.Tensor       # [Nt,3]
    tri_v2: torch.Tensor       # [Nt,3]
    tri_mat: torch.Tensor      # [Nt]   i32
    tri_checker: torch.Tensor  # [Nt]   bool — procedural checker override
    tri_group: torch.Tensor    # [Nt]   i32
    tri_valid: torch.Tensor    # [Nt]   bool

    # --- bounding-sphere prune groups --------------------------------------
    grp_center: torch.Tensor  # [G,3] f32 (group 0 = scene sphere)
    grp_radius: torch.Tensor  # [G]   f32 (radius <= 0 -> never prunes)

    # --- material table -----------------------------------------------------
    mat_ambient: torch.Tensor       # [M,3]
    mat_diffuse: torch.Tensor       # [M,3]
    mat_specular: torch.Tensor      # [M,3]
    mat_transparency: torch.Tensor  # [M,3]
    mat_refraction: torch.Tensor    # [M]

    # --- lights (Light, MySdlApplication.cpp:214-232) ----------------------
    light_pos: torch.Tensor    # [L,3]
    light_color: torch.Tensor  # [L,3]

    # --- checkerboard parameters (CheckerBoard, :1064-1113) ----------------
    board_pos: torch.Tensor     # [3] — world position of the board quad
    board_half: torch.Tensor    # []  — half edge size (160)
    board_square: torch.Tensor  # []  — square edge size (40)

    # --- metadata -----------------------------------------------------------
    #: material rows used for even/odd checker squares (white, black).
    checker_mats: Tuple[int, int] = (0, 1)
    #: True when every material's transparency is all-0 or all-1 so the
    #: single-path chain is exact (see RenderConfig.mode).
    chain_exact: bool = True
    #: True when some material traces transmitted rays at all.
    has_transmission: bool = False

    # ------------------------------------------------------------------ api
    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_groups(self) -> int:
        return self.grp_radius.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mat_refraction.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sph_center.device

    def replace(self, **changes) -> "FlatScene":
        return dataclasses.replace(self, **changes)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tensor leaves by field name (metadata excluded)."""
        return {f.name: getattr(self, f.name) for f in _TENSOR_FIELDS}

    def to(self, device) -> "FlatScene":
        return self.replace(**{k: v.to(device)
                               for k, v in self.tensors().items()})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The tensor leaves as numpy arrays (the ``from_numpy`` input)."""
        return {k: v.detach().cpu().numpy() for k, v in self.tensors().items()}

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], *,
                   checker_mats: Tuple[int, int] = (0, 1),
                   chain_exact: bool = True, has_transmission: bool = False,
                   device=None) -> "FlatScene":
        """Build from a dict of numpy arrays keyed by field name — e.g. the
        leaves of the JAX package's FlatScene, ``np.asarray`` each."""
        names = [f.name for f in _TENSOR_FIELDS]
        missing = set(names) - set(arrays)
        if missing:
            raise KeyError(f"missing FlatScene fields: {sorted(missing)}")
        return cls(**{k: torch.from_numpy(np.array(arrays[k])).to(device)
                      for k in names},
                   checker_mats=tuple(int(c) for c in checker_mats),
                   chain_exact=bool(chain_exact),
                   has_transmission=bool(has_transmission))


_TENSOR_FIELDS = tuple(f for f in dataclasses.fields(FlatScene)
                       if f.name not in ("checker_mats", "chain_exact",
                                         "has_transmission"))


def tri_derived(v0, v1, v2, small: float = SMALL_NUMBER):
    """Precomputed per-triangle quantities, exactly the ``Triangle``
    constructor (MySdlApplication.cpp:406-433): edge vectors u,v, unit plane
    normal n, the dot products uv/uu/vv, the barycentric denominator
    ``uv^2 - uu*vv`` and the degeneracy flag.  Returns a dict of tensors
    batched like the inputs."""
    u = v1 - v0
    v = v2 - v0
    n_raw = torch.linalg.cross(u, v, dim=-1)
    n_len = torch.sqrt(torch.clamp(torch.sum(n_raw * n_raw, -1), min=1e-30))
    degenerate = n_len < small
    n = n_raw / n_len[..., None]
    uv = torch.sum(u * v, -1)
    uu = torch.sum(u * u, -1)
    vv = torch.sum(v * v, -1)
    denominator = uv * uv - uu * vv
    degenerate = torch.logical_or(degenerate, torch.abs(denominator) < small)
    return dict(u=u, v=v, n=n, uv=uv, uu=uu, vv=vv,
                denominator=denominator, degenerate=degenerate)


def concat_scenes(a: FlatScene, b: FlatScene) -> FlatScene:
    """Merge two flat scenes into one: primitives, materials, prune groups
    and lights concatenate, with ``b``'s material/group ids re-based onto the
    combined tables.

    Board parameters and ``checker_mats`` come from ``a``; ``b`` must not
    contain checker-override triangles (two procedural boards cannot share
    one id pair — build combined boards through ``SceneBuilder`` instead).
    """
    if bool(b.tri_checker.any()):
        raise ValueError("b has checker triangles; merge boards via the "
                         "builder so they share one checker_mats pair")
    m_off = a.num_materials
    g_off = a.num_groups
    cat = lambda x, y: torch.cat([x, y.to(x.device)], 0)
    return a.replace(
        sph_center=cat(a.sph_center, b.sph_center),
        sph_radius=cat(a.sph_radius, b.sph_radius),
        sph_mat=cat(a.sph_mat, b.sph_mat + m_off),
        sph_group=cat(a.sph_group, b.sph_group + g_off),
        sph_valid=cat(a.sph_valid, b.sph_valid),
        tri_v0=cat(a.tri_v0, b.tri_v0), tri_v1=cat(a.tri_v1, b.tri_v1),
        tri_v2=cat(a.tri_v2, b.tri_v2),
        tri_mat=cat(a.tri_mat, b.tri_mat + m_off),
        tri_checker=cat(a.tri_checker, b.tri_checker),
        tri_group=cat(a.tri_group, b.tri_group + g_off),
        tri_valid=cat(a.tri_valid, b.tri_valid),
        grp_center=cat(a.grp_center, b.grp_center),
        grp_radius=cat(a.grp_radius, b.grp_radius),
        mat_ambient=cat(a.mat_ambient, b.mat_ambient),
        mat_diffuse=cat(a.mat_diffuse, b.mat_diffuse),
        mat_specular=cat(a.mat_specular, b.mat_specular),
        mat_transparency=cat(a.mat_transparency, b.mat_transparency),
        mat_refraction=cat(a.mat_refraction, b.mat_refraction),
        light_pos=cat(a.light_pos, b.light_pos),
        light_color=cat(a.light_color, b.light_color),
        chain_exact=a.chain_exact and b.chain_exact,
        has_transmission=a.has_transmission or b.has_transmission)
