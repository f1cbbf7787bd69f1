"""SceneBuilder — host-side scene construction.

Replaces the reference's interactive stdin scene menu and loader
(``initScene2``/``loadScene``/``convertStringCoordinate``,
``Hw4/MySdlApplication.cpp:1326-1346, 1430-1539``) with a programmatic API.
Board coordinates ("b4") work exactly like the reference: letter = row
(mapped to -z), digit = column (mapped to +x), objects float 1.5 squares
above the board and lights a further 3.5 squares up.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import (BOARD_HALF_SIZE, BOARD_POSITION, SQUARE_EDGE_SIZE, WHITE)
from . import primitives as prim
from .flat import FlatScene
from .materials import (BLACK_SQUARE, CUBE_MATERIAL, DEFAULT_MATERIAL, Material,
                        SPHERE_MATERIAL, TETRAHEDRON_MATERIAL, WHITE_SQUARE)

Vec3 = Tuple[float, float, float]
Position = Union[str, Sequence[float]]

#: Object-type codes of the interactive menu (MySdlApplication.cpp:16,1457).
MENU_TYPES = ("light", "tetrahedron", "cube", "sphere", "cylinder", "cone")


def convert_board_coordinate(coord: str,
                             square: float = SQUARE_EDGE_SIZE,
                             half: float = BOARD_HALF_SIZE) -> np.ndarray:
    """Board-local position of a coordinate string like "b4"
    (``convertStringCoordinate``, MySdlApplication.cpp:1326-1346): row letter
    walks -z from the near edge, column digit walks +x from the left edge,
    and the point floats 1.5 squares above the board."""
    if len(coord) != 2:
        raise ValueError(f"board coordinate must be 2 chars, got {coord!r}")
    row = ord(coord[0]) - ord("a")
    col = ord(coord[1]) - ord("1")
    first_square = np.array([-half, 0.0, half])
    offset = np.array([(col + 0.5) * square, 1.5 * square, -(row + 0.5) * square])
    return first_square + offset


class SceneBuilder:
    """Accumulates objects, then ``build()``s the FlatScene of tensors.

    Construction mirrors the reference scene graph: a root composite at
    ``board_position`` with bounding radius ``sqrt(3)*board_half``
    (``g_scene``, MySdlApplication.cpp:590) whose children are added in
    insertion order (closest-hit ties resolve to the earlier primitive, like
    the strict ``<`` nearest test at ``:813``).
    """

    def __init__(self,
                 board_position: Vec3 = BOARD_POSITION,
                 board_half: float = BOARD_HALF_SIZE,
                 square: float = SQUARE_EDGE_SIZE,
                 scene_radius: Optional[float] = "reference",  # type: ignore
                 light_color: Vec3 = WHITE):
        self.board_position = np.asarray(board_position, np.float64)
        self.board_half = float(board_half)
        self.square = float(square)
        #: "reference" -> sqrt(3)*board_half like g_scene; None -> auto-fit
        #: an enclosing sphere at build time; float -> explicit.
        self.scene_radius = scene_radius
        self.default_light_color = np.asarray(light_color, np.float64)

        # Checker materials always occupy rows 0/1 so the procedural override
        # can select them by parity (CheckerBoard::intersection, :1104-1111).
        self._materials: List[Material] = [WHITE_SQUARE, BLACK_SQUARE]
        self._tris: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int, bool, int]] = []
        self._spheres: List[Tuple[np.ndarray, float, int, int]] = []
        # Group 0 reserved for the scene bounding sphere.
        self._groups: List[Tuple[np.ndarray, float]] = [(self.board_position, -1.0)]
        self._lights: List[Tuple[np.ndarray, np.ndarray]] = []

    # ------------------------------------------------------------- helpers
    def material_id(self, m: Material) -> int:
        for i, existing in enumerate(self._materials):
            if existing == m:
                return i
        self._materials.append(m)
        return len(self._materials) - 1

    def _resolve(self, position: Position) -> np.ndarray:
        """Board coordinate string -> board-local point; sequences pass
        through as board-local coordinates."""
        if isinstance(position, str):
            return convert_board_coordinate(position, self.square, self.board_half)
        return np.asarray(position, np.float64)

    def _world(self, local: np.ndarray) -> np.ndarray:
        return self.board_position + local

    def _add_group(self, world_center: np.ndarray, radius: float) -> int:
        self._groups.append((np.asarray(world_center, np.float64), float(radius)))
        return len(self._groups) - 1

    def _add_tris(self, tris, mat_id: int, group: int, checker: bool = False,
                  world_offset: Optional[np.ndarray] = None):
        off = self.board_position if world_offset is None else world_offset
        for (a, b, c) in tris:
            self._tris.append((a + off, b + off, c + off, mat_id, checker, group))

    # ------------------------------------------------------------- objects
    def add_checkerboard(self, position: Position = (0.0, 0.0, 0.0)) -> "SceneBuilder":
        local = self._resolve(position)
        tris = prim.checkerboard(local, self.board_half)
        self._add_tris(tris, mat_id=0, group=0, checker=True)
        return self

    def add_sphere(self, position: Position, radius: Optional[float] = None,
                   material: Material = SPHERE_MATERIAL) -> "SceneBuilder":
        radius = self.square / 2.0 if radius is None else radius
        world = self._world(self._resolve(position))
        self._spheres.append((world, float(radius), self.material_id(material), 0))
        return self

    def add_tetrahedron(self, position: Position, edge: Optional[float] = None,
                        material: Material = TETRAHEDRON_MATERIAL) -> "SceneBuilder":
        edge = self.square if edge is None else edge
        local = self._resolve(position)
        world = self._world(local)
        group = self._add_group(world, prim.tetrahedron_bounding_radius(edge))
        self._add_tris(prim.tetrahedron(local, edge), self.material_id(material), group)
        return self

    def add_cube(self, position: Position, edge: Optional[float] = None,
                 material: Material = CUBE_MATERIAL) -> "SceneBuilder":
        edge = self.square if edge is None else edge
        local = self._resolve(position)
        world = self._world(local)
        group = self._add_group(world, prim.cube_bounding_radius(edge))
        self._add_tris(prim.cube(local, edge), self.material_id(material), group)
        return self

    def add_cylinder(self, position: Position, radius: Optional[float] = None,
                     height: Optional[float] = None, *, style: str = "reference",
                     material: Material = TETRAHEDRON_MATERIAL) -> "SceneBuilder":
        """Reference cylinders are invisible (empty intersection override,
        MySdlApplication.cpp:1000-1020); pass style='fixed' for real geometry.
        No bounding group: the reference ctor's base-init is commented out
        (``:953``), leaving radius 0."""
        radius = self.square / 2.0 if radius is None else radius
        height = self.square / 2.0 if height is None else height
        local = self._resolve(position)
        tris = prim.cylinder(local, radius, height, style=style)
        self._add_tris(tris, self.material_id(material), group=0)
        return self

    def add_cone(self, position: Position, radius: Optional[float] = None,
                 height: Optional[float] = None, *, style: str = "reference",
                 material: Material = TETRAHEDRON_MATERIAL) -> "SceneBuilder":
        radius = self.square / 2.0 if radius is None else radius
        height = self.square / 2.0 if height is None else height
        local = self._resolve(position)
        tris = prim.cone(local, radius, height, style=style)
        self._add_tris(tris, self.material_id(material), group=0)
        return self

    def add_quad(self, position: Position, p1, p2, p3, p4,
                 material: Material = DEFAULT_MATERIAL) -> "SceneBuilder":
        local = self._resolve(position)
        self._add_tris(prim.quad(local, p1, p2, p3, p4),
                       self.material_id(material), group=0)
        return self

    def add_triangle(self, v0, v1, v2, material: Material = DEFAULT_MATERIAL,
                     *, world: bool = False) -> "SceneBuilder":
        off = np.zeros(3) if world else self.board_position
        self._tris.append((np.asarray(v0, np.float64) + off,
                           np.asarray(v1, np.float64) + off,
                           np.asarray(v2, np.float64) + off,
                           self.material_id(material), False, 0))
        return self

    def add_light(self, position: Position, color: Optional[Vec3] = None) -> "SceneBuilder":
        """Lights sit 3.5 squares above the object height at their coordinate
        (loadScene LIGHT branch, MySdlApplication.cpp:1511)."""
        local = self._resolve(position)
        if isinstance(position, str):
            local = local + np.array([0.0, 3.5 * self.square, 0.0])
        world = self.board_position + local
        color = self.default_light_color if color is None else np.asarray(color, np.float64)
        self._lights.append((world, color))
        return self

    def add_light_world(self, position, color: Optional[Vec3] = None) -> "SceneBuilder":
        color = self.default_light_color if color is None else np.asarray(color, np.float64)
        self._lights.append((np.asarray(position, np.float64), color))
        return self

    # ------------------------------------------------------------- loaders
    def load_board_map(self, board_map: Dict[str, Union[int, str]]) -> "SceneBuilder":
        """Replicates ``loadScene`` (MySdlApplication.cpp:1495-1539): one
        object per coordinate, iterated in sorted coordinate order (std::map).
        Values may be menu indices (0-5) or names from MENU_TYPES."""
        for coord in sorted(board_map):
            kind = board_map[coord]
            if isinstance(kind, int):
                kind = MENU_TYPES[kind]
            getattr(self, f"add_{kind}")(coord)
        return self

    # --------------------------------------------------------------- build
    def _auto_radius(self) -> float:
        far = 0.0
        for (a, b, c, *_rest) in self._tris:
            for v in (a, b, c):
                far = max(far, float(np.linalg.norm(v - self.board_position)))
        for (center, radius, *_rest) in self._spheres:
            far = max(far, float(np.linalg.norm(center - self.board_position)) + radius)
        return far * 1.001 + 1.0

    def build(self, dtype=np.float32, pad_multiple: int = 8,
              device=None) -> FlatScene:
        """The FlatScene of float leaves in numpy ``dtype``, on ``device``
        (default CPU)."""
        if self.scene_radius == "reference":
            scene_r = math.sqrt(3.0) * self.board_half
        elif self.scene_radius is None:
            scene_r = self._auto_radius()
        else:
            scene_r = float(self.scene_radius)
        groups = list(self._groups)
        groups[0] = (self.board_position, scene_r)

        def pad_to(n: int) -> int:
            return max(pad_multiple, ((n + pad_multiple - 1) // pad_multiple) * pad_multiple)

        nt, ns = len(self._tris), len(self._spheres)
        nt_p, ns_p = pad_to(nt), pad_to(ns)

        tri_v0 = np.zeros((nt_p, 3)); tri_v1 = np.zeros((nt_p, 3)); tri_v2 = np.zeros((nt_p, 3))
        # Padding triangles get distinct vertices on a far-away plane so the
        # derived quantities are non-degenerate but valid=False masks them.
        tri_v1[:, 0] = 1.0
        tri_v2[:, 1] = 1.0
        tri_v0[:, 2] = 1e8; tri_v1[:, 2] = 1e8; tri_v2[:, 2] = 1e8
        tri_mat = np.zeros(nt_p, np.int32)
        tri_checker = np.zeros(nt_p, bool)
        tri_group = np.zeros(nt_p, np.int32)
        tri_valid = np.zeros(nt_p, bool)
        for i, (a, b, c, mid, checker, grp) in enumerate(self._tris):
            tri_v0[i], tri_v1[i], tri_v2[i] = a, b, c
            tri_mat[i], tri_checker[i], tri_group[i], tri_valid[i] = mid, checker, grp, True

        sph_center = np.zeros((ns_p, 3)); sph_center[:, 2] = 1e8
        sph_radius = np.full(ns_p, 1.0)
        sph_mat = np.zeros(ns_p, np.int32)
        sph_group = np.zeros(ns_p, np.int32)
        sph_valid = np.zeros(ns_p, bool)
        for i, (center, radius, mid, grp) in enumerate(self._spheres):
            sph_center[i], sph_radius[i] = center, radius
            sph_mat[i], sph_group[i], sph_valid[i] = mid, grp, True

        grp_center = np.stack([g[0] for g in groups])
        grp_radius = np.array([g[1] for g in groups], np.float64)

        mats = np.stack([m.as_row() for m in self._materials])
        chain_exact = all(m.chain_exact for m in self._materials)
        has_transmission = any(m.is_transmissive for m in self._materials)

        if self._lights:
            light_pos = np.stack([l[0] for l in self._lights])
            light_color = np.stack([l[1] for l in self._lights])
        else:
            light_pos = np.zeros((0, 3)); light_color = np.zeros((0, 3))

        def as_t(x, dt):
            return torch.from_numpy(np.asarray(x, dtype=dt)).to(device)

        f = lambda x: as_t(x, dtype)
        i32 = lambda x: as_t(x, np.int32)
        b8 = lambda x: as_t(x, bool)
        return FlatScene(
            sph_center=f(sph_center), sph_radius=f(sph_radius),
            sph_mat=i32(sph_mat), sph_group=i32(sph_group), sph_valid=b8(sph_valid),
            tri_v0=f(tri_v0), tri_v1=f(tri_v1), tri_v2=f(tri_v2),
            tri_mat=i32(tri_mat), tri_checker=b8(tri_checker),
            tri_group=i32(tri_group), tri_valid=b8(tri_valid),
            grp_center=f(grp_center), grp_radius=f(grp_radius),
            mat_ambient=f(mats[:, 0:3]), mat_diffuse=f(mats[:, 3:6]),
            mat_specular=f(mats[:, 6:9]), mat_transparency=f(mats[:, 9:12]),
            mat_refraction=f(mats[:, 12]),
            light_pos=f(light_pos), light_color=f(light_color),
            board_pos=f(self.board_position), board_half=f(self.board_half),
            board_square=f(self.square),
            checker_mats=(0, 1), chain_exact=chain_exact,
            has_transmission=has_transmission,
        )
