"""Phong materials.

Mirrors the reference ``Material`` record — ambient/diffuse/specular RGB,
transparency RGB and a scalar refraction ratio
(``Hw4/MySdlApplication.cpp:272-307``) — plus the five named scene materials
defined at ``:583-588``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..config import BLACK, RED, WHITE

Vec3 = Tuple[float, float, float]


def _scale(c: Vec3, s: float) -> Vec3:
    return (c[0] * s, c[1] * s, c[2] * s)


@dataclasses.dataclass(frozen=True)
class Material:
    ambient: Vec3 = BLACK
    diffuse: Vec3 = BLACK
    specular: Vec3 = BLACK
    transparency: Vec3 = BLACK
    #: Ratio used directly in the Snell/thin-lens transmitted-ray formula
    #: (MySdlApplication.cpp:686-697, 780-791).  The reference applies it
    #: as-is, with no inside/outside flip.
    refraction: float = 1.0

    @property
    def is_transmissive(self) -> bool:
        """True when the reference would trace the transmitted child ray
        (``!transparency.isZero()``, MySdlApplication.cpp:1238)."""
        return any(t != 0.0 for t in self.transparency)

    @property
    def is_reflective(self) -> bool:
        """True when the reference would trace the reflected child ray
        (``!opacity.isZero()``, MySdlApplication.cpp:1243)."""
        return any(1.0 - t != 0.0 for t in self.transparency)

    @property
    def chain_exact(self) -> bool:
        """True when at most one child ray is ever traced from this material,
        i.e. transparency is all-zeros or all-ones.  All five reference
        materials satisfy this, which is what makes the iterative chain
        renderer exact for reference scenes."""
        return not (self.is_transmissive and self.is_reflective)

    def as_row(self) -> np.ndarray:
        return np.array(
            list(self.ambient)
            + list(self.diffuse)
            + list(self.specular)
            + list(self.transparency)
            + [self.refraction],
            dtype=np.float64,
        )


# ---------------------------------------------------------------------------
# Reference materials (Hw4/MySdlApplication.cpp:583-588).
# ---------------------------------------------------------------------------
WHITE_SQUARE = Material(
    ambient=_scale(WHITE, 0.1), diffuse=_scale(WHITE, 0.5), specular=WHITE,
    transparency=BLACK, refraction=1.0,
)
BLACK_SQUARE = Material(
    ambient=BLACK, diffuse=_scale(WHITE, 0.1), specular=BLACK,
    transparency=BLACK, refraction=1.0,
)
SPHERE_MATERIAL = Material(
    ambient=BLACK, diffuse=_scale(WHITE, 0.1), specular=WHITE,
    transparency=BLACK, refraction=1.0,
)
TETRAHEDRON_MATERIAL = Material(
    ambient=BLACK, diffuse=BLACK, specular=_scale(WHITE, 0.1),
    transparency=WHITE, refraction=2.0 / 3.0,
)
CUBE_MATERIAL = Material(
    ambient=_scale(RED, 0.1), diffuse=_scale(RED, 0.4), specular=RED,
    transparency=BLACK, refraction=1.0,
)
#: Default material (Material(), MySdlApplication.cpp:291-293) — all black,
#: refraction 1.  Used by bounding geometry.
DEFAULT_MATERIAL = Material()
