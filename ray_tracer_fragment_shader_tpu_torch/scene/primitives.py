"""Triangle-soup generators for the composite objects.

The reference builds every non-sphere object out of ``Triangle`` children at
construction time (``Hw4/MySdlApplication.cpp:826-1061``); these functions do
the same, emitting vertex arrays in *board-local* coordinates (the builder
adds the scene/board offset, mirroring the accumulated ``positionOffset`` of
``Shape::intersection``, ``:739``).

Vertex winding is preserved exactly: the triangle's geometric normal
``n = normalize((v1-v0) x (v2-v0))`` (``:413-422``) is never flipped toward
the incoming ray, and its sign feeds the transmitted-ray formula.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

Tri = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _t(a, b, c) -> Tri:
    return (np.asarray(a, np.float64), np.asarray(b, np.float64),
            np.asarray(c, np.float64))


def quad(p, p1, p2, p3, p4) -> List[Tri]:
    """Two triangles sharing a plane (Quad ctor, MySdlApplication.cpp:826-843)."""
    p = np.asarray(p, np.float64)
    p1, p2, p3, p4 = (np.asarray(x, np.float64) + p for x in (p1, p2, p3, p4))
    return [_t(p1, p2, p3), _t(p1, p3, p4)]


def tetrahedron(center, edge: float) -> List[Tri]:
    """Corner-slice tetrahedron (Tetrahedron ctor, MySdlApplication.cpp:863-900):
    bottom/back/left faces of a cube corner plus the diagonal front face."""
    c = np.asarray(center, np.float64)
    h = edge / 2.0
    a = c + (-h, -h, -h)
    b = c + (h, -h, -h)
    d = c + (-h, -h, h)
    e = c + (-h, h, -h)
    return [
        _t(a, b, d),  # bottom
        _t(a, d, e),  # back
        _t(a, e, d),  # left (duplicate plane of 'back' with swapped winding,
                      #       exactly as the reference builds it)
        _t(d, b, e),  # front (slicing plane)
    ]


def tetrahedron_bounding_radius(edge: float) -> float:
    return math.sqrt(3.0) * edge / 2.0


def cube(center, edge: float) -> List[Tri]:
    """Axis-aligned cube of 6 quads (Cube ctor, MySdlApplication.cpp:903-950)."""
    c = np.asarray(center, np.float64)
    h = edge / 2.0
    tris: List[Tri] = []
    # (p1, p2, p3, p4) per face, in the reference's order: top, bottom, left,
    # right, back, front.
    faces = [
        ((-h, h, -h), (h, h, -h), (h, h, h), (-h, h, h)),
        ((-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)),
        ((-h, -h, -h), (-h, h, -h), (-h, h, h), (-h, -h, h)),
        ((h, -h, -h), (h, h, -h), (h, h, h), (h, -h, h)),
        ((-h, -h, -h), (h, -h, -h), (h, h, -h), (-h, h, -h)),
        ((-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h)),
    ]
    for p1, p2, p3, p4 in faces:
        tris.extend(quad(c, p1, p2, p3, p4))
    return tris


def cube_bounding_radius(edge: float) -> float:
    return math.sqrt(3.0) * edge / 2.0


def _ring_points(p, radius: float, num_points: int, style: str) -> List[np.ndarray]:
    """The cylinder/cone base ring.  ``style='reference'`` reproduces the
    reference's degree-as-radian bug: ``dr = 360/numPoints`` is fed to
    cos/sin as radians (MySdlApplication.cpp:968-977, 1038-1047), producing a
    star-like self-intersecting ring.  ``style='fixed'`` uses 2*pi/numPoints.
    """
    dr = (360.0 / num_points) if style == "reference" else (2.0 * math.pi / num_points)
    pts = []
    for i in range(num_points):
        x = p[0] + radius * math.cos(dr * i)
        z = p[2] + radius * math.sin(dr * i)
        pts.append(np.array([x, p[1], z], np.float64))
    return pts


def cylinder(center, radius: float, height: float, *, style: str = "reference",
             num_points: int = 10) -> List[Tri]:
    """Triangulated prism (Cylinder ctor, MySdlApplication.cpp:953-998).

    The reference ``Cylinder`` never renders: its ``intersection`` override is
    empty (``:1000-1020``) so neither it nor its children are ever hit.  With
    ``style='reference'`` we preserve that observable behaviour by emitting no
    geometry.  ``style='reference_geometry'`` emits the (buggy-ring) soup the
    constructor builds; ``style='fixed'`` emits a sane cylinder.
    """
    if style == "reference":
        return []
    ring_style = "fixed" if style == "fixed" else "reference"
    c = np.asarray(center, np.float64)
    top = np.array([0.0, height, 0.0])
    p = c - top
    pts = _ring_points(p, radius, num_points, ring_style)
    tris: List[Tri] = []
    for i in range(1, num_points - 1):
        tris.append(_t(pts[0], pts[i], pts[i + 1]))                    # bottom fan
        tris.append(_t(pts[0] + top, pts[i] + top, pts[i + 1] + top))  # top fan
    for i in range(num_points):
        j = (i + 1) % num_points
        tris.append(_t(pts[i], pts[j] + top, pts[i] + top))
        tris.append(_t(pts[i], pts[j], pts[j] + top))
    return tris


def cone(center, radius: float, height: float, *, style: str = "reference",
         num_points: int = 10) -> List[Tri]:
    """Triangulated cone (Cone ctor, MySdlApplication.cpp:1023-1061): base fan
    at ``center.y - height`` plus side fan meeting at the apex ``center``.
    ``style='reference'`` keeps the degree-as-radian ring; ``style='fixed'``
    uses proper angles.  Unlike Cylinder, the reference Cone inherits the
    working ``Shape::intersection`` and does render."""
    c = np.asarray(center, np.float64)
    top = np.array([0.0, height, 0.0])
    p = c - top
    pts = _ring_points(p, radius, num_points,
                       "reference" if style == "reference" else "fixed")
    tris: List[Tri] = []
    for i in range(1, num_points - 1):
        tris.append(_t(pts[0], pts[i], pts[i + 1]))
    apex = p + top  # == center (the shift cancels, :1040+1059)
    for i in range(num_points):
        j = (i + 1) % num_points
        tris.append(_t(pts[i], pts[j], apex))
    return tris


def checkerboard(board_pos_local, half_size: float) -> List[Tri]:
    """The board's bounding quad at y=0 spanning +-half_size
    (CheckerBoard ctor, MySdlApplication.cpp:1064-1082).  Material is chosen
    procedurally at shading time by square parity (``:1101-1111``)."""
    h = half_size
    return quad(board_pos_local,
                (-h, 0.0, -h), (h, 0.0, -h), (h, 0.0, h), (-h, 0.0, h))
