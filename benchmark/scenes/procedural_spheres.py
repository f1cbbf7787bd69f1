"""BASELINE config 5's procedural scene (``procedural_spheres``): a
checkerboard quad, ``spheres`` spheres whose positions, radii, lift and
shades are drawn uniformly from the record's ranges, and lights on board
squares.  With ``layout_seed`` the layout is the one a
``numpy.random.RandomState`` of that seed draws in the program's preset's
order (x, z, radius, lift, shade), the same for every ``--seed``, so the
seed changes the cell's traffic and not its work; without it the layout is
drawn from ``--seed``.  The board's two triangles are padded to 8, the
spheres to a multiple of 8; one prune group encloses everything; the two
checker materials come first, then one material a sphere."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark import inputs


def arrays(scene: dict, seed: int) -> Dict[str, np.ndarray]:
    """The flat scene of the ``scene`` record for ``seed``: the arrays
    keyed by field name, float32, int32 and bool."""
    g = (np.random.RandomState(int(scene["layout_seed"]))
         if "layout_seed" in scene else inputs.rng(seed, inputs.SCENE))
    square, half = float(scene["square"]), float(scene["board_half"])
    board = np.asarray(scene["board_position"], np.float64)
    mats: List[Tuple[float, ...]] = [tuple(scene["white_square"]),
                                     tuple(scene["black_square"])]
    spheres = []
    lo, hi = scene["radius_squares"]
    lift_lo, lift_hi = scene["lift_squares"]
    s_lo, s_hi = scene["shade"]
    reach = scene["spread"] * half
    for _ in range(int(scene["spheres"])):
        x = g.uniform(-reach, reach)
        z = g.uniform(-reach, reach)
        r = g.uniform(lo, hi) * square
        y = r + g.uniform(lift_lo, lift_hi) * square
        shade = g.uniform(s_lo, s_hi, size=3)
        row = inputs.material_row(scene["ambient"] * shade,
                                  scene["diffuse"] * shade,
                                  scene["specular"] * shade)
        if row not in mats:
            mats.append(row)
        spheres.append((board + (x, y, z), r, mats.index(row)))
    # the board quad (p1 p2 p3), (p1 p3 p4) at y = 0, checker material 0
    p = [board + c for c in ((-half, 0.0, -half), (half, 0.0, -half),
                             (half, 0.0, half), (-half, 0.0, half))]
    tris = [(p[0], p[1], p[2]), (p[0], p[2], p[3])]
    lights = [(board + inputs.board_square(sq, square, half)
               + (0.0, 3.5 * square, 0.0), np.asarray(col, np.float64))
              for sq, col in scene["lights"]]

    nt, ns = inputs.pad(len(tris)), inputs.pad(len(spheres))
    tv = np.zeros((3, nt, 3))
    tv[1, :, 0] = 1.0
    tv[2, :, 1] = 1.0
    tv[:, :, 2] = 1e8
    for i, tri in enumerate(tris):
        for k in range(3):
            tv[k, i] = tri[k]
    center = np.zeros((ns, 3))
    center[:, 2] = 1e8
    radius = np.ones(ns)
    sph_mat = np.zeros(ns, np.int32)
    for i, (c, r, m) in enumerate(spheres):
        center[i], radius[i], sph_mat[i] = c, r, m
    far = max([float(np.linalg.norm(v - board)) for t in tris for v in t]
              + [float(np.linalg.norm(c - board)) + r for c, r, _ in spheres])
    mt = np.asarray(mats, np.float64)
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        sph_center=f32(center), sph_radius=f32(radius), sph_mat=sph_mat,
        sph_group=np.zeros(ns, np.int32),
        sph_valid=np.arange(ns) < len(spheres),
        tri_v0=f32(tv[0]), tri_v1=f32(tv[1]), tri_v2=f32(tv[2]),
        tri_mat=np.zeros(nt, np.int32),
        tri_checker=np.arange(nt) < len(tris),
        tri_group=np.zeros(nt, np.int32),
        tri_valid=np.arange(nt) < len(tris),
        grp_center=f32(board[None]), grp_radius=f32([far * 1.001 + 1.0]),
        mat_ambient=f32(mt[:, 0:3]), mat_diffuse=f32(mt[:, 3:6]),
        mat_specular=f32(mt[:, 6:9]), mat_transparency=f32(mt[:, 9:12]),
        mat_refraction=f32(mt[:, 12]),
        light_pos=f32([l[0] for l in lights]),
        light_color=f32([l[1] for l in lights]),
        board_pos=f32(board), board_half=f32(half), board_square=f32(square))
