"""The inputs of every cell, made from ``--seed`` as plain numpy arrays and
floats: a configuration's scene (the data, as weights are for a model),
each fit job's moved sphere centres, each orbit frame's eye.  Both the
program and the reference are handed the same arrays.

The scene follows the configuration file's ``scene`` record, built by the
module of its ``kind``, ``scenes/<kind>.py`` (``arrays(scene, seed)``),
found by that name.  The arrays are those a scene builder of the program
makes: triangles padded to 8, spheres padded to a multiple of 8, prune
groups, the two checker materials first.
"""
from __future__ import annotations

import importlib.util
import math
import os
from typing import Callable, Dict, Tuple

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
#: the streams drawn from one seed, one a purpose
SCENE, JOBS, ORBIT, SAMPLE = range(4)
_BUILDERS: Dict[str, Callable] = {}


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed`` (any whole number)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def board_square(coord: str, square: float, half: float) -> np.ndarray:
    """The board-local point of a square such as "b6" raised 1.5 squares:
    the row letter walks -z from the near edge, the column digit +x from
    the left edge (the reference's ``convertStringCoordinate``)."""
    row, col = ord(coord[0]) - ord("a"), ord(coord[1]) - ord("1")
    return np.array([-half + (col + 0.5) * square, 1.5 * square,
                     half - (row + 0.5) * square])


def material_row(ambient, diffuse, specular, transparency=(0.0, 0.0, 0.0),
                 refraction=1.0) -> Tuple[float, ...]:
    return (*ambient, *diffuse, *specular, *transparency, refraction)


def pad(n: int, multiple: int = 8) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def scene_builder(kind: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``<bench_dir>/scenes/<kind>.py``'s ``arrays(scene, seed)``."""
    path = os.path.join(bench_dir, "scenes", f"{kind}.py")
    if path not in _BUILDERS:
        spec = importlib.util.spec_from_file_location(
            f"benchmark_scene_{kind}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _BUILDERS[path] = mod.arrays
    return _BUILDERS[path]


def scene_arrays(scene: dict, seed: int,
                 bench_dir: str = BENCH_DIR) -> Dict[str, np.ndarray]:
    """The flat scene of the configuration's ``scene`` record for ``seed``,
    made by the builder of its ``kind``: the arrays keyed by field name,
    float32, int32 and bool."""
    return scene_builder(scene["kind"], bench_dir)(scene, seed)


def scene_meta(arrays: Dict[str, np.ndarray]) -> dict:
    """The scene's flags: the checker materials' rows, whether every
    material traces at most one child ray (so the bounce chain is exact),
    and whether any transmits."""
    t = arrays["mat_transparency"]
    t_any = (t != 0).any(-1)
    o_any = ((1.0 - t) != 0).any(-1)
    return dict(checker_mats=(0, 1),
                chain_exact=bool((~(t_any & o_any)).all()),
                has_transmission=bool(t_any.any()))


def job_offsets(arrays: Dict[str, np.ndarray], seed: int, jobs: int,
                move: float) -> np.ndarray:
    """[jobs, Ns, 3] float32: each job's move of every sphere centre, a
    uniform direction of length ``move`` (0 on padding rows)."""
    d = rng(seed, JOBS).normal(size=(jobs,) + arrays["sph_center"].shape)
    d *= move / np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, ~arrays["sph_valid"]] = 0.0
    return d.astype(np.float32)


def orbit_start(seed: int) -> float:
    """The turntable's first angle, in radians."""
    return float(rng(seed, ORBIT).uniform(0.0, 2.0 * math.pi))


def orbit_eye(camera: dict, start: float, step_deg: float,
              k: int) -> Tuple[float, float, float]:
    """Frame ``k``'s eye: the configuration's eye turned about the vertical
    axis through ``look_at`` by ``start + k * step_deg``."""
    a = start + math.radians(step_deg) * k
    ex, ey, ez = camera["eye"]
    cx, _, cz = camera["look_at"]
    dx, dz = ex - cx, ez - cz
    return (cx + dx * math.cos(a) + dz * math.sin(a), ey,
            cz - dx * math.sin(a) + dz * math.cos(a))
