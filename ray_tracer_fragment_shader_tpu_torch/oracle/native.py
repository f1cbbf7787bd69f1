"""ctypes binding of the C++ reference oracle — the port's copy of the JAX
package's ``oracle/native.py``.

Builds ``cpp/reference_oracle.cpp`` (the port's own copy of the source)
with ``g++ -O2 -shared -fPIC`` on first use into the gitignored
``ray_tracer_fragment_shader_tpu_torch/_build/`` (the file name keyed by a
hash of the source and flags; never beside the source), and exposes
``cpp_oracle_render`` with ``oracle_render``'s signature: a second,
independent float64 implementation of the reference semantics.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..config import CameraConfig, RenderConfig
from ..scene.flat import FlatScene
from .numpy_ref import as_numpy

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "cpp", "reference_oracle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

SPH_W, TRI_W, MAT_W, LIGHT_W, GRP_W = 8, 16, 16, 8, 4


def library_path() -> str:
    """Where the oracle's library is built: under ``_build/``, named by a
    hash of the source and the flags."""
    with open(SRC, "rb") as f:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liboracle_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Builds the library if this source has none; its path.  Built under
    a temporary name and renamed, so processes building at once never load
    a half-written file."""
    path = library_path()
    with _lock:
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        d = ctypes.POINTER(ctypes.c_double)
        lib.oracle_render.restype = None
        lib.oracle_render.argtypes = [
            d, ctypes.c_int, d, ctypes.c_int, d, ctypes.c_int, d,
            ctypes.c_int, d, ctypes.c_int, d, d,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int, d]
        _lib = lib
    return _lib


def _pack(scene: FlatScene):
    f = lambda x: as_numpy(x).astype(np.float64)
    tv = as_numpy(scene.tri_valid).astype(bool)
    sv = as_numpy(scene.sph_valid).astype(bool)

    ns = int(sv.sum())
    sph = np.zeros((max(ns, 1), SPH_W))
    sph[:ns, 0:3] = f(scene.sph_center)[sv]
    sph[:ns, 3] = f(scene.sph_radius)[sv]
    sph[:ns, 4] = as_numpy(scene.sph_mat)[sv]
    sph[:ns, 5] = as_numpy(scene.sph_group)[sv]

    nt = int(tv.sum())
    tri = np.zeros((max(nt, 1), TRI_W))
    tri[:nt, 0:3] = f(scene.tri_v0)[tv]
    tri[:nt, 3:6] = f(scene.tri_v1)[tv]
    tri[:nt, 6:9] = f(scene.tri_v2)[tv]
    tri[:nt, 9] = as_numpy(scene.tri_mat)[tv]
    tri[:nt, 10] = as_numpy(scene.tri_checker)[tv]
    tri[:nt, 11] = as_numpy(scene.tri_group)[tv]

    m = scene.num_materials
    mat = np.zeros((m, MAT_W))
    mat[:, 0:3] = f(scene.mat_ambient)
    mat[:, 3:6] = f(scene.mat_diffuse)
    mat[:, 6:9] = f(scene.mat_specular)
    mat[:, 9:12] = f(scene.mat_transparency)
    mat[:, 12] = f(scene.mat_refraction)

    nl = scene.num_lights
    light = np.zeros((max(nl, 1), LIGHT_W))
    light[:nl, 0:3] = f(scene.light_pos)
    light[:nl, 3:6] = f(scene.light_color)

    ng = scene.num_groups
    grp = np.zeros((max(ng, 1), GRP_W))
    grp[:ng, 0:3] = f(scene.grp_center)
    grp[:ng, 3] = f(scene.grp_radius)

    board = np.zeros(8)
    board[0:3] = f(scene.board_pos)
    board[3] = float(scene.board_half)
    board[4] = float(scene.board_square)
    board[5], board[6] = scene.checker_mats
    return sph, ns, tri, nt, mat, m, light, nl, grp, ng, board


def cpp_oracle_render(scene: FlatScene, camera: CameraConfig,
                      config: RenderConfig) -> np.ndarray:
    """[H,W,3] float64 render via the C++ oracle (j=0 bottom scanline)."""
    lib = _load()
    sph, ns, tri, nt, mat, m, light, nl, grp, ng, board = _pack(scene)

    bx, by = camera.bottom(config.width, config.height)
    cam = np.array(list(camera.eye) + list(camera.look_at) + list(camera.up)
                   + [bx, by, camera.pixel_scale], np.float64)

    out = np.zeros((config.height, config.width, 3), np.float64)
    d = ctypes.POINTER(ctypes.c_double)
    as_p = lambda a: a.ctypes.data_as(d)
    lib.oracle_render(
        as_p(sph), ns, as_p(tri), nt, as_p(mat), m, as_p(light), nl,
        as_p(grp), ng, as_p(board), as_p(cam),
        config.width, config.height, config.max_depth,
        config.small_number, config.attenuation_factor,
        1 if config.prune else 0, 1, as_p(out))
    return out
