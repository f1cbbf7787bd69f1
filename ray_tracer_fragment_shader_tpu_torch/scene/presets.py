"""Named scene presets: the reference demo scene plus the five BASELINE.json
benchmark configurations."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import CameraConfig, RenderConfig, SQUARE_EDGE_SIZE
from .builder import SceneBuilder
from .flat import FlatScene
from .materials import Material

Preset = Tuple[FlatScene, CameraConfig, RenderConfig]

#: World-unit width of the benchmark viewing window.  The reference couples
#: window size to resolution (1 unit/pixel, 500x500); benchmark presets
#: instead fix a 512-unit window and scale pixels so every resolution frames
#: the same scene.
FRAME = 512.0


def _cam(size: int) -> CameraConfig:
    return CameraConfig(pixel_scale=FRAME / size)


def reference_demo(dtype=np.float32) -> Preset:
    """The canonical regression scene hard-coded in ``initScene``
    (Hw4/MySdlApplication.cpp:1387-1428): checkerboard, light at b6,
    tetrahedron at b4, sphere at d7, cube at a7, 500x500 window with
    16-sample supersampling and depth-5 recursion."""
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_light("b6")
             .add_tetrahedron("b4")
             .add_sphere("d7")
             .add_cube("a7")
             .build(dtype=dtype))
    return scene, CameraConfig(), RenderConfig(width=500, height=500,
                                               max_depth=5, samples=16)


def single_sphere(size: int = 256, dtype=np.float32) -> Preset:
    """BASELINE config 1: single diffuse sphere + 1 point light, primary rays
    only."""
    diffuse = Material(ambient=(0.05, 0.05, 0.05), diffuse=(0.7, 0.4, 0.3),
                       specular=(0.0, 0.0, 0.0))
    scene = (SceneBuilder()
             .add_sphere("d4", radius=1.5 * SQUARE_EDGE_SIZE, material=diffuse)
             .add_light("b6")
             .build(dtype=dtype))
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=0, samples=1)


def three_spheres_ground(size: int = 512, dtype=np.float32) -> Preset:
    """BASELINE config 2: 3 spheres + ground plane, Phong + hard shadows."""
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_sphere("c3")
             .add_sphere("d6", radius=0.75 * SQUARE_EDGE_SIZE)
             .add_sphere("f4",
                         material=Material(ambient=(0.05, 0.0, 0.0),
                                           diffuse=(0.6, 0.1, 0.1),
                                           specular=(0.9, 0.9, 0.9)))
             .add_light("b6")
             .build(dtype=dtype))
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=0, samples=1)


def full_reflective(size: int = 1024, depth: int = 2, dtype=np.float32) -> Preset:
    """BASELINE config 3: full scene with depth-``depth`` specular
    reflections (opaque materials only, so the chain renderer is exact and
    single-path)."""
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_sphere("d7")
             .add_sphere("c3", radius=0.75 * SQUARE_EDGE_SIZE)
             .add_sphere("f5", radius=0.6 * SQUARE_EDGE_SIZE)
             .add_cube("a7")
             .add_light("b6")
             .build(dtype=dtype))
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=depth, samples=1)


def fit_target(size: int = 512, dtype=np.float32) -> Preset:
    """BASELINE config 4 target scene: the differentiable-fit workload
    recovers sphere centers/radii + light position from this render."""
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_sphere("c3")
             .add_sphere("e6", radius=0.8 * SQUARE_EDGE_SIZE)
             .add_light("c6")
             .build(dtype=dtype))
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=1, samples=1)


def procedural_spheres(n: int = 64, size: int = 4096, depth: int = 3,
                       seed: int = 1234, dtype=np.float32) -> Preset:
    """BASELINE config 5: n-sphere procedural scene, depth-3 bounces, for the
    multi-host sharded render."""
    rng = np.random.RandomState(seed)
    b = SceneBuilder(scene_radius=None).add_checkerboard()
    half = b.board_half
    for i in range(n):
        x = rng.uniform(-0.9 * half, 0.9 * half)
        z = rng.uniform(-0.9 * half, 0.9 * half)
        r = rng.uniform(0.2, 0.6) * SQUARE_EDGE_SIZE
        y = r + rng.uniform(0.0, 2.0) * SQUARE_EDGE_SIZE
        shade = rng.uniform(0.2, 1.0, size=3)
        mat = Material(ambient=tuple(0.05 * shade), diffuse=tuple(0.4 * shade),
                       specular=tuple(shade))
        b.add_sphere((x, y, z), radius=r, material=mat)
    b.add_light("b6").add_light("g7", color=(0.6, 0.6, 0.9))
    scene = b.build(dtype=dtype)
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=depth, samples=1)


def fractional_glass(size: int = 128, depth: int = 2,
                     dtype=np.float32) -> Preset:
    """A glass sphere of fractional transparency (T=0.5) beside an opaque
    one: the reference's rayTraceRay then traces BOTH a transmitted child
    weighted T and a reflected child weighted 1-T (MySdlApplication.cpp
    :1238-1246) — the bounce tree, not a chain.  The scene of the JAX
    package's tests/test_pallas.py::_fractional_scene; not a CLI preset."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_sphere("d5", material=glass)
             .add_sphere("c3")
             .add_light("b6")
             .build(dtype=dtype))
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=depth, samples=1)


def glass_cube(size: int = 128, depth: int = 7,
               dtype=np.float32) -> Preset:
    """A cube of fractional glass (T=0.5, refraction 0.9) beside an opaque
    sphere: a ray that enters the cube meets its faces one triangle after
    another, and every hit spawns a transmitted and a reflected child, so
    its bounce trees stay alive to the deepest levels (at 16^2 and depth
    10, hits on every level; ``fractional_glass``'s end by level 3).  The
    scene of the deep-tree fits (K6/K7 at depths 7-10); not a CLI
    preset."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_cube("d5", material=glass)
             .add_sphere("c3")
             .add_light("b6")
             .build(dtype=dtype))
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=depth, samples=1)


def glass_chain(size: int = 128, depth: int = 1,
                dtype=np.float32) -> Preset:
    """A fully transparent glass sphere (T=1, refraction 0.9) beside an
    opaque one, lit by two lights: a chain-exact scene on which the chain
    takes the transmitted child (Snell) and the packed residual carries two
    lit bits.  The scene of the JAX package's
    tests/test_adjoint_fused.py::test_twophase_packed_transmitting_chain;
    not a CLI preset."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(1.0, 1.0, 1.0),
                     refraction=0.9)
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_sphere("d5", material=glass)
             .add_sphere("c3")
             .add_light("b6")
             .add_light("f7", color=(0.8, 0.9, 1.0))
             .build(dtype=dtype))
    return scene, _cam(size), RenderConfig(width=size, height=size,
                                           max_depth=depth, samples=1)


def pack_overflow(size: int = 128, fractional: bool = True,
                  dtype=np.float32) -> Preset:
    """BASELINE config 5's 66 primitives lit by 15 lights, depth 1: its
    packed residual word would need 128 x 128 x 2^15 > 2^24
    (``kernels/render.py::pack_widths``), so K3/K4 refuse it.  With
    ``fractional`` its first sphere's material is made fractional
    (transparency 0.5, refraction 0.9), so the fit takes K6/K7's tree form;
    without, it is a chain scene for K6/K7's chain form or split mode.  Not
    a CLI preset."""
    scene, cam, cfg = procedural_spheres(n=64, size=size, depth=1,
                                         dtype=dtype)
    rng = np.random.RandomState(3)
    pos = rng.uniform(-150.0, 150.0, size=(15, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1]) + 150.0
    scene = scene.replace(
        light_pos=torch.from_numpy(pos).to(scene.light_pos.dtype),
        light_color=torch.full((15, 3), 0.1, dtype=scene.light_color.dtype))
    if fractional:
        m = int(scene.sph_mat[0])
        trans = scene.mat_transparency.clone()
        rho = scene.mat_refraction.clone()
        trans[m], rho[m] = 0.5, 0.9
        scene = scene.replace(mat_transparency=trans, mat_refraction=rho,
                              chain_exact=False, has_transmission=True)
    return scene, cam, cfg


PRESETS = {
    "reference_demo": reference_demo,
    "single_sphere": single_sphere,
    "three_spheres_ground": three_spheres_ground,
    "full_reflective": full_reflective,
    "fit_target": fit_target,
    "procedural_spheres": procedural_spheres,
}
