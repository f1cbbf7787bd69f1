"""The look-at scanline of even-size frames, on the CPU: every forward of
the kernel path against the port's f64 oracle there, whole images against
the JAX core, and fwd+bwd steps against ``jax.value_and_grad`` of the JAX
core's ``l2_loss``.

At an even frame height the middle scanline's rays pass through the
camera's look-at point, which lies on an edge of the board's checker
squares: the square, and with it the material, turns on the last bits of
the hit point.  The core, the oracle and the reference form a triangle's
hit point as o + m*v (m the plane parameter along the unnormalised
direction v); so do the kernels and their plain versions
(csrc/tile_ops.cuh::hit_attrs, kernels/render.py::_PlainOps.hit_attrs,
csrc/adjoint_ops.cuh::node_primal, kernels/adjoint.py::_node_math).  Formed
as o + |v|*m*u, the point rounds off the edge, and about a third of the
board pixels of that row took the other square.

* The scanline: the chain forward (``render_image_kernel``), the packed
  forward with its residual planes, the chain's and the tree's residual
  forms and the tree forward (on ``presets.fractional_glass``), each
  against ``oracle/numpy_ref.py`` (one ``trace_ray`` a pixel of the row):
  every pixel within 1e-3, and each level-0 material id of the planes
  equal to the oracle's primary hit's.  Two even sizes and an odd one of
  ``fit_target``, ``reference_demo`` at one sample, ``full_reflective``
  at depth 3 and the tree scene, ``fit_target`` at 64^2 and
  ``full_reflective`` at 128^2.  (At the full sizes, 500^2 and 1024^2,
  a few pixels of the row reflect off an object back onto the same edge
  line, where float32 and float64 round the bounce apart: chip_smoke.py's
  phase 21 holds those against the oracle's colour with that bounce on the
  other square, ``oracle_pixels(..., ties=True)``, whose walk
  ``test_oracle_tie_walk_flips_the_edge_square`` checks.)
* Whole images: the chain forward against the JAX core's renders of
  every image case, at most two pixels over 1e-3, and at each of them the
  port within 1e-3 of the oracle (traced for that pixel).  Measured: 0
  pixels on every case but full_reflective, 1 at 32^2 and 2 at 64^2.  At
  32^2 (16, 25) and 64^2 (32, 50), on the look-at row, the JAX core
  leaves the oracle by 0.87 where the port is within 4.5e-8 of it; at
  64^2 (40, 27) the two part by 1.13e-3, the port 4.1e-4 from the oracle
  and JAX 7.3e-4.
* Steps: ``fit_value_and_grad`` in each mode ("twophase": the plain K3
  and K4; "fused": K6's; "split": the residual forward and K8's) from the
  sphere centres and the lights moved by 1.5, to the port's render of the
  scene at an even size of each preset, against the JAX core's autodiff:
  the loss within 1e-3 relative and each table within 2e-3 of max|JAX|,
  tests/test_torch_scripts.py's tolerances for the kernel path against
  the core.

The JAX side runs in two subprocesses started as the module starts
(``tests/torch_checker_edge_ref.py``'s parts, ``tests/torch_jax_ref.py``:
no interpret mode, no fused multiply-adds in XLA's CPU programs).
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_jax_ref
from torch_checker_edge_ref import (DEPTH, FIELDS, IMAGE_CASES, MOVE,
                                    PARTS, STEP_CASES, TREE_SIZES, key)
from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.oracle import numpy_ref as NR
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
    Camera, primary_rays, screen_points)
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets

CPU = torch.device("cpu")
TOL = 1e-3
LOSS_TOL, GRAD_TOL = 1e-3, 2e-3
#: every scanline case: the image cases, the tree scene's, fit_target at
#: 64^2 and full_reflective at 128^2
SCANLINE_CASES = (IMAGE_CASES
                  + tuple(("fractional_glass", n) for n in TREE_SIZES)
                  + (("fit_target", 64), ("full_reflective", 128)))
MODES = ("twophase", "fused", "split")


def port_preset(name, size):
    """The port's (scene, CameraConfig, RenderConfig) of a case (the JAX
    side's ``torch_checker_edge_ref.jax_preset``)."""
    if name == "reference_demo":
        s, c, f = tpresets.reference_demo()
        return s, c, dataclasses.replace(f, width=size, height=size,
                                         samples=1)
    if name in ("full_reflective", "fractional_glass"):
        return getattr(tpresets, name)(size=size, depth=DEPTH)
    return getattr(tpresets, name)(size=size)


def oracle_pixels(scene, cam, cfg, pixels):
    """Pixels ``[(j, i), ...]`` by the f64 oracle: the colours [N,3] and the
    primary hit's material id (-1 on a miss)."""
    colours, hits = NR.oracle_pixels(scene, cam, cfg, pixels)
    return colours, np.asarray([-1 if h is None else h.mat_id for h in hits])


@pytest.fixture(scope="module")
def targets():
    """The port's render of each step case's scene: the steps' targets."""
    return {key(name, n): K.render_image_kernel(*port_preset(name, n),
                                                device=CPU)
            for name, n in STEP_CASES}


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory, targets):
    """The module's JAX subprocesses, started as the module starts."""
    tmp = tmp_path_factory.mktemp("checker_edge")
    inputs = {k: t.numpy() for k, t in targets.items()}
    pending = [torch_jax_ref.start("tests/torch_checker_edge_ref.py",
                                   tmp / f"{part}.npz", inputs, extra=[part])
               for part in PARTS]
    yield pending
    for p in pending:
        p.cancel()


@pytest.fixture(scope="module")
def ref(jax_side):
    out = {}
    for p in jax_side:
        out.update(p.result())
    return out


@pytest.fixture(scope="module")
def oracle():
    """Each scanline case's look-at row by the oracle."""
    out = {}
    for name, n in SCANLINE_CASES:
        s, c, f = port_preset(name, n)
        out[key(name, n)] = oracle_pixels(s, c, f,
                                          [(n // 2, i) for i in range(n)])
    return out


@pytest.fixture(scope="module")
def images():
    return {key(name, n): K.render_image_kernel(*port_preset(name, n),
                                                device=CPU)
            for name, n in SCANLINE_CASES}


def forward_inputs(name, n):
    """The forwards' inputs of a case: tables, rays, eye, render keywords
    and the pack (None where the scene is not chain-exact)."""
    scene, cam, cfg = port_preset(name, n)
    camera = Camera.from_config(cam, n, n, device=CPU)
    _, v = primary_rays(camera, screen_points(camera, n, n))
    scene_c, tables, kw = AF.scene_tables(scene, cfg, CPU)
    pack = (K.pack_widths(tables["tri"].shape[0], scene_c.num_spheres,
                          scene_c.num_materials, scene_c.num_lights)
            if scene_c.chain_exact else None)
    return tables, v.contiguous(), camera.eye.tolist(), kw, pack


def row(x, n):
    """The look-at row of a [P, ...] or [K, P] tensor of an n x n frame."""
    if x.shape[0] == n * n:
        return x.reshape(n, n, *x.shape[1:])[n // 2].numpy()
    return x.reshape(*x.shape[:-1], n, n)[..., n // 2, :].numpy()


def assert_scanline(oracle, name, n, img_row, mid0=None):
    want, mids = oracle[key(name, n)]
    bad = np.flatnonzero(np.abs(img_row - want).max(-1) > TOL)
    assert bad.size == 0, (f"{name} {n}^2 row {n // 2}: {bad.size} pixels "
                           f"over {TOL} at columns {bad.tolist()}")
    if mid0 is not None:
        hit = mids >= 0
        assert np.array_equal(mid0[hit], mids[hit]), (
            f"{name} {n}^2: level-0 materials differ at columns "
            f"{np.flatnonzero(hit & (mid0 != mids)).tolist()}")


@pytest.mark.parametrize("name,n", SCANLINE_CASES,
                         ids=[key(*c) for c in SCANLINE_CASES])
def test_scanline_of_the_frame_matches_the_oracle(oracle, images, name, n):
    """``render_image_kernel`` (the chain forward; the tree forward on the
    tree scene)."""
    assert_scanline(oracle, name, n, images[key(name, n)][n // 2].numpy())


@pytest.mark.parametrize("name,n", SCANLINE_CASES,
                         ids=[key(*c) for c in SCANLINE_CASES])
def test_scanline_of_the_residual_form_matches_the_oracle(oracle, name, n):
    """The chain's or the tree's residual forward: its image and its
    level-0 material plane."""
    tables, v, eye, kw, pack = forward_inputs(name, n)
    img, res = K.render_residuals(tables, v, eye, tree=pack is None, **kw)
    assert_scanline(oracle, name, n, row(img, n), row(res["mid"][0], n))


@pytest.mark.parametrize("name,n", [c for c in SCANLINE_CASES
                                    if c[0] != "fractional_glass"],
                         ids=[key(*c) for c in SCANLINE_CASES
                              if c[0] != "fractional_glass"])
def test_scanline_of_the_packed_forward_matches_the_oracle(oracle, name, n):
    """The packed forward (K3's plain version): its image, and the
    level-0 material of its packed plane, which equals the residual
    form's planes."""
    tables, v, eye, kw, pack = forward_inputs(name, n)
    img, pk = K.render_packed(tables, v, eye, pack=pack, **kw)
    planes = K.unpack_residuals(pk, kw["nl"], pack)
    _, res = K.render_residuals(tables, v, eye, tree=False, **kw)
    for f in ("bi", "mid", "lit"):
        assert torch.equal(planes[f], res[f]), f
    assert_scanline(oracle, name, n, row(img, n), row(planes["mid"][0], n))


@pytest.mark.parametrize("name,n", IMAGE_CASES,
                         ids=[key(*c) for c in IMAGE_CASES])
def test_image_matches_jax_core(ref, images, name, n):
    got = images[key(name, n)].numpy()
    want = ref["img/" + key(name, n)]
    over = np.argwhere(np.abs(got - want).max(-1) > TOL)
    assert len(over) <= 2, f"{name} {n}^2: {len(over)} pixels over {TOL}"
    if len(over):
        orc, _ = oracle_pixels(*port_preset(name, n), over.tolist())
        err = np.abs(got[tuple(over.T)] - orc).max(-1)
        assert (err <= TOL).all(), (
            f"{name} {n}^2: the port leaves the oracle at "
            f"{over[err > TOL].tolist()}")


@pytest.fixture(scope="module")
def steps(targets):
    """(loss, gradients) of each step case in each mode."""
    out = {}
    for name, n in STEP_CASES:
        scene, cam, cfg = port_preset(name, n)
        camera = Camera.from_config(cam, n, n, device=CPU)
        for mode in MODES:
            params = FitParams.from_scene(scene)
            with torch.no_grad():
                params.sph_center += MOVE
                params.light_pos += MOVE
            out[key(name, n), mode] = AF.fit_value_and_grad(
                params, scene, camera, cfg, targets[key(name, n)],
                mode=mode, device=CPU)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,n", STEP_CASES,
                         ids=[key(*c) for c in STEP_CASES])
def test_step_matches_jax_core(ref, steps, name, n, mode):
    loss, grads = steps[key(name, n), mode]
    want = float(ref["loss/" + key(name, n)])
    assert abs(float(loss) - want) <= LOSS_TOL * abs(want), (float(loss),
                                                              want)
    for f in FIELDS:
        w = ref[f"grad/{key(name, n)}/{f}"]
        g = grads[f].detach().numpy()
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, f"{f}: {err:.3g} of max|JAX|"


@pytest.mark.parametrize("dz,flipped", [(1e-3, False), (-1e-3, True)],
                         ids=["same-square", "other-square"])
def test_oracle_tie_walk_flips_the_edge_square(dz, flipped):
    """``trace_ray``'s tie walk, the oracle's side of chip_smoke.py's phase
    21: a bounce after the primary hit that meets the board on a square's
    edge is listed by its path, and traced with that path in ``flip`` it
    takes the other square, the colour of a ray moved 1e-3 units (2.5e-5
    squares) into that square.  The ray is fit_target's of pixel (8, 5) at
    16^2, meeting the board at m = 1 on the edge pz = -160, named here as
    the reflected bounce ("r",); as a primary ray it is never listed."""
    scene, _, cfg = port_preset("fit_target", 16)
    sc = NR.OracleScene.from_flat(scene, small=cfg.small_number)
    args = (cfg.max_depth, cfg.small_number, cfg.attenuation_factor,
            cfg.prune)
    o, v = np.array([0.0, 100.0, 200.0]), np.array([-96.0, -100.0, -360.0])
    edges, moved_edges, primary_edges = [], [], []
    same = NR.trace_ray(sc, o, v, *args, edges=edges, path=("r",))
    other = NR.trace_ray(sc, o, v, *args, flip=frozenset(edges),
                         path=("r",))
    moved = NR.trace_ray(sc, o, v + np.array([0.0, 0.0, dz]), *args,
                         edges=moved_edges, path=("r",))
    NR.trace_ray(sc, o, v, *args, edges=primary_edges)
    assert edges == [("r",)] and moved_edges == [] and primary_edges == []
    assert np.abs(other - same).max() > 0.1
    assert np.abs((other if flipped else same) - moved).max() <= 1e-5
