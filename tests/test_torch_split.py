"""The port's split mode and differentiable render against the JAX package,
on the CPU: the residual forward (kernels.render: ``render_residuals``,
``render_forward_with_residuals``), K8's entry points and the split branch
of ``fit_value_and_grad`` (kernels.adjoint_fused), ``render_image_diff``
and ``l2_loss_kernel`` (kernels.adjoint), the port's copy of the f64 oracle
(oracle/) and ``grad_bar.py``.

Here the wrappers run their plain versions.  The JAX side runs its Pallas
kernels in interpret mode once per function, at 33², depth 1, from one
module-scoped fixture (the residual forward and ``fit_grads_pallas``;
33, not 32: at an even size the middle scanline passes through the look-at
point, on a checker edge, where JAX's own kernel, which forms a triangle's
hit point as o + |v|*m*u, leaves the f64 oracle: 2 of the 32 pixels of
that row of ``fit_target`` at 32^2, where the port's forwards, forming it
as o + m*v, equal the oracle; tests/test_torch_checker_edge.py holds the
port at even sizes against the oracle and the JAX core);
everything else is held against its XLA replays
(kernels/adjoint.py::replay_render, replay_render_tree) and its oracle.

Tolerances: the residual planes equal JAX's exactly and the image is within
2e-4 (measured 9.3e-5: the two renders round hit points and reciprocals in
their own order); the JAX replay of the port's planes reproduces the image
within atol 2e-3 on the chain (tests/test_adjoint.py) and 1e-4 on the tree
(tests/test_adjoint_tree.py:58); K8's plain version against
``fit_grads_pallas`` on the same planes and cotangent, and
``render_image_diff``'s scene and camera gradients against ``jax.vjp`` of the
replay, within 5e-4 of max per field (float32 reassociation, as
tests/test_adjoint_fused.py:46-51); split against two-phase, and
``l2_loss_kernel``'s gradients against split, within 1e-5 of max (the same
replay under the same cotangent up to its rounding); the oracle copy bit for
bit; the f64 finite-difference bar max-abs-err <= 1e-4 (BASELINE.md).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
    replay_render as j_replay)
from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
    replay_render_tree as j_replay_tree)
from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
    fit_grads_pallas as j_fit_grads_pallas)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    compact_scene as j_compact)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    pack_widths as j_pack_widths)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    render_forward_with_residuals as j_forward_with_residuals)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera as JCamera
from ray_tracer_fragment_shader_tpu.oracle import (
    oracle_render as j_oracle_render)
from ray_tracer_fragment_shader_tpu.scene import Material, SceneBuilder
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets
from ray_tracer_fragment_shader_tpu_torch import grad_bar
from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
    l2_loss_kernel, render_image_diff)
from ray_tracer_fragment_shader_tpu_torch.oracle import oracle_render
from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets

SIZE = 32
JSIZE = 33  # the interpret-mode fixture's size (module docstring)
FIELDS = FitParams.FIELDS
CPU = "cpu"
CAMERA_FIELDS = ("eye", "look_at", "up", "bottom_x", "bottom_y",
                 "pixel_scale")


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-12)


def _jax_fractional(size, depth):
    """The JAX package's tree scene of tests/test_adjoint_tree.py:25-36
    (the port's ``presets.fractional_glass``)."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder().add_checkerboard()
             .add_sphere("d5", material=glass).add_sphere("c3")
             .add_light("b6").build())
    return (scene, jpresets._cam(size),
            dataclasses.replace(jpresets.fit_target(size=size)[2],
                                max_depth=depth))


def both(name, size=SIZE):
    """(JAX preset, port preset) of one scene at ``size``."""
    if name == "fractional_glass":
        return (_jax_fractional(size, 2),
                tpresets.fractional_glass(size=size, depth=2))
    kw = {"depth": 3} if name == "full_reflective" else {}
    return (jpresets.PRESETS[name](size=size, **kw),
            tpresets.PRESETS[name](size=size, **kw))


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


@pytest.fixture(scope="module")
def jax_split():
    """One interpret-mode run each of JAX's residual forward and of
    ``fit_grads_pallas`` on ``fit_target`` at 33², depth 1, beside the
    port's residual forward and a cotangent drawn from a seed (a quarter
    of its pixels 0): (port image, port planes, JAX image, JAX planes, g,
    JAX's K8 tables on the port's planes)."""
    (js, jc, jf), (ts, tc, tf) = both("fit_target", size=JSIZE)
    js = j_compact(js)
    jcam = JCamera.from_config(jc, JSIZE, JSIZE)
    j_img, j_res = j_forward_with_residuals(js, jcam, jf, interpret=True)
    t_img, t_res = K.render_forward_with_residuals(
        ts, Camera.from_config(tc, JSIZE, JSIZE), tf, device=CPU)
    rng = np.random.RandomState(7)
    g = rng.standard_normal((JSIZE, JSIZE, 3)).astype(np.float32) * 1e-3
    g[rng.uniform(size=(JSIZE, JSIZE)) < 0.25] = 0.0
    j_grads = j_fit_grads_pallas(
        js, jcam, jf, {k: jnp.asarray(v) for k, v in _np(t_res).items()},
        jnp.asarray(g), interpret=True)
    return dict(t_img=t_img, t_res=t_res, j_img=np.asarray(j_img),
                j_res=_np(j_res), g=g,
                j_grads={k: np.asarray(v) for k, v in j_grads.items()})


# ------------------------------------------------------ the residual forward

def test_residual_planes_equal_jax(jax_split):
    for k in ("bi", "mid", "lit"):
        np.testing.assert_array_equal(jax_split["t_res"][k].numpy(),
                                      jax_split["j_res"][k], err_msg=k)
    np.testing.assert_allclose(jax_split["t_img"].numpy(),
                               jax_split["j_img"], atol=2e-4)


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain",
                                  "fractional_glass"])
def test_residual_image_is_the_render_kernels_image(name):
    """The residual form is each kernel's image code: the image equals the
    plain chain's or tree's bit for bit, and the planes have JAX's shapes
    ([K,H,W], [nl,K,H,W]), dead levels or nodes holding -1, 0 and 1."""
    scene, cam, cfg = (tpresets.glass_chain(size=SIZE, depth=3)
                       if name == "glass_chain" else both(name)[1])
    camera = Camera.from_config(cam, SIZE, SIZE)
    img, res = K.render_forward_with_residuals(scene, camera, cfg,
                                               device=CPU)
    assert torch.equal(img, K.render_image_kernel(scene, camera, cfg,
                                                  device=CPU))
    depth, nl = cfg.max_depth, scene.num_lights
    K_ = K.n_tree_nodes(depth) if name == "fractional_glass" else depth + 1
    assert tuple(res["bi"].shape) == tuple(res["mid"].shape) == (K_, SIZE,
                                                                  SIZE)
    assert tuple(res["lit"].shape) == (nl, K_, SIZE, SIZE)
    dead = res["bi"] < 0
    assert bool(dead.any()) and bool((~dead).any())
    assert bool((res["mid"][dead] == 0).all())
    assert bool((res["lit"][:, dead] == 1).all())


@pytest.mark.parametrize("name", ["full_reflective", "fractional_glass"])
def test_jax_replay_of_port_planes_reproduces_the_image(name):
    (js, jc, jf), (ts, tc, tf) = both(name)
    img, res = K.render_forward_with_residuals(
        ts, Camera.from_config(tc, SIZE, SIZE), tf, device=CPU)
    replay = j_replay if ts.chain_exact else j_replay_tree
    out = replay(js, JCamera.from_config(jc, SIZE, SIZE), jf,
                 {k: jnp.asarray(v) for k, v in _np(res).items()})
    atol = 2e-3 if ts.chain_exact else 1e-4
    np.testing.assert_allclose(np.asarray(out), img.numpy(), atol=atol)


# ------------------------------------------------------------------ K8

def test_fit_grads_kernel_matches_jax_fit_grads_pallas(jax_split):
    ts, tc, tf = tpresets.fit_target(size=JSIZE)
    grads = AF.fit_grads_kernel(ts, Camera.from_config(tc, JSIZE, JSIZE), tf,
                                jax_split["t_res"],
                                torch.from_numpy(jax_split["g"]), device=CPU)
    for k, ref in jax_split["j_grads"].items():
        assert np.abs(ref).max() > 0, k
        r = _rel(ref, grads[k].numpy())
        assert r <= 5e-4, f"{k}: rel diff {r:.3g}"


@pytest.mark.parametrize("name,dc", [("full_reflective", 1.5),
                                     ("glass_chain", 1.0)])
def test_split_matches_twophase(name, dc):
    """Split and two-phase replay the same chain under the same cotangent:
    loss within 1e-5 relative, fields within 1e-5 of max."""
    scene, cam, cfg = (tpresets.glass_chain(size=SIZE)
                       if name == "glass_chain" else both(name)[1])
    camera = Camera.from_config(cam, SIZE, SIZE)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += dc
    K.reset_launch_counts()
    loss, grads = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        mode="split", device=CPU)
    assert all(n == 0 for n in K.LAUNCHES.values())
    ref_loss, ref = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                          device=CPU)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for f in FIELDS:
        assert np.abs(ref[f].numpy()).max() > 0, f
        assert _rel(ref[f].numpy(), grads[f].numpy()) <= 1e-5, f


def _overflow_scene(size):
    """config 5's 66 primitives with 15 lights: the packed residual word
    overflows 2^24 (128 x 128 x 2^15)."""
    scene, cam, cfg = tpresets.procedural_spheres(n=64, size=size, depth=1)
    rng = np.random.RandomState(3)
    pos = rng.uniform(-150.0, 150.0, size=(15, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1]) + 150.0
    scene = scene.replace(
        light_pos=torch.from_numpy(pos),
        light_color=torch.full((15, 3), 0.1, dtype=torch.float32))
    return scene, Camera.from_config(cam, size, size), cfg


def test_pack_overflow_scene_runs_split_only():
    n = 8
    scene, camera, cfg = _overflow_scene(n)
    c = K.compact_scene(scene)
    counts = (K.pack_scene(c)["tri"].shape[0], c.num_spheres,
              c.num_materials, c.num_lights)
    with pytest.raises(ValueError, match="packed residual"):
        j_pack_widths(*counts)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU) * 0.9
    params = FitParams.from_scene(scene)
    with pytest.raises(ValueError, match="packed residual"):
        AF.fit_value_and_grad(params, scene, camera, cfg, target, device=CPU)
    loss, grads = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        mode="split", device=CPU)
    assert float(loss) > 0 and bool(torch.isfinite(loss))
    for f in FIELDS:
        assert grads[f].shape == getattr(params, f).shape, f
        assert bool(torch.isfinite(grads[f]).all()), f
    assert float(grads["light_pos"].abs().max()) > 0


# ---------------------------------------------- the differentiable render

def _leaves(scene, camera):
    """The scene's float fields and the camera's six tensors, as fresh
    leaves that require grad."""
    scene = scene.replace(**{k: t.clone().requires_grad_()
                             for k, t in scene.tensors().items()
                             if t.is_floating_point()})
    camera = dataclasses.replace(camera, **{
        f: getattr(camera, f).clone().requires_grad_()
        for f in CAMERA_FIELDS})
    return scene, camera


@pytest.mark.parametrize("name", ["full_reflective", "fractional_glass"])
def test_render_image_diff_grads_match_jax_replay_vjp(name):
    (js, jc, jf), (ts, tc, tf) = both(name)
    scene, camera = _leaves(ts, Camera.from_config(tc, SIZE, SIZE))
    g = np.random.RandomState(1).standard_normal(
        (SIZE, SIZE, 3)).astype(np.float32)
    K.reset_launch_counts()
    img = render_image_diff(scene, camera, tf, device=CPU)
    img.backward(torch.from_numpy(g))
    assert all(n == 0 for n in K.LAUNCHES.values())
    _, res = K.render_forward_with_residuals(ts, camera, tf, device=CPU)
    jres = {k: jnp.asarray(v) for k, v in _np(res).items()}
    replay = j_replay if ts.chain_exact else j_replay_tree
    jcam = JCamera.from_config(jc, SIZE, SIZE)
    _, vjp = jax.vjp(lambda s, c: replay(s, c, jf, jres), js, jcam)
    j_scene, j_cam = vjp(jnp.asarray(g))
    pairs = [(getattr(j_scene, k), t.grad, k)
             for k, t in scene.tensors().items() if t.is_floating_point()]
    pairs += [(getattr(j_cam, f), getattr(camera, f).grad, f)
              for f in CAMERA_FIELDS]
    nonzero = 0
    for ref, got, k in pairs:
        ref = np.asarray(ref)
        assert got is not None and got.shape == ref.shape, k
        if np.abs(ref).max() == 0:
            assert float(got.abs().max()) == 0.0, k
            continue
        nonzero += 1
        r = _rel(ref, got.numpy())
        assert r <= 5e-4, f"{k}: rel diff {r:.3g}"
    assert nonzero >= 15
    for k, t in scene.tensors().items():
        if not t.is_floating_point():
            assert t.grad is None, k


def test_l2_loss_kernel_backward_matches_split():
    ts, tc, tf = both("full_reflective")[1]
    camera = Camera.from_config(tc, SIZE, SIZE)
    target = K.render_image_kernel(ts, camera, tf, device=CPU)
    params = FitParams.from_scene(ts)
    with torch.no_grad():
        params.sph_center += 1.5
    loss = l2_loss_kernel(params, ts, camera, tf, target, device=CPU)
    loss.backward()
    ref_loss, ref = AF.fit_value_and_grad(params, ts, camera, tf, target,
                                          mode="split", device=CPU)
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-6)
    for f in FIELDS:
        got = getattr(params, f).grad
        assert _rel(ref[f].numpy(), got.numpy()) <= 1e-5, f


@pytest.mark.parametrize("shape", [(5, 3), (5,)], ids=["rows", "scalars"])
def test_gather_rows_backward_sums_each_row_over_chunks(monkeypatch, shape):
    """The replay's row gather: the forward is ``table[idx]``; the backward
    sums each row's cotangents over several chunks of pixels, as
    ``index_add_`` does (float32 reassociation apart)."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint as A
    from ray_tracer_fragment_shader_tpu_torch.ops import gather
    monkeypatch.setattr(gather, "GATHER_CHUNK", 7)
    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    table.requires_grad_()
    idx = torch.from_numpy(rng.randint(0, shape[0], size=40))
    g = torch.from_numpy(
        rng.standard_normal((40, *shape[1:])).astype(np.float32))
    rows = A._gather_rows(table, idx)
    assert torch.equal(rows, table.detach()[idx])
    rows.backward(g)
    ref = torch.zeros(shape).index_add_(0, idx, g)
    torch.testing.assert_close(table.grad, ref, rtol=1e-6, atol=1e-6)


def test_render_image_diff_keeps_cpu_leaves_through_to():
    """Leaves on one device, the render on the device asked for: the
    gradient comes back to the leaf (``.to`` keeps autograd)."""
    ts, tc, tf = tpresets.fit_target(size=8)
    center = ts.sph_center.clone().requires_grad_()
    img = render_image_diff(ts.replace(sph_center=center),
                            Camera.from_config(tc, 8, 8), tf, device=CPU)
    img.sum().backward()
    assert center.grad is not None and float(center.grad.abs().max()) > 0


# -------------------------------------------------- the oracle and the bar

@pytest.mark.parametrize("name", ["three_spheres_ground", "full_reflective"])
def test_oracle_copy_renders_bit_equal_to_jax(name):
    (js, jc, jf), (ts, tc, tf) = both(name, size=16)
    jf = dataclasses.replace(jf, max_depth=2)
    tf = dataclasses.replace(tf, max_depth=2)
    np.testing.assert_array_equal(oracle_render(ts, tc, tf),
                                  j_oracle_render(js, jc, jf))


@pytest.mark.parametrize("check", ["chain_fit_target", "camera_eye"])
def test_plain_split_meets_the_f64_grad_bar(check):
    """BASELINE: max-abs-err <= 1e-4 against f64 finite differences through
    the port's oracle copy: K8's plain version on fit_target 128², and eye
    gradients of render_image_diff at 64² (grad_bar.py's checks)."""
    run = dict(chain_fit_target=lambda: grad_bar.run_chain(128, CPU),
               camera_eye=lambda: grad_bar.run_camera(64, CPU))[check]
    s = run()
    assert s["grad_scale"] > 1e-3 and s["n_checks"] >= 3
    assert s["max_abs_err"] <= grad_bar.BAR, s


# ------------------------------------------------------------ refusals

def _case(size=8):
    scene, cam, cfg = tpresets.fit_target(size=size)
    return scene, Camera.from_config(cam, size, size), cfg


@pytest.mark.parametrize("change", [dict(samples=2),
                                    dict(force_jitter=True)],
                         ids=["samples", "force_jitter"])
def test_residual_forward_refuses_more_than_one_sample(change):
    scene, camera, cfg = _case()
    cfg = dataclasses.replace(cfg, **change)
    with pytest.raises(ValueError, match="exactly one sample"):
        K.render_forward_with_residuals(scene, camera, cfg, device=CPU)
    with pytest.raises(ValueError, match="exactly one sample"):
        render_image_diff(scene, camera, cfg, device=CPU)


def test_fit_grads_kernel_refuses_a_tree_scene():
    scene, cam, cfg = tpresets.fractional_glass(size=8)
    camera = Camera.from_config(cam, 8, 8)
    _, res = K.render_forward_with_residuals(scene, camera, cfg, device=CPU)
    with pytest.raises(ValueError, match="chain"):
        AF.fit_grads_kernel(scene, camera, cfg, res, torch.zeros(8, 8, 3),
                            device=CPU)


def test_caps_raise_on_every_device():
    scene, camera, cfg = _case()
    _, tables, kw = AF.scene_tables(scene, cfg, CPU)
    v = torch.zeros((64, 3))
    eye = camera.eye.tolist()
    deep = AF.ADJOINT_MAX_DEPTH + 1
    res = dict(bi=torch.zeros(deep + 1, 64), mid=torch.zeros(deep + 1, 64),
               lit=torch.zeros(1, deep + 1, 64))
    with pytest.raises(ValueError, match="depth <= 15"):
        AF.fit_grads(tables, v, eye, torch.zeros(64, 3), res, nl=1,
                     depth=deep, atten=1e5, want_trans=False)
    nl = AF.ADJOINT_MAX_LIGHTS + 1
    light = torch.zeros((nl, K.LIGHT_COLS))
    many = dict(tables, light=light)
    res = dict(bi=torch.zeros(2, 64), mid=torch.zeros(2, 64),
               lit=torch.zeros(nl, 2, 64))
    with pytest.raises(ValueError, match="16 lights"):
        AF.fit_grads(many, v, eye, torch.zeros(64, 3), res, nl=nl, depth=1,
                     atten=1e5, want_trans=False)
    nl = K.RESIDUAL_MAX_LIGHTS + 1
    with pytest.raises(ValueError, match="32 lights"):
        K.render_residuals(dict(tables, light=torch.zeros((nl, 8))), v, eye,
                           tree=False, **dict(kw, nl=nl))


def test_new_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera, cfg = _case()
    target = torch.zeros(8, 8, 3)
    params = FitParams.from_scene(scene)
    _, res = K.render_forward_with_residuals(scene, camera, cfg, device=CPU)
    calls = [
        lambda: K.render_forward_with_residuals(scene, camera, cfg),
        lambda: AF.fit_grads_kernel(scene, camera, cfg, res, target),
        lambda: render_image_diff(scene, camera, cfg),
        lambda: l2_loss_kernel(params, scene, camera, cfg, target),
        lambda: AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                      mode="split"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
