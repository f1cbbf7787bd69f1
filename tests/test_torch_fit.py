"""The port's fit path (ray_tracer_fragment_shader_tpu_torch: kernels
.render's packed forward, kernels.adjoint, kernels.adjoint_fused, diff.fit,
utils.checkpoint, the CLI's ``fit``) against the JAX package, on the CPU.

Here the wrappers run their plain versions: the packed forward is the plain
chain plus the per-level pack, and the adjoint is autograd through the
plain replay.  The JAX side runs only XLA: its replay adjoint
(kernels/adjoint.py::replay_render) on the port's residuals, core-renderer
autodiff, optax, and the numpy f64 oracle (oracle/gradcheck.py) for the
BASELINE gradient bar.  No Pallas kernel runs here.

Tolerances: the replay reproduces the image within atol 2e-3
(tests/test_adjoint.py); loss within 1e-6 relative and gradient fields
within 5e-4 of max|ref| against the JAX replay's vjp
(tests/test_adjoint_fused.py:46-51: float32 reassociation); against core
autodiff under a uniform cotangent 5e-3 (spheres) and 3e-2 (lights,
materials), as tests/test_adjoint_fused.py:76-78; the f64
finite-difference bar max-abs-err <= 1e-4 (BASELINE.md).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.core.renderer import render_image
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams as JFitParams
from ray_tracer_fragment_shader_tpu.diff.fit import default_fit_optimizer as j_opt
from ray_tracer_fragment_shader_tpu.kernels.adjoint import replay_render as j_replay
from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
    _pack_diff_tables as j_pack_diff_tables)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    compact_scene as j_compact)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    pack_widths as j_pack_widths)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera as JCamera
from ray_tracer_fragment_shader_tpu.oracle.gradcheck import (
    make_functional, param_checks, stable_interior_pixels, stratified_pick,
    summarize)
from ray_tracer_fragment_shader_tpu.scene import Material, SceneBuilder
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets
from ray_tracer_fragment_shader_tpu.utils.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from ray_tracer_fragment_shader_tpu_torch import cli as tcli
from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
    FitParams, default_fit_optimizer, make_fit_step_kernel)
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
    l2_loss_kernel, replay_render)
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                           primary_rays,
                                                           screen_points)
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets
from ray_tracer_fragment_shader_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)

SIZE = 32
FIELDS = FitParams.FIELDS
CPU = "cpu"


def _jax_glass_chain(size, depth):
    """The JAX package's scene of tests/test_adjoint_fused.py:138-150."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(1.0, 1.0, 1.0),
                     refraction=0.9)
    scene = (SceneBuilder().add_checkerboard()
             .add_sphere("d5", material=glass).add_sphere("c3")
             .add_light("b6").add_light("f7", color=(0.8, 0.9, 1.0))
             .build())
    return (scene, jpresets._cam(size),
            dataclasses.replace(jpresets.fit_target(size=size)[2],
                                max_depth=depth))


def both(name, size=SIZE):
    """(JAX preset, port preset) of one scene at ``size``."""
    if name == "glass_chain":
        return _jax_glass_chain(size, 1), tpresets.glass_chain(size=size)
    kw = {"depth": 3} if name == "full_reflective" else {}
    return (jpresets.PRESETS[name](size=size, **kw),
            tpresets.PRESETS[name](size=size, **kw))


def packed_forward(scene, cam, cfg):
    """The port's packed forward on the compacted scene: (tables, v, eye,
    img [P,3], pk, pack)."""
    scene = K.compact_scene(scene)
    camera = Camera.from_config(cam, cfg.width, cfg.height)
    _, v = primary_rays(camera, screen_points(camera, cfg.width, cfg.height))
    tables = K.pack_scene(scene)
    pack = K.pack_widths(tables["tri"].shape[0], scene.num_spheres,
                         scene.num_materials, scene.num_lights)
    img, pk = K.render_packed(tables, v.contiguous(), camera.eye.tolist(),
                              pack=pack, **K.render_kwargs(scene, cfg))
    return tables, v, camera.eye.tolist(), img, pk, pack


def residuals_np(pk, nl, pack, h, w):
    res = K.unpack_residuals(pk, nl, pack)
    k = pk.shape[0]
    return dict(bi=res["bi"].reshape(k, h, w).numpy(),
                mid=res["mid"].reshape(k, h, w).numpy(),
                lit=res["lit"].reshape(nl, k, h, w).numpy())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


# ----------------------------------------------------------- the pack

def test_pack_widths_equal_jax_for_all_presets():
    cases = [(name, {}) for name in tpresets.PRESETS]
    cases.append(("glass_chain", None))
    for name, _ in cases:
        if name == "glass_chain":
            scene = K.compact_scene(tpresets.glass_chain()[0])
        else:
            kw = {"n": 64} if name == "procedural_spheres" else {}
            scene = K.compact_scene(tpresets.PRESETS[name](**kw)[0])
        args = (K.pack_scene(scene)["tri"].shape[0], scene.num_spheres,
                scene.num_materials, scene.num_lights)
        assert K.pack_widths(*args) == j_pack_widths(*args), name
    with pytest.raises(ValueError, match="packed residual"):
        j_pack_widths(0, 2 ** 20, 100, 7)
    with pytest.raises(ValueError, match="packed residual"):
        K.pack_widths(0, 2 ** 20, 100, 7)


@pytest.mark.parametrize("name,kw", [
    ("full_reflective", {"depth": 3}), ("glass_chain", {}),
    ("procedural_spheres", {"n": 16})], ids=["full_reflective",
                                            "glass_chain", "procedural"])
def test_packed_image_is_the_chain_image(name, kw):
    scene, cam, cfg = tpresets.PRESETS.get(name, tpresets.glass_chain)(
        size=SIZE, **kw)
    tables, v, eye, img, pk, pack = packed_forward(scene, cam, cfg)
    chain = K.render_chain(tables, v.contiguous(), eye,
                           **K.render_kwargs(K.compact_scene(scene), cfg))
    assert torch.equal(img, chain)
    assert tuple(pk.shape) == (cfg.max_depth + 1, SIZE * SIZE)


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain"])
def test_levels_after_a_miss_hold_the_dead_value(name):
    _, (scene, cam, cfg) = both(name)
    *_, pk, pack = packed_forward(scene, cam, cfg)
    nl = scene.num_lights
    res = K.unpack_residuals(pk, nl, pack)
    dead = (2 ** nl - 1) * pack[0] * pack[1]
    missed = torch.cumsum((res["bi"] < 0).int(), 0) > 0
    assert bool(missed[-1].any()) and bool((~missed[0]).any())
    assert bool((pk[missed] == dead).all())
    assert bool((res["bi"][~missed] >= 0).all())


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain"])
def test_jax_replay_of_port_residuals_reproduces_the_image(name):
    (js, jc, jf), (ts, tc, tf) = both(name)
    *_, img, pk, pack = packed_forward(ts, tc, tf)
    res = residuals_np(pk, ts.num_lights, pack, SIZE, SIZE)
    jcam = JCamera.from_config(jc, SIZE, SIZE)
    replay = j_replay(js, jcam, jf,
                      {k: jnp.asarray(a) for k, a in res.items()})
    np.testing.assert_allclose(np.asarray(replay),
                               img.reshape(SIZE, SIZE, 3).numpy(), atol=2e-3)
    # and the port's own replay of them, on the same scene
    port = replay_render(ts, Camera.from_config(tc, SIZE, SIZE), tf,
                         {k: torch.from_numpy(a) for k, a in res.items()})
    np.testing.assert_allclose(port.numpy(), np.asarray(replay), atol=1e-5)


# ------------------------------------------------------------ gradients

def _perturbed(js, ts, dc):
    jp = JFitParams.from_scene(js).replace(sph_center=js.sph_center + dc)
    tp = FitParams.from_scene(ts)
    with torch.no_grad():
        tp.sph_center += dc
    return jp, tp


@pytest.mark.parametrize("name,dc", [("full_reflective", 1.5),
                                     ("glass_chain", 1.0)])
def test_grads_match_jax_replay_vjp(name, dc):
    (js, jc, jf), (ts, tc, tf) = both(name)
    cam = Camera.from_config(tc, SIZE, SIZE)
    target = K.render_image_kernel(ts, tc, tf, device=CPU)
    jp, tp = _perturbed(js, ts, dc)
    loss, grads = AF.fit_value_and_grad(tp, ts, cam, tf, target, device=CPU)

    *_, img, pk, pack = packed_forward(tp.into_scene(ts), tc, tf)
    res = residuals_np(pk.detach(), ts.num_lights, pack, SIZE, SIZE)
    img = jnp.asarray(img.detach().reshape(SIZE, SIZE, 3).numpy())
    tgt = jnp.asarray(target.numpy())
    j_loss = jnp.mean((img - tgt) ** 2)
    assert abs(float(loss) - float(j_loss)) <= 1e-6 * float(j_loss)

    jcam = JCamera.from_config(jc, SIZE, SIZE)
    jres = {k: jnp.asarray(a) for k, a in res.items()}
    _, vjp = jax.vjp(lambda p: j_replay(p.into_scene(js), jcam, jf, jres), jp)
    (j_grads,) = vjp((2.0 / img.size) * (img - tgt))
    for f in FIELDS:
        ref = np.asarray(getattr(j_grads, f))
        assert np.abs(ref).max() > 0, f
        r = _rel(ref, grads[f].numpy())
        assert r < 5e-4, f"{f}: rel diff {r:.3g}"


def test_grads_match_core_autodiff_under_uniform_cotangent():
    js, jc, jf = jpresets.full_reflective(size=SIZE)
    ts, tc, tf = tpresets.full_reflective(size=SIZE)
    jcam = JCamera.from_config(jc, SIZE, SIZE)
    core = jax.grad(lambda p: jnp.mean(
        render_image(p.into_scene(js), jcam, jf)))(JFitParams.from_scene(js))
    # target = img - g*denom/2 feeds the uniform cotangent g = 1/denom
    img = K.render_image_kernel(ts, tc, tf, device=CPU)
    _, grads = AF.fit_value_and_grad(
        FitParams.from_scene(ts), ts, Camera.from_config(tc, SIZE, SIZE), tf,
        img - 0.5, device=CPU)
    for f, tol in [("sph_center", 5e-3), ("sph_radius", 5e-3),
                   ("light_pos", 3e-2), ("mat_diffuse", 3e-2),
                   ("mat_specular", 3e-2), ("mat_ambient", 3e-2)]:
        r = _rel(np.asarray(getattr(core, f)), grads[f].numpy())
        assert r < tol, f"{f}: rel diff {r:.3g}"


def test_plain_adjoint_meets_the_f64_grad_bar():
    """BASELINE: grad max-abs-err <= 1e-4 against central finite
    differences through the float64 numpy oracle, on the stable interior
    pixels of fit_target 128^2 (tests/test_grad_bar.py's recipe)."""
    n = 128
    js, jc, jf = jpresets.fit_target(size=n)
    js = j_compact(js)
    ts, tc, tf = tpresets.fit_target(size=n)
    *_, img, pk, pack = packed_forward(ts, tc, tf)
    res = residuals_np(pk, ts.num_lights, pack, n, n)
    pix = stable_interior_pixels(res, jf, js, jc)
    assert len(pix) >= 24
    pix, n_sph = stratified_pick(pix, res, js, n_each=16)
    assert n_sph >= 4
    w_rgb = np.random.RandomState(0).uniform(0.25, 1.0, size=(len(pix), 3))
    g = np.zeros((n, n, 3), np.float32)
    for k, (j, i) in enumerate(pix):
        g[j, i] = w_rgb[k] / len(pix)
    denom = float(n * n * 3)
    target = img.reshape(n, n, 3) - torch.from_numpy(g) * (denom / 2.0)
    _, grads = AF.twophase_loss_grads_kernel(
        ts, Camera.from_config(tc, n, n), tf, target, device=CPU)
    grads = {k: v.double().numpy() for k, v in grads.items()}
    s = summarize(param_checks(make_functional(js, jf, jc, pix, w_rgb), js,
                               grads))
    assert s["grad_scale"] > 1e-3
    assert s["max_abs_err"] <= 1e-4, s


# ------------------------------------------------------- the optimizer

def test_adam_groups_match_optax():
    js, _, _ = jpresets.fit_target(size=SIZE)
    ts, _, _ = tpresets.fit_target(size=SIZE)
    jp, tp = JFitParams.from_scene(js), FitParams.from_scene(ts)
    opt_j = j_opt()
    state = opt_j.init(jp)
    opt_t = default_fit_optimizer(tp)
    rng = np.random.RandomState(0)
    for _ in range(10):
        g = {f: rng.standard_normal(np.shape(getattr(jp, f)))
             .astype(np.float32) for f in FIELDS}
        updates, state = opt_j.update(
            jp.replace(**{f: jnp.asarray(g[f]) for f in FIELDS}), state, jp)
        jp = optax.apply_updates(jp, updates)
        for f in FIELDS:
            getattr(tp, f).grad = torch.from_numpy(g[f])
        opt_t.step()
    # optax forms Adam's bias correction 1 - 0.999^t in f32 (1.3e-5
    # relative error at t=1), torch in f64: each step's update may differ
    # by ~1e-5 of the group's learning rate, so 10 steps by 10x that
    lrs = dict(sph_center=0.5, sph_radius=0.5, light_pos=1.0,
               mat_diffuse=0.01, mat_specular=0.01, mat_ambient=0.01)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).detach().numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-5,
                                   atol=10 * 1e-5 * lrs[f], err_msg=f)


def test_kernel_step_lowers_the_loss():
    scene, cam, cfg = tpresets.fit_target(size=SIZE)
    camera = Camera.from_config(cam, SIZE, SIZE)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 3.0
    step = make_fit_step_kernel(
        scene, camera, cfg, target,
        torch.optim.Adam([params.sph_center], lr=0.3), device=CPU)
    losses = [float(step(params)) for _ in range(3)]
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("path", ["l2_loss_kernel", "fit_value_and_grad"])
def test_adam_over_every_leaf_descends(path):
    """tests/test_adjoint.py::test_pallas_fit_descends (the replay adjoint
    under autograd) and tests/test_adjoint_fused.py::test_fused_fit_descends
    (the default fit path) on the port: full_reflective 32^2 from centres
    moved 2.0, six Adam steps at 0.05 over every leaf lower the loss, and
    the first step's loss is the fit path's within 1e-6."""
    scene, cam, cfg = tpresets.full_reflective(size=SIZE)
    camera = Camera.from_config(cam, SIZE, SIZE)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 2.0
    loss_ref, _ = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        device=CPU)
    opt = torch.optim.Adam(params.parameters(), lr=0.05)

    def step():
        opt.zero_grad()
        if path == "l2_loss_kernel":
            loss = l2_loss_kernel(params, scene, camera, cfg, target,
                                  device=CPU)
            loss.backward()
        else:
            loss, grads = AF.fit_value_and_grad(params, scene, camera, cfg,
                                                target, device=CPU)
            for f in FIELDS:
                leaf = getattr(params, f)
                leaf.grad = grads[f].reshape(leaf.shape)
        opt.step()
        return loss

    losses = [step().item() for _ in range(6)]
    assert losses[0] == pytest.approx(float(loss_ref), rel=1e-6)
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


# --------------------------------------------------------------- the CLI

def test_cli_fit_writes_its_four_files(tmp_path):
    params, history = tcli.main(["fit", "--cpu", "--size", "32", "--steps",
                                 "2", "--out-dir", str(tmp_path)])
    for f in ("target.png", "fitted.png", "params.npz", "history.json"):
        assert (tmp_path / f).exists(), f
    assert json.loads((tmp_path / "history.json").read_text()) == history
    j_save_checkpoint(str(tmp_path / "jax.npz"),
                      JFitParams.from_scene(jpresets.fit_target(size=32)[0]))
    with np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "params.npz") as t:
        assert sorted(j.files) == sorted(t.files)
    back = restore_checkpoint(str(tmp_path / "params.npz"), params)
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(params, f))


def test_checkpoint_round_trips_a_dict(tmp_path):
    tree = {"a": torch.arange(3.0), "b": torch.ones(2, 2)}
    save_checkpoint(str(tmp_path / "d.npz"), tree)
    back = restore_checkpoint(str(tmp_path / "d.npz"),
                              {k: torch.zeros_like(v)
                               for k, v in tree.items()})
    assert all(torch.equal(back[k], tree[k]) for k in tree)


# ------------------------------------------------------------ refusals

def _fit_case():
    scene, cam, cfg = tpresets.fit_target(size=8)
    camera = Camera.from_config(cam, 8, 8)
    return (scene, camera, cfg, torch.zeros(8, 8, 3),
            FitParams.from_scene(scene))


@pytest.mark.parametrize("change", [
    dict(mode="fused"), dict(mode="split"), dict(samples=2),
    dict(force_jitter=True), dict(adaptive=True), dict(tree_scene=True)],
    ids=["fused", "split", "samples", "force_jitter", "adaptive", "tree"])
def test_unported_fit_modes_raise(change):
    """The fit modes that slice 2 left unported all run now (K6 fused and
    tree, K7 supersampled and adaptive, and split: the residual forward
    and K8) and give a finite loss and gradients of the FitParams
    shapes; none raises."""
    scene, camera, cfg, target, params = _fit_case()
    mode = change.pop("mode", "twophase")
    if change.pop("tree_scene", False):
        scene, _, _ = tpresets.fractional_glass(size=8)
        params = FitParams.from_scene(scene)
    cfg = dataclasses.replace(cfg, **change)
    loss, grads = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        mode=mode, device=CPU)
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    for f in FIELDS:
        assert grads[f].shape == getattr(params, f).shape, f
        assert bool(torch.isfinite(grads[f]).all()), f


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera, cfg, target, params = _fit_case()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        K.render_image_kernel(scene, camera, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AF.fit_value_and_grad(params, scene, camera, cfg, target)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_fit_step_kernel(scene, camera, cfg, target,
                             default_fit_optimizer(params))
    # the multi-view fit (on the core renderer) needs --cpu without a GPU
    # too; nothing falls back to the CPU
    with pytest.raises(RuntimeError, match="--cpu"):
        tcli.main(["fit", "--views", "2"])


def test_stale_prep_raises():
    scene, camera, cfg, target, params = _fit_case()
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=CPU)
    AF.fit_value_and_grad(params, scene, camera, cfg, target, prep=prep,
                          device=CPU)
    with pytest.raises(ValueError, match="different `target`"):
        AF.fit_value_and_grad(params, scene, camera, cfg, target.clone(),
                              prep=prep, device=CPU)


def test_prepared_inputs_match_inline():
    """tests/test_adjoint_fused.py::test_prepared_inputs_match_inline on the
    port: ``prepare_fit_inputs`` and ``prep=`` give the inline path's loss
    and gradients bit for bit."""
    scene, cam, cfg = tpresets.full_reflective(size=SIZE)
    camera = Camera.from_config(cam, SIZE, SIZE)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.0
    loss_i, grads_i = AF.fit_value_and_grad(params, scene, camera, cfg,
                                            target, device=CPU)
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=CPU)
    loss_p, grads_p = AF.fit_value_and_grad(params, scene, camera, cfg,
                                            target, prep=prep, device=CPU)
    assert float(loss_i) == float(loss_p)
    for f in FIELDS:
        assert torch.equal(grads_i[f], grads_p[f]), f


def test_diff_tables_equal_jax():
    js = j_compact(jpresets.procedural_spheres(n=16, size=8)[0])
    ts = K.compact_scene(tpresets.procedural_spheres(n=16, size=8)[0])
    for a, b in zip(AF._pack_diff_tables(ts), j_pack_diff_tables(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_fit_never_launches_kernels():
    K.reset_launch_counts()
    scene, camera, cfg, target, params = _fit_case()
    AF.fit_value_and_grad(params, scene, camera, cfg, target, device=CPU)
    assert all(n == 0 for n in K.LAUNCHES.values())
