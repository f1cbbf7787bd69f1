"""The port's one-dispatch and per-sample fits against the JAX package, on
the CPU: the tree forward's residuals (kernels.render), the tree replay
(kernels.adjoint), and the K6 and K7 paths of kernels.adjoint_fused
(``fused_adjoint``, ``recompute_adjoint``, ``fit_value_and_grad`` with
``mode="fused"``, fractional-transparency scenes, supersampled and adaptive
configs) and diff.fit on tree scenes.

Here the wrappers run their plain versions: the plain forward with its
residuals, then autograd through the plain replay.  The JAX side runs only
XLA: its replays (kernels/adjoint.py::replay_render_tree) under
``jax.vjp``, core-renderer autodiff (core/renderer.py::render_rays, the
trace behind diff/fit.py::l2_loss, compiled once per scene for the whole
file) and its own jitter draws (ops/rays.py::sample_jitter), fed to the
port.  No Pallas kernel runs here.

Tolerances: the tree replay reproduces the image within atol 1e-4
(tests/test_adjoint_tree.py:58) and the port's replay equals JAX's within
atol 1e-5; loss within 1e-5 relative and fields within 5e-4 of max|ref|
against the JAX replay's vjp (float32 reassociation); against core
autodiff under a uniform cotangent 1e-2 (spheres) and 3e-2 (others), as
tests/test_adjoint_tree.py:76-78; supersampled against core autodiff,
loss 5e-3 relative, sph_center 1e-2, mat_diffuse and light_pos 3e-2
(tests/test_adjoint_tree.py:166-170); fused against two-phase on the
chain, loss 1e-6 relative and fields 1e-5 of max; the adaptive divisor
quirk 1e-4 (tests/test_adjoint_fused.py:392) and mixed accepts 5e-4
(:350).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.config import RenderConfig as JRenderConfig
from ray_tracer_fragment_shader_tpu.core.renderer import render_rays
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams as JFitParams
from ray_tracer_fragment_shader_tpu.diff.fit import (
    make_fit_step_pallas as j_make_fit_step_pallas)
from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
    replay_render_tree as j_replay_tree)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera as JCamera
from ray_tracer_fragment_shader_tpu.ops.rays import primary_rays as j_primary_rays
from ray_tracer_fragment_shader_tpu.ops.rays import sample_jitter as j_sample_jitter
from ray_tracer_fragment_shader_tpu.ops.rays import screen_points as j_screen_points
from ray_tracer_fragment_shader_tpu.scene import Material, SceneBuilder
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets
from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
    FitParams, default_fit_optimizer, fit, make_fit_step_kernel)
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
    replay_render_tree)
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                           primary_rays,
                                                           screen_points)
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets

SIZE = 32
FIELDS = FitParams.FIELDS
CPU = "cpu"


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-12)


def jax_fractional(depth):
    """The JAX package's tree scene of tests/test_adjoint_tree.py:25-36
    (the port's ``presets.fractional_glass``): (scene, camera, config)."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder().add_checkerboard()
             .add_sphere("d5", material=glass).add_sphere("c3")
             .add_light("b6").build())
    return (scene, JCamera.from_config(jpresets._cam(SIZE), SIZE, SIZE),
            JRenderConfig(width=SIZE, height=SIZE, max_depth=depth,
                          samples=1))


def port_fractional(depth):
    scene, cam, cfg = tpresets.fractional_glass(size=SIZE, depth=depth)
    return scene, Camera.from_config(cam, SIZE, SIZE), cfg


def jax_fit_target():
    js, jc, jcfg = jpresets.fit_target(size=SIZE)
    return js, JCamera.from_config(jc, SIZE, SIZE), jcfg


def jax_jitter(cfg, n):
    """The [S, n, 3] jitter the JAX package draws for ``cfg``: one
    ``sample_jitter`` per key of ``split(PRNGKey(seed), S)``."""
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.samples)
    return np.stack([np.asarray(j_sample_jitter(k, n, cfg.jitter_scale))
                     for k in keys])


@functools.lru_cache(maxsize=None)
def core_trace(name):
    """The JAX core renderer's trace of one sample's rays, as
    core/renderer.py::render_pixels calls it (``render_rays``), jitted once
    per scene so that every test of this file shares its compilation:
    (scene, camera, config, trace(params, o, v) -> [P,3])."""
    js, jcam, jcfg = jax_fractional(2) if name == "tree" else jax_fit_target()
    trace = jax.jit(lambda p, o, v: render_rays(
        p.into_scene(js), o, v, max_depth=jcfg.max_depth,
        mode=jcfg.resolved_mode(js.chain_exact), small=jcfg.small_number,
        attenuation_factor=jcfg.attenuation_factor, prune=jcfg.prune))
    return js, jcam, jcfg, trace


def core_supersampled(name, samples):
    """The core's supersampled render written out (core/renderer.py:181-188:
    the mean of ``render_rays`` over the jittered screen points of JAX's
    draws) as ``params -> [P,3]``, with the draws [S, P, 3]."""
    js, jcam, jcfg, trace = core_trace(name)
    cfg = dataclasses.replace(jcfg, samples=samples)
    pts = j_screen_points(jcam, SIZE, SIZE)
    jit = jax_jitter(cfg, SIZE * SIZE)
    rays = [j_primary_rays(jcam, pts, jitter=jnp.asarray(j)) for j in jit]

    def render(p):
        total = jnp.zeros_like(pts)
        for o, v in rays:
            total = total + trace(p, o, v)
        return total / samples
    return render, jit


def tree_residuals(scene, camera, cfg):
    """The port's plain tree forward of ``scene`` with its residuals:
    (img [H,W,3], residuals as numpy [K,H,W] / [L,K,H,W])."""
    sc, tables, kw, _ = AF.kernel_inputs(scene, cfg, SIZE * SIZE, device=CPU)
    _, v = primary_rays(camera, screen_points(camera, SIZE, SIZE))
    img, res = K.render_tree_ref(tables, v.contiguous(),
                                 camera.eye.tolist(), residuals=True, **kw)
    k = K.n_tree_nodes(cfg.max_depth)
    shapes = dict(bi=(k, SIZE, SIZE), mid=(k, SIZE, SIZE),
                  lit=(sc.num_lights, k, SIZE, SIZE))
    return (img.reshape(SIZE, SIZE, 3),
            {n: res[n].reshape(shapes[n]).numpy() for n in shapes})


def perturbed(js, ts):
    """Both packages' FitParams moved as tests/test_adjoint_tree.py:122-124
    does: mat_diffuse*1.3 + 0.02, sph_center + 0.6."""
    jp = JFitParams.from_scene(js).replace(
        mat_diffuse=js.mat_diffuse * 1.3 + 0.02,
        sph_center=js.sph_center + 0.6)
    tp = FitParams.from_scene(ts)
    with torch.no_grad():
        tp.mat_diffuse.mul_(1.3).add_(0.02)
        tp.sph_center.add_(0.6)
    return jp, tp


# ----------------------------------------------------- the tree residuals

@pytest.fixture(scope="module", params=[2, 3], ids=["d2", "d3"])
def tree_forward(request):
    depth = request.param
    ts, tcam, tcfg = port_fractional(depth)
    img, res = tree_residuals(ts, tcam, tcfg)
    return depth, img, res


def test_tree_residual_mode_keeps_the_image(tree_forward):
    depth, img, res = tree_forward
    ts, tcam, tcfg = port_fractional(depth)
    assert torch.equal(img, K.render_image_kernel(ts, tcam, tcfg, device=CPU))
    assert res["bi"].shape[0] == 2 ** (depth + 1) - 1 == K.n_tree_nodes(depth)


def test_tree_nodes_after_a_miss_hold_the_dead_value(tree_forward):
    depth, _, res = tree_forward
    dead = res["bi"] < 0
    assert dead.any() and (~dead).any()
    assert (res["mid"][dead] == 0).all()
    assert (res["lit"][:, dead] == 1).all()
    # a child of a node that misses misses too (preorder: children of node
    # k at level l are k+1 and k+2^(depth-l))
    k = 0
    for level in range(depth):
        assert (dead[k + 1][dead[k]]).all()
        assert (dead[k + 2 ** (depth - level)][dead[k]]).all()
        k += 1


def test_jax_tree_replay_of_port_residuals_reproduces_the_image(
        tree_forward):
    depth, img, res = tree_forward
    js, jcam, jcfg = jax_fractional(depth)
    jres = {k: jnp.asarray(a) for k, a in res.items()}
    rep = np.asarray(j_replay_tree(js, jcam, jcfg, jres))
    np.testing.assert_allclose(rep, img.numpy(), atol=1e-4)
    ts, tcam, tcfg = port_fractional(depth)
    port = replay_render_tree(ts, tcam, tcfg,
                              {k: torch.from_numpy(a) for k, a in res.items()})
    np.testing.assert_allclose(port.numpy(), rep, atol=1e-5)


# ------------------------------------------------------- K6, tree and chain

def test_fused_tree_matches_jax_replay_vjp():
    js, jcam, jcfg = jax_fractional(2)
    ts, tcam, tcfg = port_fractional(2)
    target = K.render_image_kernel(ts, tcam, tcfg, device=CPU)
    jp, tp = perturbed(js, ts)
    loss, grads = AF.fit_value_and_grad(tp, ts, tcam, tcfg, target,
                                        device=CPU)
    img, res = tree_residuals(tp.into_scene(ts), tcam, tcfg)
    jres = {k: jnp.asarray(a) for k, a in res.items()}
    img_j, tgt = jnp.asarray(img.detach().numpy()), jnp.asarray(target.numpy())

    def j_loss(p):
        # value: the forward's image; gradient: the replay's (JAX
        # kernels/adjoint.py::render_image_diff)
        rep = j_replay_tree(p.into_scene(js), jcam, jcfg, jres)
        return jnp.mean((img_j + rep - jax.lax.stop_gradient(rep) - tgt) ** 2)

    j_val, j_grads = jax.value_and_grad(j_loss)(jp)
    assert abs(float(loss) - float(j_val)) <= 1e-5 * float(j_val)
    for f in FIELDS:
        ref = np.asarray(getattr(j_grads, f))
        assert np.abs(ref).max() > 0, f
        r = _rel(ref, grads[f].numpy())
        assert r < 5e-4, f"{f}: rel diff {r:.3g}"


def test_fused_tree_matches_core_autodiff_under_uniform_cotangent():
    js, jcam, _, trace = core_trace("tree")
    ts, tcam, tcfg = port_fractional(2)
    o, v = j_primary_rays(jcam, j_screen_points(jcam, SIZE, SIZE))
    core = jax.grad(lambda p: jnp.mean(trace(p, o, v)))(
        JFitParams.from_scene(js))
    # target = img - 0.5 feeds the uniform cotangent 2*0.5/denom = 1/denom
    img = K.render_image_kernel(ts, tcam, tcfg, device=CPU)
    _, grads = AF.fit_value_and_grad(FitParams.from_scene(ts), ts, tcam,
                                     tcfg, img - 0.5, device=CPU)
    for f, tol in [("sph_center", 1e-2), ("sph_radius", 1e-2),
                   ("light_pos", 3e-2), ("mat_diffuse", 3e-2),
                   ("mat_specular", 3e-2), ("mat_ambient", 3e-2)]:
        r = _rel(np.asarray(getattr(core, f)), grads[f].numpy())
        assert r < tol, f"{f}: rel diff {r:.3g}"
        assert grads[f].abs().max() > 0, f


@pytest.mark.parametrize("make", [
    lambda: tpresets.full_reflective(size=SIZE, depth=3),
    lambda: tpresets.glass_chain(size=SIZE, depth=3)],
    ids=["full_reflective", "glass_chain"])
def test_fused_chain_equals_twophase(make):
    scene, cam, cfg = make()
    camera = Camera.from_config(cam, SIZE, SIZE)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center.add_(1.0)
    lf, gf = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                   mode="fused", device=CPU)
    lt, gt = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                   mode="twophase", device=CPU)
    assert abs(float(lf) - float(lt)) <= 1e-6 * float(lt)
    for f in FIELDS:
        assert gt[f].abs().max() > 0, f
        assert _rel(gt[f].numpy(), gf[f].numpy()) <= 1e-5, f


def test_fused_wrapper_equals_its_plain_version_on_the_cpu():
    scene, camera, cfg = port_fractional(2)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=CPU)
    _, tables, kw, akw = AF.kernel_inputs(scene, cfg, SIZE * SIZE,
                                          device=CPU)
    args = (tables, prep["v"], prep["eye"], prep["target"] * 0.9,
            prep["mask"])
    K.reset_launch_counts()
    got = AF.fused_adjoint(*args, tree=True, g_scale=akw["g_scale"], **kw)
    ref = AF.fused_adjoint_ref(*args, tree=True, g_scale=akw["g_scale"],
                               **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert float(got[0]) > 0 and all(n == 0 for n in K.LAUNCHES.values())


# ------------------------------------------------- K7: supersampled fits

@pytest.mark.parametrize("name", ["tree", "fit_target"])
def test_supersampled_matches_core_autodiff(name):
    """Two jittered samples (JAX's draws) through the port's K7 path against
    ``jax.value_and_grad`` of the core's L2 loss on the same samples (the
    loss of diff/fit.py::l2_loss, the supersampled render written out)."""
    js, _, _, _ = core_trace(name)
    render, jit = core_supersampled(name, 2)
    jp = JFitParams.from_scene(js)
    target = render(jp) * 0.9
    loss_c, g_c = jax.value_and_grad(
        lambda p: jnp.mean((render(p) - target) ** 2))(jp)
    ts, tcam, tcfg = (port_fractional(2) if name == "tree" else
                      (lambda s, c, f: (s, Camera.from_config(c, SIZE, SIZE),
                                        f))(*tpresets.fit_target(size=SIZE)))
    loss, grads = AF.fit_value_and_grad(
        FitParams.from_scene(ts), ts, tcam,
        dataclasses.replace(tcfg, samples=2),
        torch.from_numpy(np.array(target)).reshape(SIZE, SIZE, 3),
        jitter=torch.from_numpy(jit), device=CPU)
    assert float(loss) == pytest.approx(float(loss_c), rel=5e-3)
    for f, tol in [("sph_center", 1e-2), ("mat_diffuse", 3e-2),
                   ("light_pos", 3e-2)]:
        r = _rel(np.asarray(getattr(g_c, f)), grads[f].numpy())
        assert r < tol, f"{f}: rel diff {r:.3g}"


def test_adaptive_divisor_quirk_gradient():
    """Zero jitter: every pixel converges at k=1 with divisor 1 but two
    accumulated samples (the reference's quirk), so img = 2c and the
    adaptive gradients are 2x the single-sample ones at target - c0
    (tests/test_adjoint_fused.py:354-393)."""
    scene, cam, cfg = tpresets.fit_target(size=SIZE)
    camera = Camera.from_config(cam, SIZE, SIZE)
    cfg_a = dataclasses.replace(cfg, samples=4, adaptive=True,
                                force_jitter=True, jitter_scale=0.0)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center.add_(0.3)
    scene_p = params.into_scene(scene)
    c0 = K.render_image_kernel(scene_p, camera, cfg, device=CPU).detach()
    img_a = K.render_image_kernel(scene_p, camera, cfg_a, device=CPU)
    assert torch.equal(img_a, 2.0 * c0)
    target = K.render_image_kernel(scene, camera, cfg_a, device=CPU) * 0.9
    loss_a, g_a = AF.fit_value_and_grad(params, scene, camera, cfg_a, target,
                                        device=CPU)
    _, g_1 = AF.fit_value_and_grad(params, scene, camera, cfg, target - c0,
                                   device=CPU)
    assert float(loss_a) == pytest.approx(
        float(torch.mean((img_a - target) ** 2).detach()), rel=1e-5)
    for f in FIELDS:
        assert g_a[f].abs().max() > 0, f
        r = _rel(2.0 * g_1[f].numpy(), g_a[f].numpy())
        assert r < 1e-4, f"{f}: rel diff {r:.3g}"


def test_adaptive_with_mixed_accepts_matches_weighted_replays():
    """Real jitter (JAX's draws, S=3): constant regions converge at k=1
    while detailed pixels take every sample.  The adaptive gradients equal
    the sum of per-sample plain replay gradients weighted by the same
    accept_k / divisor planes, which JAX's emulation loop recomputes from
    the port's sample images (tests/test_adjoint_fused.py:278-351)."""
    scene, cam, cfg = tpresets.full_reflective(size=SIZE)
    camera = Camera.from_config(cam, SIZE, SIZE)
    S = 3
    cfg_a = dataclasses.replace(cfg, samples=S, adaptive=True)
    jit = torch.from_numpy(jax_jitter(cfg_a, SIZE * SIZE))
    target = K.render_image_kernel(scene, camera, cfg_a, jitter=jit,
                                   device=CPU) * 0.9
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center.add_(0.3)
    loss_a, g_a = AF.fit_value_and_grad(params, scene, camera, cfg_a, target,
                                        jitter=jit, device=CPU)

    sc, tables, kw, akw = AF.kernel_inputs(params.into_scene(scene), cfg,
                                           SIZE * SIZE, device=CPU)
    pts0 = screen_points(camera, SIZE, SIZE)
    rays = [primary_rays(camera, pts0 + jit[k])[1].contiguous()
            for k in range(S)]
    imgs = [np.asarray(K.render_chain(tables, v, camera.eye.tolist(), **kw)
                       ).reshape(SIZE, SIZE, 3) for v in rays]
    # the emulation, in JAX (adjoint_fused.py:1711-1726)
    accum = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    divisor = jnp.full((SIZE, SIZE), float(S), jnp.float32)
    done = jnp.zeros((SIZE, SIZE), bool)
    accepts = []
    for k in range(S):
        accepts.append(jnp.logical_not(done))
        accum_after = jnp.where(done[..., None], accum, accum + imgs[k])
        d = k * accum_after - (k + 1.0) * accum
        dnorm = jnp.sqrt(jnp.sum(d * d, -1))
        newly = jnp.logical_and(~done,
                                dnorm < cfg.small_number * k * (k + 1.0))
        divisor = jnp.where(newly, float(k), divisor)
        done = jnp.logical_or(done, newly)
        accum = accum_after
    assert 0 < float(jnp.mean(jnp.where(accepts[-1], 1.0, 0.0))) < 1
    img = accum / divisor[..., None]
    tgt = jnp.asarray(target.numpy())
    assert float(loss_a) == pytest.approx(float(jnp.mean((img - tgt) ** 2)),
                                          rel=1e-5)
    g = (2.0 / img.size) * (img - tgt)
    expected = None
    for k in range(S):
        wk = jnp.where(accepts[k], 1.0, 0.0) / divisor
        gk = torch.from_numpy(np.array(g * wk[..., None])).reshape(-1, 3)
        tabs = AF.replay_grads(
            tables, rays[k], camera.eye.tolist(),
            K.unpack_residuals(K.render_packed_ref(
                tables, rays[k], camera.eye.tolist(), pack=akw["pack"],
                **kw)[1], kw["nl"], akw["pack"]),
            gk, tree=False, nl=kw["nl"], depth=kw["depth"], atten=kw["atten"])
        expected = tabs if expected is None else tuple(
            a + b for a, b in zip(expected, tabs))
    g_e = AF.grads_to_fitparams(params, scene, AF._grads_c(sc, *expected))
    for f in FIELDS:
        assert g_a[f].abs().max() > 0, f
        r = _rel(g_e[f].numpy(), g_a[f].numpy())
        assert r < 5e-4, f"{f}: rel diff {r:.3g}"


def test_recompute_grads_kernel_is_the_single_sample_gradient():
    """K7's entry point under the L2 cotangent gives the two-phase path's
    gradients on a chain scene, and the fused path's on the tree."""
    for scene, camera, cfg in (port_fractional(2),
                               (lambda s, c, f: (s, Camera.from_config(
                                   c, SIZE, SIZE), f))(
                                   *tpresets.fit_target(size=SIZE))):
        target = K.render_image_kernel(scene, camera, cfg, device=CPU) * 0.9
        img = K.render_image_kernel(scene, camera, cfg, device=CPU)
        g = (2.0 / img.numel()) * (img - target)
        params = FitParams.from_scene(scene)
        grads = AF.grads_to_fitparams(params, scene, AF.recompute_grads_kernel(
            scene, camera, cfg, g, device=CPU))
        _, ref = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                       device=CPU)
        for f in FIELDS:
            assert _rel(ref[f].numpy(), grads[f].numpy()) <= 1e-5, f


# ---------------------------------------------------------- the tree fit

def test_tree_fit_descends():
    """diff.fit.fit on the fractional scene, 8 Adam steps at 0.02 over every
    leaf from mat_diffuse*1.6 + 0.05 (tests/test_adjoint_tree.py:84-108):
    the loss falls below half its start."""
    scene, camera, cfg = port_fractional(2)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.mat_diffuse.mul_(1.6).add_(0.05)
    K.reset_launch_counts()
    _, losses = fit(scene, camera, cfg, target, steps=8, params=params,
                    optimizer=torch.optim.Adam(params.parameters(), lr=0.02),
                    device=CPU)
    assert losses[-1] < 0.5 * losses[0], losses
    assert np.isfinite(losses).all()
    assert all(n == 0 for n in K.LAUNCHES.values())


# ------------------------------------------------------------ refusals

def _fit_case(size=8):
    scene, cam, cfg = tpresets.fit_target(size=size)
    camera = Camera.from_config(cam, size, size)
    return (scene, camera, cfg, torch.zeros(size, size, 3),
            FitParams.from_scene(scene))


def test_split_mode_raises_naming_k8():
    """Split mode, once refused until K8 was ported, now runs on the CPU
    through the plain versions of the residual forward and K8 and agrees
    with the two-phase path (fields within 1e-5 of max); only an unknown
    mode raises."""
    scene, camera, cfg, target, params = _fit_case()
    K.reset_launch_counts()
    loss, grads = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        mode="split", device=CPU)
    assert all(n == 0 for n in K.LAUNCHES.values())
    ref_loss, ref = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                          device=CPU)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    for f in FIELDS:
        assert _rel(ref[f].numpy(), grads[f].numpy()) <= 1e-5, f
    with pytest.raises(ValueError, match="unknown fit mode"):
        AF.fit_value_and_grad(params, scene, camera, cfg, target,
                              mode="other", device=CPU)


def test_prep_with_a_jittered_config_raises():
    scene, camera, cfg, target, params = _fit_case()
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=CPU)
    for change in (dict(samples=2), dict(force_jitter=True)):
        with pytest.raises(ValueError, match="no supersampling"):
            AF.fit_value_and_grad(params, scene, camera,
                                  dataclasses.replace(cfg, **change), target,
                                  prep=prep, device=CPU)


def test_fit_step_with_a_jittered_config_raises_as_jax_does():
    js, jc, jf = jpresets.fit_target(size=8)
    jcfg = dataclasses.replace(jf, samples=2)
    jcam = JCamera.from_config(jc, 8, 8)
    jp = JFitParams.from_scene(js)
    opt = optax.adam(0.1)
    j_step = j_make_fit_step_pallas(js, jcam, jcfg, np.zeros((8, 8, 3)), opt)
    with pytest.raises(ValueError, match="no supersampling"):
        j_step(jp, opt.init(jp))
    scene, camera, cfg, target, params = _fit_case()
    step = make_fit_step_kernel(scene, camera,
                                dataclasses.replace(cfg, samples=2), target,
                                default_fit_optimizer(params), device=CPU)
    with pytest.raises(ValueError, match="no supersampling"):
        step(params)


def test_tree_depth_above_the_cap_raises():
    scene, camera, cfg = port_fractional(AF.TREE_ADJOINT_MAX_DEPTH + 1)
    target = torch.zeros(SIZE, SIZE, 3)
    cap = (f"tree depth <= {AF.TREE_ADJOINT_MAX_DEPTH} \\(the tree "
           f"forward's own limit")
    with pytest.raises(ValueError, match=cap):
        AF.fit_value_and_grad(FitParams.from_scene(scene), scene, camera, cfg,
                              target, device=CPU)
    with pytest.raises(ValueError, match=cap):
        AF.recompute_grads_kernel(scene, camera, cfg, target, device=CPU)


def test_new_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera, cfg, target, params = _fit_case()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AF.fused_loss_grads_kernel(scene, camera, cfg, target)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AF.recompute_grads_kernel(scene, camera, cfg, target)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AF.fit_value_and_grad(params, scene, camera,
                              dataclasses.replace(cfg, samples=2), target)
    tree, tcam, tcfg = port_fractional(2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fit(tree, tcam, tcfg, torch.zeros(SIZE, SIZE, 3), steps=1)
