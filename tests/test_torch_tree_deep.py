"""K6 and K7's plain versions on bounce trees deeper than their old cap of
6, on the CPU: the fused tree fit (``fit_value_and_grad`` on a fractional
scene) and ``recompute_grads_kernel``.

The scene is ``presets.glass_cube``: a cube of fractional glass, inside
which every hit spawns a transmitted and a reflected child, so its trees
hit at the deepest levels (``fractional_glass``'s end by level 3).

* Depth 7 (255 preorder nodes), 16^2: against the JAX package's tree replay
  under ``jax.vjp`` on the port's residuals, as tests/test_torch_fused.py
  does at depth 2 (no Pallas kernel runs); JAX's replay reproducing the
  port's image (atol 1e-4); the loss against JAX's primal's; the f64
  finite-difference bar on a few components; ``fit()`` descending.  The
  replay is replay_render_tree's recursion over the JAX package's own node
  math (kernels/adjoint.py::_node_math), written out here so that a
  subtree that misses on every pixel is skipped: it adds exactly zero, and
  JAX's eager recursion over all 255 nodes takes about 50 s.
* Depth 10 (2047 nodes, the tree forward's own limit), 8^2: against the
  port's own ``render_image_diff`` (autograd through
  kernels/adjoint.py::replay_tree).  JAX's replay unrolls the tree node by
  node in Python, too slow at this depth for the tier-1 run.
* Depth 11: refused on every device.

Tolerances: loss within 1e-5 relative and each field within 5e-4 of
max|ref| (float32 reassociation, as tests/test_torch_fused.py:210-233);
the BASELINE bar, max-abs-err <= 1e-4 against f64 finite differences
(``grad_bar.BAR``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.config import RenderConfig as JRenderConfig
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams as JFitParams
from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
    _node_math as j_node_math)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    compact_scene as j_compact_scene)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera as JCamera
from ray_tracer_fragment_shader_tpu.ops.rays import (
    primary_rays as j_primary_rays)
from ray_tracer_fragment_shader_tpu.ops.rays import (
    screen_points as j_screen_points)
from ray_tracer_fragment_shader_tpu.scene.flat import (
    tri_derived as j_tri_derived)
from ray_tracer_fragment_shader_tpu.scene import Material as JMaterial
from ray_tracer_fragment_shader_tpu.scene import SceneBuilder as JSceneBuilder
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets
from ray_tracer_fragment_shader_tpu_torch import grad_bar
from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams, fit
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
    render_image_diff)
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                           primary_rays,
                                                           screen_points)
from ray_tracer_fragment_shader_tpu_torch.oracle.gradcheck import (
    fd_param, make_functional, summarize)
from ray_tracer_fragment_shader_tpu_torch.scene import presets

CPU = "cpu"
FIELDS = FitParams.FIELDS
SIZE7 = 16


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-12)


def port_cube(depth, size):
    scene, cam, cfg = presets.glass_cube(size=size, depth=depth)
    return scene, Camera.from_config(cam, size, size), cfg


def jax_cube(depth, size):
    """The JAX package's build of ``presets.glass_cube``."""
    glass = JMaterial(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                      specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                      refraction=0.9)
    scene = (JSceneBuilder().add_checkerboard().add_cube("d5", material=glass)
             .add_sphere("c3").add_light("b6").build())
    return (scene, JCamera.from_config(jpresets._cam(size), size, size),
            JRenderConfig(width=size, height=size, max_depth=depth,
                          samples=1))


def j_replay_tree(scene, camera, config, res, live):
    """kernels/adjoint.py::replay_render_tree of the JAX package, its node
    math and recursion, over the preorder nodes whose ``live`` flag is set
    (a node that misses on every pixel, with its subtree, adds exactly
    zero and is skipped) -> [P,3]."""
    scene = j_compact_scene(scene)
    depth, P = config.max_depth, config.width * config.height
    der = j_tri_derived(scene.tri_v0, scene.tri_v1, scene.tri_v2,
                        config.small_number)
    tri_n = der["n"]
    tri_nv0 = jnp.sum(tri_n * scene.tri_v0, -1)
    o0, v0 = j_primary_rays(camera, j_screen_points(camera, config.width,
                                                    config.height))
    counter = [0]

    def node(o, v, level):
        idx = counter[0]
        if not live[idx]:
            counter[0] += 2 ** (depth - level + 1) - 1
            return jnp.zeros((P, 3), jnp.float32)
        counter[0] += 1
        nm = j_node_math(scene, tri_n, tri_nv0, o, v, res["bi"][idx],
                         res["mid"][idx], res["lit"][:, idx], config)
        color = nm["local"]
        if level < depth:
            take_t = nm["take_t"][:, None]
            refl_ok = nm["refl_ok"][:, None]
            ct = node(nm["p"], jnp.where(take_t, nm["trans"], 0.0), level + 1)
            cr = node(nm["p"], jnp.where(refl_ok, nm["refl"], 0.0), level + 1)
            color = color + jnp.where(take_t, nm["trn"] * ct, 0.0)
            color = color + jnp.where(refl_ok, (1.0 - nm["trn"]) * cr, 0.0)
        return jnp.where(nm["hitm"][:, None], color, jnp.zeros_like(color))

    return node(o0, v0, 0)


def moved(params):
    """The fit's start: sphere centres + 0.6, diffuse colours * 1.3 + 0.02
    (tests/test_adjoint_tree.py:122-124)."""
    with torch.no_grad():
        params.mat_diffuse.mul_(1.3).add_(0.02)
        params.sph_center.add_(0.6)
    return params


@pytest.fixture(scope="module")
def depth7():
    """Depth 7: the port's K6 path (fit_value_and_grad) and K7 path
    (recompute_grads_kernel under a random cotangent), and the JAX tree
    replay's vjp of the loss and of that cotangent on the port's residuals
    of the moved scene; the loss and its cotangent from JAX's primal."""
    ts, tcam, tcfg = port_cube(7, SIZE7)
    target = K.render_image_kernel(ts, tcam, tcfg, device=CPU)
    tp = moved(FitParams.from_scene(ts))
    loss, grads = AF.fit_value_and_grad(tp, ts, tcam, tcfg, target,
                                        device=CPU)
    g = np.random.RandomState(0).standard_normal(
        (SIZE7, SIZE7, 3)).astype(np.float32)
    scene7 = tp.into_scene(ts)
    k7 = AF.grads_to_fitparams(tp, ts, AF.recompute_grads_kernel(
        scene7, tcam, tcfg, torch.from_numpy(g), device=CPU))
    # the port's residuals of the moved scene, as JAX's replay reads them
    sc, tables, kw, _ = AF.kernel_inputs(scene7, tcfg, SIZE7 ** 2,
                                         device=CPU)
    _, v = primary_rays(tcam, screen_points(tcam, SIZE7, SIZE7))
    img, res = K.render_tree_ref(tables, v.contiguous(), tcam.eye.tolist(),
                                 residuals=True, **kw)
    jres = {n: jnp.asarray(t.numpy()) for n, t in res.items()}
    live = (res["bi"] >= 0).any(-1).tolist()
    js, jcam, jcfg = jax_cube(7, SIZE7)
    jp = JFitParams.from_scene(js).replace(
        mat_diffuse=js.mat_diffuse * 1.3 + 0.02,
        sph_center=js.sph_center + 0.6)
    j_img, vjp = jax.vjp(lambda p: j_replay_tree(p.into_scene(js), jcam,
                                                 jcfg, jres, live), jp)
    diff = j_img - jnp.asarray(target.reshape(-1, 3).numpy())
    (j_loss_grads,) = vjp((2.0 / diff.size) * diff)
    (j_k7,) = vjp(jnp.asarray(g.reshape(-1, 3)))
    return dict(loss=float(loss), grads=grads, k7=k7, img=img.numpy(),
                j_img=np.asarray(j_img), j_loss=float(jnp.mean(diff * diff)),
                j_loss_grads=j_loss_grads, j_k7=j_k7,
                deep_hits=int((res["bi"][127:] >= 0).sum()))


def test_glass_cube_trees_hit_below_the_old_cap(depth7):
    # preorder nodes 127.. of a depth-7 tree include every level-7 node
    # and some of levels 1-6 below the old cap's reach: the scene keeps
    # hits there
    assert depth7["deep_hits"] > 0


def test_jax_deep_replay_reproduces_the_port_image(depth7):
    # JAX's replay of the port's residuals gives the port's image, so the
    # loss and cotangent below are JAX's own numbers
    np.testing.assert_allclose(depth7["j_img"], depth7["img"], atol=1e-4)


def test_deep_fused_tree_fit_matches_jax_replay_vjp(depth7):
    assert abs(depth7["loss"] - depth7["j_loss"]) <= 1e-5 * depth7["j_loss"]
    for f in FIELDS:
        ref = np.asarray(getattr(depth7["j_loss_grads"], f))
        assert np.abs(ref).max() > 0, f
        r = _rel(ref, depth7["grads"][f].numpy())
        assert r < 5e-4, f"{f}: rel diff {r:.3g}"


def test_deep_recompute_grads_matches_jax_replay_vjp(depth7):
    for f in FIELDS:
        ref = np.asarray(getattr(depth7["j_k7"], f))
        assert np.abs(ref).max() > 0, f
        r = _rel(ref, depth7["k7"][f].numpy())
        assert r < 5e-4, f"{f}: rel diff {r:.3g}"


def test_depth10_fits_match_render_image_diff():
    """K6 (``fit_value_and_grad``) and K7 (``recompute_grads_kernel``
    under the loss's cotangent) at depth 10, 8^2, against one
    ``render_image_diff`` backward of that cotangent."""
    size = 8
    scene, camera, cfg = port_cube(10, size)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU) * 0.9
    params = moved(FitParams.from_scene(scene))
    loss, grads = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        device=CPU)
    ref_params = moved(FitParams.from_scene(scene))
    img = render_image_diff(ref_params.into_scene(scene), camera, cfg,
                            device=CPU)
    diff = img.detach() - target
    g = (2.0 / diff.numel()) * diff
    img.backward(g)
    assert float(loss) == pytest.approx(float(torch.mean(diff * diff)),
                                        rel=1e-5)
    k7 = AF.grads_to_fitparams(params, scene, AF.recompute_grads_kernel(
        params.into_scene(scene), camera, cfg, g, device=CPU))
    for f in FIELDS:
        ref = getattr(ref_params, f).grad.numpy()
        assert np.abs(ref).max() > 0, f
        assert _rel(ref, grads[f].numpy()) <= 5e-4, f
        assert _rel(ref, k7[f].numpy()) <= 5e-4, f


def test_deep_k7_meets_the_f64_grad_bar():
    """K7's plain version at depth 7 under the functional's cotangent
    against f64 finite differences (``grad_bar._param_bar``'s pixels and
    weights, 64^2): the light position and the glass and sphere
    materials' diffuse and specular colours."""
    scene, camcfg, cfg = presets.glass_cube(size=64, depth=7)
    scene, cam, res, pix, w_rgb = grad_bar._picked(scene, camcfg, cfg,
                                                   torch.device(CPU), 2,
                                                   seed=0)
    g = np.zeros((64, 64, 3), np.float32)
    for k, (j, i) in enumerate(pix):
        g[j, i] = w_rgb[k] / len(pix)
    grads = {k: v.double().numpy() for k, v in AF.recompute_grads_kernel(
        scene, cam, cfg, torch.from_numpy(g), device=CPU).items()}
    J = make_functional(scene, cfg, camcfg, pix, w_rgb)
    comps = ([("light_pos", (0, a)) for a in range(3)]
             + [(f, (j, a)) for j in range(scene.num_materials)
                for a in range(3) for f in ("mat_diffuse", "mat_specular")])
    eps = dict(light_pos=1e-2)
    s = summarize([(f"{f}{idx}", grads[f][idx],
                    fd_param(J, scene, f, idx, eps.get(f, 1e-4)))
                   for f, idx in comps])
    assert s["grad_scale"] > 1e-3 and s["n_checks"] >= 20, s
    assert s["max_abs_err"] <= grad_bar.BAR, s


def test_deep_tree_fit_descends():
    """diff.fit.fit at depth 7, 8^2: 4 Adam steps at 0.02 over every leaf
    from the moved start; the loss falls."""
    scene, camera, cfg = port_cube(7, 8)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = moved(FitParams.from_scene(scene))
    K.reset_launch_counts()
    _, losses = fit(scene, camera, cfg, target, steps=4, params=params,
                    optimizer=torch.optim.Adam(params.parameters(), lr=0.02),
                    device=CPU)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_depth_11_is_refused():
    scene, camera, cfg = port_cube(11, 4)
    with pytest.raises(ValueError, match="tree depth <= 10"):
        AF.fit_value_and_grad(FitParams.from_scene(scene), scene, camera,
                              cfg, torch.zeros(4, 4, 3), device=CPU)
    with pytest.raises(ValueError, match="tree depth <= 10"):
        AF.recompute_grads_kernel(scene, camera, cfg, torch.zeros(4, 4, 3),
                                  device=CPU)
