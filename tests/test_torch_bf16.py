"""The port's ``bf16_shading`` variant on the CPU: its plain versions against
the JAX package, its fit paths against the f32 replay of the bf16 forward's
topology, and the one-dispatch fits (K6/K7's plain versions) on scenes the
2^24 pack cannot hold and on a tree deeper than the old cap of 5.

The JAX references run in ONE subprocess for the module (fixture
``jax_bf16``): ``render_image_pallas`` in interpret mode on ``fit_target``,
``full_reflective`` (depth 2) and the transparent scene of
tests/test_bf16_shading.py:86-105, and ``render_forward_with_residuals``
on ``fit_target``, all at 32² with ``bf16_shading``.  The subprocess sets
``XLA_FLAGS=--xla_allow_excess_precision=false``: by default XLA on the CPU
keeps f32 intermediates inside jitted bf16 expressions (Pallas interpret
mode is jitted), where the TPU's bf16 units, and PyTorch's bf16 ops, round
every operation.  With the default flag 4 % of the port's pixels are more
than 1e-3 from JAX's; with it off, 0.9 %, all but one on the checker edge
under the middle scanline, where at an even size the two renders' last-bit
rounding picks either square (tests/test_torch_split.py).
tests/conftest.py imports jax first, so the flag cannot be set in this
process.  ``RTFS_SWEEP_UNROLL=0`` runs the kernels' primitive sweeps as
loops: the same operations in the same order (bit-identical images and
planes), a program that compiles in seconds instead of minutes.

Tolerances: the plain bf16 image against JAX's at most 1 % of pixels past
1e-3 (tests/test_pallas.py::_compare's budget) and the means within 5 %;
the residual planes equal JAX's but on that 1 % of pixels; the port's bf16
image against its f32 image more than 3 % of pixels past 1e-3 (JAX: 6.2 %
on fit_target), which the bars of tests/test_bf16_shading.py cannot show;
every fit path's gradients equal the f32 replay of the bf16 forward's
residuals (``replay_grads``) within 1e-5 of max and their loss that of the
bf16 image (the same replay under the same cotangent up to its rounding);
the JAX test's own bars on the port (gradients within 5 % of the f32
path's, 8 Adam steps descend); K6/K7's plain versions within 5e-4 of max
of ``render_image_diff``'s autograd (already held against ``jax.vjp`` of
the replay, tests/test_torch_split.py), and the f64 finite-difference bar
1e-4 (BASELINE.md) at 64², the least size at which both scenes have stable
pixels (``oracle.gradcheck.stable_interior_pixels``; none at 8² or 16²).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch import grad_bar
from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
    FitParams, make_fit_step_kernel)
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
    l2_loss_kernel, render_image_diff)
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
    Camera, primary_rays, screen_points)
from ray_tracer_fragment_shader_tpu_torch.oracle.gradcheck import (
    fd_param, make_functional, summarize)
from ray_tracer_fragment_shader_tpu_torch.scene import (Material,
                                                        SceneBuilder, presets)

SIZE = 32
CPU = "cpu"
FIELDS = FitParams.FIELDS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("fit_target", "full_reflective", "transparent")

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        compact_scene, render_forward_with_residuals, render_image_pallas)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu.scene import (Material, SceneBuilder,
                                                      presets)
    S = int(sys.argv[2])
    bf = lambda cfg: dataclasses.replace(cfg, bf16_shading=True)
    def render(scene, cam, cfg):
        return np.asarray(render_image_pallas(
            scene, Camera.from_config(cam, S, S), bf(cfg), interpret=True))
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(1.0, 1.0, 1.0),
                     refraction=0.9)
    transparent = (SceneBuilder().add_checkerboard()
                   .add_sphere("d5", material=glass).add_sphere("c3")
                   .add_light("b6").build())
    out = dict(fit_target=render(*presets.fit_target(size=S)),
               full_reflective=render(*presets.full_reflective(size=S,
                                                               depth=2)),
               transparent=render(transparent, presets._cam(S),
                                  presets.fit_target(size=S)[2]))
    s, c, f = presets.fit_target(size=S)
    img, res = render_forward_with_residuals(
        compact_scene(s), Camera.from_config(c, S, S), bf(f), interpret=True)
    out["residual_img"] = np.asarray(img)
    out.update({"residual_" + k: np.asarray(v) for k, v in res.items()})
    np.savez(sys.argv[1], **out)
""")


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-12)


def _bf16(cfg, on=True):
    return dataclasses.replace(cfg, bf16_shading=on)


def port_scene(name, size=SIZE):
    """The port's counterpart of each scene the JAX subprocess renders."""
    if name == "transparent":
        glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                         specular=(0.4, 0.4, 0.4),
                         transparency=(1.0, 1.0, 1.0), refraction=0.9)
        scene = (SceneBuilder().add_checkerboard()
                 .add_sphere("d5", material=glass).add_sphere("c3")
                 .add_light("b6").build())
        return scene, presets._cam(size), presets.fit_target(size=size)[2]
    if name == "full_reflective":
        return presets.full_reflective(size=size, depth=2)
    return presets.fit_target(size=size)


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    """The JAX package's bf16 renders and residual planes at 32², from one
    subprocess with per-op bf16 rounding (module docstring)."""
    out = tmp_path_factory.mktemp("jax_bf16") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", RTFS_SWEEP_UNROLL="0",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                          str(SIZE)], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_images():
    """Each scene's plain render with and without bf16_shading."""
    out = {}
    for name in SCENES:
        scene, cam, cfg = port_scene(name)
        out[name] = tuple(K.render_image_kernel(scene, cam, _bf16(cfg, on),
                                                device=CPU).numpy()
                          for on in (True, False))
    return out


def _past(a, b, tol=1e-3):
    return float((np.abs(a - b).max(-1) > tol).mean())


# ------------------------------------------ the plain bf16 forward vs JAX

@pytest.mark.parametrize("name", SCENES)
def test_plain_bf16_image_matches_jax_per_op_rounding(jax_bf16, port_images,
                                                      name):
    got, ref = port_images[name][0], jax_bf16[name]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _past(got, ref) <= 0.01, _past(got, ref)
    assert abs(got.mean() / ref.mean() - 1.0) <= 0.05


@pytest.mark.parametrize("name", SCENES)
def test_bf16_image_differs_from_the_f32_image(port_images, name):
    """The bf16 branch ran: the bars of tests/test_bf16_shading.py hold for
    f32 against bf16 too, so they cannot show it."""
    bf, f32 = port_images[name]
    assert _past(bf, f32) > 0.03, _past(bf, f32)


@pytest.mark.parametrize("name", ["full_reflective", "fit_target"])
def test_bf16_shading_parity_bars(name):
    """tests/test_bf16_shading.py::test_bf16_shading_parity_bars on the
    port, at its 64^2: against the f32 image, the p99 of each pixel's
    largest channel error under 1e-2 and under 0.5 % of pixels past 3e-2."""
    scene, cam, cfg = port_scene(name, size=64)
    bf, f32 = (K.render_image_kernel(scene, cam, _bf16(cfg, on),
                                     device=CPU).numpy()
               for on in (True, False))
    d = np.abs(bf - f32).max(-1)
    assert np.isfinite(bf).all()
    assert np.quantile(d, 0.99) < 1e-2, np.quantile(d, 0.99)
    assert (d > 3e-2).mean() < 5e-3, (d > 3e-2).mean()


def test_residual_planes_equal_jax(jax_bf16):
    scene, cam, cfg = port_scene("fit_target")
    img, res = K.render_forward_with_residuals(scene, cam, _bf16(cfg),
                                               device=CPU)
    assert _past(img.numpy(), jax_bf16["residual_img"]) <= 0.01
    for k in ("bi", "mid", "lit"):
        got, ref = res[k].numpy(), jax_bf16[f"residual_{k}"]
        assert got.shape == ref.shape, k
        differ = (got != ref).reshape(-1, SIZE, SIZE).any(0)
        assert differ.mean() <= 0.01, (k, differ.mean())


# ----------------------------------------------------- the fit paths

def _fit_case(size=16, on=True, dc=1.0):
    scene, cam, cfg = presets.fit_target(size=size)
    cfg = _bf16(cfg, on)
    camera = Camera.from_config(cam, size, size)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += dc
    return scene, camera, cfg, target, params


def _jitter(cfg, samples):
    return (np.random.RandomState(5).uniform(
        -0.5, 0.5, (samples, cfg.width * cfg.height, 3))
        * cfg.jitter_scale).astype(np.float32)


def _replayed(params, scene, camera, cfg, target, jitter):
    """(loss, FitParams gradients) of the bf16 forward's residuals replayed
    in f32 (``replay_grads``), sample by sample: what every fit path must
    compute under bf16_shading."""
    scene_full = params.into_scene(scene)
    sc, tables, kw = AF.scene_tables(scene_full, cfg, CPU)
    assert kw["bf16"]
    pts = screen_points(camera, cfg.width, cfg.height)
    shifts = [0.0] if jitter is None else [torch.from_numpy(j)
                                           for j in jitter]
    tgt = torch.as_tensor(target).reshape(-1, 3)
    runs = []
    for d in shifts:
        _, v = primary_rays(camera, pts + d)
        v = v.contiguous()
        img, res = K.render_residuals_ref(tables, v, camera.eye.tolist(),
                                          tree=not sc.chain_exact, **kw)
        runs.append((v, img, res))
    diff = sum(r[1] for r in runs) / len(runs) - tgt
    g = (2.0 / (diff.numel() * len(runs))) * diff
    sums = None
    for v, _, res in runs:
        tabs = AF.replay_grads(tables, v, camera.eye.tolist(), res, g,
                               tree=not sc.chain_exact, nl=kw["nl"],
                               depth=kw["depth"], atten=kw["atten"])
        sums = tabs if sums is None else tuple(a + b
                                               for a, b in zip(sums, tabs))
    grads = AF.grads_to_fitparams(params, scene_full, AF._grads_c(sc, *sums))
    return torch.mean(diff * diff), grads


FIT_MODES = ("twophase", "fused", "split", "samples2")


@pytest.mark.parametrize("mode", FIT_MODES)
def test_fit_grads_replay_the_bf16_topology_in_f32(mode):
    scene, camera, cfg, target, params = _fit_case()
    jitter = None
    if mode == "samples2":
        cfg = dataclasses.replace(cfg, samples=2)
        jitter = _jitter(cfg, 2)
    K.reset_launch_counts()
    loss, grads = AF.fit_value_and_grad(
        params, scene, camera, cfg, target,
        mode="twophase" if mode == "samples2" else mode,
        jitter=None if jitter is None else torch.from_numpy(jitter),
        device=CPU)
    assert all(n == 0 for n in K.LAUNCHES.values())
    ref_loss, ref = _replayed(params, scene, camera, cfg, target, jitter)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    for f in FIELDS:
        assert np.abs(ref[f].detach().numpy()).max() > 0, f
        assert _rel(ref[f].detach().numpy(),
                    grads[f].detach().numpy()) <= 1e-5, f


def _step_loss(scene, camera, cfg, target, params):
    step = make_fit_step_kernel(scene, camera, cfg, target,
                                torch.optim.SGD(params.parameters(), lr=0.0),
                                device=CPU)
    return step(params)


def _diff_loss(scene, camera, cfg, target, params):
    return l2_loss_kernel(params, scene, camera, cfg, target,
                          device=CPU).detach()


PATHS = {
    "twophase": lambda *a: AF.fit_value_and_grad(*a, device=CPU)[0],
    "fused": lambda *a: AF.fit_value_and_grad(*a, mode="fused",
                                              device=CPU)[0],
    "split": lambda *a: AF.fit_value_and_grad(*a, mode="split",
                                              device=CPU)[0],
    "samples2": lambda p, s, c, cfg, t: AF.fit_value_and_grad(
        p, s, c, dataclasses.replace(cfg, samples=2), t,
        jitter=torch.from_numpy(_jitter(cfg, 2)), device=CPU)[0],
    "fit_step": lambda p, s, c, cfg, t: _step_loss(s, c, cfg, t, p),
    "render_image_diff": lambda p, s, c, cfg, t: _diff_loss(s, c, cfg, t, p),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_fit_paths_do_not_return_f32_under_the_flag(path):
    """ROADMAP queue 3: the fit paths once dropped bf16_shading.  Under the
    flag each returns the loss of the bf16 render, not of the f32 one."""
    scene, camera, cfg, target, params = _fit_case(on=False)
    fn = PATHS[path]
    loss_bf = float(fn(params, scene, camera, _bf16(cfg), target))
    loss_f32 = float(fn(params, scene, camera, cfg, target))
    if path == "samples2":
        cfg = dataclasses.replace(cfg, samples=2)
        jitter = torch.from_numpy(_jitter(cfg, 2))
        img = K.render_image_kernel(params.into_scene(scene), camera,
                                    _bf16(cfg), jitter=jitter, device=CPU)
    else:
        img = K.render_image_kernel(params.into_scene(scene), camera,
                                    _bf16(cfg), device=CPU)
    want = float(torch.mean((img.detach() - target) ** 2))
    assert loss_bf == pytest.approx(want, rel=1e-5)
    assert abs(loss_bf - loss_f32) > 1e-4 * loss_f32


def test_bf16_shading_fit_descends_and_grads_close():
    """tests/test_bf16_shading.py's bars on the port: gradients within 5 %
    of the f32 path's, 8 Adam steps at 0.05 descend."""
    scene, camera, cfg, target, params = _fit_case(size=SIZE, dc=1.0)
    loss_b, g_b = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        device=CPU)
    loss_f, g_f = AF.fit_value_and_grad(params, scene, camera,
                                        _bf16(cfg, False), target, device=CPU)
    assert float(loss_b) == pytest.approx(float(loss_f), rel=0.1)
    for f in ("sph_center", "sph_radius", "light_pos", "mat_diffuse"):
        a, b = g_f[f].numpy(), g_b[f].numpy()
        assert _rel(a, b) < 5e-2, f
        assert np.abs(b).max() > 0, f
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 2.0
    step = make_fit_step_kernel(scene, camera, cfg, target,
                                torch.optim.Adam(params.parameters(),
                                                 lr=0.05), device=CPU)
    losses = [float(step(params)) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert min(losses[1:]) < losses[0]


# ------------------------------ A1: K6/K7 past the pack and the old cap

A1_SCENES = {
    "overflow_fractional": lambda size: presets.pack_overflow(size=size),
    "overflow_chain": lambda size: presets.pack_overflow(size=size,
                                                         fractional=False),
    "tree_depth6": lambda size: presets.fractional_glass(size=size,
                                                         depth=6),
}


def test_a1_scenes_are_past_the_pack_and_the_old_cap():
    scene = K.compact_scene(presets.pack_overflow(size=8)[0])
    tables = K.pack_scene(scene)
    counts = (tables["tri"].shape[0], scene.num_spheres,
              scene.num_materials, scene.num_lights)
    assert not scene.chain_exact
    with pytest.raises(ValueError, match="packed residual"):
        K.pack_widths(*counts)
    assert AF.TREE_ADJOINT_DEPTH_CAPS == (5, 7, 10)
    assert AF.TREE_ADJOINT_MAX_DEPTH == K.TREE_MAX_DEPTH


@pytest.mark.parametrize("name", list(A1_SCENES))
def test_unpacked_k6_k7_match_render_image_diff(name):
    """K6 (``mode="fused"``; tree scenes take it anyway) and K7 on scenes
    the pack cannot hold and on the deeper tree cap, against
    ``render_image_diff``'s autograd.  ``overflow_chain`` takes their chain
    form, which refused it too before the pack was dropped."""
    size = 8
    scene, cam, cfg = A1_SCENES[name](size)
    camera = Camera.from_config(cam, size, size)
    target = K.render_image_kernel(scene, camera, cfg, device=CPU) * 0.9
    params = FitParams.from_scene(scene)
    K.reset_launch_counts()
    loss, grads = AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        mode="fused", device=CPU)
    ref_params = FitParams.from_scene(scene)
    ref_loss = l2_loss_kernel(ref_params, scene, camera, cfg, target,
                              device=CPU)
    ref_loss.backward()
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    for f in FIELDS:
        ref = getattr(ref_params, f).grad.numpy()
        assert np.abs(ref).max() > 0, f
        assert _rel(ref, grads[f].numpy()) <= 5e-4, f
    # K7 under an outside cotangent, against render_image_diff's backward
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (size, size, 3)).astype(np.float32))
    got = AF.recompute_grads_kernel(scene, camera, cfg, g, device=CPU)
    sc = K.compact_scene(scene).replace(**{
        k: t.clone().requires_grad_()
        for k, t in K.compact_scene(scene).tensors().items()
        if t.is_floating_point()})
    render_image_diff(sc, camera, cfg, device=CPU).backward(g)
    for f in ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
              "mat_specular", "mat_ambient"):
        ref = getattr(sc, f).grad.numpy()
        assert _rel(ref, got[f].numpy()) <= 5e-4, f
    assert all(n == 0 for n in K.LAUNCHES.values())


def _a1_bar(name):
    """K7's plain version under the functional's cotangent against f64
    finite differences (``grad_bar._param_bar``'s pixels and weights), at
    64²: every FitParams component of the deep tree; on the overflow
    scene, whose 895 components take the numpy oracle 45 s, the lights'
    and the picked pixels' own spheres and materials."""
    scene, camcfg, cfg = A1_SCENES[name](64)
    scene, cam, res, pix, w_rgb = grad_bar._picked(scene, camcfg, cfg,
                                                   torch.device(CPU), 2,
                                                   seed=0)
    g = np.zeros((64, 64, 3), np.float32)
    for k, (j, i) in enumerate(pix):
        g[j, i] = w_rgb[k] / len(pix)
    grads = {k: v.double().numpy() for k, v in AF.recompute_grads_kernel(
        scene, cam, cfg, torch.from_numpy(g), device=CPU).items()}
    J = make_functional(scene, cfg, camcfg, pix, w_rgb)
    bi0 = res["bi"][0].numpy()
    nt = int(scene.num_triangles)
    sph = sorted({int(bi0[p]) - nt for p in pix if bi0[p] >= nt})
    mats = sorted({int(res["mid"][0].numpy()[p]) for p in pix})
    if name == "tree_depth6":
        sph, mats = range(scene.num_spheres), range(scene.num_materials)
    comps = ([("sph_center", (i, a)) for i in sph for a in range(3)]
             + [("sph_radius", (i,)) for i in sph]
             + [("light_pos", (li, a)) for li in range(scene.num_lights)
                for a in range(3)]
             + [(f, (j, a)) for j in mats for a in range(3)
                for f in ("mat_ambient", "mat_diffuse", "mat_specular")])
    eps = dict(sph_center=1e-3, sph_radius=1e-3, light_pos=1e-2)
    return summarize([(f"{f}{idx}", grads[f][idx],
                       fd_param(J, scene, f, idx, eps.get(f, 1e-4)))
                      for f, idx in comps])


@pytest.mark.parametrize("name", ["overflow_fractional", "tree_depth6"])
def test_unpacked_k7_meets_the_f64_grad_bar(name):
    s = _a1_bar(name)
    assert s["grad_scale"] > 1e-3 and s["n_checks"] >= 20, s
    assert s["max_abs_err"] <= grad_bar.BAR, s


def test_bf16_work_counts_split_their_basic_operations():
    """utils/opcount.py's bf16 units: ``BF16_OPS`` is a part of each
    one's ``basic`` operations; a bf16 forward of an
    all-opaque scene runs them (shadow sweep and blend) where the f32 one
    runs none; and the data-sheet bound prices them at twice the FP32
    rate."""
    from ray_tracer_fragment_shader_tpu_torch.utils import opcount
    for unit, n in opcount.BF16_OPS.items():
        assert 0 < n < opcount.CLASSES[unit]["basic"], unit
    scene, cam, cfg = presets.full_reflective(size=16, depth=2)
    camera = Camera.from_config(cam, 16, 16)
    _, v = primary_rays(camera, screen_points(camera, 16, 16))
    tables = K.pack_scene(scene)
    kw = K.render_kwargs(scene, _bf16(cfg))
    w_bf = opcount.forward_work(tables, v.contiguous(), camera.eye.tolist(),
                                **kw)
    w_32 = opcount.forward_work(tables, v.contiguous(), camera.eye.tolist(),
                                **dict(kw, bf16=False))
    assert w_32["bf16_ops"] == 0
    assert 0 < w_bf["bf16_ops"] < w_bf["classes"]["basic"]
    as_fp32 = opcount.bound_ms(w_bf["ops"], 0.0)[0]
    bound = opcount.bound_ms(w_bf["ops"], 0.0, w_bf["bf16_ops"])[0]
    assert bound == pytest.approx(
        as_fp32 - w_bf["bf16_ops"] / opcount.PEAK_BF16_FLOPS * 1e3)
    assert w_bf["units"].get("TRI_TEST_BF16", 0) > 0
    assert w_bf["units"]["SHADE_LIGHT_BF16"] == w_32["units"]["SHADE_LIGHT"]
