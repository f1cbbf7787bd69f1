"""The port's forward render (ray_tracer_fragment_shader_tpu_torch.kernels
.render) against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions, so these
tests hold the plain versions against three references: the JAX core
renderer, the committed Pallas goldens (tests/goldens/*_pallas.npy, the JAX
kernel's own interpret-mode output at 64x64, scripts/make_goldens.py) and
the same JAX jitter draws for supersampling.  Budgets are fractions of
pixels whose max-channel difference exceeds 1e-3: decision-boundary pixels
(checker parity on the board's horizon row and its reflections) flip
between float32 evaluation orders, as in tests/test_pallas.py.

The CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py
(marker ``gpu``) and chip_smoke.py hold them against the plain versions.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.config import CameraConfig as JCameraConfig
from ray_tracer_fragment_shader_tpu.config import RenderConfig as JRenderConfig
from ray_tracer_fragment_shader_tpu.core.renderer import render_image
from ray_tracer_fragment_shader_tpu.ops.rays import sample_jitter as j_sample_jitter
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                           primary_rays,
                                                           screen_points)
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SIZE = 32
TOL = 1e-3


def assert_close_frac(ref, img, budget, name=""):
    ref, img = np.asarray(ref), np.asarray(img)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    d = np.abs(ref - img).max(-1)
    frac = (d > TOL).mean()
    assert frac <= budget, (f"{name}: {frac:.4f} of pixels off by > {TOL} "
                            f"(budget {budget}), max {d.max():.3g}")
    assert img.mean() == pytest.approx(ref.mean(), rel=0.05)


def both(name, **kw):
    """(JAX preset, port preset) of one name with the same arguments."""
    return jpresets.PRESETS[name](**kw), tpresets.PRESETS[name](**kw)


def jax_jitter(cfg, n):
    """The [S, n, 3] jitter the JAX renderers draw for ``cfg``."""
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.samples)
    draw = jax.jit(jax.vmap(lambda k: j_sample_jitter(k, n, cfg.jitter_scale)))
    return torch.from_numpy(np.array(draw(keys)))


CORE_CASES = [
    ("single_sphere", {}, 0.0),
    ("three_spheres_ground", {}, 0.01),
    ("full_reflective", {"depth": 3}, 0.01),
    ("fit_target", {}, 0.01),
    ("procedural_spheres", {"n": 64}, 0.01),
]


@pytest.mark.parametrize("name,kw,budget", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_chain_matches_jax_core(name, kw, budget):
    (js, jc, jf), (ts, tc, tf) = both(name, size=SIZE, **kw)
    assert_close_frac(render_image(js, jc, jf),
                      K.render_image_kernel(ts, tc, tf, device="cpu"), budget,
                      name)


def test_reference_demo_matches_jax_core():
    (js, jc, jf), (ts, tc, tf) = both("reference_demo")
    jf = dataclasses.replace(jf, width=SIZE, height=SIZE, samples=1,
                             max_depth=3)
    tf = dataclasses.replace(tf, width=SIZE, height=SIZE, samples=1,
                             max_depth=3)
    # the demo's 1:1 pixel scale puts a whole image row on the horizon,
    # where checker parity is decision-boundary noise
    assert_close_frac(render_image(js, jc, jf),
                      K.render_image_kernel(ts, tc, tf, device="cpu"), 0.02)


GOLDEN_CASES = [
    ("single_sphere", {}, 0.0),
    ("three_spheres_ground", {}, 0.01),
    ("full_reflective", {}, 0.01),
    ("fit_target", {}, 0.01),
    ("procedural_spheres", {"n": 64, "depth": 3}, 0.01),
]


@pytest.mark.parametrize("name,kw,budget", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_chain_matches_pallas_golden(name, kw, budget):
    """The JAX kernel's own output at 64x64 (scripts/make_goldens.py)."""
    scene, cam, cfg = tpresets.PRESETS[name](size=64, **kw)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_pallas.npy"))
    assert_close_frac(golden,
                      K.render_image_kernel(scene, cam, cfg, device="cpu"),
                      budget, name)


def test_reference_demo_adaptive_matches_pallas_golden():
    """The demo golden: 16-sample adaptive, depth 5, 64x64, with the JAX
    kernel's own jitter fed through ``jitter=``."""
    scene, cam, cfg = tpresets.reference_demo()
    cfg = dataclasses.replace(cfg, width=64, height=64, adaptive=True)
    golden = np.load(os.path.join(GOLDEN_DIR, "reference_demo_pallas.npy"))
    img = K.render_image_kernel(scene, cam, cfg,
                                jitter=jax_jitter(cfg, 64 * 64), device="cpu")
    assert_close_frac(golden, img, 0.02)


def test_tree_matches_jax_core_on_fractional_scene():
    from test_pallas import _fractional_scene
    ts, cam, cfg = tpresets.fractional_glass(size=SIZE, depth=2)
    assert not ts.chain_exact
    js = _fractional_scene()
    a = render_image(js, JCameraConfig(**dataclasses.asdict(cam)),
                     JRenderConfig(**dataclasses.asdict(cfg)))
    assert_close_frac(a, K.render_image_kernel(ts, cam, cfg, device="cpu"),
                      0.01)


def test_tree_matches_chain_on_chain_exact_scene():
    scene, cam, cfg = tpresets.full_reflective(size=SIZE)
    chain = K.render_image_kernel(scene, cam, cfg, device="cpu")
    tree = K.render_image_kernel(scene.replace(chain_exact=False), cam, cfg,
                                 device="cpu")
    forced = K.render_image_kernel(scene, cam,
                                   dataclasses.replace(cfg, mode="tree"),
                                   device="cpu")
    assert_close_frac(chain.numpy(), tree.numpy(), 0.01)
    assert torch.equal(tree, forced)


def test_nonsquare_frame():
    (js, jc, jf), (ts, tc, tf) = both("single_sphere", size=SIZE)
    jf = dataclasses.replace(jf, width=48, height=24)
    tf = dataclasses.replace(tf, width=48, height=24)
    b = K.render_image_kernel(ts, tc, tf, device="cpu")
    assert tuple(b.shape) == (24, 48, 3)
    assert np.abs(np.asarray(render_image(js, jc, jf)) - b.numpy()).max() < TOL


@pytest.mark.parametrize("adaptive", [False, True], ids=["mean", "adaptive"])
def test_supersampling_with_jax_jitter_matches_core(adaptive):
    """Same jitter draws -> the same sample sets as the JAX core."""
    (js, jc, jf), (ts, tc, tf) = both("single_sphere", size=16)
    jf = dataclasses.replace(jf, samples=4, adaptive=adaptive)
    tf = dataclasses.replace(tf, samples=4, adaptive=adaptive)
    img = K.render_image_kernel(ts, tc, tf, jitter=jax_jitter(tf, 16 * 16),
                                device="cpu")
    np.testing.assert_allclose(img.numpy(), np.asarray(render_image(js, jc, jf)),
                               atol=1e-3)


def test_generator_jitter_is_seeded():
    scene, cam, cfg = tpresets.single_sphere(size=16)
    cfg = dataclasses.replace(cfg, samples=3)
    a = K.render_image_kernel(scene, cam, cfg, device="cpu")
    b = K.render_image_kernel(scene, cam, cfg,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    c = K.render_image_kernel(scene, cam, dataclasses.replace(cfg, seed=1),
                              device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="jitter"):
        K.render_image_kernel(scene, cam, cfg, jitter=torch.zeros(2, 5, 3),
                              device="cpu")


def test_cpu_tensors_never_launch_kernels():
    K.reset_launch_counts()
    scene, cam, cfg = tpresets.full_reflective(size=16)
    K.render_image_kernel(scene, cam, cfg, device="cpu")
    K.render_image_kernel(scene.replace(chain_exact=False), cam, cfg,
                          device="cpu")
    K.render_forward_with_residuals(scene, cam, cfg, device="cpu")
    assert K.LAUNCHES == {"render_chain": 0, "render_tree": 0,
                          "render_packed": 0, "render_chain_residuals": 0,
                          "render_tree_residuals": 0, "adjoint_packed": 0,
                          "fused_adjoint": 0, "recompute_adjoint": 0,
                          "fit_grads": 0, "mix_chain": 0, "op_chain": 0,
                          "bf16_chain": 0, "render_chain_bf16": 0,
                          "render_tree_bf16": 0, "render_packed_bf16": 0,
                          "render_chain_residuals_bf16": 0,
                          "render_tree_residuals_bf16": 0,
                          "fused_adjoint_bf16": 0,
                          "recompute_adjoint_bf16": 0}


def test_no_device_without_cuda_raises(monkeypatch):
    """A CPU scene and no ``device``: the entry point runs on the GPU or
    raises; it never renders on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam, cfg = tpresets.full_reflective(size=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        K.render_image_kernel(scene, cam, cfg)


def _wrapper_inputs(size=16):
    scene, cam, cfg = tpresets.full_reflective(size=size)
    camera = Camera.from_config(cam, size, size)
    _, v = primary_rays(camera, screen_points(camera, size, size))
    return (K.pack_scene(scene), v.contiguous(), camera.eye.tolist(),
            K.render_kwargs(scene, cfg))


def test_wrappers_check_their_inputs():
    tables, v, eye, kw = _wrapper_inputs()
    with pytest.raises(ValueError, match="v must be"):
        K.render_chain(tables, v.double(), eye, **kw)
    with pytest.raises(ValueError, match="v must be"):
        K.render_chain(tables, v[:, :2], eye, **kw)
    with pytest.raises(ValueError, match="table 'tri'"):
        K.render_tree(dict(tables, tri=tables["tri"][:, :20].contiguous()),
                      v, eye, **kw)
    with pytest.raises(ValueError, match="TREE_MAX_DEPTH"):
        K.render_tree(tables, v, eye, **dict(kw, depth=K.TREE_MAX_DEPTH + 1))
    # bf16_shading runs (it raised before its kernels were ported)
    scene, cam, cfg = tpresets.single_sphere(size=8)
    K.reset_launch_counts()
    img = K.render_image_kernel(scene, cam,
                                dataclasses.replace(cfg, bf16_shading=True),
                                device="cpu")
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert all(n == 0 for n in K.LAUNCHES.values())
