"""The CUDA kernels on the card, against their plain PyTorch versions on
the same inputs.  Every test here needs a CUDA GPU and skips without one.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Budget: the fraction of pixels whose max-channel difference exceeds 1e-3
(decision-boundary flips from fma contraction and rsqrtf on the card)
stays within 1% (2% for reference_demo, whose horizon row is
checker-parity noise), and the image means agree within 1%.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                           primary_rays,
                                                           screen_points)
from ray_tracer_fragment_shader_tpu_torch.scene import presets

pytestmark = pytest.mark.gpu
N = 64
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def case(name):
    if name == "reference_demo":
        s, c, f = presets.reference_demo()
        return s, c, dataclasses.replace(f, width=N, height=N, samples=1,
                                         max_depth=3), 0.02
    if name == "fractional_glass":
        return (*presets.fractional_glass(size=N, depth=2), 0.01)
    if name == "procedural_spheres":
        return (*presets.procedural_spheres(n=64, size=N, depth=3), 0.01)
    return (*presets.full_reflective(size=N, depth=3), 0.01)


def inputs(scene, cam, cfg, device):
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=device)
    _, v = primary_rays(camera, screen_points(camera, cfg.width, cfg.height))
    return (K.pack_scene(scene.to(device)), v.contiguous(),
            camera.eye.tolist(), K.render_kwargs(scene, cfg))


def assert_close_frac(ref, img, budget):
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    frac = ((img - ref).abs().amax(-1) > 1e-3).float().mean().item()
    assert frac <= budget, f"{frac:.4f} of pixels off (budget {budget})"
    assert img.mean().item() == pytest.approx(ref.mean().item(), rel=0.01)


@pytest.mark.parametrize("kernel,name", [
    ("render_chain", "full_reflective"),
    ("render_chain", "reference_demo"),
    ("render_chain", "procedural_spheres"),
    ("render_tree", "fractional_glass"),
    ("render_tree", "full_reflective"),
])
def test_kernel_matches_plain(cuda, kernel, name):
    scene, cam, cfg, budget = case(name)
    tables, v, eye, kw = inputs(scene, cam, cfg, cuda)
    before = K.LAUNCHES[kernel]
    img = getattr(K, kernel)(tables, v, eye, **kw)
    torch.cuda.synchronize()
    assert img.is_cuda and K.LAUNCHES[kernel] == before + 1
    plain = getattr(K, kernel + "_ref")(tables, v, eye, **kw)
    assert_close_frac(plain, img, budget)


def test_render_image_kernel_on_the_card(cuda):
    scene, cam, cfg = presets.full_reflective(size=N, depth=3)
    cfg = dataclasses.replace(cfg, samples=2, adaptive=True)
    K.reset_launch_counts()
    img = K.render_image_kernel(scene, cam, cfg, device=cuda,
                                generator=torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert img.is_cuda and K.LAUNCHES["render_chain"] >= 1
    assert K.LAUNCHES["render_tree"] == 0
    single = K.render_image_kernel(scene, cam,
                                   dataclasses.replace(cfg, samples=1),
                                   device=cuda)
    cpu = K.render_image_kernel(scene, cam, dataclasses.replace(cfg,
                                                                samples=1))
    assert_close_frac(cpu, single.cpu(), 0.01)


def test_wrapper_rejects_tables_on_another_device(cuda):
    scene, cam, cfg, _ = case("full_reflective")
    tables, v, eye, kw = inputs(scene, cam, cfg, cuda)
    with pytest.raises(ValueError, match="table"):
        K.render_chain({k: t.cpu() for k, t in tables.items()}, v, eye, **kw)


@pytest.mark.parametrize("name,kw,budget", [
    ("single_sphere", {}, 0.0),
    ("three_spheres_ground", {}, 0.01),
    ("full_reflective", {}, 0.01),
    ("fit_target", {}, 0.01),
    ("procedural_spheres", {"n": 64, "depth": 3}, 0.01),
])
def test_kernel_matches_pallas_golden(cuda, name, kw, budget):
    """The kernels against the JAX kernel's own output at 64x64
    (tests/goldens/*_pallas.npy, scripts/make_goldens.py)."""
    scene, cam, cfg = presets.PRESETS[name](size=64, **kw)
    golden = torch.from_numpy(np.load(os.path.join(GOLDEN_DIR,
                                                   f"{name}_pallas.npy")))
    img = K.render_image_kernel(scene, cam, cfg, device=cuda)
    assert_close_frac(golden, img.cpu(), budget)
