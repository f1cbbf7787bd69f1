"""The frozen reference against the program's CPU path (its kernels' plain
versions) at a tiny size: the same frame, loss and gradients."""
import _bench_setup  # noqa: F401  (the path and the thread count)

import numpy as np
import pytest
import torch

from benchmark import inputs, reference
from _bench_setup import SEED, small_cell

PORT = pytest.importorskip("ray_tracer_fragment_shader_tpu_torch")


def _setup(size=24):
    cell = small_cell("config5_spheres64.fit_4096", size)
    cfg = cell.config
    arrays = inputs.scene_arrays(cfg["scene"], SEED)
    meta = inputs.scene_meta(arrays)
    from ray_tracer_fragment_shader_tpu_torch.config import (CameraConfig,
                                                             RenderConfig)
    from ray_tracer_fragment_shader_tpu_torch.scene.flat import FlatScene
    cam = cfg["camera"]
    camcfg = CameraConfig(eye=tuple(cam["eye"]), look_at=tuple(cam["look_at"]),
                          up=tuple(cam["up"]), pixel_scale=cam["pixel_scale"])
    rcfg = RenderConfig(width=size, height=size, max_depth=cfg["max_depth"],
                        samples=1)
    scene = FlatScene.from_numpy(arrays, **meta)
    return cfg, arrays, scene, camcfg, rcfg


def test_scene_arrays_have_the_builders_layout():
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    cfg, arrays, *_ = _setup()
    ps = presets.procedural_spheres(n=64, size=16, depth=3)[0].to_numpy()
    # the configuration's layout_seed is the preset's seed: the same scene,
    # array for array, whatever the run's seed
    for k, v in ps.items():
        assert arrays[k].shape == v.shape and arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    other = inputs.scene_arrays(cfg["scene"], SEED + 1)
    assert all(np.array_equal(other[k], arrays[k]) for k in arrays)
    assert inputs.scene_meta(arrays) == dict(
        checker_mats=(0, 1), chain_exact=True, has_transmission=False)


def test_frame_equals_the_programs():
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    cfg, arrays, scene, camcfg, rcfg = _setup()
    got = K.render_image_kernel(scene, camcfg, rcfg, device="cpu")
    ref, topo, counts = reference.render(
        arrays, reference.scene_leaves(arrays, "cpu"), cfg["camera"],
        rcfg.width, rcfg.height, depth=rcfg.max_depth, device="cpu",
        count=True)
    assert torch.equal(got.reshape(-1, 3), ref)
    assert topo["bi"].shape == (rcfg.max_depth + 1, rcfg.width * rcfg.height)
    assert counts["hits"] > 0 and counts["visits"] >= rcfg.width ** 2


def test_loss_and_gradients_match_the_programs():
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
    from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint_fused import (
        fit_value_and_grad)
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
    cfg, arrays, scene, camcfg, rcfg = _setup()
    W = rcfg.width
    target = reference.render(arrays, reference.scene_leaves(arrays, "cpu"),
                              cfg["camera"], W, W, depth=rcfg.max_depth,
                              device="cpu")[0].reshape(W, W, 3)
    params = FitParams.from_scene(scene)
    off = inputs.job_offsets(arrays, SEED, 1, 1.5)[0]
    with torch.no_grad():
        params.sph_center += torch.from_numpy(off)
    loss_p, grads_p = fit_value_and_grad(
        params, scene, Camera.from_config(camcfg, W, W), rcfg, target,
        device="cpu")
    leaves = {k: getattr(params, k).detach() for k in reference.LEAVES}
    loss_r, grads_r, live = reference.loss_and_grads(
        arrays, leaves, cfg["camera"], W, W, target, depth=rcfg.max_depth)
    assert live > 0
    assert abs(float(loss_p) - loss_r) <= 1e-6 * loss_r
    for k in reference.LEAVES:
        gp, gr = grads_p[k].double(), grads_r[k]
        gap = float((gp - gr).norm())
        assert gap <= 1e-5 * max(float(gr.norm()), 1e-12), k


def test_adam_follows_torch():
    g = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
    lrs = {"a": 0.5, "b": 0.01}
    mine = reference.Adam(lrs)
    ta = torch.nn.Parameter(p["a"].clone())
    tb = torch.nn.Parameter(p["b"].clone())
    opt = torch.optim.Adam([{"params": [ta], "lr": 0.5},
                            {"params": [tb], "lr": 0.01}])
    cur = {k: v.clone() for k, v in p.items()}
    for _ in range(3):
        grads = {"a": torch.randn(5, 3, generator=g),
                 "b": torch.randn(4, generator=g)}
        ta.grad, tb.grad = grads["a"].clone(), grads["b"].clone()
        opt.step()
        cur = mine.step(cur, grads)
    torch.testing.assert_close(cur["a"], ta.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(cur["b"], tb.detach(), rtol=1e-6, atol=1e-6)
