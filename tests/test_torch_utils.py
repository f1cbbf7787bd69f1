"""The port's utils (logging, guards, profiling, the checkpoint pairs) and
its C++ oracle (oracle/native.py), on the CPU: the counterparts of the
guards, logger and checkpoint cases of tests/test_io_utils.py and of
tests/test_cpp_oracle.py, with their tolerances (the C++ oracle within
1e-11 of the port's numpy oracle; two float64 implementations)."""
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu_torch.kernels.render import (
    render_image_kernel)
from ray_tracer_fragment_shader_tpu_torch.oracle import oracle_render
from ray_tracer_fragment_shader_tpu_torch.scene import presets
from ray_tracer_fragment_shader_tpu_torch.utils.checkpoint import (
    restore_checkpoint_dcp, save_checkpoint_dcp)
from ray_tracer_fragment_shader_tpu_torch.utils.guards import (
    assert_finite, checked_render)
from ray_tracer_fragment_shader_tpu_torch.utils.logging import (
    JsonlLogger, stderr_logger)
from ray_tracer_fragment_shader_tpu_torch.utils.profiling import (
    RaysMeter, named_phase, trace)

CPU = "cpu"
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="needs g++")


# ---------------------------------------------------------------- guards

def test_assert_finite_raises():
    with pytest.raises(FloatingPointError):
        assert_finite({"x": torch.tensor([1.0, float("nan")])})
    assert_finite({"x": torch.tensor([1.0, 2.0])})  # no raise


def test_assert_finite_names_the_leaf_in_nests():
    tree = {"a": [torch.ones(2), (np.zeros(3), torch.tensor([float("inf")]))],
            "n": torch.tensor([1, 2])}
    with pytest.raises(FloatingPointError, match=r"out\['a'\]\[1\]\[1\]"):
        assert_finite(tree, "out")
    params = FitParams.from_scene(presets.fit_target(size=8)[0])
    assert_finite(params)
    with torch.no_grad():
        params.light_pos[0, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\.light_pos"):
        assert_finite(params, "params")


def test_checked_render_clean():
    scene, cam, cfg = presets.single_sphere(size=16)
    out = checked_render(render_image_kernel, scene, cam, cfg, device=CPU)
    assert out.shape == (16, 16, 3) and bool(torch.isfinite(out).all())


def test_checked_render_raises_on_a_nan_output():
    with pytest.raises(FloatingPointError):
        checked_render(lambda x: x / 0.0 * 0.0, torch.ones(3))


# --------------------------------------------------------------- logging

def test_jsonl_logger(tmp_path, capsys):
    p = str(tmp_path / "log.jsonl")
    with JsonlLogger(path=p) as log:
        log.log({"step": 1, "loss": 0.5})
        log.log({"step": 2, "loss": 0.25})
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]["step"] == 1 and lines[1]["loss"] == 0.25
    assert "t" in lines[0]
    stderr_logger().log({"step": 3})
    assert json.loads(capsys.readouterr().err)["step"] == 3


# ------------------------------------------------------------- profiling

def test_trace_writes_a_chrome_trace_with_the_phase(tmp_path):
    with trace(str(tmp_path / "prof")):
        with named_phase("rtfs_forward"):
            render_image_kernel(*presets.single_sphere(size=8), device=CPU)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rtfs_forward" for e in events)


def test_rays_meter_counts_steps_and_chips():
    meter = RaysMeter(1000, n_chips=4)
    meter.step(3)
    meter._t0 -= 10.0   # 3000 rays over about 10 s
    assert meter.rays_per_s == pytest.approx(300.0, rel=1e-2)
    assert meter.rays_per_s_per_chip == pytest.approx(meter.rays_per_s / 4,
                                                      rel=1e-2)
    # no process group here: the CUDA devices, at least one
    assert RaysMeter(10).n_chips == max(torch.cuda.device_count(), 1)


# ------------------------------------------------------------ checkpoints

def test_checkpoint_roundtrip_dcp(tmp_path):
    """JAX's orbax pair (tests/test_io_utils.py:94-107) is the
    ``torch.distributed.checkpoint`` pair here (its multi-rank use runs in
    tests/test_torch_parallel.py's gloo group)."""
    scene, _, _ = presets.fit_target(size=8)
    params = FitParams.from_scene(scene)
    path = str(tmp_path / "dcp_ckpt")
    save_checkpoint_dcp(path, params)
    like = FitParams.from_scene(scene)
    with torch.no_grad():
        like.sph_center += 1.0
    restored = restore_checkpoint_dcp(path, like)
    assert torch.equal(restored.sph_center, params.sph_center)
    assert torch.equal(restored.light_pos, params.light_pos)
    assert not torch.equal(like.sph_center, params.sph_center)
    back = restore_checkpoint_dcp(path, {k: torch.zeros_like(v) for k, v
                                         in params.state_dict().items()})
    assert torch.equal(back["mat_diffuse"], params.mat_diffuse)


# ----------------------------------------------------------- C++ oracle

def _cpp():
    from ray_tracer_fragment_shader_tpu_torch.oracle.native import (
        cpp_oracle_render)
    return cpp_oracle_render


@needs_gxx
def test_cpp_matches_numpy_oracle_simple():
    scene, cam, cfg = presets.single_sphere(size=32)
    np.testing.assert_allclose(_cpp()(scene, cam, cfg),
                               oracle_render(scene, cam, cfg), atol=1e-11)


@needs_gxx
def test_cpp_matches_numpy_oracle_bounces():
    scene, cam, cfg = presets.full_reflective(size=32)
    np.testing.assert_allclose(_cpp()(scene, cam, cfg),
                               oracle_render(scene, cam, cfg), atol=1e-11)


@needs_gxx
def test_cpp_matches_numpy_oracle_transmission():
    scene, cam, cfg = presets.reference_demo()
    cfg = dataclasses.replace(cfg, width=24, height=24, samples=1,
                              max_depth=4)
    np.testing.assert_allclose(_cpp()(scene, cam, cfg),
                               oracle_render(scene, cam, cfg), atol=1e-11)


@needs_gxx
def test_cpp_prune_flag_respected():
    scene, cam, cfg = presets.three_spheres_ground(size=24)
    a = _cpp()(scene, cam, dataclasses.replace(cfg, prune=True))
    b = _cpp()(scene, cam, dataclasses.replace(cfg, prune=False))
    np.testing.assert_allclose(a, b, atol=1e-12)


@needs_gxx
def test_kernel_path_vs_cpp_oracle_128():
    """tests/test_cpp_oracle.py's 128^2 sweep, on the port's main path
    (the chain kernel's plain version here): at most 0.2 % of pixels
    beyond 2e-3."""
    scene, cam, cfg = presets.full_reflective(size=128)
    a = render_image_kernel(scene, cam, cfg, device=CPU).numpy()
    d = np.abs(a - _cpp()(scene, cam, cfg)).max(-1)
    assert (d > 2e-3).mean() < 0.002


@needs_gxx
def test_cpp_oracle_builds_under_the_ports_build_dir():
    from ray_tracer_fragment_shader_tpu_torch.oracle import native
    path = native.build_library()
    port = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(path) == os.path.join(port, "_build")
    assert os.path.exists(path) and sys.platform != "win32"
