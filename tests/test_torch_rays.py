"""The port's camera and primary rays (ray_tracer_fragment_shader_tpu_torch
.ops.rays) against the JAX package's, at 48x24."""
import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.ops import rays as jrays
from ray_tracer_fragment_shader_tpu_torch.config import CameraConfig
from ray_tracer_fragment_shader_tpu_torch.ops import rays as trays

W, H = 48, 24
ATOL = 1e-5
CAMERAS = {
    "reference": CameraConfig(),
    "bench_frame": CameraConfig(pixel_scale=512.0 / W),
    "offset": CameraConfig(eye=(30.0, 80.0, 150.0), look_at=(10.0, 5.0, -150.0),
                           bottom_x=-20.0, bottom_y=-10.0, pixel_scale=1.5),
}


def cams(cfg):
    return (jrays.Camera.from_config(cfg, W, H),
            trays.Camera.from_config(cfg, W, H))


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_basis_matches_jax(name):
    j, t = cams(CAMERAS[name])
    for a, b in zip(j.basis(), t.basis()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_screen_points_and_primary_rays_match_jax(name):
    j, t = cams(CAMERAS[name])
    jp = jrays.screen_points(j, W, H)
    tp = trays.screen_points(t, W, H)
    assert tuple(tp.shape) == (W * H, 3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    jit = np.random.RandomState(0).normal(size=(W * H, 3)).astype(np.float32)
    jo, jv = jrays.primary_rays(j, jp, jitter=jit)
    to, tv = trays.primary_rays(t, tp, jitter=torch.from_numpy(jit))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_screen_points_subset():
    j, t = cams(CAMERAS["bench_frame"])
    rng = np.random.RandomState(1)
    ii, jj = rng.randint(0, W, 17), rng.randint(0, H, 17)
    full = trays.screen_points(t, W, H)
    sub = trays.screen_points(t, W, H, ij=(torch.from_numpy(ii),
                                           torch.from_numpy(jj)))
    np.testing.assert_allclose(sub.numpy(), full.numpy()[jj * W + ii],
                               atol=ATOL)
    np.testing.assert_allclose(
        sub.numpy(), np.asarray(jrays.screen_points(j, W, H, ij=(ii, jj))),
        atol=ATOL)


def test_sample_jitter_length_and_determinism():
    g = torch.Generator().manual_seed(3)
    a = trays.sample_jitter(g, 1000, 0.5)
    assert tuple(a.shape) == (1000, 3) and a.dtype == torch.float32
    np.testing.assert_allclose(a.norm(dim=-1).numpy(), 0.5, atol=1e-6)
    b = trays.sample_jitter(torch.Generator().manual_seed(3), 1000, 0.5)
    assert torch.equal(a, b)
    # directions spread over the sphere: the mean is near 0
    assert a.mean(0).abs().max() < 0.05


JMATH = ["safe_sqrt", "safe_div", "dot3", "norm3", "safe_normalize", "cross3"]


@pytest.mark.parametrize("name", JMATH)
def test_jmath_matches_jax(name):
    """The guarded helpers on inputs with zeros and negatives (the masked
    lanes they exist for)."""
    from ray_tracer_fragment_shader_tpu.utils import jmath as jm
    from ray_tracer_fragment_shader_tpu_torch.utils import jmath as tm
    rng = np.random.RandomState(2)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    a[:8] = 0.0
    b[8:16, 0] = 0.0
    args = {"safe_sqrt": (a[:, 0],), "safe_div": (a[:, 1], b[:, 0]),
            "dot3": (a, b), "norm3": (a,), "safe_normalize": (a,),
            "cross3": (a, b)}[name]
    want = np.asarray(getattr(jm, name)(*args))
    got = getattr(tm, name)(*(torch.from_numpy(x) for x in args)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
