"""The port's roofline model (ray_tracer_fragment_shader_tpu_torch/utils/
roofline.py, utils/opcount.py) against the JAX package's.

The schedules are the JAX code's, copied: they must come out equal.  The
plain version of K9 (``mix_chain_ref``) is held against the JAX
``_mix_kernel`` in Pallas interpret mode (``fast=False``: an exact
reciprocal, as the plain version) at two 8x256 tiles, two chains, 2 and 8
iterations, on inputs from numpy's default_rng(0), to 1e-6 of max (float32
rounding of the same operations in the same order; a scratch run agreed to
1.1e-7).  Each JAX kernel runs once, in a module-scoped fixture.  The
per-class counts must add up to the operation counts the data-sheet bound
uses, on three scenes at 32^2.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.utils import roofline as JR
from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
from ray_tracer_fragment_shader_tpu_torch.scene import presets
from ray_tracer_fragment_shader_tpu_torch.utils import opcount
from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL

# tests/test_roofline.py::RENDER_LIKE: every class _emit knows
RENDER_LIKE = dict(basic=8000.0, select=2000.0, cmp=1200.0, abs=150.0,
                   rsqrt=300.0, sqrt=60.0, recip_nr=220.0, floor=40.0,
                   sign=30.0, div=20.0)
BLENDS = [RENDER_LIKE, {"basic": 1.0}, {"sign": 5.0, "floor": 5.0}]
TOL = 1e-6


@pytest.mark.parametrize("counts", BLENDS, ids=["render_like", "basic",
                                                "sign_floor_debt"])
def test_schedules_equal_jax(counts):
    assert RL.mix_schedule(counts) == JR.mix_schedule(counts)
    sched = RL.mix_schedule(counts)
    assert RL._rewrite_schedule(sched) == JR._rewrite_schedule(sched)
    assert RL._MIX_CLASSES == JR._MIX_CLASSES
    assert RL._EXTRA_BASIC == JR._EXTRA_BASIC


def _x(tiles):
    rng = np.random.default_rng(0)
    return (0.5 + 0.2 * rng.random((8 * tiles, 256))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mix():
    """The JAX _mix_kernel (interpret mode, fast=False) at two tiles, two
    chains, on RENDER_LIKE's schedule, for 2 and 8 iterations."""
    sched, _ = JR._rewrite_schedule(JR.mix_schedule(RENDER_LIKE))
    x = jnp.asarray(_x(2))
    tile = pl.BlockSpec((8, 256), lambda i: (i, 0))
    out = {}
    for iters in (2, 8):
        kern = functools.partial(JR._mix_kernel, iters=iters, nc=2,
                                 sched=sched, fast=False)
        out[iters] = np.asarray(pl.pallas_call(
            kern, grid=(2,), in_specs=[tile], out_specs=tile,
            interpret=True,
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(x))
    return sched, out


@pytest.mark.parametrize("iters", [2, 8])
def test_mix_chain_ref_matches_jax_mix_kernel(jax_mix, iters):
    sched, out = jax_mix
    got = RL.mix_chain_ref(torch.from_numpy(_x(2)), iters=iters, nc=2,
                           sched=sched).numpy()
    ref = out[iters]
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    # the chains settle at normal numbers (no denormals, no zeros into div)
    assert 4.0 < got.min() and got.max() < 4.5


def test_folded_ops_count_dead_compares_and_idempotent_repeats():
    # the first cmp is overwritten before a select reads it; the last cmp
    # feeds the tail select; a select right after a select and an abs
    # right after an abs change nothing
    sched = ("cmp", "basic", "cmp", "select", "select", "cmp", "abs",
             "abs", "basic")
    assert RL.folded_ops(sched) == 3
    assert RL.budget_per_step(sched, 2) == 256 + 1 + 2 - 3
    assert RL.folded_ops(("select", "cmp", "cmp")) == 1


def test_unit_classes_add_up_to_each_unit_count():
    for unit, classes in opcount.CLASSES.items():
        counted = sum(classes.get(k, 0) for k in opcount.COUNTED)
        assert counted == getattr(opcount, unit), unit
        assert set(classes) <= set(RL._MIX_CLASSES), unit


def _inputs(preset):
    scene, cam, cfg = preset
    camera = Camera.from_config(cam, cfg.width, cfg.height)
    target = K.render_image_kernel(scene, camera, cfg, device="cpu")
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.5
    prep = AF.prepare_fit_inputs(camera, cfg, target, device="cpu")
    v, eye = prep["v"], prep["eye"]
    scene_c, t, kw, akw = AF.kernel_inputs(params.into_scene(scene), cfg,
                                           v.shape[0], device="cpu")
    return t, v, eye, kw, akw, prep, not scene_c.chain_exact


def _counted(work):
    return sum(work["classes"].get(k, 0.0) for k in opcount.COUNTED)


@pytest.mark.parametrize("name,make", [
    ("full_reflective", lambda: presets.full_reflective(size=32, depth=3)),
    ("fractional_glass", lambda: presets.fractional_glass(size=32, depth=3)),
    ("glass_chain", lambda: presets.glass_chain(size=32, depth=3)),
])
def test_class_counts_sum_to_the_operation_counts(name, make):
    t, v, eye, kw, akw, prep, tree = _inputs(make())
    works = [opcount.forward_work(t, v, eye, tree=tree, **kw),
             opcount.fused_work(t, v, eye, tree=tree, target=prep["target"],
                                mask=prep["mask"], **kw)]
    if not tree:
        img, pk = K.render_packed(t, v, eye, pack=akw["pack"], **kw)
        works.append(opcount.adjoint_work(
            t, img, prep["target"], prep["mask"], pk, pack=akw["pack"],
            nl=akw["nl"], depth=akw["depth"], want_trans=akw["want_trans"]))
        img, res = K.render_residuals(t, v, eye, tree=False, **kw)
        g = (akw["g_scale"] * (img - prep["target"])).contiguous()
        works.append(opcount.fit_grads_work(
            t, g, res, nl=akw["nl"], depth=akw["depth"],
            want_trans=akw["want_trans"]))
    for w in works:
        assert w["ops"] > 0 and _counted(w) == w["ops"]
        # the classes the count leaves out are there too
        assert w["classes"]["cmp"] > 0 and w["classes"]["select"] > 0
    # K6's forward part is the forward's own count
    assert works[1]["classes_fwd"] == works[0]["classes"]


def test_sol_report_on_the_cpu_returns_finite_fields():
    scene, cam, cfg = presets.full_reflective(size=32, depth=1)
    camera = Camera.from_config(cam, cfg.width, cfg.height)
    target = K.render_image_kernel(scene, camera, cfg, device="cpu")
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.5
    w = opcount.step_work(params.into_scene(scene), camera, cfg, target,
                          device="cpu")
    assert w["kernels"] == ["render_packed", "adjoint_packed"]
    rep = RL.sol_report(w["fwd"], w["bwd"], 32 * 32, fwd_s=1e-3,
                        fwd_bwd_s=2e-3, device="cpu", iters=1, reps=1)
    for key in ("ops_per_pixel_fwd", "ops_per_pixel_bwd",
                "mix_rate_fwd_ops_per_s", "sol_fwd_s", "sol_fraction_fwd",
                "mix_rate_fwd_bwd_ops_per_s", "sol_fwd_bwd_s",
                "sol_fraction_fwd_bwd"):
        assert math.isfinite(rep[key]) and rep[key] > 0, key
    assert rep["counts_fwd"] == w["fwd"]
