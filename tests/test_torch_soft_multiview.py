"""The port's soft-silhouette and multi-view fits
(ray_tracer_fragment_shader_tpu_torch: diff.soft, diff.multiview, the CLI's
``fit --views > 1``) against the JAX package's, on the CPU.

Scenes and parameters cross as numpy arrays; the targets are the port's
core renders (test_torch_core.py holds those against the JAX core), given
to both sides.  The JAX gradients run in ONE subprocess for the module
(fixture ``ref``; ``tests/torch_soft_ref.py`` run as a script,
``tests/torch_jax_ref.py``: no fused multiply-add in XLA's compiled
programs, which round apart from the port's per-operation rounding).  ``multiview_loss`` runs on two views
in soft mode and on one in hard mode, where the geometry is held.  The
numpy-only pieces (``orbit_views``, ``downsample``, ``_jitter_params``'
draws, ``recovery_report``) run here.

Tolerances: images within 1e-5 of max|JAX|; losses within 1e-5 relative;
each gradient table within 5e-4 of max|JAX| (float32 reassociation, as
test_torch_core.py); ``downsample`` and the jittered parameters exact.
"""
import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_ref
import torch_soft_ref as R
from torch_jax_ref import port_configs, port_scene
from torch_soft_ref import FIELDS, SIGMA, SIZE
from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.diff import multiview as JM
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams as JFitParams
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets
from ray_tracer_fragment_shader_tpu_torch import cli as tcli
from ray_tracer_fragment_shader_tpu_torch.core.renderer import render_image
from ray_tracer_fragment_shader_tpu_torch.diff import multiview as TM
from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu_torch.diff.soft import (fit_soft,
                                                            render_soft,
                                                            soft_l2_loss)
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets

CPU = "cpu"


def problem():
    """``torch_soft_ref.problem()`` on the port's side: (scene,
    CameraConfig, RenderConfig, views, the moved parameters as numpy)."""
    js, cam, cfg, views, p = R.problem()
    return (port_scene(js), *port_configs(cam, cfg),
            list(port_configs(*views)), p)


def port_params(p) -> FitParams:
    return FitParams(*(p[f] for f in FIELDS))


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """The module's JAX subprocess, started as the module starts, and the
    targets it was given: the port's core renders of the single view
    (``one``) and of the views (``many``).  The recovery checks, which
    need no JAX, come first in the module and run beside it."""
    scene, cam, cfg, views, _ = problem()
    with torch.no_grad():
        inputs = dict(one=render_image(scene, cam, cfg, device=CPU).numpy(),
                      many=TM.render_views(scene, views, cfg,
                                           device=CPU).numpy())
    out = tmp_path_factory.mktemp("jax_soft") / "ref.npz"
    pending = torch_jax_ref.start(R.__file__, out, inputs)
    yield pending, inputs
    pending.cancel()


@pytest.fixture(scope="module")
def ref(jax_side):
    """``torch_soft_ref.jax_reference``'s arrays and the targets."""
    pending, inputs = jax_side
    return {**pending.result(), **inputs}


def rel_max(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.abs(want - got).max() / max(np.abs(want).max(), 1e-12)


def assert_grads(ref, name, params):
    for f in FIELDS:
        want, got = ref[f"{name}/grad/{f}"], getattr(params, f).grad
        got = np.zeros_like(want) if got is None else got.numpy()
        assert np.isfinite(got).all(), f
        assert rel_max(want, got) <= 5e-4, (name, f, rel_max(want, got))


# ----------------------------------------------------------- recovery
# The JAX package's tests/test_multiview.py recovery checks, at their
# sizes, seeds and thresholds, on the port's recipe.

def test_fit_multiview_recovers_geometry():
    """Two orbit views of fit_target at 96^2, the centres moved by up to 6
    units (RandomState(1)): the soft pyramid with two restarts brings the
    worst centre within 0.3 of its start and lowers the hard loss."""
    size = 96
    scene, camcfg, cfg = tpresets.fit_target(size=size)
    views = TM.orbit_views(camcfg, 2, span_deg=80.0)
    with torch.no_grad():
        targets = TM.render_views(scene, views, cfg, device=CPU)
    cams = [Camera.from_config(v, size, size) for v in views]
    rng = np.random.RandomState(1)
    nv = int(scene.sph_valid.sum())
    dc = np.zeros((scene.num_spheres, 3), np.float32)
    dc[:nv] = rng.uniform(-6, 6, (nv, 3))
    dr = (1 + rng.uniform(-0.08, 0.08, scene.num_spheres)).astype(np.float32)
    init = FitParams.from_scene(scene)
    with torch.no_grad():
        init.sph_center += torch.from_numpy(dc)
        init.sph_radius *= torch.from_numpy(dr)
    err0 = TM.recovery_report(init, scene)
    res = TM.fit_multiview(scene, views, cfg, targets, init=init,
                           sizes=(48,), sigmas=(1.5, 1.0),
                           steps_per_sigma=40, restarts=2, restart_steps=10,
                           restart_jitter=(4.0, 0.05, 0.0), geom_lr=0.4,
                           light_lr=0.0, seed=0, device=CPU)
    err1 = TM.recovery_report(res.params, scene)
    assert np.isfinite(res.history).all()
    with torch.no_grad():
        l_init, l_fit = (float(TM.multiview_loss(q, scene, cams, cfg,
                                                 targets, None, device=CPU))
                         for q in (init, res.params))
    assert l_fit < l_init
    # JAX measured 6.89 -> 0.91 world units (one board square = 40)
    print("centre error", err0["center_err_max"], "->",
          err1["center_err_max"])
    assert err1["center_err_max"] < 0.3 * err0["center_err_max"]
    assert len(res.restart_losses) == 2


def test_light_polish_descends_light_error():
    """Geometry at the truth, the light moved by (8, -6, 5): the light-only
    polish (60 hard-render steps at 48^2, two views) lowers the light's
    error."""
    size = 48
    scene, camcfg, cfg = tpresets.fit_target(size=size)
    views = TM.orbit_views(camcfg, 2, span_deg=80.0)
    with torch.no_grad():
        targets = TM.render_views(scene, views, cfg, device=CPU)
    init = FitParams.from_scene(scene)
    with torch.no_grad():
        init.light_pos += torch.tensor([[8.0, -6.0, 5.0]])
    err0 = TM.recovery_report(init, scene)
    assert err0["light_err_max"] > 10.0
    res = TM.fit_multiview(scene, views, cfg, targets, init=init,
                           sizes=(48,), sigmas=(None,), steps_per_sigma=1,
                           restarts=1, restart_steps=1, geom_lr=0.0,
                           light_lr=1.0, light_polish_steps=60, seed=0,
                           device=CPU)
    err1 = TM.recovery_report(res.params, scene)
    assert res.stage_log[-1]["stage"] == "light_polish"
    print("light error", err0["light_err_max"], "->", err1["light_err_max"])
    assert err1["light_err_max"] < err0["light_err_max"]


# --------------------------------------------------------------- soft

def test_render_soft_and_soft_l2_loss_match_jax(ref):
    scene, cam, cfg, _, p = problem()
    params = port_params(p)
    before = dict(K.LAUNCHES)
    img = render_soft(params.into_scene(scene), cam, cfg, sigma=SIGMA,
                      device=CPU)
    assert rel_max(ref["soft_image"], img.detach().numpy()) <= 1e-5
    loss = soft_l2_loss(params, scene, cam, cfg, ref["one"], sigma=SIGMA,
                        device=CPU)
    loss.backward()
    assert K.LAUNCHES == before  # the core renderer launches no kernel
    assert loss.item() == pytest.approx(float(ref["soft/loss"]), rel=1e-5)
    assert_grads(ref, "soft", params)
    # the occupancy term: the sphere centres move the silhouette
    assert np.abs(ref["soft/grad/sph_center"]).max() > 1e-6


def test_soft_converges_to_hard_as_sigma_shrinks():
    scene, cam, cfg, _, _ = problem()
    hard = render_image(scene, cam, cfg, device=CPU)
    d = [(render_soft(scene, cam, cfg, sigma=s, device=CPU) - hard)
         .abs().mean().item() for s in (8.0, 0.25)]
    assert d[1] < d[0] and d[1] < 5e-3


def test_fit_soft_descends():
    scene, cam, cfg, _, p = problem()
    one = render_image(scene, cam, cfg, device=CPU)
    params, history = fit_soft(scene, cam, cfg, one,
                               params=port_params(p), steps=8,
                               sigmas=(2.0, 1.0), geom_lr=0.3,
                               light_lr=0.5, device=CPU)
    assert np.isfinite(history).all() and len(history) == 8
    assert min(history[-3:]) < history[0]


# ---------------------------------------------------------- multi-view

def test_orbit_views_match_jax():
    _, cam, _, _, _ = problem()
    jcam = jpresets.fit_target(size=SIZE)[1]
    for n, span in ((1, 90.0), (2, 80.0), (3, 80.0), (5, 120.0)):
        got = TM.orbit_views(cam, n, span_deg=span)
        want = JM.orbit_views(jcam, n, span_deg=span)
        assert [dataclasses.asdict(v) for v in got] == \
            [dataclasses.asdict(v) for v in want]
    assert got[0].eye == cam.eye  # the base view first when n is odd


def test_downsample_is_exact_and_matches_the_coarse_render():
    """Decimation equals JAX's on any array, and the decimated full-size
    render equals the coarse render at the stage's pixel scale: the
    property that makes the pyramid's coarse losses zero at the truth."""
    rng = np.random.RandomState(0)
    img = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    for size in (8, 4, 2):
        np.testing.assert_array_equal(
            TM.downsample(torch.from_numpy(img), size).numpy(),
            np.asarray(JM.downsample(jnp.asarray(img), size)))
    with pytest.raises(ValueError):
        TM.downsample(torch.from_numpy(img), 3)
    scene, cam, cfg, views, _ = problem()
    with torch.no_grad():
        full = TM.render_views(scene, views, cfg, device=CPU)
        coarse = TM.render_views(scene, TM._stage_views(views, SIZE, 16),
                                 TM._stage_config(cfg, 16), device=CPU)
    torch.testing.assert_close(TM.downsample(full, 16), coarse, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("mode", ["mv_soft", "mv_hard"])
def test_multiview_loss_and_gradients_match_jax(ref, mode):
    scene, cam, cfg, views, p = problem()
    params = port_params(p)
    cams = [Camera.from_config(v, SIZE, SIZE) for v in views]
    tgts = torch.from_numpy(ref["many"])
    sigma = 1.5 * cam.pixel_scale if mode == "mv_soft" else None
    if sigma is None:
        cams, tgts = cams[:1], tgts[:1]
    loss = TM.multiview_loss(params, scene, cams, cfg, tgts, sigma,
                             device=CPU)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref[f"{mode}/loss"]),
                                        rel=1e-5)
    assert_grads(ref, mode, params)
    if mode == "mv_hard":  # hard mode holds the geometry
        assert params.sph_center.grad is None
        assert np.abs(ref["mv_hard/grad/light_pos"]).max() > 0


def test_jitter_params_draw_what_jax_draws():
    scene, _, _, _, p = problem()
    got = TM._jitter_params(port_params(p), np.random.RandomState(4),
                            15.0, 0.1, 20.0)
    jp = JFitParams(**{f: jnp.asarray(p[f]) for f in FIELDS})
    want = JM._jitter_params(jp, np.random.RandomState(4), 15.0, 0.1, 20.0)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).detach().numpy(),
                                      np.asarray(getattr(want, f)))


def test_recovery_report_zero_at_truth_and_as_jax_elsewhere():
    scene, _, _, _, p = problem()
    rep = TM.recovery_report(FitParams.from_scene(scene), scene)
    assert rep["center_err_max"] == 0.0 and rep["light_err_max"] == 0.0
    js = jpresets.fit_target(size=SIZE)[0]
    jp = JFitParams(**{f: jnp.asarray(p[f]) for f in FIELDS})
    want = JM.recovery_report(jp, js)
    got = TM.recovery_report(port_params(p), scene)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_fit_multiview_descends_and_gates_its_stages():
    """A tiny pyramid (one size, a soft and a hard stage, the light
    polish) from the moved parameters: every stage ends at or under its
    entry loss, the restarts race, the hard loss falls, and ``init`` is
    left as it was."""
    scene, cam, cfg, views, p = problem()
    cfg = TM._stage_config(cfg, 16)
    views = TM._stage_views(views, SIZE, 16)
    with torch.no_grad():
        tgts = TM.render_views(scene, views, cfg, device=CPU)
    init = port_params(p)
    before = {f: getattr(init, f).detach().clone() for f in FIELDS}
    res = TM.fit_multiview(scene, views, cfg, tgts, init=init, sizes=(),
                           sigmas=(1.5, None), steps_per_sigma=4,
                           restarts=2, restart_steps=2,
                           restart_jitter=(4.0, 0.05, 0.0), geom_lr=0.4,
                           light_lr=0.5, light_polish_steps=3, device=CPU)
    assert np.isfinite(res.history).all() and len(res.restart_losses) == 2
    assert [e.get("stage") for e in res.stage_log] == [None, None,
                                                       "light_polish"]
    for e in res.stage_log:
        assert e["loss"] <= e["loss_entry"] + 1e-12, e
    cams = [Camera.from_config(v, 16, 16) for v in views]
    hard = [float(TM.multiview_loss(q, scene, cams, cfg, tgts, None,
                                    device=CPU)) for q in (init, res.params)]
    assert hard[1] < hard[0]
    for f in FIELDS:
        assert torch.equal(getattr(init, f).detach(), before[f]), f


def test_cli_fit_views_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``fit --views 2`` through the port's CLI: the multi-view recipe on
    the core renderer (the single-view fit steps the kernels), its race
    and light polish cut short."""
    monkeypatch.setattr(TM, "fit_multiview", functools.partial(
        TM.fit_multiview, restarts=1, restart_steps=2, light_polish_steps=2))
    out = tmp_path / "mv"
    before = dict(K.LAUNCHES)
    params, history = tcli.main([
        "fit", "--cpu", "--views", "2", "--span", "80", "--size", "32",
        "--steps", "30", "--lr", "0.3", "--out-dir", str(out)])
    text = capsys.readouterr().out
    assert "recovery error" in text and "loss:" in text
    assert np.isfinite(history).all() and min(history) < history[0]
    rep = json.loads((out / "recovery.json").read_text())
    assert set(rep) >= {"center_err_max", "light_err_max"}
    for name in ("target.png", "fitted.png", "params.npz", "history.json"):
        assert (out / name).exists(), name
    assert K.LAUNCHES == before  # no kernel wrapper counts on the CPU
    assert isinstance(params, FitParams)


