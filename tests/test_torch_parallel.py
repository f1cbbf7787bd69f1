"""The port's multi-rank paths (ray_tracer_fragment_shader_tpu_torch:
parallel.mesh, parallel.shard, parallel.multihost, diff.fit's sharded
steps) and the fit-mode knob, on the CPU: the counterparts of
tests/test_parallel.py, tests/test_parallel_pallas.py and
tests/test_scaling.py, at their sizes and tolerances.

Four sources run at once as the module starts:

* a JAX subprocess with 8 virtual devices (``tests/torch_parallel_ref.py``
  through ``tests/torch_jax_ref.py``, without fused multiply-adds in XLA)
  computes the JAX package's sharded core render, its sharded core loss
  at 27x35 and its index helpers;
* a second one runs one step of JAX's Pallas band step
  (``make_sharded_fit_step_pallas``, interpret mode) over 3 devices at
  16x13 on the port's target and parameters, and returns its loss and
  gradients (the 8-device cases of tests/test_parallel_pallas.py are not
  run: interpret mode over 8 devices);
* ONE 2-process gloo group (``tests/torch_parallel_worker.py``) runs
  everything collective: ``initialize_multihost``, the ``all_gather``
  renders, both sharded steps against the single-process values, their
  descent, ``sharded_value_and_grad``, the checkpoint pair,
  ``scaling_sweep([1, 2])`` and ``dryrun_multichip(2)``; it prints one
  JSON line a check, which the ``test_gloo_*`` tests read.
* Beside them, in this process, every rank of a world runs one after
  another (each rank's share is a function of ``(rank, world)`` with no
  collective) and the shares are summed in rank order.

Tolerances: renders within 1e-5 absolute (the bands bit for bit), the
core loss within 1e-6 relative, the kernel band step's loss within 1e-5
relative and one Adam step's parameters within rtol 2e-4, atol 2e-6
(tests/test_parallel_pallas.py), the bands' tables within 1e-5 of
max|table| of the unsharded ones; against JAX's band step, whose forward
is its own, the loss within 1e-4 relative and the tables within 1e-4 of
max|table|.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_jax_ref
import torch_parallel_ref as R
from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch.core.renderer import render_image
from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
    FitParams, band_fit_inputs, band_loss_grads, band_twophase, l2_loss,
    make_fit_step_kernel, shard_loss_grads)
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                           sample_jitter,
                                                           screen_points)
from ray_tracer_fragment_shader_tpu_torch.parallel import mesh as M
from ray_tracer_fragment_shader_tpu_torch.parallel import multihost as MH
from ray_tracer_fragment_shader_tpu_torch.parallel import shard as S
from ray_tracer_fragment_shader_tpu_torch.scene import (Material,
                                                        SceneBuilder)
from ray_tracer_fragment_shader_tpu_torch.scene import presets

CPU = "cpu"
SIZE = 32
WORLD = 2   # ranks of the gloo group
FIELDS = FitParams.FIELDS
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")


# ------------------------------------------------------------ the sources

@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """The module's JAX subprocess, started as the module starts."""
    pending = torch_jax_ref.start(
        R.__file__, tmp_path_factory.mktemp("jax_parallel") / "ref.npz")
    yield pending
    pending.cancel()


@pytest.fixture(scope="module")
def ref(jax_side):
    return jax_side.result()


def band_step_case():
    """``tests/torch_parallel_ref.py::band_step``'s inputs: fit_target's
    16^2 camera over ``R.BAND_STEP_SHAPE`` and its perturbed parameters
    (tests/test_parallel_pallas.py:50)."""
    scene, camcfg, cfg = presets.fit_target(size=16)
    w, h = R.BAND_STEP_SHAPE
    cfg = dataclasses.replace(cfg, width=w, height=h)
    cam = camera_of(camcfg, cfg)
    target = K.render_image_kernel(scene, cam, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 2.0
        params.sph_radius *= 1.1
    return scene, cam, cfg, target, params


@pytest.fixture(scope="module", autouse=True)
def jax_band_step_side(tmp_path_factory):
    """The JAX subprocess of the Pallas band step, started as the module
    starts, beside the other."""
    *_, target, params = band_step_case()
    inputs = {f: getattr(params, f).detach().numpy() for f in R.FIT_FIELDS}
    pending = torch_jax_ref.start(
        R.__file__, tmp_path_factory.mktemp("jax_band_step") / "ref.npz",
        inputs=dict(inputs, target=target.numpy()))
    yield pending
    pending.cancel()


class Gloo:
    """The 2-process gloo group, started at once; ``lines()`` waits for
    it and returns each rank's JSON lines by check name."""

    def __init__(self, out_dir):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=torch_jax_ref.REPO)
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(WORLD), str(port),
             str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=torch_jax_ref.REPO)
            for r in range(WORLD)]
        self.by_check = None

    def lines(self):
        if self.by_check is None:
            outs = [p.communicate(timeout=300)[0] for p in self.procs]
            for p, out in zip(self.procs, outs):
                assert p.returncode == 0, out[-4000:]
            self.by_check = {}
            for out in outs:
                for ln in out.splitlines():
                    if ln.startswith("{"):
                        rec = json.loads(ln)
                        self.by_check.setdefault(rec["check"], []).append(
                            rec)
        return self.by_check

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def gloo_group(tmp_path_factory):
    group = Gloo(tmp_path_factory.mktemp("gloo"))
    yield group
    group.close()


@pytest.fixture(scope="module")
def gloo(gloo_group):
    return gloo_group.lines()


def each_rank(gloo, check, n=1):
    """The records of ``check``: ``n`` a rank from every rank."""
    recs = gloo[check]
    assert sorted(r["rank"] for r in recs) == sorted(
        list(range(WORLD)) * n), recs
    return recs


# ----------------------------------------------------------------- inputs

def camera_of(camcfg, cfg):
    return Camera.from_config(camcfg, cfg.width, cfg.height)


def tree_scene():
    """tests/test_parallel_pallas.py:103-141's fractional glass scene."""
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder().add_checkerboard()
             .add_sphere("d5", material=glass).add_sphere("c3")
             .add_light("b6").build())
    assert not scene.chain_exact
    cfg = dataclasses.replace(presets.fit_target(size=SIZE)[2], max_depth=2)
    return scene, presets._cam(SIZE), cfg


def band_sums(params, scene, cam, cfg, target, world, twophase):
    """Every rank's ``band_loss_grads`` of a world, summed in rank order,
    and each rank's buffer."""
    bufs = [band_loss_grads(params, scene, cam,
                            band_fit_inputs(cam, cfg, target, r, world,
                                            device=CPU),
                            twophase=twophase, device=CPU)
            for r in range(world)]
    total = bufs[0].clone()
    for b in bufs[1:]:
        total += b
    return total, bufs


def as_grads(params, flat):
    return S.unflatten_grads(flat, {f: getattr(params, f) for f in FIELDS})


def test_band_points_are_the_frame_rows_bit_for_bit():
    """A world of 3 at 1024 rows (342-row bands, 2 padding rows): each
    band's screen points equal the whole frame's rows, to the bit."""
    scene, camcfg, cfg = presets.full_reflective(size=1024, depth=3)
    cam = camera_of(camcfg, cfg)
    full = screen_points(cam, cfg.width, cfg.height)
    h_pad, hs = S.band_split(cfg.height, 3)
    assert (h_pad, hs) == (1026, 342)
    bands = torch.cat([S.band_points(cam, cfg.width, hs, r)
                       for r in range(3)])
    assert bands.shape[0] == h_pad * cfg.width
    assert torch.equal(bands[:full.shape[0]], full)


# ------------------------------------------------ every rank, one process

@pytest.mark.parametrize("world", [3, 8])
def test_band_render_equals_the_full_frame(world):
    """The kernel back end's row bands (the plain version on the CPU),
    concatenated and cut, equal the full frame's render bit for bit: each
    pixel is the same ray."""
    scene, camcfg, cfg = presets.full_reflective(size=SIZE, depth=2)
    cfg = dataclasses.replace(cfg, height=20)
    cam = camera_of(camcfg, cfg)
    bands = [S.render_band(scene, cam, cfg, r, world, device=CPU)
             for r in range(world)]
    _, hs = S.band_split(cfg.height, world)
    assert all(b.shape == (hs, cfg.width, 3) for b in bands)
    full = K.render_image_kernel(scene, cam, cfg, device=CPU)
    assert torch.equal(torch.cat(bands)[:cfg.height], full)


def _band_case(kind):
    if kind == "tree":
        scene, camcfg, cfg = tree_scene()
        dc, radius, lr = 1.0, 1.0, 0.05
    else:
        scene, camcfg, cfg = presets.fit_target(size=SIZE)
        dc, radius, lr = 2.0, 1.1, 0.1
    cam = camera_of(camcfg, cfg)
    target = K.render_image_kernel(scene, cam, cfg, device=CPU)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += dc
        params.sph_radius *= radius
    return scene, cam, cfg, target, params, lr


@pytest.mark.parametrize("world", [3, 8])
@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_band_step_matches_unsharded(kind, world):
    """tests/test_parallel_pallas.py:45-76 and :103-141: the ranks' band
    buffers (K3+K4 on the chain, K6's tree form on the tree; plain
    versions here), summed in rank order, against ``fit_value_and_grad``
    on the whole frame: the loss within 1e-5 relative, each table within
    1e-5 of max|table| (every band scales its cotangent by the whole
    image's H*W*3), and one Adam step's parameters within rtol 2e-4,
    atol 2e-6."""
    scene, cam, cfg, target, params, lr = _band_case(kind)
    mode = "twophase" if kind == "chain" else "fused"
    loss_s, grads_s = AF.fit_value_and_grad(params, scene, cam, cfg, target,
                                            mode=mode, device=CPU)
    total, bufs = band_sums(params, scene, cam, cfg, target, world,
                            twophase=kind == "chain")
    sq, grads = as_grads(params, total)
    loss = sq / float(cfg.width * cfg.height * 3)
    assert float(loss) == pytest.approx(float(loss_s), rel=1e-5)
    for f in FIELDS:
        scale = float(grads_s[f].abs().max())
        assert float((grads[f] - grads_s[f].reshape(grads[f].shape))
                     .abs().max()) <= 1e-5 * max(scale, 1e-12), f
    # the padding rows add nothing: each band's buffer is its own rows'
    assert all(bool(torch.isfinite(b).all()) for b in bufs)

    def adam_step(g):
        p = FitParams.from_scene(scene)
        p.load_state_dict(params.state_dict())
        opt = torch.optim.Adam(p.parameters(), lr=lr)
        for f in FIELDS:
            getattr(p, f).grad = g[f].reshape(getattr(p, f).shape).clone()
        opt.step()
        return p
    p_s, p_m = adam_step(grads_s), adam_step(grads)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(p_m, f).detach().numpy(),
                                   getattr(p_s, f).detach().numpy(),
                                   rtol=2e-4, atol=2e-6)


def test_band_step_matches_jax_sharded_pallas_step(jax_band_step_side):
    """The ranks' band buffers of a world of 3 (K3+K4's plain versions;
    5-row bands, 2 masked padding rows), summed in rank order, against
    JAX's ``make_sharded_fit_step_pallas`` over 3 devices on the same
    target and parameters: the loss within 1e-4 relative, each table within
    1e-4 of max|table|.  Not the 1e-5 of tests/test_parallel_pallas.py,
    which holds one forward against itself: here two float32 forwards meet,
    whose pixels differ by up to 5e-5 (JAX's own Pallas and core renders
    of fit_target at 16^2 do too), and the loss and tables came 1.1e-5 and
    4e-5 apart."""
    scene, cam, cfg, target, params = band_step_case()
    total, _ = band_sums(params, scene, cam, cfg, target,
                         R.BAND_STEP_WORLD, twophase=True)
    sq, grads = as_grads(params, total)
    loss = sq / float(cfg.width * cfg.height * 3)
    ref = jax_band_step_side.result()
    assert float(loss) == pytest.approx(float(ref["loss"]), rel=1e-4)
    for f in FIELDS:
        scale = float(np.abs(ref[f]).max())
        assert scale > 0, f
        diff = np.abs(grads[f].numpy().reshape(ref[f].shape) - ref[f]).max()
        assert diff <= 1e-4 * scale, (f, diff, scale)


def test_band_cotangent_takes_the_global_denominator():
    """A band's tables scale by 2/denom: with the band's own default
    denominator (its H_band*W*3) a world of 4's tables would each come
    out 4x the global share; with ``denom`` the image's they sum to the
    unsharded tables."""
    scene, cam, cfg, target, params, _ = _band_case("chain")
    band = band_fit_inputs(cam, cfg, target, 1, 4, device=CPU)
    kw = dict(mask=band["mask"], pts=band["pts"], device=CPU)
    sq_g, g_global = AF.twophase_loss_grads_kernel(
        params.into_scene(scene), cam, band["config"], band["target"],
        denom=band["denom"], **kw)
    sq_b, g_band = AF.twophase_loss_grads_kernel(
        params.into_scene(scene), cam, band["config"], band["target"], **kw)
    assert float(sq_g) == float(sq_b)
    for f in g_global:
        torch.testing.assert_close(g_band[f], 4.0 * g_global[f],
                                   rtol=1e-6, atol=0.0)


# --------------------------------------------------------- the fit-mode knob

KNOB_KERNELS = ("render_packed", "adjoint_packed", "fused_adjoint",
                "render_chain_residuals", "fit_grads")


@pytest.fixture
def counted(monkeypatch):
    """Counts each fit wrapper the CPU run reaches in ``render.LAUNCHES``,
    as its launch would on the card (on the CPU the plain versions run and
    count nothing)."""
    def wrap(module, name, key):
        fn = getattr(module, name)

        def counting(*a, **kw):
            K.LAUNCHES[key(kw) if callable(key) else key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, counting)
    wrap(AF, "render_packed", "render_packed")
    wrap(AF, "adjoint_packed", "adjoint_packed")
    wrap(AF, "fused_adjoint", "fused_adjoint")
    wrap(AF, "fit_grads", "fit_grads")
    wrap(K, "render_residuals", lambda kw: "render_tree_residuals"
         if kw["tree"] else "render_chain_residuals")
    K.reset_launch_counts()
    yield
    K.reset_launch_counts()


def _knob_case():
    scene, camcfg, cfg = presets.fit_target(size=8)
    cam = camera_of(camcfg, cfg)
    target = torch.zeros(8, 8, 3)
    return scene, cam, cfg, target, FitParams.from_scene(scene)


@pytest.mark.parametrize("env,kwargs,want", [
    (None, {}, ("render_packed", "adjoint_packed")),
    ("twophase", {}, ("render_packed", "adjoint_packed")),
    ("fused", {}, ("fused_adjoint",)),
    ("split", {}, ("render_chain_residuals", "fit_grads")),
    (None, dict(single_kernel=False), ("render_chain_residuals",
                                       "fit_grads")),
    ("fused", dict(mode="twophase"), ("render_packed", "adjoint_packed")),
], ids=["unset", "twophase", "fused", "split", "single_kernel_false",
        "explicit_mode_wins"])
def test_fit_mode_knob_selects_the_kernels(counted, monkeypatch, env, kwargs,
                                           want):
    """``fit_value_and_grad(mode=None)`` reads ``RTFS_FIT_MODE`` (default
    twophase) and ``single_kernel=False`` means split, as JAX's
    adjoint_fused.py:1651-1653; the launches show which kernels ran."""
    if env is None:
        monkeypatch.delenv("RTFS_FIT_MODE", raising=False)
    else:
        monkeypatch.setenv("RTFS_FIT_MODE", env)
    scene, cam, cfg, target, params = _knob_case()
    loss, _ = AF.fit_value_and_grad(params, scene, cam, cfg, target,
                                    device=CPU, **kwargs)
    assert bool(torch.isfinite(loss))
    ran = {k for k in KNOB_KERNELS if K.LAUNCHES[k]}
    assert ran == set(want), ran
    assert all(K.LAUNCHES[k] == 1 for k in want)


def test_fit_mode_knob_rejects_unknown_values(monkeypatch):
    monkeypatch.setenv("RTFS_FIT_MODE", "bogus")
    scene, cam, cfg, target, params = _knob_case()
    with pytest.raises(ValueError, match="unknown fit mode"):
        AF.fit_value_and_grad(params, scene, cam, cfg, target, device=CPU)


@pytest.mark.parametrize("env,want", [("split", None),
                                      ("fused", ("fused_adjoint",))])
def test_make_fit_step_kernel_under_the_knob(counted, monkeypatch, env,
                                             want):
    """The kernel step passes ``prep=``: under ``RTFS_FIT_MODE=split`` a
    chain scene's step raises, as JAX's ``make_fit_step_pallas``
    (ADVICE.md); under ``fused`` it runs K6."""
    monkeypatch.setenv("RTFS_FIT_MODE", env)
    scene, cam, cfg, target, params = _knob_case()
    step = make_fit_step_kernel(scene, cam, cfg, target,
                                torch.optim.Adam(params.parameters()),
                                device=CPU)
    if want is None:
        with pytest.raises(ValueError, match="prep= is only supported"):
            step(params)
        return
    step(params)
    assert {k for k in KNOB_KERNELS if K.LAUNCHES[k]} == set(want)


@pytest.mark.parametrize("env,twophase", [(None, True), ("fused", False),
                                          ("split", False)])
def test_band_step_reads_the_knob_as_jax(monkeypatch, env, twophase):
    """JAX diff/fit.py:216-219: K3+K4 only for a chain scene under
    twophase; every other value, split included, takes K6."""
    if env is None:
        monkeypatch.delenv("RTFS_FIT_MODE", raising=False)
    else:
        monkeypatch.setenv("RTFS_FIT_MODE", env)
    assert band_twophase(presets.fit_target(size=8)[0]) == twophase
    assert not band_twophase(tree_scene()[0])


def test_band_step_rejects_unknown_knob_values(monkeypatch):
    """The band step parses the knob as ``fit_value_and_grad`` does: an
    unknown value raises on a chain scene (a tree scene never reads it,
    as in JAX)."""
    monkeypatch.setenv("RTFS_FIT_MODE", "bogus")
    with pytest.raises(ValueError, match="unknown fit mode"):
        band_twophase(presets.fit_target(size=8)[0])
    assert not band_twophase(tree_scene()[0])


# ------------------------------------------------------ the new parameters

def test_render_image_kernel_takes_given_points_and_jitters_them():
    """``pts=`` stands in for the camera's points; a supersampled config
    jitters the given points, so the camera's own points with one jitter
    tensor give the full frame's supersampled image bit for bit."""
    scene, camcfg, cfg = presets.three_spheres_ground(size=16)
    cfg = dataclasses.replace(cfg, samples=2)
    cam = camera_of(camcfg, cfg)
    gen = torch.Generator().manual_seed(3)
    jit = torch.stack([sample_jitter(gen, 256, cfg.jitter_scale)
                       for _ in range(2)])
    pts = screen_points(cam, 16, 16)
    a = K.render_image_kernel(scene, cam, cfg, jitter=jit, pts=pts.clone(),
                              device=CPU)
    b = K.render_image_kernel(scene, cam, cfg, jitter=jit, device=CPU)
    assert torch.equal(a, b)
    moved = K.render_image_kernel(scene, cam, dataclasses.replace(
        cfg, samples=1), pts=pts + 5.0, device=CPU)
    assert not torch.equal(moved, K.render_image_kernel(
        scene, cam, dataclasses.replace(cfg, samples=1), device=CPU))
    with pytest.raises(ValueError, match="pts must be"):
        K.render_image_kernel(scene, cam, cfg, pts=pts[:10], device=CPU)


def test_prep_remembers_its_mask_and_points():
    scene, cam, cfg, target, params, _ = _band_case("chain")
    band = band_fit_inputs(cam, cfg, target, 0, 2, device=CPU)
    args = (params.into_scene(scene), cam, band["config"], band["target"])
    AF.twophase_loss_grads_kernel(*args, mask=band["mask"], pts=band["pts"],
                                  prep=band["prep"], device=CPU)
    with pytest.raises(ValueError, match="different `mask`"):
        AF.twophase_loss_grads_kernel(*args, mask=band["mask"].clone(),
                                      prep=band["prep"], device=CPU)
    with pytest.raises(ValueError, match="different `pts`"):
        AF.fused_loss_grads_kernel(*args, pts=band["pts"].clone(),
                                   prep=band["prep"], device=CPU)


# ------------------------------------------------ mesh and bring-up, here

def test_no_process_group_means_no_mesh():
    """Nothing falls back to one process: without a group ``make_mesh``
    raises; ``initialize_multihost`` with one process and no address is a
    no-op (as JAX's); NCCL without a card raises before any init."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    MH.initialize_multihost()
    MH.initialize_multihost(num_processes=1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        S.render_image_sharded(*presets.single_sphere(size=8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gloo"):
            MH.initialize_multihost("localhost:1", 2, 0)
    with pytest.raises(ValueError, match="equal shards"):
        M.shard_bounds(10, 0, 3)


# ------------------------------------------------------- the gloo group

def test_gloo_group_comes_up_through_initialize_multihost(gloo):
    recs = each_rank(gloo, "init")
    for r in recs:
        assert (r["world"], r["mesh_size"], r["backend"], r["device"]) == (
            WORLD, WORLD, "gloo", "cpu")
        assert r["mesh_rank"] == r["rank"]


def test_gloo_replicated_and_row_sharded(gloo):
    """``replicated`` broadcasts rank 0's tensor; ``row_sharded`` is each
    rank's leading-axis slice."""
    for r in each_rank(gloo, "replicated"):
        assert r["got"] == [7.0] * 3
        assert r["rows"] == [2 * r["rank"], 2 * r["rank"] + 1]


@pytest.mark.parametrize("check", ["render_kernel", "render_core"])
def test_gloo_all_gather_renders_match_single_process(gloo, check):
    """Row bands (24x21: a padding row) and flat shards (27x35: padding
    pixels), gathered on every rank, against one process's render."""
    for r in each_rank(gloo, check):
        assert r["max_abs"] <= 1e-5, r
        if check == "render_kernel":
            assert r["shape"] == [21, 24, 3] and r["equal"]
        else:
            assert r["shape"] == [35, 27, 3]


def test_gloo_kernel_step_matches_single_process(gloo):
    recs = each_rank(gloo, "kernel_step")
    assert len({r["loss"] for r in recs}) == 1   # one all_reduced loss
    for r in recs:
        assert r["loss_rel"] <= 1e-5 and r["params_ok"], r


@pytest.mark.parametrize("check", ["kernel_descent", "core_descent"])
def test_gloo_sharded_steps_descend(gloo, check):
    recs = each_rank(gloo, check)
    assert recs[0]["losses"] == recs[1]["losses"]
    losses = recs[0]["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_gloo_core_loss_matches_l2_loss_nondivisible(gloo):
    for r in each_rank(gloo, "core_loss"):
        assert r["loss_rel"] <= 1e-6, r


def test_gloo_sharded_value_and_grad_is_the_mean(gloo):
    for r in each_rank(gloo, "value_and_grad"):
        assert r["value_rel"] <= 1e-6 and r["grad_rel"] <= 1e-5, r


def test_gloo_checkpoint_round_trips(gloo):
    assert all(r["equal"] for r in each_rank(gloo, "checkpoint"))


@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_gloo_scaling_sweep(gloo, backend):
    """tests/test_scaling.py: one row a group size, the same loss on
    every size, every rank reporting rank 0's rows."""
    recs = [r for r in each_rank(gloo, "sweep", n=2)
            if r["backend"] == backend]
    assert len(recs) == WORLD and recs[0]["rows"] == recs[1]["rows"]
    rows = recs[0]["rows"]
    assert [r["n"] for r in rows] == [1, 2]
    for row in rows:
        assert set(row) == {"n", "step_time_s", "rays_per_s", "efficiency",
                            "timing_method", "timing_spread", "loss"}
        assert row["step_time_s"] > 0 and row["efficiency"] > 0
        assert np.isfinite(row["loss"])
    losses = [row["loss"] for row in rows]
    assert max(losses) - min(losses) < 1e-4


def test_gloo_dryrun_multichip(gloo):
    recs = each_rank(gloo, "dryrun")
    for r in recs:
        assert np.isfinite([r["kernel"], r["core"]]).all()
        # each step's target is its own forward's render of the scene, and
        # the kernel and core forwards part only on decision-boundary pixels
        assert r["kernel"] == pytest.approx(r["core"], rel=1e-3)
    assert recs[0]["kernel"] == recs[1]["kernel"]


# ------------------------- against JAX's sharded core (its result last)

@pytest.mark.parametrize("name,w,h", [("three_spheres_ground", 32, 32),
                                      ("single_sphere", 24, 40)])
def test_sharded_core_render_matches_single_and_jax(jax_side, name, w, h):
    """tests/test_parallel.py:24-44: 8 ranks' flat shards, gathered in
    rank order and cut, against ``render_image``, and at 32^2 against
    JAX's sharded render."""
    scene, camcfg, cfg = presets.PRESETS[name](size=SIZE)
    cfg = dataclasses.replace(cfg, width=w, height=h, chunk_size=1024)
    cam = camera_of(camcfg, cfg)
    flat = torch.cat([S.render_tile(scene, cam, cfg, r, 8, device=CPU)
                      for r in range(8)])
    img = flat[:w * h].reshape(h, w, 3)
    single = render_image(scene, cam, cfg, device=CPU)
    np.testing.assert_allclose(img.numpy(), single.numpy(), atol=1e-5)
    if (w, h) == (32, 32):
        np.testing.assert_allclose(img.numpy(), jax_side.result()["render"],
                                   atol=1e-5)


def test_sharded_core_loss_matches_unsharded_nondivisible(ref):
    """tests/test_parallel.py:72-102 at 27x35 over 8 ranks: the padding
    pixels weigh 0 and the normaliser is global, so the ranks' losses sum
    to ``l2_loss`` (and to JAX's sharded loss) and their gradients to its
    gradients."""
    scene, camcfg, cfg = presets.fit_target(size=SIZE)
    cfg = dataclasses.replace(cfg, width=27, height=35, chunk_size=1024)
    cam = camera_of(camcfg, cfg)
    assert (27 * 35) % 8 != 0
    target = render_image(scene, cam, cfg, device=CPU)
    np.testing.assert_allclose(target.numpy(), ref["target_27x35"],
                               atol=1e-5)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_radius *= 1.1
    tgt_flat = S.pad_pixels(target, 8)
    total = sum(shard_loss_grads(params, scene, cam, cfg, tgt_flat, r, 8,
                                 device=CPU) for r in range(8))
    loss, grads = as_grads(params, total)
    single = l2_loss(params, scene, cam, cfg, target, device=CPU)
    g_single = torch.autograd.grad(single, [getattr(params, f)
                                            for f in FIELDS])
    assert float(loss) == pytest.approx(float(single.detach()), rel=1e-6)
    assert float(loss) == pytest.approx(float(ref["core_loss"]), rel=1e-6)
    for f, g in zip(FIELDS, g_single):
        scale = float(g.abs().max())
        assert float((grads[f] - g).abs().max()) <= 1e-5 * max(scale,
                                                                1e-12), f
    assert float(g_single[1].abs().max()) > 0   # the radii carry gradient


# ---------------------------- index helpers against JAX (its result last)

@pytest.mark.parametrize("k", range(len(R.BAND_SPLITS)))
def test_band_split_equals_jax(ref, k):
    assert S.band_split(*R.BAND_SPLITS[k]) == tuple(ref[f"band_split_{k}"])


@pytest.mark.parametrize("k", range(len(R.BAND_ROWS)))
def test_band_rows_equal_jax(ref, k):
    w, hs, n = R.BAND_ROWS[k]
    got = torch.cat([torch.stack(S.band_rows(w, hs, r)) for r in range(n)],
                    1)
    np.testing.assert_array_equal(got.numpy(), ref[f"band_rows_{k}"])


@pytest.mark.parametrize("k", range(len(R.PIXEL_INDEX)))
def test_pixel_index_arrays_equal_jax(ref, k):
    ii, jj, total = S._pixel_index_arrays(*R.PIXEL_INDEX[k])
    np.testing.assert_array_equal(torch.stack([ii, jj]).numpy(),
                                  ref[f"pixel_index_{k}"])
    assert total == int(ref[f"pixel_total_{k}"])
