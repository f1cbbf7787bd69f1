"""The port's core renderer (ray_tracer_fragment_shader_tpu_torch: ops
.intersect, ops.shading, core.renderer, diff.fit's l2_loss and
make_fit_step) against the JAX package's, on the CPU.

Scenes cross as numpy arrays (``FlatScene.from_numpy``), so both sides see
the same float32 inputs; rays come from numpy with a fixed seed, jitter
from the JAX package's own draws.

The JAX references run in ONE subprocess for the module
(``tests/torch_core_ref.py`` run as a script, ``tests/torch_jax_ref.py``;
the shared inputs are defined there), without fused multiply-adds in
XLA's compiled programs: with them, float fields part by up to 1.2e-5 of
max (the sphere test's cancellation amplifies a last bit), one mirror
pixel of full_reflective 32^2 d2 takes another bounce (0.87 off, the mean
1.009 % off) and ``l2_loss`` parts by 3.4e-5 relative; without them the
port equals the JAX core on every image here.

Tolerances: ``valid`` and ``prim_id`` exact, the other hit fields within
1e-5 of max|JAX| per field; images to phase 2's budget of chip_smoke.py
(pixels whose max-channel difference exceeds 1e-3 at most 1 %, 2 % for
reference_demo; means within 1 %); ``l2_loss`` within 1e-5 relative and
each gradient table within 5e-4 of max|JAX| (float32 reassociation,
tests/test_adjoint_fused.py:46-51); three Adam steps within 1e-4 relative
of optax's (torch's Adam rounds apart, diff/fit.py).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_core_ref as R
import torch_jax_ref
from torch_jax_ref import port_configs, port_scene
from torch_core_ref import (FIELDS, HIT_FIELDS, IMAGE_CASES,
                            INTERSECT_SCENES, RAYS, SIZE, checker_rays,
                            exclusions, fit_problem, image_case, jax_jitter,
                            jax_preset, random_rays, tie_case)
from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch.config import RenderConfig
from ray_tracer_fragment_shader_tpu_torch.core import renderer as TR
from ray_tracer_fragment_shader_tpu_torch.core.topology import same_topology
from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
    FitParams, default_fit_optimizer, l2_loss, make_fit_step)
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
    render_image_diff)
from ray_tracer_fragment_shader_tpu_torch.ops import intersect as TI
from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
from ray_tracer_fragment_shader_tpu_torch.ops.shading import shade_local
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets

CPU = "cpu"
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
GOLDEN_NAMES = ["reference_demo", "single_sphere", "three_spheres_ground",
                "full_reflective", "fit_target", "procedural_spheres"]


# ------------------------------------------------------------ shared inputs

def golden_case(name):
    """The port's preset of tests/goldens/<name>_core.npy
    (scripts/make_goldens.py): 64^2; the demo 16-spp adaptive."""
    n = 64
    if name == "reference_demo":
        scene, cam, cfg = tpresets.reference_demo()
        return scene, cam, dataclasses.replace(cfg, width=n, height=n,
                                               adaptive=True)
    if name == "procedural_spheres":
        return tpresets.procedural_spheres(n=64, size=n, depth=3)
    return tpresets.PRESETS[name](size=n)


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """The module's JAX subprocess, started as the module starts: the
    checks that need no JAX run beside it."""
    pending = torch_jax_ref.start(
        R.__file__, tmp_path_factory.mktemp("jax_core") / "ref.npz")
    yield pending
    pending.cancel()


@pytest.fixture(scope="module")
def ref(jax_side):
    """``jax_reference``'s arrays, from one subprocess."""
    return jax_side.result()


# ---------------------------------------------------------------- checks

def budget_of(ref_img, img, budget):
    """Phase 2's budget; returns the fraction of pixels over 1e-3."""
    ref_img, img = np.asarray(ref_img), np.asarray(img)
    assert img.shape == ref_img.shape and np.isfinite(img).all()
    frac = float((np.abs(img - ref_img).max(-1) > 1e-3).mean())
    rel = abs(img.mean() - ref_img.mean()) / max(abs(ref_img.mean()), 1e-12)
    assert frac <= budget, f"{frac:.4f} of pixels off (budget {budget})"
    assert rel <= 0.01, rel
    return frac


def rel_max(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.abs(want - got).max() / max(np.abs(want).max(), 1e-12)


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_hits_match(ref, prefix, got):
    for f in ("valid", "prim_id"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      ref[f"{prefix}/{f}"], err_msg=f)
    valid = ref[f"{prefix}/valid"]
    for f in HIT_FIELDS:
        want, have = ref[f"{prefix}/{f}"], getattr(got, f).numpy()
        if f == "dist":  # misses stay BIG on both sides
            np.testing.assert_array_equal(have[~valid], want[~valid])
            want, have = want[valid], have[valid]
        assert rel_max(want, have) <= 1e-5, (f, rel_max(want, have))


# --------------------------------------------------------------- port only

@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_render_image_matches_core_golden(name):
    """The JAX core's committed 64x64 renders (tests/goldens/*_core.npy,
    scripts/make_goldens.py); the demo with JAX's jitter draws, made here
    as the goldens were."""
    scene, cam, cfg = golden_case(name)
    jit = jax_jitter(cfg, 64 * 64) if cfg.samples > 1 else None
    img = TR.render_image(scene, cam, cfg, device=CPU,
                          jitter=None if jit is None else t_(jit))
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_core.npy"))
    frac = budget_of(golden, img.numpy(),
                     0.02 if name == "reference_demo" else 0.01)
    print(f"{name}: {frac:.5f} of pixels over 1e-3")


def test_chunking_invariance():
    scene, cam, cfg = tpresets.three_spheres_ground(size=SIZE)
    a = TR.render_image(scene, cam, dataclasses.replace(cfg,
                                                        chunk_size=1 << 20),
                        device=CPU)
    b = TR.render_image(scene, cam, dataclasses.replace(cfg, chunk_size=100),
                        device=CPU)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_chain_equals_tree_on_chain_exact_scene():
    scene, cam, cfg = tpresets.full_reflective(size=SIZE)
    assert scene.chain_exact
    a = TR.render_image(scene, cam, dataclasses.replace(cfg, mode="chain"),
                        device=CPU)
    b = TR.render_image(scene, cam, dataclasses.replace(cfg, mode="tree"),
                        device=CPU)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_adaptive_divisor_quirk_on_identical_samples():
    """Identical samples (zero jitter) converge at k=1 and the 2 summed
    samples are divided by 1: a 2x brightening (SEMANTICS.md D3,
    tests/test_adaptive.py)."""
    scene, cam, cfg = tpresets.three_spheres_ground(size=24)
    base = TR.render_image(scene, cam, cfg, device=CPU)
    adapt = TR.render_image(scene, cam, dataclasses.replace(
        cfg, samples=8, adaptive=True, force_jitter=True, jitter_scale=0.0),
        device=CPU)
    lit = base.amax(-1) > 0
    torch.testing.assert_close(adapt[lit], 2 * base[lit], atol=1e-5, rtol=0)
    assert bool((adapt[~lit] == 0).all())


def test_render_image_jit_is_render_image():
    scene, cam, cfg = tpresets.fit_target(size=16)
    camera = Camera.from_config(cam, 16, 16)
    a = TR.render_image_jit(scene, camera, cfg, device=CPU)
    b = TR.render_image(scene, camera, cfg, device=CPU)
    assert torch.equal(a, b)


def test_core_renders_on_the_card_by_default(monkeypatch):
    """No device given means the GPU: without one the core raises, as
    render_image_kernel does; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam, cfg = tpresets.fit_target(size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.render_image(scene, cam, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        l2_loss(FitParams.from_scene(scene), scene, cam, cfg,
                torch.zeros(8, 8, 3))


def test_core_gradients_match_the_replay_where_topology_agrees():
    """The core's autograd against the replay adjoint
    (``render_image_diff``) at full_reflective 128^2 d3, the uniform
    cotangent restricted to the pixels where the two forwards took the same
    topology (core/topology.py) and the colours agree within 1e-3: within
    tests/test_adjoint.py:47-49's 5e-3 for the geometry and 3e-2 for the
    rest, as chip_smoke.py's phase 18 holds the card's 1024^2 frame.
    Printed (measured: the sphere centres part by 0.317 of max
    unrestricted, from the 2 of 16,384 pixels where the two forwards take
    another topology, (64, 100) on the look-at row and (74, 91): there the
    core's colour leaves the f64 oracle by 0.87 and 0.48 and the kernel
    path's is within 3.7e-5 of it (before the kernel path formed a
    triangle's hit point as the core does, o + m*v, the checker-edge
    scanline, 0.18 % of the frame, took the other square too); by 0.00287
    on the same topology, all from one ill-conditioned pixel, an
    inter-reflection between two spheres whose colours part by 1.1e-3 and
    which alone carries 0.79 of the held centre table's max; by 0.000673
    without it)."""
    n = 128
    scene, cam, cfg = tpresets.full_reflective(size=n, depth=3)
    camera = Camera.from_config(cam, n, n)
    _, res = K.render_forward_with_residuals(scene, camera, cfg, device=CPU)
    same = same_topology(scene, camera, cfg, res)
    assert 0.0 < 1.0 - same.float().mean().item() < 0.01
    imgs, leaves = {}, {}
    for label, render in (("core", TR.render_image),
                          ("replay", render_image_diff)):
        params = FitParams.from_scene(scene)
        imgs[label] = render(params.into_scene(scene), camera, cfg,
                             device=CPU)
        leaves[label] = [getattr(params, f) for f in FIELDS]
    parts = (imgs["core"] - imgs["replay"]).abs().amax(-1) > 1e-3
    assert int((same & parts).sum()) <= 2
    masks = {"held": same & ~parts, "uniform": torch.ones_like(same),
             "same topology": same, "ill-conditioned": same & parts}
    rel, grads = {}, {}
    for cot, m in masks.items():
        w = m[..., None].expand(n, n, 3).float() / (n * n * 3)
        grads[cot] = {k: torch.autograd.grad(imgs[k], leaves[k],
                                             grad_outputs=w,
                                             retain_graph=True)
                      for k in imgs}
        rel[cot] = [((a - b).abs().max() / a.abs().max()).item()
                    for a, b in zip(grads[cot]["core"], grads[cot]["replay"])]
        print(cot, int(m.sum()), "pixels:", dict(zip(FIELDS, rel[cot])))
    held = grads["held"]["core"][0].abs().max().item()
    print("ill-conditioned: colours part by",
          (imgs["core"] - imgs["replay"]).abs()[same & parts].max().item(),
          "; centre gradient over the held's max:",
          grads["ill-conditioned"]["core"][0].abs().max().item() / held)
    for f, r, a in zip(FIELDS, rel["held"], grads["held"]["core"]):
        tol = 5e-3 if f in ("sph_center", "sph_radius") else 3e-2
        assert a.abs().max() > 0, f
        assert r < tol, f


# ---------------------------------------------------------------- intersect

@pytest.mark.parametrize("use_excl", [False, True], ids=["all", "excl"])
@pytest.mark.parametrize("prune", [True, False], ids=["prune", "noprune"])
@pytest.mark.parametrize("name", INTERSECT_SCENES)
def test_intersect_scene_matches_jax(ref, name, prune, use_excl):
    prefix = f"hit/{name}/{prune}/{use_excl}"
    assert ref[f"{prefix}/valid"].mean() > 0.2  # the rays hit something
    js = jax_preset(name)[0]
    o, v = random_rays(RAYS, seed=len(name))
    got = TI.intersect_scene(port_scene(js), t_(o), t_(v), prune=prune,
                             exclude_id=t_(exclusions(js)) if use_excl
                             else None)
    assert_hits_match(ref, prefix, got)
    assert got.prim_id.dtype == torch.int32


def test_intersect_ties_keep_the_earliest_primitive(ref):
    """Two coincident spheres and two coincident triangles: the nearest
    hit uses strict < (MySdlApplication.cpp:811-815), so the first of each
    pair wins, in the port (torch.argmin's first minimum) as in JAX; with
    the first excluded the second takes its place."""
    js, t, o, v = tie_case()
    nt = js.num_triangles
    for k, (excl, want) in enumerate(((None, [nt, t]),
                                      ([nt, t], [nt + 1, t + 1]))):
        got = TI.intersect_scene(port_scene(js), t_(o), t_(v),
                                 exclude_id=None if excl is None else
                                 torch.tensor(excl, dtype=torch.int32))
        assert ref["tie/prim_id"][k].tolist() == want
        assert got.prim_id.tolist() == want
        np.testing.assert_array_equal(got.dist.numpy(), ref["tie/dist"][k])


def test_checker_parity_on_negative_squares(ref):
    """The board's squares on both sides of its centre: parity by C-style
    truncation and a non-negative %, as jnp computes it (torch.fmod would
    flip the parity of negative squares)."""
    js = jax_preset("three_spheres_ground")[0]
    got = TI.intersect_scene(port_scene(js), *map(t_, checker_rays()))
    assert_hits_match(ref, "checker", got)
    dif = ref["checker/diffuse"]
    assert len(np.unique(dif.round(5), axis=0)) >= 2  # both squares seen


@pytest.mark.parametrize("name", ["full_reflective", "reference_demo"])
def test_shade_local_matches_jax(ref, name):
    ts = port_scene(jax_preset(name)[0])
    o, v = random_rays(RAYS, seed=len(name))
    u = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    hit = TI.intersect_scene(ts, t_(o), t_(v))
    got = shade_local(ts, hit, t_(u))
    want = ref[f"shade/{name}"]
    assert want.max() > 0
    assert rel_max(want, got.numpy()) <= 1e-5


# ------------------------------------------------------------------ images

@pytest.mark.parametrize("case", list(IMAGE_CASES))
def test_render_image_matches_jax_core(ref, case):
    js, jcam, jcfg, budget = image_case(case)
    jit = ref.get(f"jitter/{case}")
    before = dict(K.LAUNCHES)
    got = TR.render_image(port_scene(js), *port_configs(jcam, jcfg),
                          jitter=None if jit is None else t_(jit),
                          device=CPU)
    assert K.LAUNCHES == before  # no kernel wrapper ran
    frac = budget_of(ref[f"image/{case}"], got.numpy(), budget)
    print(f"{case}: {frac:.5f} of pixels over 1e-3")


# -------------------------------------------------------------- gradients

def port_fit_problem(ref):
    js, jcam, jcfg, jp = fit_problem()
    params = FitParams(*(np.asarray(getattr(jp, f)) for f in FIELDS))
    camera = Camera(**{f: t_(np.array(getattr(jcam, f)))
                       for f in Camera.__dataclass_fields__})
    return (port_scene(js), camera, RenderConfig(**dataclasses.asdict(jcfg)),
            ref["fit/target"], params)


def test_l2_loss_and_gradients_match_jax(ref):
    scene, camera, cfg, target, params = port_fit_problem(ref)
    camera = dataclasses.replace(camera,
                                 eye=camera.eye.clone().requires_grad_())
    loss = l2_loss(params, scene, camera, cfg, t_(target), device=CPU)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref["fit/loss"]), rel=1e-5)
    for f in FIELDS:
        want, got = ref[f"fit/grad/{f}"], getattr(params, f).grad.numpy()
        assert np.isfinite(got).all(), f
        assert rel_max(want, got) <= 5e-4, (f, rel_max(want, got))
    assert np.abs(ref["fit/grad/sph_center"]).max() > 0
    assert rel_max(ref["fit/eye"], camera.eye.grad.numpy()) <= 5e-4


def test_make_fit_step_matches_optax(ref):
    scene, camera, cfg, target, params = port_fit_problem(ref)
    step = make_fit_step(scene, camera, cfg, target,
                         default_fit_optimizer(params), device=CPU)
    before = dict(K.LAUNCHES)
    losses = [float(step(params)) for _ in range(3)]
    assert K.LAUNCHES == before
    np.testing.assert_allclose(losses, ref["fit/step_losses"], rtol=1e-5)
    for f in FIELDS:
        want, got = ref[f"fit/step/{f}"], getattr(params, f).detach().numpy()
        assert rel_max(want, got) <= 1e-4, (f, rel_max(want, got))


