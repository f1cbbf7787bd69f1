"""The CUDA kernels on the card, against their plain PyTorch versions on
the same inputs.  Every test here needs a CUDA GPU and skips without one.
The file imports no JAX, so it runs on a machine without it (the fit
kernels' tests at the end hold K3, K4, K6, K7, the residual forwards and
K8 against their plain versions):

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

from ray_tracer_fragment_shader_tpu_torch import adjoint_ab
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
                                                                samples=1),
                                device="cpu")
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


# ---- the fit kernels: packed forward (K3) and adjoint (K4) ---------------

def fit_case(name, device):
    """The adjoint's inputs on a 64x64 scene with its sphere centres moved
    by 1.5 (target: the unperturbed render), from the packed kernel."""
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    make = dict(full_reflective=lambda: presets.full_reflective(size=N,
                                                                depth=3),
                glass_chain=lambda: presets.glass_chain(size=N, depth=3),
                faint_glass=lambda: presets.glass_chain(size=N, depth=3))
    scene, cam, cfg = make[name]()
    if name == "faint_glass":
        # transparent (shadows see through it) but under small_number, so
        # the chain reflects where glass_chain transmits
        scene = scene.replace(mat_transparency=scene.mat_transparency * 1e-9)
    camera = Camera.from_config(cam, N, N, device=device)
    target = K.render_image_kernel(scene, camera, cfg, device=device)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.5
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=device)
    _, tables, kw, akw = AF.kernel_inputs(params.into_scene(scene), cfg,
                                          N * N, device=device)
    return (tables, prep["v"], prep["eye"], kw, prep["target"], prep["mask"],
            akw)


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain"])
def test_packed_kernel_matches_plain(cuda, name):
    tables, v, eye, kw, _, _, akw = fit_case(name, cuda)
    before = K.LAUNCHES["render_packed"]
    img, pk = K.render_packed(tables, v, eye, pack=akw["pack"], **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["render_packed"] == before + 1
    ref_img, ref_pk = K.render_packed_ref(tables, v, eye, pack=akw["pack"],
                                          **kw)
    assert_close_frac(ref_img, img, 0.01)
    assert (pk != ref_pk).float().mean().item() <= 0.01
    assert torch.equal(img, K.render_chain(tables, v, eye, **kw))


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain",
                                  "faint_glass"])
def test_adjoint_kernel_matches_plain_and_is_deterministic(cuda, name):
    """Loss within 1e-5 relative; each gradient table within 1e-3 of
    max|plain| (float32 reassociation); two launches bit-identical."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    tables, v, eye, kw, target, mask, akw = fit_case(name, cuda)
    img, pk = K.render_packed(tables, v, eye, pack=akw["pack"], **kw)
    args = (tables, v, eye, img, target, mask, pk)
    before = K.LAUNCHES["adjoint_packed"]
    a = AF.adjoint_packed(*args, **akw)
    b = AF.adjoint_packed(*args, **akw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["adjoint_packed"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = AF.adjoint_packed_ref(*args, **akw)
    assert a[0].item() == pytest.approx(ref[0].item(), rel=1e-5)
    for got, want in zip(a[1:], ref[1:]):
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= 1e-3, err


def test_adjoint_wrapper_refuses_other_devices(cuda):
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    tables, v, eye, kw, target, mask, akw = fit_case("full_reflective", cuda)
    img, pk = K.render_packed(tables, v, eye, pack=akw["pack"], **kw)
    with pytest.raises(ValueError, match="pk must be"):
        AF.adjoint_packed(tables, v, eye, img, target, mask, pk.cpu(), **akw)
    with pytest.raises(ValueError, match="table"):
        K.render_packed({k: t.cpu() for k, t in tables.items()}, v, eye,
                        pack=akw["pack"], **kw)


def test_fit_entry_points_run_on_the_card_by_default(cuda):
    from ray_tracer_fragment_shader_tpu_torch import (FitParams,
                                                      fit_value_and_grad)
    scene, cam, cfg = presets.fit_target(size=N)
    camera = Camera.from_config(cam, N, N)
    target = K.render_image_kernel(scene, camera, cfg)
    assert target.is_cuda
    params = FitParams.from_scene(scene).to(cuda)
    K.reset_launch_counts()
    loss, grads = fit_value_and_grad(params, scene, camera, cfg, target)
    torch.cuda.synchronize()
    assert loss.is_cuda and all(g.is_cuda for g in grads.values())
    assert K.LAUNCHES["render_packed"] == K.LAUNCHES["adjoint_packed"] == 1


# ---- the one-dispatch fit kernels: K6 (fused) and K7 (recompute) ---------

def fused_case(name, device):
    """K6/K7 inputs on a 64x64 chain or tree scene with its sphere centres
    moved by 1.5 (target: the unperturbed render): (tables, v, eye, kw,
    target, mask, akw, tree)."""
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    make = dict(full_reflective=lambda: presets.full_reflective(size=N,
                                                                depth=3),
                glass_chain=lambda: presets.glass_chain(size=N, depth=3),
                fractional_glass=lambda: presets.fractional_glass(size=N,
                                                                  depth=3))
    scene, cam, cfg = make[name]()
    camera = Camera.from_config(cam, N, N, device=device)
    target = K.render_image_kernel(scene, camera, cfg, device=device)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.5
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=device)
    sc, tables, kw, akw = AF.kernel_inputs(params.into_scene(scene), cfg,
                                           N * N, device=device)
    return (tables, prep["v"], prep["eye"], kw, prep["target"], prep["mask"],
            akw, not sc.chain_exact)


def assert_tables_close(got, want):
    for g, w in zip(got, want):
        err = ((g - w).abs().max() / w.abs().max()).item()
        assert err <= 1e-3, err


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain",
                                  "fractional_glass"])
def test_fused_kernel_matches_plain_and_is_deterministic(cuda, name):
    """K6: loss within 1e-5 relative, each gradient table within 1e-3 of
    max|plain|, two launches bit-identical; on chain scenes it equals
    K3 + K4 on the same inputs (every kernel rounds without fma)."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    tables, v, eye, kw, target, mask, akw, tree = fused_case(name, cuda)
    kw6 = dict(tree=tree, g_scale=akw["g_scale"], **kw)
    before = K.LAUNCHES["fused_adjoint"]
    a = AF.fused_adjoint(tables, v, eye, target, mask, **kw6)
    b = AF.fused_adjoint(tables, v, eye, target, mask, **kw6)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_adjoint"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = AF.fused_adjoint_ref(tables, v, eye, target, mask, **kw6)
    assert a[0].item() == pytest.approx(ref[0].item(), rel=1e-5)
    assert_tables_close(a[1:], ref[1:])
    if not tree:
        img, pk = K.render_packed(tables, v, eye, pack=akw["pack"], **kw)
        q = AF.adjoint_packed(tables, v, eye, img, target, mask, pk, **akw)
        assert a[0].item() == pytest.approx(q[0].item(), rel=1e-5)
        assert_tables_close(a[1:], q[1:])


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain",
                                  "fractional_glass"])
def test_recompute_kernel_matches_plain_and_is_deterministic(cuda, name):
    """K7 under the L2 cotangent of the moved scene's render: each table
    within 1e-3 of max|plain|, two launches bit-identical."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    tables, v, eye, kw, target, _, akw, tree = fused_case(name, cuda)
    render = K.render_tree if tree else K.render_chain
    g = (akw["g_scale"] * (render(tables, v, eye, **kw) - target)).contiguous()
    kw7 = dict(tree=tree, **kw)
    before = K.LAUNCHES["recompute_adjoint"]
    a = AF.recompute_adjoint(tables, v, eye, g, **kw7)
    b = AF.recompute_adjoint(tables, v, eye, g, **kw7)
    torch.cuda.synchronize()
    assert K.LAUNCHES["recompute_adjoint"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert_tables_close(a, AF.recompute_adjoint_ref(tables, v, eye, g, **kw7))


def test_fused_wrappers_refuse_other_devices(cuda):
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    tables, v, eye, kw, target, mask, akw, tree = fused_case(
        "fractional_glass", cuda)
    with pytest.raises(ValueError, match="mask must be"):
        AF.fused_adjoint(tables, v, eye, target, mask.cpu(), tree=tree,
                         g_scale=akw["g_scale"], **kw)
    with pytest.raises(ValueError, match="g must be"):
        AF.recompute_adjoint(tables, v, eye, target.cpu(), tree=tree, **kw)
    with pytest.raises(ValueError, match="table"):
        AF.recompute_adjoint({k: t.cpu() for k, t in tables.items()}, v, eye,
                             target, tree=tree, **kw)


def test_tree_and_sampled_fits_run_on_the_card_by_default(cuda):
    from ray_tracer_fragment_shader_tpu_torch import (FitParams,
                                                      fit_value_and_grad)
    scene, cam, cfg = presets.fractional_glass(size=N, depth=2)
    camera = Camera.from_config(cam, N, N)
    target = K.render_image_kernel(scene, camera, cfg)
    params = FitParams.from_scene(scene).to(cuda)
    K.reset_launch_counts()
    loss, grads = fit_value_and_grad(params, scene, camera, cfg, target)
    ss = dataclasses.replace(cfg, samples=2)
    loss2, _ = fit_value_and_grad(params, scene, camera, ss, target)
    torch.cuda.synchronize()
    assert loss.is_cuda and loss2.is_cuda
    assert all(g.is_cuda for g in grads.values())
    assert K.LAUNCHES["fused_adjoint"] == 1
    assert K.LAUNCHES["recompute_adjoint"] == K.LAUNCHES["render_tree"] == 2


# ---- the split mode: residual forwards (K2/K5 residual) and K8 ----------

@pytest.mark.parametrize("name", ["full_reflective", "glass_chain",
                                  "fractional_glass"])
def test_residual_kernel_matches_plain(cuda, name):
    """The residual forwards: planes equal the plain version's, the image
    within the budget and bit-identical to the plain kernel's."""
    tables, v, eye, kw, _, _, _, tree = fused_case(name, cuda)
    kname = "render_tree_residuals" if tree else "render_chain_residuals"
    before = K.LAUNCHES[kname]
    img, res = K.render_residuals(tables, v, eye, tree=tree, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kname] == before + 1
    ref_img, ref = K.render_residuals_ref(tables, v, eye, tree=tree, **kw)
    assert_close_frac(ref_img, img, 0.01)
    for k in ("bi", "mid", "lit"):
        assert torch.equal(res[k], ref[k]), k
    plain = K.render_tree if tree else K.render_chain
    assert torch.equal(img, plain(tables, v, eye, **kw))


@pytest.mark.parametrize("name", ["full_reflective", "glass_chain"])
def test_fit_grads_kernel_matches_plain_and_k4(cuda, name):
    """K8 under the L2 cotangent of the moved scene's residual render: each
    table within 1e-3 of max|plain|, two launches bit-identical, and equal
    to K4's tables on the same inputs bit for bit (one chain adjoint, the
    cotangent formed in the same order, every kernel without fma)."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    tables, v, eye, kw, target, mask, akw, _ = fused_case(name, cuda)
    img, res = K.render_residuals(tables, v, eye, tree=False, **kw)
    g = (akw["g_scale"] * (img - target)).contiguous()
    fkw = {k: akw[k] for k in ("nl", "depth", "atten", "want_trans")}
    before = K.LAUNCHES["fit_grads"]
    a = AF.fit_grads(tables, v, eye, g, res, **fkw)
    b = AF.fit_grads(tables, v, eye, g, res, **fkw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fit_grads"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert_tables_close(a, AF.fit_grads_ref(tables, v, eye, g, res, **fkw))
    img4, pk = K.render_packed(tables, v, eye, pack=akw["pack"], **kw)
    q = AF.adjoint_packed(tables, v, eye, img4, target, mask, pk, **akw)
    assert all(torch.equal(x, y) for x, y in zip(a, q[1:]))


def test_split_and_render_image_diff_run_on_the_card_by_default(cuda):
    from ray_tracer_fragment_shader_tpu_torch import (FitParams,
                                                      fit_value_and_grad)
    from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
        l2_loss_kernel, render_image_diff)
    scene, cam, cfg = presets.fit_target(size=N)
    camera = Camera.from_config(cam, N, N)
    target = K.render_image_kernel(scene, camera, cfg)
    params = FitParams.from_scene(scene).to(cuda)
    K.reset_launch_counts()
    loss, grads = fit_value_and_grad(params, scene, camera, cfg, target,
                                     mode="split")
    torch.cuda.synchronize()
    assert loss.is_cuda and all(g.is_cuda for g in grads.values())
    assert K.LAUNCHES["render_chain_residuals"] == 1
    assert K.LAUNCHES["fit_grads"] == 1
    assert K.LAUNCHES["render_packed"] == K.LAUNCHES["adjoint_packed"] == 0
    eye = camera.eye.clone().requires_grad_()
    l2 = l2_loss_kernel(params, scene,
                        dataclasses.replace(camera, eye=eye), cfg, target)
    l2.backward()
    # the eye leaf lies on the CPU: .to(device) carries its gradient back
    assert l2.is_cuda and eye.grad is not None
    assert eye.grad.device == eye.device
    assert all(getattr(params, f).grad is not None
                for f in FitParams.FIELDS)
    tree, tcam, tcfg = presets.fractional_glass(size=N, depth=2)
    img = render_image_diff(tree, tcam, tcfg)
    torch.cuda.synchronize()
    assert img.is_cuda and K.LAUNCHES["render_chain_residuals"] == 2
    assert K.LAUNCHES["render_tree_residuals"] == 1


# ---- the probes (K9, P1, P2) ---------------------------------------------
# held against their plain versions on the same card at two 8x256 tiles:
# f32 chains to 1e-5 of max|plain| (rsqrtf and rcp.approx.f32 are not
# IEEE), bf16 chains to 2^-7 (one rounding of rsqrt's result)

PROBE_TOL, PROBE_BF16_TOL = 1e-5, 2.0 ** -7
RENDER_LIKE = dict(basic=8000.0, select=2000.0, cmp=1200.0, abs=150.0,
                   rsqrt=300.0, sqrt=60.0, recip_nr=220.0, floor=40.0,
                   sign=30.0, div=20.0)


def _probe_rel(got, ref):
    scale = ref.abs().max().item()
    diff = (got - ref).abs().max().item()
    return diff / scale if scale > 0 else diff


@pytest.mark.parametrize("blend", ["render_like", "basic"])
def test_mix_chain_kernel_matches_plain_and_is_deterministic(cuda, blend):
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    counts = RENDER_LIKE if blend == "render_like" else {"basic": 1.0}
    sched = RL._rewrite_schedule(RL.mix_schedule(counts))[0]
    x = RL.probe_input(2, cuda)
    for nc in (2, 16):
        before = K.LAUNCHES["mix_chain"]
        a = PR.mix_chain(x, iters=8, nc=nc, sched=sched)
        b = PR.mix_chain(x, iters=8, nc=nc, sched=sched)
        torch.cuda.synchronize()
        assert K.LAUNCHES["mix_chain"] == before + 2
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
        ref = RL.mix_chain_ref(x, iters=8, nc=nc, sched=sched)
        assert _probe_rel(a, ref) <= PROBE_TOL


def test_op_and_bf16_chain_kernels_match_plain(cuda):
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    x = RL.probe_input(2, cuda)
    for inj in PR.INJECTS:
        a = PR.op_chain(x, inject=inj, iters=8, nc=4)
        assert torch.equal(a, PR.op_chain(x, inject=inj, iters=8, nc=4))
        ref = PR.op_chain_ref(x, inject=inj, iters=8, nc=4)
        assert _probe_rel(a, ref) <= PROBE_TOL, inj
    # every P2 instantiation: bit-identical to its plain version, and two
    # launches bit-identical
    for inj in PR.BF16_INJECTS:
        for bf16 in (False, True):
            for nc in PR.BF16_NCS:
                a = PR.bf16_chain(x, inject=inj, bf16=bf16, iters=8, nc=nc)
                b = PR.bf16_chain(x, inject=inj, bf16=bf16, iters=8, nc=nc)
                ref = PR.bf16_chain_ref(x, inject=inj, bf16=bf16, iters=8,
                                        nc=nc)
                tol = PROBE_BF16_TOL if bf16 else PROBE_TOL
                assert _probe_rel(a, ref) <= tol, (inj, bf16, nc)
                assert torch.equal(a, ref), (inj, bf16, nc)
                assert torch.equal(a, b), (inj, bf16, nc)


def test_bf16_mix_chain_matches_plain_on_subnormal_and_negative_arguments(
        cuda):
    """The bf16 mix kernel's rsqrt off the normal positive range: a
    negative d (tile 0: negative arguments, NaN) and a subnormal c and d
    (tile 1: subnormal arguments, which rsqrtf rescales) give the plain
    version's output, NaN where it has NaN, at every chain count."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    x = RL.probe_input(2, cuda).clone()
    x[0, 1] = -0.3
    x[8, 0], x[8, 1] = 1e-39, 1e-39
    for nc in PR.BF16_NCS:
        a = PR.bf16_chain(x, inject="mix", bf16=True, iters=16, nc=nc)
        ref = PR.bf16_chain_ref(x, inject="mix", bf16=True, iters=16, nc=nc)
        nan = torch.isnan(ref)
        assert bool(nan.any()) and torch.equal(torch.isnan(a), nan), nc
        assert torch.equal(a[~nan], ref[~nan]), nc


def test_probe_wrappers_refuse_other_devices_and_shapes(cuda):
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    x = RL.probe_input(2, cuda)
    sched = ("basic", "cmp", "select")
    with pytest.raises(ValueError):
        PR.mix_chain(x.to("meta"), iters=1, nc=2, sched=sched)
    with pytest.raises(ValueError):
        PR.mix_chain(x, iters=1, nc=3, sched=sched)  # not in the library
    with pytest.raises(ValueError):
        PR.op_chain(x[:, :128].contiguous(), inject="mul", iters=1, nc=4)
    with pytest.raises(ValueError):
        PR.op_chain(x.t(), inject="mul", iters=1, nc=4)
    with pytest.raises(ValueError):
        PR.bf16_chain(x, inject="mul", bf16=True, iters=1, nc=5)


def test_mix_rate_on_the_card_is_below_the_fp32_ceiling(cuda):
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    r = RL.mix_rate_details(RENDER_LIKE, iters=16, reps=3, device=cuda)
    clock = float(PR.gpu_query("clocks.max.sm").split()[0])
    ceiling = PR.sm_count() * 128 * clock * 1e6
    assert 0 < r["rate"] <= 1.05 * ceiling
    assert r["nc"] in PR.MIX_NCS and r["per_step"] <= 257


def test_bench_runs_on_the_card_by_default(cuda, monkeypatch, capsys):
    from ray_tracer_fragment_shader_tpu_torch import bench
    for k, v in {"BENCH_SIZE": "128", "BENCH_DEPTH": "2",
                 "BENCH_ITERS": "4", "BENCH_REPS": "2"}.items():
        monkeypatch.setenv(k, v)
    out = bench.main([])
    assert out["metric"] == "rays_per_s_per_chip_fwd_bwd_128x128_depth2"
    assert out["device"] == torch.cuda.get_device_name(0)
    assert 0 < out["vs_baseline"] <= 1.05
    assert out["mix_rate_ops_per_s"] > 0


# ---- bf16_shading and the unpacked K6/K7 ---------------------------------

BF16_SCENES = dict(
    full_reflective=lambda: presets.full_reflective(size=N, depth=3),
    glass_chain=lambda: presets.glass_chain(size=N, depth=3),
    fractional_glass=lambda: presets.fractional_glass(size=N, depth=3))


def bf16_case(name):
    scene, cam, cfg = BF16_SCENES[name]()
    return scene, cam, dataclasses.replace(cfg, bf16_shading=True)


@pytest.mark.parametrize("name", list(BF16_SCENES))
def test_bf16_forwards_match_plain_and_are_deterministic(cuda, name):
    """The bf16 instantiations of K2, K5, K3 and the residual forwards:
    each its plain version's image (phase 2's budget) and, for the packed
    and residual forms, its planes; two launches bit-identical."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    scene, cam, cfg = bf16_case(name)
    tables, v, eye, kw = inputs(scene, cam, cfg, cuda)
    assert kw["bf16"]
    tree = not scene.chain_exact
    before = dict(K.LAUNCHES)
    render = K.render_tree if tree else K.render_chain
    a, b = render(tables, v, eye, **kw), render(tables, v, eye, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = (K.render_tree_ref if tree else K.render_chain_ref)(tables, v, eye,
                                                              **kw)
    assert_close_frac(ref, a, 0.01)
    key = K.launch_key("render_tree" if tree else "render_chain", True)
    assert K.LAUNCHES[key] == before[key] + 2
    img, res = K.render_residuals(tables, v, eye, tree=tree, **kw)
    img_ref, res_ref = K.render_residuals_ref(tables, v, eye, tree=tree,
                                              **kw)
    assert_close_frac(img_ref, img, 0.01)
    assert all(torch.equal(res[k], res_ref[k]) for k in res)
    if not tree:
        pack = AF.kernel_inputs(scene, cfg, N * N, device=cuda)[3]["pack"]
        img, pk = K.render_packed(tables, v, eye, pack=pack, **kw)
        img_ref, pk_ref = K.render_packed_ref(tables, v, eye, pack=pack,
                                              **kw)
        assert_close_frac(img_ref, img, 0.01)
        assert (pk != pk_ref).float().mean().item() <= 0.01
    # the variant ran: its image is not the f32 kernel's
    f32 = render(tables, v, eye, **dict(kw, bf16=False))
    assert ((a - f32).abs().amax(-1) > 1e-3).float().mean().item() > 0.01


@pytest.mark.parametrize("name", list(BF16_SCENES))
def test_bf16_fused_and_recompute_match_plain_and_k3k4(cuda, name):
    """K6 and K7 with the bf16 forward: two launches bit-identical, tables
    within 1e-3 of max|plain|; on chain scenes K6 equals K3 + K4 in bf16."""
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    scene, cam, cfg = bf16_case(name)
    camera = Camera.from_config(cam, N, N, device=cuda)
    target = K.render_image_kernel(scene, camera, cfg, device=cuda)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.5
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=cuda)
    sc, tables, kw, akw = AF.kernel_inputs(params.into_scene(scene), cfg,
                                           N * N, device=cuda)
    tree = not sc.chain_exact
    args = (tables, prep["v"], prep["eye"], prep["target"], prep["mask"])
    kw6 = dict(tree=tree, g_scale=akw["g_scale"], **kw)
    before = K.LAUNCHES["fused_adjoint_bf16"]
    a = AF.fused_adjoint(*args, **kw6)
    b = AF.fused_adjoint(*args, **kw6)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_adjoint_bf16"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = AF.fused_adjoint_ref(*args, **kw6)
    assert a[0].item() == pytest.approx(ref[0].item(), rel=1e-5)
    assert_tables_close(a[1:], ref[1:])
    if not tree:
        img, pk = K.render_packed(tables, prep["v"], prep["eye"],
                                  pack=akw["pack"], **kw)
        q = AF.adjoint_packed(tables, prep["v"], prep["eye"], img,
                              prep["target"], prep["mask"], pk, **akw)
        assert a[0].item() == pytest.approx(q[0].item(), rel=1e-5)
        assert_tables_close(a[1:], q[1:])
    render = K.render_tree if tree else K.render_chain
    g = (akw["g_scale"] * (render(tables, prep["v"], prep["eye"], **kw)
                           - prep["target"])).contiguous()
    c = AF.recompute_adjoint(tables, prep["v"], prep["eye"], g, tree=tree,
                             **kw)
    d = AF.recompute_adjoint(tables, prep["v"], prep["eye"], g, tree=tree,
                             **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    assert_tables_close(c, AF.recompute_adjoint_ref(
        tables, prep["v"], prep["eye"], g, tree=tree, **kw))


@pytest.mark.parametrize("name", ["overflow_fractional", "tree_depth_cap",
                                  "tree_depth_cap_bf16"])
def test_unpacked_k6_k7_past_the_pack_and_the_old_depth_cap(cuda, name):
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    if name == "overflow_fractional":
        scene, cam, cfg = presets.pack_overflow(size=N)
    else:
        scene, cam, cfg = presets.fractional_glass(
            size=N, depth=AF.TREE_ADJOINT_MAX_DEPTH)
        cfg = dataclasses.replace(cfg, bf16_shading=name.endswith("bf16"))
    camera = Camera.from_config(cam, N, N, device=cuda)
    target = K.render_image_kernel(scene, camera, cfg, device=cuda) * 0.9
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=cuda)
    sc, tables, kw = AF.scene_tables(scene, cfg, cuda)
    assert not sc.chain_exact
    g_scale = 2.0 / (N * N * 3)
    args = (tables, prep["v"], prep["eye"], prep["target"], prep["mask"])
    kw6 = dict(tree=True, g_scale=g_scale, **kw)
    a = AF.fused_adjoint(*args, **kw6)
    b = AF.fused_adjoint(*args, **kw6)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = AF.fused_adjoint_ref(*args, **kw6)
    assert a[0].item() == pytest.approx(ref[0].item(), rel=1e-5)
    assert_tables_close(a[1:], ref[1:])
    g = (g_scale * (K.render_tree(tables, prep["v"], prep["eye"], **kw)
                    - prep["target"]))
    g = g.contiguous()
    c = AF.recompute_adjoint(tables, prep["v"], prep["eye"], g, tree=True,
                             **kw)
    assert_tables_close(c, AF.recompute_adjoint_ref(
        tables, prep["v"], prep["eye"], g, tree=True, **kw))


def test_bf16_entry_points_run_on_the_card_by_default(cuda):
    from ray_tracer_fragment_shader_tpu_torch import (FitParams,
                                                      fit_value_and_grad)
    scene, cam, cfg = bf16_case("full_reflective")
    camera = Camera.from_config(cam, N, N)
    K.reset_launch_counts()
    target = K.render_image_kernel(scene, camera, cfg)
    params = FitParams.from_scene(scene).to(cuda)
    loss, grads = fit_value_and_grad(params, scene, camera, cfg, target)
    torch.cuda.synchronize()
    assert target.is_cuda and loss.is_cuda
    assert K.LAUNCHES["render_chain_bf16"] == 1
    assert K.LAUNCHES["render_packed_bf16"] == 1
    assert K.LAUNCHES["render_chain"] == K.LAUNCHES["render_packed"] == 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


# ---- the compacted, sparse adjoints: K4, K6, K7, K8 on edge cotangents ---

SPARSE_SCENES = {
    "full_reflective": lambda n: presets.full_reflective(size=n, depth=3),
    "procedural_spheres": lambda n: presets.procedural_spheres(n=64, size=n,
                                                               depth=3),
    "reference_demo": lambda n: (lambda s, c, f: (s, c, dataclasses.replace(
        f, width=n, height=n, samples=1)))(*presets.reference_demo()),
    "fractional_glass": lambda n: presets.fractional_glass(size=n, depth=3),
    "pack_overflow": lambda n: presets.pack_overflow(size=n),
}
#: the demo at 128^2: at 64^2 its moved sphere changes no pixel, so its real
#: cotangent is the all-zero case, where K6's loss (0) would be held
#: against the last bits of its plain version's own forward
SPARSE_SIZE = {"reference_demo": 128}


@pytest.mark.parametrize("name", list(SPARSE_SCENES))
@pytest.mark.parametrize("cot", ["real", "zero", "one"])
def test_sparse_adjoints_match_plain_and_are_deterministic(cuda, name, cot):
    """adjoint_ab.hold: every adjoint twice bit-identical, within 1e-3 of
    max|plain| (loss 1e-5 relative); all-zero: tables exactly 0, K4's loss
    the full sum; one live pixel (the hit pixel nearest the centre): some
    plain table nonzero; K8 equal to K4 bit for bit."""
    preset = SPARSE_SCENES[name](SPARSE_SIZE.get(name, N))
    adjoint_ab.hold(adjoint_ab.inputs(preset, cuda), cot)


def test_sparse_adjoints_on_a_ragged_frame(cuda):
    """57^2 = 3249 pixels, not a multiple of the 256-thread block."""
    for name in ("full_reflective", "fractional_glass"):
        adjoint_ab.hold(adjoint_ab.inputs(SPARSE_SCENES[name](57), cuda),
                        "real")


@pytest.mark.parametrize("depth", [7, 8, 10])
def test_deep_tree_k6_k7_match_plain(cuda, depth):
    """K6 and K7 on ``presets.glass_cube`` (trees that hit at every level)
    at depth 7, 8 and 10, 64^2: within 1e-3 of max|plain|, twice
    bit-identical; depth 11 refused."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    x = adjoint_ab.inputs(presets.glass_cube(size=N, depth=depth), cuda)
    assert x["tree"] and x["kw"]["depth"] == depth
    adjoint_ab.hold(x, "real")
    with pytest.raises(ValueError, match="tree depth <= 10"):
        AF.fused_adjoint(x["tables"], x["v"], x["eye"], x["target"],
                         x["mask"], tree=True, g_scale=1.0,
                         **dict(x["kw"], depth=11))


def test_compacted_wrappers_do_not_synchronise(cuda):
    """K4, K7 and K8 build their live list and run on it with no host
    synchronisation: their wrappers pass under set_sync_debug_mode
    ("error")."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    calls = adjoint_ab.calls(adjoint_ab.inputs(
        SPARSE_SCENES["full_reflective"](N), cuda), "real")
    for kname in ("adjoint_packed", "recompute_adjoint", "fit_grads"):
        adjoint_ab.run(AF, calls[kname])  # built, attributes set
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kname in ("adjoint_packed", "recompute_adjoint", "fit_grads"):
            adjoint_ab.run(AF, calls[kname])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# ---- the chain forward as redesigned for the card -------------------------

def chain_scene(nl, depth, size):
    """config 5's 66 primitives at ``depth`` under ``nl`` lights: 0, 1 or 2
    of procedural_spheres' own, or pack_overflow's 15 (a chain scene)."""
    if nl == 15:
        scene, cam, cfg = presets.pack_overflow(size=size, fractional=False)
    else:
        scene, cam, cfg = presets.procedural_spheres(n=64, size=size,
                                                     depth=depth)
        scene = scene.replace(light_pos=scene.light_pos[:nl],
                              light_color=scene.light_color[:nl])
    return scene, cam, dataclasses.replace(cfg, max_depth=depth)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("depth", [0, 5])
@pytest.mark.parametrize("nl", [0, 1, 2, 15])
def test_redesigned_chain_forward_matches_plain(cuda, nl, depth, bf16):
    """K2, K3 (where the pack holds the scene) and residual K2 on a 57^2
    frame (3249 pixels: a ragged last warp and block) against their plain
    versions: two launches bit-identical, the image within the budget,
    the planes equal; the three images bit-identical."""
    from ray_tracer_fragment_shader_tpu_torch import forward_ab
    M = adjoint_ab.modules()
    x = forward_ab.forward_input(M, chain_scene(nl, depth, 57), cuda, bf16)
    assert x["v"].shape[0] == 3249 and not x["tree"]
    assert (x["pack"] is None) == (nl == 15)
    refs = {"render_chain": K.render_chain_ref,
            "render_packed": K.render_packed_ref,
            "render_chain_residuals": lambda *a, **kw:
                K.render_residuals_ref(*a, tree=False, **kw)}
    imgs = {}
    for kernel, (name, args, kw) in forward_ab.forward_calls(x).items():
        call = (name, args, kw)
        a = forward_ab.flat_outputs(forward_ab.run_forward(M, call))
        b = forward_ab.flat_outputs(forward_ab.run_forward(M, call))
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a, b)), kernel
        ref = forward_ab.flat_outputs(refs[kernel](
            *args, **{k: v for k, v in kw.items() if k != "tree"}))
        assert_close_frac(ref[0], a[0], 0.01)
        assert all(torch.equal(p, q) for p, q in zip(a[1:], ref[1:])), kernel
        imgs[kernel] = a[0]
    assert all(torch.equal(imgs["render_chain"], i) for i in imgs.values())


# ---- K6 redesigned: on the chain the records forward, the live list and
# the adjoint on the records; on the tree one dispatch -----------------------

@pytest.mark.parametrize("depth", [0, 5])
@pytest.mark.parametrize("nl", [0, 1, 2, 15])
def test_redesigned_k6_matches_plain_and_k3k4(cuda, nl, depth):
    """K6 on a 57^2 frame (3249 pixels: a ragged last warp and block) of
    config 5's primitives under nl lights, every pixel live: twice
    bit-identical, within 1e-3 of max|plain| (loss 1e-5 relative), and
    equal to K3+K4 bit for bit where the pack holds the scene."""
    x = adjoint_ab.inputs(chain_scene(nl, depth, 57), cuda)
    assert x["v"].shape[0] == 3249 and not x["tree"]
    assert ("akw" in x) == (nl != 15)
    report = adjoint_ab.hold(x, "live")
    assert "fused_adjoint" in report


@pytest.mark.parametrize("cot", ["zero", "one"])
def test_redesigned_k6_edge_cotangents(cuda, cot):
    """All-zero: every table exactly 0 and K6's loss, the full sum, equal
    to K4's; one live pixel: some table nonzero, the loss K4's."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    x = adjoint_ab.inputs(presets.full_reflective(size=N, depth=3), cuda)
    adjoint_ab.hold(x, cot)
    fns = adjoint_ab.calls(x, cot)
    k6 = adjoint_ab.run(AF, fns["fused_adjoint"])
    k4 = adjoint_ab.run(AF, fns["adjoint_packed"])
    assert torch.equal(k6[0], k4[0]) and k6[0].item() > 0
    if cot == "zero":
        assert all(not bool(t.any()) for t in k6[1:])
    else:
        assert any(bool(t.any()) for t in k6[1:])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("depth", [5, 7, 10])
def test_redesigned_k6_tree_at_each_cap(cuda, depth, bf16):
    """The tree K6 on ``presets.glass_cube`` (trees that hit at every
    level) at depths 5, 7 and 10, f32 and bf16: within 1e-3 of
    max|plain|, twice bit-identical."""
    x = adjoint_ab.inputs(presets.glass_cube(size=48, depth=depth), cuda,
                          bf16)
    assert x["tree"]
    adjoint_ab.hold(x, "real")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("depth", [0, 3, 5])
def test_tree_forward_image_and_planes(cuda, depth, bf16):
    """K5 and residual K5 on a 57^2 frame of fractional_glass: two launches
    bit-identical, K5's image equal to residual K5's bit for bit, the
    planes equal to the plain version's, the image within the budget."""
    scene, cam, cfg = presets.fractional_glass(size=57, depth=depth)
    cfg = dataclasses.replace(cfg, bf16_shading=bf16)
    tables, v, eye, kw = inputs(scene, cam, cfg, cuda)
    img = K.render_tree(tables, v, eye, **kw)
    img2, res = K.render_residuals(tables, v, eye, tree=True, **kw)
    again = K.render_tree(tables, v, eye, **kw)
    torch.cuda.synchronize()
    assert torch.equal(img, again) and torch.equal(img, img2)
    ref_img, ref = K.render_residuals_ref(tables, v, eye, tree=True, **kw)
    assert_close_frac(ref_img, img, 0.01)
    assert all(torch.equal(res[k], ref[k]) for k in ref)


# ---- the core renderer (plain PyTorch on the card, no kernel) ------------

@pytest.mark.parametrize("name", ["full_reflective", "reference_demo",
                                  "fractional_glass"])
def test_core_render_on_the_card_matches_the_cpu(cuda, name):
    """The core renderer (core/renderer.py) on the card against itself on
    the CPU at 64^2, phase 2's budget; it launches no kernel."""
    from ray_tracer_fragment_shader_tpu_torch.core.renderer import (
        render_image)
    scene, cam, cfg, budget = case(name)
    K.reset_launch_counts()
    img = render_image(scene, cam, cfg, device=cuda)
    torch.cuda.synchronize()
    assert img.is_cuda and not any(K.LAUNCHES.values())
    assert_close_frac(render_image(scene, cam, cfg, device="cpu"),
                      img.cpu(), budget)


def test_core_l2_loss_gradients_on_the_card_match_the_cpu(cuda):
    """``diff/fit.py::l2_loss`` by autograd through the core renderer at
    64^2 (full_reflective d3, sphere centres moved by 1.5): each gradient
    table on the card within 1e-3 of max|CPU|, no kernel launched."""
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (FitParams,
                                                              l2_loss)
    from ray_tracer_fragment_shader_tpu_torch.core.renderer import (
        render_image)
    scene, cam, cfg, _ = case("full_reflective")
    target = render_image(scene, cam, cfg, device="cpu")
    grads = {}
    K.reset_launch_counts()
    for dev in ("cpu", cuda):
        params = FitParams.from_scene(scene).to(dev)
        with torch.no_grad():
            params.sph_center += 1.5
        l2_loss(params, scene, cam, cfg, target, device=dev).backward()
        grads[str(dev)] = {f: getattr(params, f).grad.cpu()
                           for f in FitParams.FIELDS}
    assert not any(K.LAUNCHES.values())
    for f, want in grads["cpu"].items():
        got = grads[str(cuda)][f]
        scale = max(want.abs().max().item(), 1e-12)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-3 * scale, f


# ---- the multi-rank paths (parallel/, the sharded steps) ------------------

def test_band_render_on_the_card_equals_the_full_frame(cuda):
    """Ranks 0..2 of a world of 3 in one process: the row bands of the
    chain kernel at 64^2 d3 (22-row bands, 2 padding rows), concatenated,
    equal the full frame's render bit for bit (each pixel is the same
    ray), and each band its plain version within phase 2's budget."""
    from ray_tracer_fragment_shader_tpu_torch.parallel import shard as S
    scene, cam, cfg, budget = case("full_reflective")
    camera = Camera.from_config(cam, N, N, device=cuda)
    K.reset_launch_counts()
    bands = [S.render_band(scene, camera, cfg, r, 3, device=cuda)
             for r in range(3)]
    torch.cuda.synchronize()
    assert K.LAUNCHES["render_chain"] == 3
    full = K.render_image_kernel(scene, camera, cfg, device=cuda)
    assert torch.equal(torch.cat(bands)[:N], full)
    tables = K.pack_scene(scene.to(cuda))
    for r, band in enumerate(bands):
        _, v = primary_rays(camera, S.band_points(camera, N, 22, r))
        plain = K.render_chain_ref(tables, v.contiguous(),
                                   camera.eye.tolist(),
                                   **K.render_kwargs(scene, cfg))
        assert_close_frac(plain, band.reshape(-1, 3), budget)


@pytest.mark.parametrize("name", ["full_reflective", "fractional_glass"])
def test_band_step_on_the_card_matches_plain_and_unsharded(cuda, name):
    """The band step (K3+K4 on the chain, K6's tree on fractional_glass)
    over a world of 3 in one process at 64^2: the ranks' buffers summed
    in rank order against the unsharded ``fit_value_and_grad`` on the
    card (loss within 1e-5 relative, each table within 1e-5 of max), and
    each band's K4 (fed K3's own image and residuals) or K6 against its
    plain version on the same inputs (loss within 1e-5, each table within
    1e-3 of max|plain|), as ``chip_smoke.py`` phase 19."""
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
        FitParams, band_fit_inputs, band_loss_grads)
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    scene, cam, cfg, _ = case(name)
    chain = scene.chain_exact
    camera = Camera.from_config(cam, N, N, device=cuda)
    target = K.render_image_kernel(scene, camera, cfg, device=cuda)
    params = FitParams.from_scene(scene).to(cuda)
    with torch.no_grad():
        params.sph_center += 1.5
    bands = [band_fit_inputs(camera, cfg, target, r, 3, device=cuda)
             for r in range(3)]
    K.reset_launch_counts()
    total = sum(band_loss_grads(params, scene, camera, b, twophase=chain,
                                device=cuda) for b in bands)
    torch.cuda.synchronize()
    assert {k: c for k, c in K.LAUNCHES.items() if c} == (
        {"render_packed": 3, "adjoint_packed": 3} if chain
        else {"fused_adjoint": 3})
    loss_u, grads_u = AF.fit_value_and_grad(
        params, scene, camera, cfg, target,
        mode="twophase" if chain else "fused", device=cuda)
    ref = torch.cat([(loss_u * N * N * 3).reshape(1)] + [
        grads_u[f].reshape(-1) for f in FitParams.FIELDS])
    assert abs(total[0] - ref[0]) <= 1e-5 * abs(ref[0])
    assert (total[1:] - ref[1:]).abs().max() <= 1e-5 * ref[1:].abs().max()
    for b in bands:
        v, eye, prep = b["prep"]["v"], b["prep"]["eye"], b["prep"]
        if chain:
            _, tables, kw, akw = AF.kernel_inputs(
                params.into_scene(scene), b["config"], b["denom"] / 3,
                device=cuda)
            img, pk = K.render_packed(tables, v, eye, pack=akw["pack"], **kw)
            args = (tables, v, eye, img, prep["target"], prep["mask"], pk)
            got = AF.adjoint_packed(*args, **akw)
            want = AF.adjoint_packed_ref(*args, **akw)
        else:
            _, tables, kw = AF.scene_tables(params.into_scene(scene),
                                            b["config"], cuda)
            args = (tables, v, eye, prep["target"], prep["mask"])
            kw6 = dict(tree=True, g_scale=2.0 / b["denom"], **kw)
            got = AF.fused_adjoint(*args, **kw6)
            want = AF.fused_adjoint_ref(*args, **kw6)
        assert abs(got[0] - want[0]) <= 1e-5 * max(abs(want[0]), 1e-30)
        for g, w in zip(got[1:], want[1:]):
            assert (g - w).abs().max() <= 1e-3 * max(w.abs().max(), 1e-30)


def test_one_rank_nccl_step_matches_the_kernel_step(cuda):
    """A one-rank NCCL group through ``initialize_multihost``: 3 Adam
    steps of ``make_sharded_fit_step_kernel`` at 64^2 (full_reflective
    d3, centres + 1.5), the first loss equal to ``make_fit_step_kernel``'s
    bit for bit, the loss falling; ``render_image_sharded`` gathers the
    kernel back end's one band."""
    import socket
    import torch.distributed as dist
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
        FitParams, make_fit_step_kernel, make_sharded_fit_step_kernel)
    from ray_tracer_fragment_shader_tpu_torch.parallel import (
        make_mesh, render_image_sharded)
    from ray_tracer_fragment_shader_tpu_torch.parallel.multihost import (
        initialize_multihost)
    scene, cam, cfg, _ = case("full_reflective")
    camera = Camera.from_config(cam, N, N, device=cuda)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"localhost:{port}", num_processes=1, process_id=0)
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
        target = render_image_sharded(scene, camera, cfg, mesh,
                                      backend="kernel")
        assert torch.equal(target, K.render_image_kernel(scene, camera, cfg,
                                                         device=cuda))

        def moved():
            p = FitParams.from_scene(scene).to(cuda)
            with torch.no_grad():
                p.sph_center += 1.5
            return p
        p_ref, params = moved(), moved()
        loss_ref = make_fit_step_kernel(
            scene, camera, cfg, target,
            torch.optim.Adam([p_ref.sph_center], lr=0.3), device=cuda)(p_ref)
        step = make_sharded_fit_step_kernel(
            scene, camera, cfg, target,
            torch.optim.Adam([params.sph_center], lr=0.3), mesh)
        losses = [float(step(params)) for _ in range(3)]
        assert losses[0] == float(loss_ref)
        assert losses[-1] < losses[0]
    finally:
        dist.destroy_process_group()


# ---- the cell scripts (ray_tracer_fragment_shader_tpu_torch/scripts/) -----

def test_depth_sweep_on_the_card(cuda, tmp_path):
    """``depth_sweep.main`` at 64^2, 2 iterations: one build record, every
    row timed beside the card's name and power limit, live pixels in every
    fwd+bwd row, and its kernels launched."""
    from ray_tracer_fragment_shader_tpu_torch.scripts import depth_sweep
    K.reset_launch_counts()
    out = depth_sweep.main(["--size", "64", "--tree-size", "64", "--iters",
                            "2", "--reps", "1", "--out",
                            str(tmp_path / "sweep.json")])
    assert out["device"] == torch.cuda.get_device_name(0)
    assert out["power_limit"] and set(out["build"]) == {"seconds", "built"}
    assert len(out["rows"]) == 9
    for row in out["rows"]:
        assert row["step_ms"] > 0
        if row["kernel"] == "fused_fwd_bwd":
            assert row["live_pixels"] > 0
    for k in ("render_chain", "render_tree", "render_packed",
              "adjoint_packed"):
        assert K.LAUNCHES[k] > 0, k


def test_reference_frame_on_the_card_matches_the_cpu(cuda):
    """The reference's frame at 64^2 (16 samples, adaptive) on the card and
    through the plain version on the CPU, on one jitter tensor: phase 2's
    2 % budget; ``samples_rendered`` counts K2's launches."""
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import sample_jitter
    from ray_tracer_fragment_shader_tpu_torch.scripts import (
        bench_reference_demo as BD)
    imgs = {}
    for dev in (torch.device("cpu"), cuda):
        c = BD.demo_case(dev, size=N)
        cfg = c["config"]
        gen = torch.Generator().manual_seed(cfg.seed)
        jit = torch.stack([sample_jitter(gen, N * N, cfg.jitter_scale)
                           for _ in range(cfg.samples)]).to(dev)
        imgs[dev.type] = BD.frame(c, dev, jitter=jit).cpu()
    assert_close_frac(imgs["cpu"], imgs["cuda"], 0.02)
    before = K.LAUNCHES["render_chain"]
    n = BD.samples_rendered(BD.demo_case(cuda, size=N), cuda)
    assert 1 <= n <= 16 and K.LAUNCHES["render_chain"] - before == n


def test_fit_demo_on_the_card_launches_no_kernel(cuda, tmp_path):
    """``make_fit_demo.fit_demo`` in a short form at 32^2 on the card: the
    core only, the loss falls, five files."""
    from ray_tracer_fragment_shader_tpu_torch.scripts import make_fit_demo
    K.reset_launch_counts()
    rep = make_fit_demo.fit_demo(size=32, out=str(tmp_path), device=cuda,
                                 restarts=1, restart_steps=2,
                                 steps_per_sigma=3, light_polish_steps=3)
    assert not any(K.LAUNCHES.values())
    assert rep["loss_fit"] < rep["loss_init"]
    assert len(os.listdir(tmp_path)) == 5
