"""The port's cell scripts (ray_tracer_fragment_shader_tpu_torch.scripts:
depth_sweep, bench_reference_demo, make_fit_demo) on the CPU, against the
JAX package's scripts and core.

* Each module's ``main`` with ``--device cpu`` at a tiny size, 2 iterations
  and 1 repeat writes JSON with the keys of the JAX script's committed
  output (``artifacts/``) plus the port's own.
* The depth sweep's depth-5 chain image and depth-4 tree image against the
  JAX core's ``render_image``, and its depth-5 fwd+bwd loss and gradient
  tables against ``jax.value_and_grad`` of the JAX core's ``l2_loss`` on
  the same parameters and target.
* The fit demo's perturbation equals JAX's bit for bit, and
  ``recovery_report`` on it equals JAX's.

The JAX side runs in two subprocesses started as the module starts
(``tests/torch_scripts_ref.py``'s two parts, ``tests/torch_jax_ref.py``: no
fused multiply-adds in XLA's CPU programs).

Tolerances: images to phase 2's budget of chip_smoke.py (at most 1 % of
pixels over 1e-3, means within 1 %).  The depth-5 fwd+bwd step is the
kernel path's (the plain versions of K3 and K4 here) against the JAX
core's autodiff, which the core tests hold at 1e-5 relative (loss) and
5e-4 of max (tables) for the port's core against JAX's.  Through five
mirror bounces the kernel path's arithmetic (kernels/render.py::
_PlainOps) and the core's part by up to 5e-4 on a pixel of the moved
scene with no pixel changing topology, and the loss and tables part with
them: over odd sizes 13-25 at most 4.3e-4 relative (loss, 15^2) and
9.6e-4 of max (tables, 21^2).  So this comparison holds the loss within
1e-3 relative and each table within 2e-3 of max|JAX|.  It runs at 16^2,
an even size: the middle row's rays meet the board on a checker square's
edge, where the kernel path forms a triangle's hit point as the core
does, o + m*v (measured at 16^2: 0 pixels over 1e-3, the loss within
4.6e-6 relative, the tables within 1.3e-4 of max; with the point formed
as o + |v|*m*u the two images part on 1.6 % and 2.0 % of the pixels and
the loss by 0.68 relative).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import torch_jax_ref
import torch_scripts_ref as R
from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from torch_scripts_ref import FIELDS, MOVE, REPORT_KEYS, SEED, SIZE
from ray_tracer_fragment_shader_tpu_torch.diff.multiview import (
    recovery_report)
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets
from ray_tracer_fragment_shader_tpu_torch.scripts import (
    bench_reference_demo as BD)
from ray_tracer_fragment_shader_tpu_torch.scripts import depth_sweep as DS
from ray_tracer_fragment_shader_tpu_torch.scripts import make_fit_demo as FD

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")
LOSS_TOL, GRAD_TOL = 1e-3, 2e-3
#: the rows main writes: JAX's groups and depths
ROWS = ([("chain", d) for d in DS.CHAIN_DEPTHS]
        + [("fused_fwd_bwd", d) for d in DS.CHAIN_DEPTHS]
        + [("tree", d) for d in DS.TREE_DEPTHS])
DEMO_FILES = ("before.png", "target.png", "after.png", "triptych.png",
              "recovery.json")


def jax_keys(name):
    with open(os.path.join(ARTIFACTS, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fwd_bwd():
    """The depth sweep's depth-5 fwd+bwd row at SIZE^2: its case and the
    step's (loss, gradients) at its start."""
    assert DS.MOVE == MOVE
    c = DS.fwd_bwd_case(SIZE, 5, CPU)
    loss, grads = DS.fwd_bwd_step(c, CPU)
    return c, loss, grads


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory, fwd_bwd):
    """The module's JAX subprocesses, one a part of the reference, given the
    port's depth-5 target."""
    target = fwd_bwd[0]["target"].numpy()
    tmp = tmp_path_factory.mktemp("jax_scripts")
    pending = [torch_jax_ref.start(R.__file__, tmp / f"{part}.npz",
                                   inputs=dict(target=target), extra=[part])
               for part in R.PARTS]
    yield pending
    for p in pending:
        p.cancel()


@pytest.fixture(scope="module")
def ref(jax_side):
    out = {}
    for p in jax_side:
        out.update(p.result())
    return out


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    path = tmp_path_factory.mktemp("sweep") / "depth_sweep.json"
    out = DS.main(["--device", "cpu", "--size", "9", "--tree-size", "9",
                   "--iters", "2", "--reps", "1", "--out", str(path)])
    with open(path) as f:
        assert json.load(f) == out
    return out


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    path = tmp_path_factory.mktemp("demo") / "demo.json"
    out = BD.main(["--device", "cpu", "--size", "5", "--iters", "2",
                   "--reps", "1", "--out", str(path)])
    with open(path) as f:
        assert json.load(f) == out
    return out


@pytest.fixture(scope="module")
def fit_demo(tmp_path_factory):
    """A short make_fit_demo at 32^2: one restart, 3 steps a sigma, 2 race
    and 3 polish steps."""
    out = tmp_path_factory.mktemp("fit_demo")
    report = FD.main(["--device", "cpu", "--size", "32", "--steps-per-sigma",
                      "3", "--restarts", "1", "--restart-steps", "2",
                      "--polish-steps", "3", "--out", str(out)])
    return out, report


def budget_of(want, got, budget=0.01):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    frac = float((np.abs(got - want).max(-1) > 1e-3).mean())
    rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-12)
    assert frac <= budget, f"{frac:.4f} of pixels off (budget {budget})"
    assert rel <= 0.01, rel
    return frac


def rel_max(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.abs(want - got).max() / max(np.abs(want).max(), 1e-12)


# ------------------------------------------------------------ main's JSON

@pytest.mark.parametrize("kernel,depth", ROWS)
def test_depth_sweep_row(sweep, kernel, depth):
    """Each row: JAX's keys (``compile_s`` replaced by ``warmup_s``), a
    positive step time and rate; the fwd+bwd rows their mode and live
    pixels, the tree rows their node count."""
    jax_row = next(r for r in jax_keys("depth_sweep.json")["rows"]
                   if (r["kernel"], r["depth"]) == (kernel, depth))
    row = next(r for r in sweep["rows"]
               if (r["kernel"], r["depth"]) == (kernel, depth))
    extra = {"warmup_s", "iters", "spread"}
    if kernel == "fused_fwd_bwd":
        extra |= {"mode", "live_pixels"}
        assert row["mode"] == "twophase"
        assert row["live_pixels"] > 0
    assert set(row) == (set(jax_row) - {"compile_s"}) | extra
    assert row["size"] == 9 and row["iters"] == 2
    assert row["step_ms"] > 0 and row["mrays_per_s"] >= 0
    assert row["warmup_s"] > 0
    if kernel == "tree":
        assert row["nodes"] == 2 ** (depth + 1) - 1


def test_depth_sweep_output(sweep):
    assert set(sweep) == set(jax_keys("depth_sweep.json")) | {
        "power_limit", "build"}
    assert (sweep["device"], sweep["power_limit"], sweep["build"]) == (
        "cpu", None, None)
    assert [(r["kernel"], r["depth"]) for r in sweep["rows"]] == ROWS


def test_demo_output_keys(demo):
    assert set(demo) == set(jax_keys("bench_reference_demo.json")) | {
        "power_limit", "samples_rendered", "traced_rays_per_s"}
    assert demo["metric"] == "reference_default_frame_ms"
    assert demo["timing"]["iters"] == 2 and demo["timing"]["reps"] == 1
    assert len(demo["frame_time_ms_reps"]) == 1


def test_demo_ray_accounting(demo):
    """``rays_per_s`` counts every one of the 16 samples, as JAX's;
    ``traced_rays_per_s`` the samples one frame rendered, at most 16."""
    assert 1 <= demo["samples_rendered"] <= 16
    dt = demo["frame_time_ms"] / 1e3
    assert demo["rays_per_s"] == pytest.approx(5 * 5 * 16 / dt, rel=1e-3)
    assert demo["traced_rays_per_s"] == pytest.approx(
        5 * 5 * demo["samples_rendered"] / dt, rel=1e-3)


def test_demo_samples_stop_at_convergence():
    """Identical samples (no jitter) converge at the second: one frame
    renders 2 of its 16 (the adaptive loop stops launching)."""
    c = BD.demo_case(CPU, size=4)
    c["config"] = dataclasses.replace(c["config"], jitter_scale=0.0,
                                      max_depth=1)
    assert BD.samples_rendered(c, CPU) == 2


@pytest.mark.parametrize("name", DEMO_FILES)
def test_fit_demo_writes(fit_demo, name):
    out, _ = fit_demo
    path = out / name
    assert path.exists() and path.stat().st_size > 0


def test_fit_demo_report(fit_demo):
    out, report = fit_demo
    with open(out / "recovery.json") as f:
        written = json.load(f)
    assert set(written) == set(jax_keys(os.path.join(
        "fit_demo", "recovery.json"))) | {"power_limit", "recipe"}
    assert written["loss_fit"] <= written["loss_init"]
    assert written["recipe"]["steps_per_sigma"] == 3
    assert len(written["restart_losses"]) == 1
    # the stages at 32^2 (the recipe's 64 and 128 are above it): 3 sigmas,
    # then the light polish
    assert [s["size"] for s in written["stage_log"]] == [32] * 4
    assert report["init_errors"] == written["init_errors"]


@pytest.mark.parametrize("module", [DS, BD, FD])
def test_scripts_need_the_card_or_an_explicit_cpu(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--out", os.devnull])


# ------------------------------------------------- against the JAX package

def test_depth5_chain_image_matches_jax_core(ref):
    img = DS.render_frame(DS.chain_case(SIZE, 5, CPU), CPU)
    print("chain d5:", budget_of(ref["chain_d5"], img.numpy()),
          "of pixels over 1e-3")


def test_depth4_tree_image_matches_jax_core(ref):
    c = DS.tree_case(SIZE, 4, CPU)
    assert not c["scene"].chain_exact
    img = DS.render_frame(c, CPU)
    print("tree d4:", budget_of(ref["tree_d4"], img.numpy()),
          "of pixels over 1e-3")


def test_depth5_fwd_bwd_loss_matches_jax_core(ref, fwd_bwd):
    _, loss, _ = fwd_bwd
    rel = abs(float(loss) - float(ref["loss"])) / float(ref["loss"])
    print(f"loss rel {rel:.3g}")
    assert rel <= LOSS_TOL


@pytest.mark.parametrize("field", FIELDS)
def test_depth5_fwd_bwd_grads_match_jax_core(ref, fwd_bwd, field):
    _, _, grads = fwd_bwd
    want = ref[f"grad/{field}"]
    assert np.abs(want).max() > 0
    r = rel_max(want, grads[field].numpy())
    print(f"{field}: {r:.3g} of max")
    assert r <= GRAD_TOL


@pytest.mark.parametrize("field", FIELDS)
def test_perturbed_init_equals_jax(ref, field):
    scene = tpresets.fit_target(size=SIZE)[0]
    got = getattr(FD.perturbed_init(scene, SEED), field).detach().numpy()
    want = ref[f"init/{field}"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("key", REPORT_KEYS)
def test_recovery_report_equals_jax(ref, key):
    scene = tpresets.fit_target(size=SIZE)[0]
    got = recovery_report(FD.perturbed_init(scene, SEED), scene)[key]
    assert got == float(ref[f"report/{key}"])
