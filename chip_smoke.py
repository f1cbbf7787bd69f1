#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the device (name and power limit as nvidia-smi reports them, torch and
   CUDA versions) and the kernels' build from ``kernels/csrc/`` (nvcc);
2. each kernel against its plain PyTorch version on the card, same inputs,
   at 128x128: the fraction of pixels whose max-channel difference exceeds
   1e-3 must stay within 1% (2% for reference_demo, whose horizon row is
   checker-parity noise), and the image means must agree within 1%;
3. the main path through the port's CLI (``cli.main(["render", ...])``,
   writing PNGs under chiprun_out/chip_smoke/): BASELINE config 3
   (full_reflective, 1024^2, depth 3), reference_demo at its own 500^2,
   depth 5, 16-sample adaptive, config 5 (procedural_spheres n=64, 4096^2,
   depth 3) and full_reflective at 1024^2 forced to the tree kernel.  The
   launch counters, zeroed just before, must show every kernel launched;
   every image must be finite and non-black.  Each single-sample image
   (1024^2 chain, 4096^2 chain, 1024^2 tree) must match its kernel's plain
   version on the same rays within phase 2's budget; the jittered adaptive
   demo is checked for finite, non-black pixels only;
4. the fit kernels against their plain versions at 128^2, on
   full_reflective d3, procedural_spheres n=64 d3 and glass_chain d3 (a
   transmitting two-light chain): the packed forward (K3) within phase 2's
   image budget, with at most that fraction of packed residuals
   differing, and whether its image is bit-identical to the chain
   kernel's; the adjoint (K4), fed the kernel's own image and residuals
   (target: the unperturbed render; parameters: sphere centres + 1.5),
   with the loss within 1e-5 relative, each gradient table within
   max|diff| <= 1e-3 max|plain|, and two launches bit-identical;
5. the fit path, with the launch counters zeroed just before: config 3
   (1024^2 d3) ``fit_value_and_grad``, then 5 Adam steps of
   ``make_fit_step_kernel`` from sphere centres + 1.5 with the loss
   falling; config 4 through the CLI (``fit --size 512 --steps 20``) with
   the loss falling; config 5 (2048^2 d3) ``fit_value_and_grad``.  The
   counters must show K3 and K4 launched; config 3's and config 5's losses
   and gradients are then held against the plain version on the same
   inputs, as in phase 4;
6. the fused fit kernels K6 and K7 against their plain versions at 128^2, on
   the scenes of phase 4 and fractional_glass d3 (the tree), parameters
   sphere centres + 1.5, target the unperturbed render: K6
   (``fused_adjoint``) and K7 (``recompute_adjoint``, cotangent
   (2/denom)(img - target)), each twice bit-identical, with the loss within
   1e-5 relative and each gradient table within 1e-3 of max|plain| over the
   full frame; on the chain scenes K6 also against K3+K4 to the same
   tolerances;
7. this slice's paths at full width, each with the launch counters zeroed
   just before it and read just after: the fused chain
   (``fit_value_and_grad(mode="fused")``, config 3 1024^2 d3: K6 launched,
   K3 and K4 not); the tree fit (``fit()`` on fractional_glass 1024^2 d3,
   5 Adam steps from mat_diffuse*1.6 + 0.05, one Adam at 0.02 over every
   leaf: K6 only, the loss falls); the reference's frame (reference_demo
   500^2 d5, 16 samples adaptive, jitter from a seeded torch.Generator:
   one ``fit_value_and_grad`` from sphere centres + 1.5 with up to 16
   chain renders and as many K7, then 3 Adam steps of
   ``default_fit_optimizer``, the loss finite, the accept planes mixed);
   and the tree supersampled fit (fractional_glass 512^2 d3, 4 samples:
   K5 and K7).  Each is then held against its plain version on the same
   inputs (the same jitter), full frame, to phase 6's tolerances: K6
   launched directly on the path's inputs (bit-identical to the path's
   result where the path is one launch), the sampled paths against
   ``recompute_adjoint_ref`` per sample under the same weights.

8. each timed kernel's output against its plain version (phase 2's
   budget), then CUDA-event times of the kernel and its plain version
   (plain, kernel, kernel, plain), beside the card's name and power limit;
   for K3 and K4 at config 3 1024^2 d3 and config 5 2048^2 d3, and one
   fwd+bwd step (``fit_value_and_grad``) on the host clock.  Then K6 at
   config 3, config 5 and fractional_glass 1024^2 d3 (its plain version
   except at config 5), K6 against K3+K4 alternated (K3+K4, K6, K6, K3+K4)
   and held to phase 6's tolerances, K7 at reference_demo 500^2 d5 and
   fractional_glass 512^2 d3 (one sample each), and each path's step
   (``fit_value_and_grad``) on the host clock in ms and rays/s.  Each
   kernel's bound is the larger of its FP32 operations over 67 TFLOP/s and
   its bytes over 3.35 TB/s, counted on this run's inputs
   (``utils/opcount.py``).
9. the residual forwards against their plain versions at 128^2: the chain
   (K2's residual form) on phase 4's scenes, the tree (K5's) on
   fractional_glass d3, planes equal exactly and images within phase 2's
   budget; K8 (``fit_grads``) on phase 4's scenes under the cotangent
   (2/denom)(img - target) of the moved scene, twice bit-identical, each
   table within 1e-3 of max|plain|, and against K4 on the same inputs
   (expected equal bit for bit; printed, and held to 1e-3);
10. this slice's paths at full width, each with the launch counters zeroed
   just before it and read just after: the split fit
   (``fit_value_and_grad(mode="split")``, config 3 1024^2 d3, 5 Adam steps
   of ``default_fit_optimizer``; its first step held against the two-phase
   path), ``render_image_diff`` fwd+bwd through ``l2_loss_kernel`` at
   config 3 (gradients to FitParams, held against K8's, and to all six
   camera tensors, finite), one split step at config 5 2048^2 d3 held
   against two-phase, and ``render_image_diff`` on fractional_glass 1024^2
   d3 through the residual tree, held against K6's tree tables;
11. the BASELINE gradient bar on the card (``grad_bar.main``: K8 on
   fit_target 128^2, K7's tree on a two-light fractional scene 64^2, eye
   gradients of ``render_image_diff`` 64^2), max-abs-err <= 1e-4 against
   f64 finite differences, written to chiprun_out/grad_bar_h100.json;
12. times: the residual chain at config 3 and the residual tree at
   fractional_glass 1024^2 d3 against their plain versions; K8 at config 3
   and config 5 2048^2 with K4 alternated (K4, K8, K8, K4), its plain
   version at config 3; the split step and the ``render_image_diff`` step
   on the host clock;
13. the probes (``probe_phase``): the op-class blends of the bench's
   chain forward, two-phase and fused steps at config 3 and of the tree
   forward at fractional_glass 1024^2 d3 (at most four K9 schedules), K9's
   libraries for them and P3's, P1's and P2's built at once with
   -fmad=false, their registers and spills (ptxas) and the SASS opcodes of
   P1's mul, add and mix (no FFMA); P2's SASS census (what one chain step
   of each hot loop issues, by pipe: the bf16 mul one packed multiply,
   some on HFMA2.MMA; the bf16 mix 8 packed, 2 MUFU, 1 pack and no FP32
   arithmetic but rsqrtf's rescale, at most 2 a MUFU); K9 on each blend and P1's 14 classes against their plain
   versions at two tiles and 8 iterations, twice bit-identical (f32 within
   1e-5 of max|plain|), every P2 instantiation (mul and mix, f32 and bf16,
   each chain count) bit-identical to its plain version; K9's rate for
   each blend and the P1 mul rate, each at most 1.05 of SMs x 128 x the SM
   clock sampled during the run; with the launch counters zeroed just
   before each: ``bench.main`` at config 3 (``vs_baseline`` in (0, 1.05]),
   P1 and P2 at 64 iterations (P2's bf16/f32 speedups and each row's share
   of its bound), P3 over 2, 8, 32 and 96 chains; the probes' times against
   their plain versions (P2's bf16 mix and mul against bounds priced pipe
   by pipe, ``probes/common.py::chain_step_bound``); and each render and
   fit kernel's bound at K9's rate for its family's blend (``k9_bound_ms``
   in the ``kernels`` line, the larger of that and its bytes' time).
14. ``bf16_shading`` and the unpacked K6/K7 (``bf16_phase``): K6/K7's
   local memory per tree depth cap (ptxas) and what it reserves for the
   card's resident threads; the SASS census of the library's bf16 HFMA2
   (none may fuse a multiply and an add); at 128^2 each bf16 kernel (K2,
   K3, K5, the residual K2/K5, K6 and K7, chain and tree) against its plain
   version (phase 2's budget, planes equal), K6/K7 twice bit-identical
   within 1e-3 of max|plain| and K6 against K3+K4 in bf16 (bit-equality
   printed); K6/K7 in f32 on ``presets.pack_overflow`` (past the 2^24
   pack) and on a tree at the deepest cap; then, each with the launch
   counters zeroed just before and read just after, the bf16 path at full width: ``render_image_kernel``
   at config 3 and ``fractional_glass`` 1024^2 d3, ``fit_value_and_grad``
   in the twophase, fused and split modes at config 3 (each held against
   K6's plain version), 5 Adam steps of ``make_fit_step_kernel`` with the
   loss falling, ``render_image_diff`` at config 3 and on the tree, the
   tree fit, and 2-sample fits at config 3 and on the tree 512^2 (K7,
   against ``recompute_adjoint_ref`` per sample); every bf16 kernel must
   have launched.  Then each bf16 kernel's time beside its f32 sibling on
   the same inputs (plain, f32, bf16, bf16, f32, plain), its bounds (the
   data sheet's, bf16 operations priced as FP32 ones, and K9's rate for
   the f32 kernel's blend) and ``bf16_ab.py``
   (chiprun_out/bf16_shading_ab_h100.json).
15. the compacted, sparse adjoints (``sparse_phase``, on
   ``adjoint_ab.py``'s inputs and checks): K4, K6, K7 and K8, each twice
   bit-identical and against its plain version (loss within 1e-5
   relative, each table within 1e-3 of max|plain|), under the real
   cotangent, an all-zero one (every table exactly 0, K4's and K6's loss
   the full sum) and one live pixel (the hit pixel nearest the frame's
   centre; some plain table nonzero), at config 3, config 5 2048^2,
   reference_demo 500^2 d5, fractional_glass 1024^2 d3 (the tree),
   pack_overflow 128^2 and a 57^2 frame (3249 pixels, not a multiple of
   256); K8 under K4's cotangent equal to K4 bit for bit; K6/K7 on
   ``presets.glass_cube`` 64^2 (trees that hit at every level) at depths
   7, 8 and 10, and the refusal at depth 11; the K4, K7 and K8 wrappers
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   synchronisation); with the launch counters zeroed just before each, the
   tree fit on glass_cube 128^2 d10 (K6) and a 2-sample fit on glass_cube
   128^2 d8 (K5 and K7), each held against its plain version; and
   ``adjoint_ab.py``'s times of K4, K6, K7 and K8 under the real, an
   all-zero and an all-live cotangent, with the live pixels counted and
   each wrapper's host time a call, and the host-clock times of the
   config 3 fwd+bwd step (two-phase and split), the 500^2 d5 16-spp
   frame differentiated and ``render_image_diff`` on the tree
   (chiprun_out/adjoint_ab_h100.json).
16. the chain forward as redesigned for the card (``chain_phase``): the
   SASS census of its sweep loops (instructions a primitive test on the
   fast trip, by class), ptxas's registers and spills and the blocks a SM
   holds (``forward_ab.py``); K2, K3 and residual K2, f32 and bf16, twice
   bit-identical and against their plain versions (phase 2's budget,
   planes equal) on config 3, config 5, glass_chain (nearest-occluder
   shadows), pack_overflow (15 lights: K2 and residual K2) and a 57^2
   frame (a ragged last warp), K3's image equal to K2's and residual K2's
   bit for bit; the sweeps' lane efficiency at config 5 2048^2
   (``opcount.lane_efficiency``); and, with the counters zeroed, a config
   5 2048^2 frame (K2, held against its plain version) and a two-phase
   fit step there (K3).
17. K6 redesigned for the card (``k6_phase``: on the chain the records
   forward at the chain forward's launch bounds, the live list, the
   adjoint on the records; on the tree one dispatch): ptxas's registers,
   stack and spills and the blocks a SM of every K6 kernel and of K5; K6,
   chain and tree, f32 and bf16, on config 3, glass_chain, a 57^2 frame,
   fractional_glass and glass_cube at depths 5, 7 and 10 (the tree caps),
   under the real cotangent and in f32 the all-zero and one-live ones,
   twice bit-identical and within 1e-3 of max|plain|
   (``adjoint_ab.hold``), the chain K6 equal to K3+K4 bit for bit; K5 and
   residual K5 on fractional_glass 57^2 at depths 0, 3 and 5 (planes
   equal to the plain version's, K5's image equal to residual K5's bit
   for bit); and, with the counters zeroed, a fused fit step at config 5
   2048^2 (K6 alone) equal to the two-phase step bit for bit.
18. the core renderer (``core_phase``: core/renderer.py, plain PyTorch on
   the card, no kernel; the launch counters must read zero across it):
   its images at config 3 1024^2 d3 (chain), reference_demo 500^2 d5
   16-spp adaptive (one jitter tensor fed to both) and fractional_glass
   1024^2 d3 (tree) against the kernel path's, phase 2's budget; its
   uniform-cotangent gradients of mean(render_image) at config 3 against
   ``render_image_diff``'s (5e-3 of max for the geometry, 3e-2 for light
   and materials, tests/test_adjoint.py:47-49), every table nonzero;
   ``fit_soft`` and the CLI's ``fit --views 3`` at 128^2 (finite, the loss
   falls); and the host-clock times of the core forward frame and
   ``l2_loss`` fwd+bwd step at config 3 beside K2's frame and the K3+K4
   step, with the step's peak memory and the kernel path's factor over
   naive autodiff.
19. the multi-rank paths (``parallel_phase``: parallel/ and the sharded
   fit steps of diff/fit.py), at full width, ranks 0..2 of a world of 3
   run one after another in this process (1024 rows: 342-row bands, 2
   padding rows, a masked tail): the kernel band render at config 3
   against ``render_image_kernel`` of the full frame (the differing
   pixels printed, bit-identical expected; phase 2's budget) and each
   band against its plain version; the band step at config 3 (K3+K4) and
   on fractional_glass 1024^2 d3 (K6's tree), with the counters zeroed
   just before and read just after, its ranks' buffers summed in rank
   order against the unsharded ``fit_value_and_grad`` (loss within 1e-5
   relative, each table within 1e-5 of max|table|) and each band's K4 or
   K6 against its plain version (phase 4's tolerances); then a one-rank
   NCCL group through ``initialize_multihost``: 5 Adam steps of
   ``make_sharded_fit_step_kernel`` at config 3 from centres + 1.5 (K3
   and K4 counted, the loss falls, the first loss equal to
   ``make_fit_step_kernel``'s bit for bit) and one ``scaling_sweep`` row
   at world 1 (step ms and rays/s beside the card's name and power
   limit).
20. the cell scripts (``scripts_phase``: ray_tracer_fragment_shader_tpu_
   torch/scripts/), each run by its own functions with the launch counters
   zeroed just before and read just after: ``depth_sweep.sweep`` at full
   width, 8 iterations and 1 repeat, mode "twophase" (K2, K3, K4 and K5
   launched, K6 not; every row printed beside the card's name and power
   limit; every fwd+bwd row with live pixels), then its depth-5 chain image
   (1024^2) and depth-4 tree image (512^2) against their plain versions
   (phase 2's budget), its depth-5 two-phase step's K3 image and residuals
   and its loss and tables against the plain versions on K3's outputs
   (phase 4's tolerances), and one depth-5 step with mode="fused" (K6
   alone) against it (phase 6's); ``bench_reference_demo.bench`` at its
   defaults (K2 alone; ``frame_time_ms``, ``samples_rendered`` and both
   ray rates printed), its frame on the seeded jitter tensor equal to the
   bench's bit for bit and held against the same adaptive loop with the
   chain kernel's plain version in place of K2 (2 % budget); and
   ``make_fit_demo.fit_demo`` in a short form (64^2, 3 views, 1 restart of
   3 steps, 5 steps a sigma, 5 polish steps; no kernel launched, the loss
   falls, its five files written under chiprun_out/chip_smoke/fit_demo_64/).
21. the look-at scanline of even-size frames (``checker_edge_phase``): a
   triangle's hit point is o + m*v in every kernel; ``render_image_kernel``
   renders the reference's 500^2 frame at one sample and config 3 (K2) and
   fractional_glass 1024^2 d3 (K5), the counters zeroed just before; each
   frame's middle row, whose rays meet the board on a checker square's
   edge, is held against its plain version and against the port's f64
   oracle (oracle/numpy_ref.py): no primary hit may take another material
   than the oracle's, and a pixel over 1e-3 passes only where a later
   bounce meets the board on a square's edge (a tie float32 cannot
   settle) and the card's colour is within 1e-3 of the oracle's with that
   bounce on the other square; the row's residual planes (residual K2 / K5) and K3's packed
   planes equal the plain version's; then K2, K3, K5, the residual forms,
   K4, K6, K7 and K8 are timed as in phase 8 (counts and times in
   chiprun_out/chip_smoke/checker_edge.json).
A kernel's ``max_abs_err`` in the ``kernels`` line is the largest over
every check (for K4, over the gradient tables), and ``max_mismatch_frac``
(forward kernels) the largest fraction of pixels over 1e-3.  The bf16 rows
(``<kernel>_bf16``) name the f32 kernel's source and TPU kernel, with the
bf16 branches in ``variant``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port's package beside this file, it fails before printing any result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
FRAC_TOL = 1e-3      # per-pixel max-channel difference counted as a mismatch
MEAN_REL_TOL = 0.01  # relative difference of the image means
GRAD_REL_TOL = 1e-3  # max|kernel - plain| / max|plain| per gradient table
LOSS_REL_TOL = 1e-5
KERNEL_SOURCES = {
    "render_chain": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                     "render_chain.cu",
                     "ray_tracer_fragment_shader_tpu/kernels/render_pallas.py"
                     ":737"),
    "render_tree": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                    "render_tree.cu",
                    "ray_tracer_fragment_shader_tpu/kernels/render_pallas.py"
                    ":901"),
    "render_packed": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                      "render_chain.cu",
                      "ray_tracer_fragment_shader_tpu/kernels/"
                      "render_pallas.py:765"),
    "adjoint_packed": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                       "adjoint_packed.cu",
                       "ray_tracer_fragment_shader_tpu/kernels/"
                       "adjoint_fused.py:866"),
    "fused_adjoint": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                      "adjoint_fused.cu",
                      "ray_tracer_fragment_shader_tpu/kernels/"
                      "adjoint_fused.py:1031"),
    "recompute_adjoint": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                          "adjoint_fused.cu",
                          "ray_tracer_fragment_shader_tpu/kernels/"
                          "adjoint_fused.py:1123"),
    "render_chain_residuals": ("ray_tracer_fragment_shader_tpu_torch/kernels/"
                               "csrc/render_chain.cu",
                               "ray_tracer_fragment_shader_tpu/kernels/"
                               "render_pallas.py:737"),
    "render_tree_residuals": ("ray_tracer_fragment_shader_tpu_torch/kernels/"
                              "csrc/render_tree.cu",
                              "ray_tracer_fragment_shader_tpu/kernels/"
                              "render_pallas.py:901"),
    "fit_grads": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                  "fit_grads.cu",
                  "ray_tracer_fragment_shader_tpu/kernels/"
                  "adjoint_fused.py:814"),
    "mix_chain": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                  "mix_probe.cu",
                  "ray_tracer_fragment_shader_tpu/utils/roofline.py:161"),
    "op_chain": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                 "op_probe.cu", "scripts/vpu_op_probe.py:119"),
    "bf16_chain": ("ray_tracer_fragment_shader_tpu_torch/kernels/csrc/"
                   "bf16_probe.cu", "scripts/bf16_probe.py:71"),
}
#: tolerances of the probes against their plain versions (max|diff| /
#: max|plain|): f32 chains 1e-5 (rsqrtf and rcp.approx.f32 are not IEEE,
#: a few ulps a step), bf16 chains 2^-7 (one bf16 rounding of rsqrtf's
#: result may differ)
PROBE_TOL, BF16_TOL = 1e-5, 2.0 ** -7
#: a chain rate above this share of SMs x 128 x the SM clock was folded
CEILING_SHARE = 1.05
#: the K9 blend phase 13 prices each render and fit kernel's bound at:
#: the blend of its family's bench step (the adjoints K4 and K8 share
#: chain_adjoint; K7 is K6's source) or the tree forward
FAMILY = {"render_chain": "chain forward", "render_packed": "chain forward",
          "render_chain_residuals": "chain forward",
          "render_tree": "tree forward",
          "render_tree_residuals": "tree forward",
          "adjoint_packed": "two-phase fwd+bwd",
          "fit_grads": "two-phase fwd+bwd",
          "fused_adjoint": "fused fwd+bwd",
          "recompute_adjoint": "fused fwd+bwd"}
FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient")
#: phase 14's rows: each kernel's bf16_shading variant (the instantiation of
#: its source with BF16), counted apart by its wrapper (render.launch_key);
#: the TPU kernel is the same pallas_call built with bf16_shading=True
#: (_make_tile_ops's bf16 branches, render_pallas.py:310-371 and :540-555)
BF16_ROWS = {f"{k}_bf16": k for k in (
    "render_chain", "render_tree", "render_packed", "render_chain_residuals",
    "render_tree_residuals", "fused_adjoint", "recompute_adjoint")}
BF16_CODE = ("ray_tracer_fragment_shader_tpu/kernels/render_pallas.py"
             ":310-371,540-555")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def compare(img, ref, budget):
    """Mismatch fraction, max abs error and mean agreement of two images."""
    import torch
    d = (img - ref).abs().amax(-1)
    frac = (d > FRAC_TOL).float().mean().item()
    mi, mr = img.mean().item(), ref.mean().item()
    rel = abs(mi - mr) / max(abs(mr), 1e-12)
    ok = (frac <= budget and rel <= MEAN_REL_TOL
          and bool(torch.isfinite(img).all()))
    return dict(frac=frac, max_abs_err=d.max().item(), mean=mi,
                plain_mean=mr, mean_rel=rel, budget=budget, ok=ok)


def rel_err(got, ref):
    """max|got - ref| / max|ref| (0 where ref is all 0 and got equals it)."""
    scale = ref.abs().max().item()
    diff = (got - ref).abs().max().item()
    return diff / scale if scale > 0 else diff


def fit_inputs(K, AF, dev, preset, dc=1.5, params=None):
    """The fit kernels' inputs on scene ``preset`` with its sphere centres
    moved by ``dc`` (or with ``params``): the tables, rays, target, mask and
    keywords of ``AF.scene_tables``, ``tree`` (the scene is not
    chain-exact), the parameters, camera and config; ``akw``, the adjoint's
    keywords of ``AF.kernel_inputs`` on chain scenes, only the cotangent
    scale on tree scenes (they take K6/K7, which need no pack); on chain
    scenes also the packed kernel's image and residuals (img, pk).  The
    target is the unperturbed scene's kernel render."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
    scene, cam, cfg = preset
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    target = K.render_image_kernel(scene, camera, cfg, device=dev)
    if params is None:
        params = FitParams.from_scene(scene)
        with torch.no_grad():
            params.sph_center += dc
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=dev)
    v, eye = prep["v"], prep["eye"]
    scene_c, tables, kw = AF.scene_tables(params.into_scene(scene), cfg, dev)
    tree = not scene_c.chain_exact
    akw = (dict(g_scale=2.0 / (v.shape[0] * 3)) if tree else
           AF.kernel_inputs(params.into_scene(scene), cfg, v.shape[0],
                            device=dev)[3])
    x = dict(tables=tables, v=v, eye=eye, kw=kw, target=prep["target"],
             mask=prep["mask"], akw=akw, tree=tree,
             scene=scene, scene_c=scene_c, params=params, camera=camera,
             cfg=cfg)
    if not x["tree"]:
        x["img"], x["pk"] = K.render_packed(tables, v, eye, pack=akw["pack"],
                                            **kw)
    return x


def fused_args(x):
    """(args, keywords) of fused_adjoint / fused_adjoint_ref on ``x``."""
    return ((x["tables"], x["v"], x["eye"], x["target"], x["mask"]),
            dict(tree=x["tree"], g_scale=x["akw"]["g_scale"], **x["kw"]))


def recompute_args(K, x):
    """(args, keywords) of recompute_adjoint / recompute_adjoint_ref on
    ``x``: the cotangent is (2/denom)(img - target), img the chain or tree
    kernel's render of the moved scene."""
    render = K.render_tree if x["tree"] else K.render_chain
    img = render(x["tables"], x["v"], x["eye"], **x["kw"])
    g = (x["akw"]["g_scale"] * (img - x["target"])).contiguous()
    return ((x["tables"], x["v"], x["eye"], g),
            dict(tree=x["tree"], **x["kw"]))


def hold_grads(kname, label, got, ref, against="plain"):
    """Holds a fit kernel's output ``got`` against its plain version's
    ``ref`` (or what ``against`` names), both (loss, dsph, dmat, dlight) or,
    for K7, (dsph, dmat, dlight): the loss within LOSS_REL_TOL, each
    gradient table within max|diff| <= GRAD_REL_TOL max|ref|.  Returns the
    largest absolute table difference."""
    import torch
    torch.cuda.synchronize()
    msg = ""
    loss_rel = 0.0
    if len(got) == 4:
        loss_rel = abs(got[0].item() - ref[0].item()) / max(
            abs(ref[0].item()), 1e-30)
        msg = (f"loss {got[0].item():.7g} vs {against} {ref[0].item():.7g} "
               f"(rel {loss_rel:.2e}); ")
        got, ref = got[1:], ref[1:]
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    print(f"{kname} {label}: {msg}max|diff|/max|{against}| dsph "
          f"{errs[0]:.2e} dmat {errs[1]:.2e} dlight {errs[2]:.2e} "
          f"(tolerance {GRAD_REL_TOL})")
    check(loss_rel <= LOSS_REL_TOL and max(errs) <= GRAD_REL_TOL,
          f"{kname} disagrees with {against} on {label}")
    return max((g - r).abs().max().item() for g, r in zip(got, ref))


def twice(fn, kname, label):
    """Two launches of ``fn``, which must give bit-identical outputs."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    ident = all(torch.equal(p, q) for p, q in zip(a, b))
    print(f"check {kname} {label}: two launches bit-identical: {ident}")
    check(ident, f"{kname} is not deterministic on {label}")
    return a


def as_fields(AF, x, tables):
    """Gradient tables (dsph, dmat, dlight) of the compacted scene of ``x``
    as FitParams fields."""
    return AF.grads_to_fitparams(x["params"], x["scene"],
                                 AF._grads_c(x["scene_c"], *tables))


def hold_fields(kname, label, loss, grads, ref_loss, ref, against="plain"):
    """A path's (loss, FitParams gradients) against the plain version's (or
    what ``against`` names), to hold_grads' tolerances, field by field."""
    loss_rel = abs(float(loss) - float(ref_loss)) / max(abs(float(ref_loss)),
                                                        1e-30)
    errs = {f: rel_err(grads[f], ref[f]) for f in FIELDS}
    print(f"{kname} {label}: loss {float(loss):.7g} vs {against} "
          f"{float(ref_loss):.7g} (rel {loss_rel:.2e}); max|diff|/max|"
          f"{against}| " + " ".join(f"{f} {e:.2e}" for f, e in errs.items())
          + f" (tolerance {GRAD_REL_TOL})")
    check(loss_rel <= LOSS_REL_TOL and max(errs.values()) <= GRAD_REL_TOL,
          f"{kname} disagrees with {against} on {label}")
    return max((grads[f] - ref[f]).abs().max().item() for f in FIELDS)


def sampled_plain(AF, K, dev, preset, params, jitter):
    """The plain version of a supersampled or adaptive fit on the same
    inputs as ``fit_value_and_grad`` (the [S, P, 3] ``jitter``): its
    forward (``AF.sampled_forward``, the chain or tree kernel per sample),
    then per sample ``recompute_adjoint_ref`` in place of K7.  Returns
    (loss, FitParams gradients, the rendered samples' accept planes)."""
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
    scene, cam, cfg = preset
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    target = K.render_image_kernel(scene, camera, cfg, jitter=jitter,
                                   device=dev)
    fw = AF.sampled_forward(params.into_scene(scene), camera, cfg, target,
                            jitter=jitter, device=dev)
    sums = None
    for v, g in zip(fw["rays"], fw["cots"]):
        t = AF.recompute_adjoint_ref(fw["tables"], v, fw["eye"], g,
                                     tree=fw["tree"], **fw["kw"])
        sums = t if sums is None else tuple(a + b for a, b in zip(sums, t))
    grads = AF.grads_to_fitparams(params, scene,
                                  AF._grads_c(fw["scene_c"], *sums))
    return fw["loss"], grads, fw["accepts"]


def hold_adjoint(AF, label, x, got):
    """Holds ``got``, what adjoint_packed gave on the inputs ``x``, against
    adjoint_packed_ref on the same inputs (``hold_grads``)."""
    ref = AF.adjoint_packed_ref(x["tables"], x["v"], x["eye"], x["img"],
                                x["target"], x["mask"], x["pk"], **x["akw"])
    return hold_grads("adjoint_packed", label, got, ref)


def hold_probe(kname, label, got, ref, tol):
    """A probe kernel's output against its plain version's: max|diff| <=
    tol * max|plain|.  Returns max|diff|."""
    import torch
    rel = rel_err(got, ref)
    print(f"check {kname:10s} {label:34s} max|diff|/max|plain| {rel:.3e} "
          f"(tolerance {tol:.3g})")
    check(bool(torch.isfinite(got).all()) and rel <= tol,
          f"{kname} disagrees with its plain version on {label}")
    return (got - ref).abs().max().item()


def fused_stack_frames(log: str):
    """{(tree, bf16, cap): stack-frame bytes} of the one-dispatch
    instantiations (K6's tree form, K7; csrc/adjoint_fused.cu's
    fused_adjoint_kernel<TREE, EXTERNAL_G, WANT_TRANS, BF16, TREE_CAP>) in
    a ptxas -v log."""
    import re
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*fused_adjoint_kernelILb(\d)"
                      r"ELb\dELb\dELb(\d)ELi(\d+)E", line)
        if m:
            key = (bool(int(m.group(1))), bool(int(m.group(2))),
                   int(m.group(3)))
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and key is not None:
            out[key] = max(out.get(key, 0), int(m.group(1)))
            key = None
    return out


def bf16_fma_census(library: str):
    """{"mul", "add", "fused"}: the bfloat16 HFMA2 instructions in the
    SASS of ``library`` (cuobjdump -sass) that multiply (addend -RZ), add
    (multiplier 1, 1) or fuse a multiply and an add.  The bf16 forms use
    only __hmul_rn/__hadd_rn/__hsub_rn, each rounded alone; nvcc emits some
    of them as HFMA2 with a unit multiplier or a zero addend, which rounds
    once as the operation does.  A fused one would round a product and a
    sum once together, as JAX's per-op bf16 does not."""
    import re
    from ray_tracer_fragment_shader_tpu_torch.kernels.probe import sass_text
    out = {"mul": 0, "add": 0, "fused": 0, "fused_lines": []}
    for line in sass_text(library).splitlines():
        m = re.search(r"HFMA2[.A-Z0-9_]*BF16[.A-Z0-9_]*\s+([^;]*);", line)
        if not m:
            continue
        ops = [o.strip().split(".")[0] for o in m.group(1).split(",")]
        if ops[-1] in ("-RZ", "RZ"):
            out["mul"] += 1
        elif len(ops) == 5 and ops[2] == "1" and ops[3] == "1":
            out["add"] += 1
        else:
            out["fused"] += 1
            out["fused_lines"] = (out["fused_lines"] + [line.strip()])[:5]
    return out


def bf16_phase(dev, card, launches, errs, fracs, times, bounds, k9):
    """Phase 14: the bf16_shading variants and the unpacked K6/K7.  Fills
    ``launches``, ``errs``, ``fracs``, ``times``, ``bounds`` and ``k9`` for
    the BF16_ROWS."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch import bf16_ab
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
        FitParams, make_fit_step_kernel)
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
        l2_loss_kernel)
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
        Camera, primary_rays, sample_jitter, screen_points)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    from ray_tracer_fragment_shader_tpu_torch.utils import opcount
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    from ray_tracer_fragment_shader_tpu_torch.utils.timing import time_ms
    t14 = time.perf_counter()
    n = 128

    def bf(preset):
        scene, cam, cfg = preset
        return scene, cam, dataclasses.replace(cfg, bf16_shading=True)

    for k in BF16_ROWS:
        errs[k] = []
    fracs.update({k: [] for k in BF16_ROWS if "adjoint" not in k})

    # -- the build: K6/K7's local memory at each depth cap, no fused bf16
    frames = fused_stack_frames(cuda_build.build_info.get("log", ""))
    resident = AF.resident_threads(dev)
    for (tree, bf16, cap), b in sorted(frames.items()):
        print(f"ptxas fused_adjoint_kernel tree={tree} bf16={bf16}"
              + (f" cap={cap}" if tree else "") + f": {b} B stack frame "
              f"a thread = {b * resident / 2**30:.3f} GiB reserved for "
              f"{resident} resident threads [{card}]")
    if frames:
        caps = sorted({c for (t, _, c) in frames if t})
        check(caps == list(AF.TREE_ADJOINT_DEPTH_CAPS),
              f"tree caps built {caps}, the wrapper's "
              f"{AF.TREE_ADJOINT_DEPTH_CAPS}")
    census = bf16_fma_census(cuda_build.build_info["path"])
    print(f"SASS bf16 HFMA2 of the kernel library: {census} (fused must be "
          f"0)")
    check(census["fused"] == 0, "a bf16 multiply and add were fused")

    # -- each bf16 kernel against its plain version at 128^2
    def hold_img(kname, label, img, ref, budget=0.01):
        r = compare(img, ref.reshape(img.shape), budget)
        errs[kname].append(r["max_abs_err"])
        fracs[kname].append(r["frac"])
        print(f"check {kname:28s} {label:30s}: {r['frac']:.5f} of pixels > "
              f"{FRAC_TOL} (budget {budget}), max abs err "
              f"{r['max_abs_err']:.4g}, mean {r['mean']:.6f} vs plain "
              f"{r['plain_mean']:.6f}")
        check(r["ok"], f"{kname} disagrees with its plain version on "
                       f"{label}")

    def rays(preset):
        scene, cam, cfg = preset
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        _, v = primary_rays(camera, screen_points(camera, cfg.width,
                                                  cfg.height))
        return (K.pack_scene(scene.to(dev)), v.contiguous(),
                camera.eye.tolist(), K.render_kwargs(scene, cfg))

    def hold_residuals(label, t, v, eye, kw, tree):
        kname = ("render_tree_residuals_bf16" if tree
                 else "render_chain_residuals_bf16")
        img, res = K.render_residuals(t, v, eye, tree=tree, **kw)
        img_ref, res_ref = K.render_residuals_ref(t, v, eye, tree=tree, **kw)
        hold_img(kname, label, img, img_ref)
        diff = {k: (res[k] != res_ref[k]).float().mean().item() for k in res}
        print(f"check {kname} {label}: planes differing from the plain "
              f"version's {diff} (must be 0)")
        check(all(d == 0.0 for d in diff.values()),
              f"{kname} planes differ on {label}")

    chain_cases = [
        ("full_reflective d3", lambda s: presets.full_reflective(size=s,
                                                                 depth=3)),
        ("procedural_spheres n64 d3",
         lambda s: presets.procedural_spheres(n=64, size=s, depth=3)),
        ("glass_chain d3", lambda s: presets.glass_chain(size=s, depth=3))]
    tree_case = ("fractional_glass d3 (tree)",
                 lambda s: presets.fractional_glass(size=s, depth=3))
    for label, make in chain_cases + [tree_case]:
        preset = bf(make(n))
        t, v, eye, kw = rays(preset)
        tree = not preset[0].chain_exact
        if not tree:
            img = K.render_chain(t, v, eye, **kw)
            hold_img("render_chain_bf16", label, img,
                     K.render_chain_ref(t, v, eye, **kw))
            f32 = K.render_chain(t, v, eye, **dict(kw, bf16=False))
            print(f"check render_chain_bf16 {label}: "
                  f"{compare(img, f32, 1.0)['frac']:.5f} of pixels > "
                  f"{FRAC_TOL} from the f32 kernel's image")
            pack = AF.kernel_inputs(preset[0], preset[2], n * n,
                                    device=dev)[3]["pack"]
            img, pk = K.render_packed(t, v, eye, pack=pack, **kw)
            img_ref, pk_ref = K.render_packed_ref(t, v, eye, pack=pack, **kw)
            hold_img("render_packed_bf16", label, img, img_ref)
            pk_frac = (pk != pk_ref).float().mean().item()
            print(f"check render_packed_bf16 {label}: {pk_frac:.5f} of packed"
                  f" residuals differ (budget 0.01)")
            check(pk_frac <= 0.01, f"render_packed_bf16 residuals, {label}")
        hold_img("render_tree_bf16", label, K.render_tree(t, v, eye, **kw),
                 K.render_tree_ref(t, v, eye, **kw))
        hold_residuals(label, t, v, eye, kw, tree)
        # K6 and K7 in bf16: twice bit-identical, against the plain version
        # and (chain) against K3+K4 in bf16
        x = fit_inputs(K, AF, dev, bf(make(n)))
        args, kw6 = fused_args(x)
        a = twice(lambda: AF.fused_adjoint(*args, **kw6),
                  "fused_adjoint_bf16", label)
        errs["fused_adjoint_bf16"].append(hold_grads(
            "fused_adjoint_bf16", label, a,
            AF.fused_adjoint_ref(*args, **kw6)))
        if not tree:
            q = AF.adjoint_packed(x["tables"], x["v"], x["eye"], x["img"],
                                  x["target"], x["mask"], x["pk"],
                                  **x["akw"])
            same = all(torch.equal(p, r) for p, r in zip(a, q))
            print(f"check fused_adjoint_bf16 {label}: equals K3+K4 in bf16 "
                  f"bit for bit: {same}")
            hold_grads("fused_adjoint_bf16", label, a, q, against="K3+K4")
        args7, kw7 = recompute_args(K, x)
        b = twice(lambda: AF.recompute_adjoint(*args7, **kw7),
                  "recompute_adjoint_bf16", label)
        errs["recompute_adjoint_bf16"].append(hold_grads(
            "recompute_adjoint_bf16", label, b,
            AF.recompute_adjoint_ref(*args7, **kw7)))
        del x, a, b, args, args7
    torch.cuda.empty_cache()

    # -- A1: K6/K7 past the pack and at the deeper tree cap, 128^2
    deep = AF.TREE_ADJOINT_MAX_DEPTH
    for label, preset in (
            ("pack_overflow fractional, 66 prims 15 lights",
             presets.pack_overflow(n)),
            (f"fractional_glass d{deep}",
             presets.fractional_glass(size=n, depth=deep)),
            (f"fractional_glass d{deep} bf16",
             bf(presets.fractional_glass(size=n, depth=deep)))):
        x = fit_inputs(K, AF, dev, preset)
        args, kw6 = fused_args(x)
        a = twice(lambda: AF.fused_adjoint(*args, **kw6), "fused_adjoint",
                  label)
        hold_grads("fused_adjoint", f"{label} (A1)", a,
                   AF.fused_adjoint_ref(*args, **kw6))
        args7, kw7 = recompute_args(K, x)
        b = twice(lambda: AF.recompute_adjoint(*args7, **kw7),
                  "recompute_adjoint", label)
        hold_grads("recompute_adjoint", f"{label} (A1)", b,
                   AF.recompute_adjoint_ref(*args7, **kw7))
        print(f"A1 {label}: tree {x['tree']}, depth {x['kw']['depth']}")
        del x, a, b, args, args7
    torch.cuda.empty_cache()

    # -- the path at full width, each with the counters zeroed just before
    bf16_launches = {k: 0 for k in BF16_ROWS}
    bf16_launches.update(adjoint_packed=0, fit_grads=0)

    def drive(label, fn, want, absent=()):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        print(f"path bf16 {label}: launches "
              f"{ {k: c for k, c in counts.items() if c} }")
        for k in want:
            check(counts[k] > 0, f"bf16 {label}: never launched {k}")
        for k in absent:
            check(counts[k] == 0, f"bf16 {label}: launched {k}")
        for k in bf16_launches:
            bf16_launches[k] += counts[k]
        return out, counts

    fr3 = bf(presets.full_reflective(size=1024, depth=3))
    fg3 = bf(presets.fractional_glass(size=1024, depth=3))
    f32_kernels = [k for k in BF16_ROWS.values()]
    for label, preset, kname in (
            ("serve config 3 1024^2 d3", fr3, "render_chain_bf16"),
            ("serve fractional_glass 1024^2 d3", fg3, "render_tree_bf16")):
        scene, cam, cfg = preset
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        img, _ = drive(label, lambda: K.render_image_kernel(
            scene, camera, cfg, device=dev), [kname], f32_kernels)
        t, v, eye, kw = rays(preset)
        plain = K.render_tree_ref if "tree" in kname else K.render_chain_ref
        hold_img(kname, label + " (path)", img, plain(t, v, eye, **kw))
        del img, t, v
    x = fit_inputs(K, AF, dev, fr3)
    params = x["params"].to(dev)
    args, kw6 = fused_args(x)
    ref6 = AF.fused_adjoint_ref(*args, **kw6)
    P3 = x["v"].shape[0]
    ref_loss, ref = ref6[0] / (P3 * 3), as_fields(AF, x, ref6[1:])
    for mode, want in (("twophase", ["render_packed_bf16", "adjoint_packed"]),
                       ("fused", ["fused_adjoint_bf16"]),
                       ("split", ["render_chain_residuals_bf16",
                                  "fit_grads"])):
        (loss, grads), _ = drive(
            f"fit_value_and_grad {mode} config 3 1024^2 d3",
            lambda: AF.fit_value_and_grad(params, x["scene"], x["camera"],
                                          x["cfg"], x["target"], mode=mode,
                                          device=dev), want, f32_kernels)
        err = hold_fields(want[0], f"bf16 {mode} config 3 1024^2 d3 (path)",
                          loss, grads, ref_loss, ref, against="K6 plain")
        if mode == "fused":
            errs["fused_adjoint_bf16"].append(err)
    loss_f32, g_f32 = AF.fit_value_and_grad(
        params, x["scene"], x["camera"],
        dataclasses.replace(x["cfg"], bf16_shading=False), x["target"],
        mode="twophase", device=dev)
    rel = {f: rel_err(ref[f], g_f32[f]) for f in FIELDS}
    print(f"path bf16 config 3: loss {float(ref_loss):.7g} vs the f32 "
          f"path's {float(loss_f32):.7g}; gradients' max|bf16 - f32| / "
          f"max|f32| " + " ".join(f"{f} {e:.3e}" for f, e in rel.items()))
    check(float(ref_loss) != float(loss_f32), "bf16 path returned f32")

    # make_fit_step_kernel: 5 Adam steps from sphere centres + 1.5
    step_params = FitParams.from_scene(fr3[0]).to(dev)
    step_params.load_state_dict(x["params"].state_dict())
    step = make_fit_step_kernel(x["scene"], x["camera"], x["cfg"],
                                x["target"], torch.optim.Adam(
                                    [step_params.sph_center], lr=0.3),
                                device=dev)
    steps, _ = drive("make_fit_step_kernel 5 Adam steps config 3",
                     lambda: [float(step(step_params)) for _ in range(5)],
                     ["render_packed_bf16", "adjoint_packed"], f32_kernels)
    print(f"path bf16 make_fit_step_kernel config 3: loss "
          f"{' -> '.join(f'{v:.6g}' for v in steps)}")
    check(steps[-1] < steps[0] and all(map(math.isfinite, steps)),
          "bf16 fit step: the loss did not fall")

    # render_image_diff through l2_loss_kernel, against K6's tables
    pd = FitParams.from_scene(fr3[0]).to(dev)
    pd.load_state_dict(x["params"].state_dict())

    def diff_step():
        """l2_loss_kernel's fwd+bwd on ``pd`` and ``x``."""
        loss = l2_loss_kernel(pd, x["scene"], x["camera"], x["cfg"],
                              x["target"], device=dev)
        loss.backward()
        return loss.detach()
    loss_d, _ = drive("render_image_diff config 3 1024^2 d3", diff_step,
                      ["render_chain_residuals_bf16"], f32_kernels)
    hold_fields("render_chain_residuals_bf16",
                "render_image_diff config 3 (path)", loss_d,
                {f: getattr(pd, f).grad for f in FIELDS}, ref_loss, ref,
                against="K6 plain")
    del x, params, step_params, pd, args, ref6, ref
    torch.cuda.empty_cache()

    # the tree: K6's fit, render_image_diff, and the 2-sample fits (K7)
    x = fit_inputs(K, AF, dev, fg3)
    params = x["params"].to(dev)
    args, kw6 = fused_args(x)
    ref6 = AF.fused_adjoint_ref(*args, **kw6)
    Pt = x["v"].shape[0]
    ref_loss, ref = ref6[0] / (Pt * 3), as_fields(AF, x, ref6[1:])
    (loss, grads), _ = drive(
        "tree fit fractional_glass 1024^2 d3",
        lambda: AF.fit_value_and_grad(params, x["scene"], x["camera"],
                                      x["cfg"], x["target"], device=dev),
        ["fused_adjoint_bf16"], f32_kernels)
    errs["fused_adjoint_bf16"].append(hold_fields(
        "fused_adjoint_bf16", "tree fractional_glass 1024^2 d3 (path)", loss,
        grads, ref_loss, ref))
    pd = FitParams.from_scene(fg3[0]).to(dev)
    pd.load_state_dict(x["params"].state_dict())
    loss_d, _ = drive("render_image_diff fractional_glass 1024^2 d3",
                      diff_step, ["render_tree_residuals_bf16"], f32_kernels)
    hold_fields("render_tree_residuals_bf16", "render_image_diff tree (path)",
                loss_d, {f: getattr(pd, f).grad for f in FIELDS}, ref_loss,
                ref, against="K6 plain")
    del x, params, pd, args, ref6, ref
    torch.cuda.empty_cache()
    for label, preset, render_k in (
            ("2 spp config 3 1024^2 d3", fr3, "render_chain_bf16"),
            ("2 spp fractional_glass 512^2 d3",
             bf(presets.fractional_glass(size=512, depth=3)),
             "render_tree_bf16")):
        scene, cam, cfg = preset
        cfg = dataclasses.replace(cfg, samples=2)
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        P = cfg.width * cfg.height
        gen = torch.Generator(dev).manual_seed(cfg.seed)
        jit = torch.stack([sample_jitter(gen, P, cfg.jitter_scale).to(dev)
                           for _ in range(2)])
        target = K.render_image_kernel(scene, camera, cfg, jitter=jit,
                                       device=dev)
        start = FitParams.from_scene(scene)
        with torch.no_grad():
            start.sph_center += 1.5
        params = FitParams.from_scene(scene).to(dev)
        params.load_state_dict(start.state_dict())
        (loss, grads), _ = drive(
            label, lambda: AF.fit_value_and_grad(
                params, scene, camera, cfg, target, jitter=jit, device=dev),
            [render_k, "recompute_adjoint_bf16"], f32_kernels)
        ref_loss, ref, _ = sampled_plain(AF, K, dev, (scene, cam, cfg),
                                         start, jit)
        errs["recompute_adjoint_bf16"].append(hold_fields(
            "recompute_adjoint_bf16", f"{label} (path)", loss, grads,
            ref_loss, ref))
        del params, grads, ref, jit, target
        torch.cuda.empty_cache()
    print(f"bf16 path launched {bf16_launches}")
    for k, c in bf16_launches.items():
        check(c > 0, f"the bf16 path never launched {k}")
    launches.update({k: bf16_launches[k] for k in BF16_ROWS})

    # -- times at full width, with bounds: data sheet (bf16 + - * at twice
    # the FP32 rate, which the card reaches only on packed pairs split
    # between the FMA pipe and HFMA2.MMA) and K9's rate for the f32
    # kernel's blend, bf16 priced as f32: these kernels' scalar bf16 ops
    # and packed pairs on the FMA pipe alone issue no faster per element
    # than FP32 (P2, csrc/bf16_probe.cu)
    def four_times(pk_fn, pp_fn, reps_k, reps_p):
        t_p1 = time_ms(pp_fn, reps_p)
        t_k1, t_k2 = time_ms(pk_fn, reps_k), time_ms(pk_fn, reps_k)
        t_p2 = time_ms(pp_fn, reps_p)
        return (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2

    x = fit_inputs(K, AF, dev, fr3)
    t, v, eye, kw, akw = x["tables"], x["v"], x["eye"], x["kw"], x["akw"]
    xt = fit_inputs(K, AF, dev, fg3)
    tt, vt, eyet, kwt = xt["tables"], xt["v"], xt["eye"], xt["kw"]
    args, kw6 = fused_args(x)
    args7, kw7 = recompute_args(K, x)

    def launchers(on):
        """Each row's kernel on its timed inputs, in bf16 (``on``) or its
        f32 sibling on the same inputs."""
        c, ct = dict(kw, bf16=on), dict(kwt, bf16=on)
        c6, c7 = dict(kw6, bf16=on), dict(kw7, bf16=on)
        return {
            "render_chain_bf16": lambda: K.render_chain(t, v, eye, **c),
            "render_packed_bf16": lambda: K.render_packed(
                t, v, eye, pack=akw["pack"], **c),
            "render_chain_residuals_bf16": lambda: K.render_residuals(
                t, v, eye, tree=False, **c),
            "render_tree_bf16": lambda: K.render_tree(tt, vt, eyet, **ct),
            "render_tree_residuals_bf16": lambda: K.render_residuals(
                tt, vt, eyet, tree=True, **ct),
            "fused_adjoint_bf16": lambda: AF.fused_adjoint(*args, **c6),
            "recompute_adjoint_bf16": lambda: AF.recompute_adjoint(*args7,
                                                                   **c7)}
    timed = {
        "render_chain_bf16": (
            lambda: K.render_chain_ref(t, v, eye, **kw),
            lambda: opcount.forward_work(t, v, eye, **kw)),
        "render_packed_bf16": (
            lambda: K.render_packed_ref(t, v, eye, pack=akw["pack"], **kw),
            lambda: opcount.forward_work(t, v, eye, packed=True, **kw)),
        "render_chain_residuals_bf16": (
            lambda: K.render_residuals_ref(t, v, eye, tree=False, **kw),
            lambda: opcount.forward_work(t, v, eye, residuals=True, **kw)),
        "render_tree_bf16": (
            lambda: K.render_tree_ref(tt, vt, eyet, **kwt),
            lambda: opcount.forward_work(tt, vt, eyet, tree=True, **kwt)),
        "render_tree_residuals_bf16": (
            lambda: K.render_residuals_ref(tt, vt, eyet, tree=True, **kwt),
            lambda: opcount.forward_work(tt, vt, eyet, tree=True,
                                         residuals=True, **kwt)),
        "fused_adjoint_bf16": (
            lambda: AF.fused_adjoint_ref(*args, **kw6),
            lambda: opcount.fused_work(t, v, eye, tree=False,
                                       target=x["target"], mask=x["mask"],
                                       **kw)),
        "recompute_adjoint_bf16": (
            lambda: AF.recompute_adjoint_ref(*args7, **kw7),
            lambda: opcount.fused_work(t, v, eye, tree=False, g=args7[3],
                                       **kw)),
    }
    kerns, kerns32 = launchers(True), launchers(False)
    for kname, (plain, work_fn) in timed.items():
        # plain, f32, bf16, bf16, f32, plain
        tp1 = time_ms(plain, 1)
        t32 = [time_ms(kerns32[kname], 20)]
        tk = [time_ms(kerns[kname], 20), time_ms(kerns[kname], 20)]
        t32.append(time_ms(kerns32[kname], 20))
        tp = (tp1 + time_ms(plain, 1)) / 2
        tk, t32 = sum(tk) / 2, sum(t32) / 2
        w = work_fn()
        b = opcount.bound_ms(w["ops"], w["bytes"], w["bf16_ops"])
        f32 = BF16_ROWS[kname]
        rate = k9[f32]["k9_rate_ops_per_s"]
        t_ops = RL.flat_slots(w["classes"]) / rate * 1e3
        t_bytes = w["bytes"] / opcount.PEAK_BYTES_PER_S * 1e3
        times[kname], bounds[kname] = (tk, tp), b
        k9[kname] = dict(k9_bound_ms=max(t_ops, t_bytes),
                         k9_bound_by="operations" if t_ops >= t_bytes
                         else "bytes", k9_rate_ops_per_s=rate,
                         f32_kernel_ms_same_inputs=t32)
        label = ("fractional_glass 1024^2 d3" if "tree" in kname
                 else "config 3 1024^2 d3")
        print(f"time {kname:28s} {label}: kernel {tk:.4f} ms; its f32 "
              f"kernel on the same inputs {t32:.4f} ms (bf16/f32 "
              f"{tk / t32:.4f}); plain {tp:.2f} ms; bound {b[0]:.5f} ms "
              f"({b[1]}: {w['ops']:.4g} ops of which {w['bf16_ops']:.4g} "
              f"bf16 at twice the FP32 rate, {w['bytes']:.4g} B); at K9's "
              f"{FAMILY[f32]} rate {rate / 1e12:.4f} T: "
              f"{k9[kname]['k9_bound_ms']:.5f} ms ({k9[kname]['k9_bound_by']}"
              f") [{card}]")
    del x, xt, args, args7, timed
    torch.cuda.empty_cache()

    # -- bf16_ab.py: fwd and fwd+bwd, f32 against bf16
    check(bf16_ab.main(["--out", os.path.join(REPO, bf16_ab.OUT)]) == 0,
          "bf16_ab failed")
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")


def sparse_phase(dev, card, launches, errs):
    """Phase 15: the compacted, sparse adjoints and the tree cap at 10.
    Adds to ``launches`` and ``errs`` of K4, K6, K7 and K8."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch import adjoint_ab
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import FitParams
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
        Camera, sample_jitter)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    t15 = time.perf_counter()

    def hold(label, x, cot):
        """adjoint_ab.hold: each kernel twice bit-identical and against its
        plain version; K8 under K4's cotangent equal to K4 bit for bit."""
        report = adjoint_ab.hold(x, cot)
        for kname, r in report.items():
            errs[kname].extend(r["diffs"])
            loss_txt = ("" if r["loss_rel"] is None
                        else f"loss rel {r['loss_rel']:.2e}, ")
            print(f"check {kname:17s} {label} {cot}: two launches "
                  f"bit-identical, {loss_txt}max|diff|/max|plain| "
                  f"{r['worst']:.2e} (tolerance {adjoint_ab.GRAD_REL_TOL}), "
                  f"max|plain| {r['plain_max']:.3g}")
        if "fit_grads" in report:
            print(f"check fit_grads {label} {cot}: equals K4 bit for bit")
        if cot == "zero":
            print(f"check {label} zero: every table exactly 0")
        if cot == "one":
            print(f"check {label} one: pixel {adjoint_ab.one_pixel(x)}, "
                  f"some plain table nonzero")

    # -- 1. every adjoint against its plain version at full width
    demo, demo_cam, demo_cfg = presets.reference_demo()
    cases = [
        ("config 3 1024^2 d3", presets.full_reflective(size=1024, depth=3)),
        ("config 5 2048^2 d3",
         presets.procedural_spheres(n=64, size=2048, depth=3)),
        ("reference_demo 500^2 d5",
         (demo, demo_cam, dataclasses.replace(demo_cfg, samples=1))),
        ("fractional_glass 1024^2 d3",
         presets.fractional_glass(size=1024, depth=3)),
        ("pack_overflow 128^2 (tree)", presets.pack_overflow(128)),
        ("full_reflective 57^2 d3 (3249 pixels)",
         presets.full_reflective(size=57, depth=3))]
    for label, preset in cases:
        x = adjoint_ab.inputs(preset, dev)
        for cot in ("real", "zero", "one"):
            hold(label, x, cot)
        del x
        torch.cuda.empty_cache()

    # -- 2. K6/K7 on trees of depth 7, 8 and 10, and the refusal at 11
    for depth in (7, 8, 10):
        x = adjoint_ab.inputs(presets.glass_cube(size=64, depth=depth), dev)
        check(x["tree"], "glass_cube is not a tree scene")
        hold(f"glass_cube 64^2 d{depth}", x, "real")
    try:
        AF.fused_adjoint(x["tables"], x["v"], x["eye"], x["target"],
                         x["mask"], tree=True, g_scale=1.0,
                         **dict(x["kw"], depth=11))
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"tree depth 11: {refused}")
    check("tree depth <= 10" in refused, "tree depth 11 not refused")

    # -- 3. no host synchronisation in the compacted wrappers
    x = adjoint_ab.inputs(presets.full_reflective(size=1024, depth=3), dev)
    fns = adjoint_ab.calls(x, "real")
    for kname in ("adjoint_packed", "recompute_adjoint", "fit_grads"):
        adjoint_ab.run(AF, fns[kname])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kname in ("adjoint_packed", "recompute_adjoint", "fit_grads"):
            adjoint_ab.run(AF, fns[kname])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("check adjoint_packed, recompute_adjoint, fit_grads config 3: no "
          "host synchronisation (set_sync_debug_mode(\"error\")): True")
    del x, fns
    torch.cuda.empty_cache()

    # -- 4. the deep-tree paths, each with the counters zeroed just before
    def drive(label, fn, want):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        print(f"path {label}: launches "
              f"{ {k: c for k, c in counts.items() if c} }")
        for k in want:
            check(counts[k] > 0, f"{label}: never launched {k}")
            launches[k] += counts[k]
        return out

    x = fit_inputs(K, AF, dev, presets.glass_cube(size=128, depth=10))
    params = x["params"].to(dev)
    loss, grads = drive(
        "tree fit glass_cube 128^2 d10", lambda: AF.fit_value_and_grad(
            params, x["scene"], x["camera"], x["cfg"], x["target"],
            device=dev), ["fused_adjoint"])
    args, kw6 = fused_args(x)
    ref6 = AF.fused_adjoint_ref(*args, **kw6)
    errs["fused_adjoint"].append(hold_fields(
        "fused_adjoint", "glass_cube 128^2 d10 (path)", loss, grads,
        ref6[0] / (x["v"].shape[0] * 3), as_fields(AF, x, ref6[1:])))
    scene, cam, cfg = presets.glass_cube(size=128, depth=8)
    cfg = dataclasses.replace(cfg, samples=2)
    camera = Camera.from_config(cam, 128, 128, device=dev)
    gen = torch.Generator(dev).manual_seed(cfg.seed)
    jit = torch.stack([sample_jitter(gen, 128 * 128, cfg.jitter_scale)
                       .to(dev) for _ in range(2)])
    target = K.render_image_kernel(scene, camera, cfg, jitter=jit,
                                   device=dev)
    start = FitParams.from_scene(scene)
    with torch.no_grad():
        start.sph_center += 1.5
    params = FitParams.from_scene(scene).to(dev)
    params.load_state_dict(start.state_dict())
    loss, grads = drive(
        "2 spp fit glass_cube 128^2 d8", lambda: AF.fit_value_and_grad(
            params, scene, camera, cfg, target, jitter=jit, device=dev),
        ["render_tree", "recompute_adjoint"])
    ref_loss, ref, _ = sampled_plain(AF, K, dev, (scene, cam, cfg), start,
                                     jit)
    errs["recompute_adjoint"].append(hold_fields(
        "recompute_adjoint", "2 spp glass_cube 128^2 d8 (path)", loss, grads,
        ref_loss, ref))
    del x, params, args, ref6, grads, ref
    torch.cuda.empty_cache()

    # -- 5. the kernels under real, all-zero and all-live cotangents
    check(adjoint_ab.main(["--out", os.path.join(REPO, adjoint_ab.OUT)])
          == 0, "adjoint_ab failed")
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")


def chain_phase(dev, card, launches, errs, fracs, k9):
    """Phase 16: the chain forward as redesigned for this card (the
    sweeps' gates as predicates, the packed and bf16 residual forms built
    for 4 blocks a SM).  Adds to ``launches``, ``errs`` and ``fracs`` of
    K2, K3, residual K2 and their bf16 rows; prices K3 at config 5 2048^2
    at ``k9``'s (phase 13) chain-forward rate."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch import adjoint_ab, forward_ab
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    from ray_tracer_fragment_shader_tpu_torch.utils import opcount
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    from ray_tracer_fragment_shader_tpu_torch.utils.timing import time_ms
    t16 = time.perf_counter()
    M = adjoint_ab.modules()

    # -- the SASS census of the sweeps, ptxas's registers and spills
    census = forward_ab.chain_census(M, os.path.join(OUT_DIR, "chain_sass"))
    forward_ab.print_census("chain kernel", census, card)
    for key in forward_ab.CENSUS_KEYS:
        check(any(row["per_test"] for row in census["loops"].get(key, [])),
              f"no sweep loop found in render_chain_kernel<{key}>")

    # -- K2, K3 and residual K2 against their plain versions
    n = 128
    cases = [
        ("config 3 d3", presets.full_reflective(size=n, depth=3)),
        ("config 5 d3", presets.procedural_spheres(n=64, size=n, depth=3)),
        ("glass_chain d3", presets.glass_chain(size=n, depth=3)),
        ("pack_overflow d1 (chain, 15 lights)",
         presets.pack_overflow(size=n, fractional=False)),
        ("config 5 d3 57^2 (ragged last warp)",
         presets.procedural_spheres(n=64, size=57, depth=3))]
    refs = {"render_chain": K.render_chain_ref,
            "render_packed": K.render_packed_ref,
            "render_chain_residuals": lambda *a, **kw:
                K.render_residuals_ref(*a, tree=False, **kw)}
    for label, preset in cases:
        for bf16 in (False, True):
            x = forward_ab.forward_input(M, preset, dev, bf16)
            imgs = {}
            for kernel, call in forward_ab.forward_calls(x).items():
                kname = kernel + ("_bf16" if bf16 else "")
                got = forward_ab.flat_outputs(forward_ab.run_forward(M, call))
                again = forward_ab.flat_outputs(
                    forward_ab.run_forward(M, call))
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{kname}: two launches differ on {label}")
                _, args, kw = call
                kw = {k: v for k, v in kw.items() if k != "tree"}
                ref = forward_ab.flat_outputs(refs[kernel](*args, **kw))
                r = compare(got[0], ref[0], 0.01)
                errs.setdefault(kname, []).append(r["max_abs_err"])
                fracs.setdefault(kname, []).append(r["frac"])
                planes = all(torch.equal(a, b) for a, b in zip(got[1:],
                                                               ref[1:]))
                print(f"check {kname:26s} {label:36s}: {r['frac']:.5f} of "
                      f"pixels > {FRAC_TOL}, max abs err "
                      f"{r['max_abs_err']:.4g}, planes equal the plain "
                      f"version's {planes}, two launches bit-identical")
                check(r["ok"] and planes,
                      f"{kname} disagrees with its plain version on {label}")
                imgs[kernel] = got[0]
            same = all(torch.equal(imgs["render_chain"], img)
                       for img in imgs.values())
            print(f"check {label} {'bf16' if bf16 else 'f32'}: the images "
                  f"of {sorted(imgs)} bit-identical: {same}")
            check(same, f"K2, K3 and residual K2 images differ on {label}")
            del x
    torch.cuda.empty_cache()

    # -- how full the lanes are in the sweeps at config 5 2048^2 (the
    # plain version's count of the one-pixel-a-lane design)
    c5 = presets.procedural_spheres(n=64, size=2048, depth=3)
    x = forward_ab.forward_input(M, c5, dev, False)
    kw = {k: v for k, v in x["kw"].items() if k != "bf16"}
    eff = opcount.lane_efficiency(x["tables"], x["v"], x["eye"], **kw)
    for sweep in ("closest", "shadow"):
        e = eff[sweep]
        print(f"lanes config 5 2048^2 d3 {sweep}: {e['tests']} tests in "
              f"{e['warp_steps']} warp steps, lane efficiency "
              f"{e['efficiency']:.4f} [{card}]")
    # K3 there against its bound at K9's chain-forward rate
    w = opcount.forward_work(x["tables"], x["v"], x["eye"], packed=True,
                             **kw)
    rate = k9["render_packed"]["k9_rate_ops_per_s"]
    t_ops = RL.flat_slots(w["classes"]) / rate * 1e3
    t_bytes = w["bytes"] / opcount.PEAK_BYTES_PER_S * 1e3
    sheet = opcount.bound_ms(w["ops"], w["bytes"])
    k3 = forward_ab.forward_calls(x)["render_packed"]
    ms = time_ms(lambda: forward_ab.run_forward(M, k3), 20)
    print(f"bound render_packed config 5 2048^2 d3: data sheet "
          f"{sheet[0]:.5f} ms ({sheet[1]}); at K9's chain forward rate "
          f"{rate / 1e12:.4f} T: {max(t_ops, t_bytes):.5f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}); kernel "
          f"{ms:.4f} ms = {max(t_ops, t_bytes) / ms:.4f} of it [{card}]")

    # -- the main paths with the counters zeroed: a config 5 2048^2 frame
    # (K2) and a two-phase fit step (K3)
    scene, cam, cfg = c5
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    params = M.fit.FitParams.from_scene(scene).to(dev)
    with torch.no_grad():
        params.sph_center += 1.5
    target = []
    for label, fn, want in (
            ("serve config 5 2048^2 d3", lambda: K.render_image_kernel(
                scene, camera, cfg, device=dev), "render_chain"),
            ("fit step config 5 2048^2 d3 two-phase", lambda:
                AF.fit_value_and_grad(params, scene, camera, cfg, target[0],
                                      mode="twophase", device=dev),
             "render_packed")):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: c for k, c in K.LAUNCHES.items() if c}
        print(f"path {label}: launches {counts}")
        check(counts.get(want, 0) > 0, f"{label}: never launched {want}")
        launches[want] += counts[want]
        if want == "render_chain":
            target.append(out)
            r = compare(out.reshape(-1, 3), K.render_chain_ref(
                x["tables"], x["v"], x["eye"], **x["kw"]), 0.01)
            errs["render_chain"].append(r["max_abs_err"])
            print(f"check render_chain {label} (path): {r['frac']:.5f} of "
                  f"pixels > {FRAC_TOL}, max abs err {r['max_abs_err']:.4g}")
            check(r["ok"], f"render_chain path disagrees on {label}")
        else:
            check(math.isfinite(float(out[0])), f"{label}: loss not finite")
        del out
    del x, target, params
    torch.cuda.empty_cache()
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")


def k6_phase(dev, card, launches, errs):
    """Phase 17: K6 redesigned (on the chain the records forward, the live
    list and the adjoint on the records; on the tree one dispatch) and K5.
    Adds to ``launches`` and ``errs`` of K6, K5 and their bf16 rows."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch import adjoint_ab, forward_ab
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    t17 = time.perf_counter()
    M = adjoint_ab.modules()

    # -- registers, stack, spills and blocks a SM of K6's kernels and K5's
    fr = presets.full_reflective(size=64, depth=3)
    x = adjoint_ab.inputs(fr, dev)
    smem_t = 4 * K._flat_tables(x["tables"], x["kw"]["nl"]).numel()
    ncols = (1 + 4 * x["tables"]["sph"].shape[0]
             + 9 * x["tables"]["mat"].shape[0] + 3 * x["kw"]["nl"])
    smem_a = smem_t + 4 * (8 * ncols + AF.ADJOINT_STAGE_FLOATS)
    k6 = forward_ab.print_resources(
        "K6", adjoint_ab.k6_all(M, smem_t, smem_a), M, card)
    k5 = forward_ab.print_resources(
        "K5", [("render_tree_kernel", (wt, 0, bf),
                forward_ab.occupancy(M, "tree_occupancy", wt, 0, bf, smem_t))
               for wt in (0, 1) for bf in (0, 1)], M, card)
    check(len(k6) == 18 and all(r.get("registers") for r in k6 + k5),
          "K6's or K5's instantiations missing from the build log")

    # -- K6 against its plain version: chain and tree, f32 (real, all-zero
    # and one-live cotangents) and bf16 (real), the tree caps 5, 7 and 10;
    # the chain K6 against K3+K4
    n = 64
    cases = [("config 3 d3", presets.full_reflective(size=n, depth=3)),
             ("glass_chain d3", presets.glass_chain(size=n, depth=3)),
             ("config 5 d3 57^2", presets.procedural_spheres(n=64, size=57,
                                                             depth=3)),
             ("fractional_glass d3", presets.fractional_glass(size=n,
                                                              depth=3))]
    cases += [(f"glass_cube 32^2 d{d}", presets.glass_cube(size=32, depth=d))
              for d in (5, 7, 10)]
    for label, preset in cases:
        for bf16 in (False, True):
            x = adjoint_ab.inputs(preset, dev, bf16)
            kname = "fused_adjoint" + ("_bf16" if bf16 else "")
            for cot in ("real",) if bf16 else ("real", "zero", "one"):
                r = adjoint_ab.hold(x, cot)["fused_adjoint"]
                errs[kname].extend(r["diffs"])
                print(f"check {kname} {label} {cot}: two launches "
                      f"bit-identical, loss rel {r['loss_rel']:.2e}, "
                      f"max|diff|/max|plain| {r['worst']:.2e} (tolerance "
                      f"{adjoint_ab.GRAD_REL_TOL})")
            if "akw" in x:
                fns = adjoint_ab.calls(x, "real")
                a = adjoint_ab.run(AF, fns["fused_adjoint"])
                b = adjoint_ab.run(AF, fns["adjoint_packed"])
                same = all(torch.equal(p, q) for p, q in zip(a, b))
                print(f"check {kname} {label}: the chain K6's loss and "
                      f"tables equal K3+K4's bit for bit: {same}")
                check(same, f"{kname} is not K3+K4 bit for bit on {label}")
            del x
    torch.cuda.empty_cache()

    # -- K5 and residual K5 against their plain versions
    for depth in (0, 3, 5):
        for bf16 in (False, True):
            scene, cam, cfg = presets.fractional_glass(size=57, depth=depth)
            x = forward_ab.forward_input(
                M, (scene, cam, dataclasses.replace(cfg, bf16_shading=bf16)),
                dev, bf16)
            t, v, eye, kw = x["tables"], x["v"], x["eye"], x["kw"]
            img = K.render_tree(t, v, eye, **kw)
            img2, res = K.render_residuals(t, v, eye, tree=True, **kw)
            ref_img, ref = K.render_residuals_ref(t, v, eye, tree=True, **kw)
            r = compare(img, ref_img, 0.01)
            planes = all(torch.equal(res[k], ref[k]) for k in ref)
            kname = "render_tree" + ("_bf16" if bf16 else "")
            errs[kname].append(r["max_abs_err"])
            print(f"check {kname} fractional_glass 57^2 d{depth}: "
                  f"{r['frac']:.5f} of pixels > {FRAC_TOL}, image equal to "
                  f"residual K5's {torch.equal(img, img2)}, planes equal the "
                  f"plain version's {planes}")
            check(r["ok"] and planes and torch.equal(img, img2),
                  f"{kname} disagrees on fractional_glass d{depth}")

    # -- the main path with the counters zeroed: a fused fit step at config
    # 5 2048^2 (K6 alone), held against the two-phase step bit for bit
    scene, cam, cfg = presets.procedural_spheres(n=64, size=2048, depth=3)
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    params = M.fit.FitParams.from_scene(scene).to(dev)
    target = K.render_image_kernel(scene, camera, cfg, device=dev)
    with torch.no_grad():
        params.sph_center += 1.5
    steps = {}
    for mode, want in (("fused", "fused_adjoint"),
                       ("twophase", "render_packed")):
        K.reset_launch_counts()
        steps[mode] = AF.fit_value_and_grad(params, scene, camera, cfg,
                                            target, mode=mode, device=dev)
        torch.cuda.synchronize()
        counts = {k: c for k, c in K.LAUNCHES.items() if c}
        print(f"path fit step config 5 2048^2 d3 {mode}: launches {counts}")
        check(counts.get(want, 0) > 0, f"{mode} step never launched {want}")
        launches[want] += counts[want]
        if mode == "fused":
            check(set(counts) == {"fused_adjoint"},
                  "the fused step launched another kernel")
    (l6, g6), (l4, g4) = steps["fused"], steps["twophase"]
    same = torch.equal(l6, l4) and all(torch.equal(g6[k], g4[k]) for k in g4)
    print(f"check fit step config 5 2048^2 d3: the fused step's loss and "
          f"gradients equal the two-phase step's bit for bit: {same}")
    check(same, "the fused step differs from the two-phase step")
    del steps, params, target
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t17:.1f} s")


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: phase 19's shift of the band step's sphere centres (scene units) on top
#: of +1.5 on all: sphere 0 up into the top band, sphere 1 towards the
#: camera into the bottom band, so every band, and the rows beside the
#: masked padding, carries live pixels
REACH_BANDS = ((0, (0.0, 150.0, 0.0)), (1, (0.0, 0.0, 250.0)))


def parallel_phase(dev, card, launches, errs):
    """Phase 19: the multi-rank paths (parallel/, diff/fit.py's sharded
    steps) at full width.  Ranks 0..2 of a world of 3 run one after another
    in this process (each rank's share issues no collective): the row
    bands of the kernel render at config 3 against the full frame, and the
    band step at config 3 (K3+K4) and on fractional_glass (K6's tree),
    the ranks' buffers summed in rank order against the unsharded
    ``fit_value_and_grad`` and each band against its plain version.  Then a
    one-rank NCCL group through ``initialize_multihost``: 5 Adam steps of
    ``make_sharded_fit_step_kernel`` and one ``scaling_sweep`` row.  Adds
    to ``launches`` and ``errs`` of K2, K3, K4 and K6."""
    import socket
    import torch
    import torch.distributed as dist
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
        FitParams, band_fit_inputs, band_loss_grads, make_fit_step_kernel,
        make_sharded_fit_step_kernel)
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                               primary_rays)
    from ray_tracer_fragment_shader_tpu_torch.parallel import shard as S
    from ray_tracer_fragment_shader_tpu_torch.parallel.mesh import make_mesh
    from ray_tracer_fragment_shader_tpu_torch.parallel.multihost import (
        initialize_multihost, scaling_sweep)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    t19 = time.perf_counter()
    world = 3
    fr3 = presets.full_reflective(size=1024, depth=3)
    fg3 = presets.fractional_glass(size=1024, depth=3)
    size = fr3[2].height
    h_pad, hs = S.band_split(size, world)
    print(f"phase 19: a world of {world} at {size} rows: {hs}-row bands, "
          f"{h_pad - size} padding rows")

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        _sync(dev)
        return out, {k: c for k, c in K.LAUNCHES.items() if c}

    def camera_of(preset):
        scene, cam, cfg = preset
        return Camera.from_config(cam, cfg.width, cfg.height, device=dev)

    # -- 1. the kernel band render at config 3 against the full frame
    scene, _, cfg = fr3
    cam = camera_of(fr3)
    bands, counts = counted(lambda: [
        S.render_band(scene, cam, cfg, r, world, device=dev)
        for r in range(world)])
    print(f"path band render config 3 {size}^2 d3, {world} ranks: launches "
          f"{counts}")
    check(counts == {"render_chain": world},
          f"the band render launched {counts}")
    launches["render_chain"] += counts["render_chain"]
    full = K.render_image_kernel(scene, cam, cfg, device=dev)
    img = torch.cat(bands)[:size]
    ndiff = int((img != full).any(-1).sum())
    c = compare(img, full, 0.01)
    print(f"check band render config 3: {ndiff} pixels differ from the full "
          f"frame's render (bit-identical expected); {c['frac']:.6f} over "
          f"1e-3, max abs {c['max_abs_err']:.3g} [{card}]")
    check(c["ok"], "the band render disagrees with the full frame")
    for r, band in enumerate(bands):   # each band against its plain version
        tables = K.pack_scene(scene.to(dev))
        _, v = primary_rays(cam, S.band_points(cam, cfg.width, hs, r))
        plain = K.render_chain_ref(tables, v.contiguous(), cam.eye.tolist(),
                                   **K.render_kwargs(scene, cfg))
        c = compare(band.reshape(-1, 3), plain, 0.01)
        errs["render_chain"].append(c["max_abs_err"])
        print(f"check band {r} render_chain against its plain version: "
              f"{c['frac']:.6f} over 1e-3")
        check(c["ok"], f"band {r}'s render disagrees with its plain version")
    del bands, full, img

    # -- 2. the band step: K3+K4 at config 3, K6's tree on fractional_glass
    for label, preset, twophase, want in (
            (f"config 3 {size}^2 d3", fr3, True,
             {"render_packed": world, "adjoint_packed": world}),
            (f"fractional_glass {size}^2 d3", fg3, False,
             {"fused_adjoint": world})):
        scene, _, cfg = preset
        cam = camera_of(preset)
        target = K.render_image_kernel(scene, cam, cfg, device=dev)
        params = FitParams.from_scene(scene).to(dev)
        with torch.no_grad():
            params.sph_center += 1.5
            for i, shift in REACH_BANDS:
                params.sph_center[i] += torch.tensor(shift, device=dev)
        loss_u, grads_u = AF.fit_value_and_grad(
            params, scene, cam, cfg, target,
            mode="twophase" if twophase else "fused", device=dev)
        inputs = [band_fit_inputs(cam, cfg, target, r, world, device=dev)
                  for r in range(world)]
        bufs, counts = counted(lambda: [
            band_loss_grads(params, scene, cam, b, twophase=twophase,
                            device=dev) for b in inputs])
        print(f"path band step {label}, {world} ranks: launches {counts}")
        check(counts == want, f"the band step launched {counts}")
        for k, n in counts.items():
            launches[k] += n
        band_sq = [float(b[0]) for b in bufs]
        print(f"band step {label}: each band's squared-error sum "
              + " ".join(f"{x:.7g}" for x in band_sq))
        check(min(band_sq) > 0, f"a band of {label} has no live pixel")
        total = bufs[0].clone()
        for b in bufs[1:]:
            total += b
        sq, grads = S.unflatten_grads(total, {f: getattr(params, f)
                                              for f in FIELDS})
        loss = sq / float(size * size * 3)
        loss_rel = abs(float(loss) - float(loss_u)) / float(loss_u)
        tab = {f: rel_err(grads[f], grads_u[f].reshape(grads[f].shape))
               for f in FIELDS}
        print(f"check band step {label}: rank sums against the unsharded "
              f"fit_value_and_grad: loss {float(loss):.8g} vs "
              f"{float(loss_u):.8g} (rel {loss_rel:.2e}); max|diff|/max|"
              f"table| " + " ".join(f"{f} {e:.2e}" for f, e in tab.items())
              + f" (tolerance 1e-5) [{card}]")
        check(loss_rel <= 1e-5 and max(tab.values()) <= 1e-5,
              f"the band step's rank sums disagree with the unsharded step "
              f"on {label}")
        for r, b in enumerate(inputs):   # each band against its plain version
            v, eye, prep = b["prep"]["v"], b["prep"]["eye"], b["prep"]
            if twophase:
                _, tables, kw, akw = AF.kernel_inputs(
                    params.into_scene(scene), b["config"], b["denom"] / 3,
                    device=dev)
                img, pk = K.render_packed(tables, v, eye, pack=akw["pack"],
                                          **kw)
                args = (tables, v, eye, img, prep["target"], prep["mask"], pk)
                errs["adjoint_packed"].append(hold_grads(
                    "adjoint_packed", f"band {r} of {label}",
                    AF.adjoint_packed(*args, **akw),
                    AF.adjoint_packed_ref(*args, **akw)))
            else:
                _, tables, kw = AF.scene_tables(params.into_scene(scene),
                                                b["config"], dev)
                args = (tables, v, eye, prep["target"], prep["mask"])
                kw6 = dict(tree=True, g_scale=2.0 / b["denom"], **kw)
                errs["fused_adjoint"].append(hold_grads(
                    "fused_adjoint", f"band {r} of {label}",
                    AF.fused_adjoint(*args, **kw6),
                    AF.fused_adjoint_ref(*args, **kw6)))
        del inputs, bufs, target, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- 3. a one-rank group through initialize_multihost: 5 Adam steps of
    # the band step at config 3, its first loss equal to make_fit_step_
    # kernel's bit for bit, and one scaling_sweep row
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_multihost(f"localhost:{port}", num_processes=1, process_id=0)
    mesh = make_mesh()
    print(f"one-rank group: backend {dist.get_backend()}, rank {mesh.rank} "
          f"of {mesh.size}, device {mesh.device}")
    check(mesh.size == 1 and mesh.device.type == dev.type,
          f"the one-rank group's mesh is {mesh}")
    scene, _, cfg = fr3
    cam = camera_of(fr3)
    target = K.render_image_kernel(scene, cam, cfg, device=dev)

    def moved():
        p = FitParams.from_scene(scene).to(dev)
        with torch.no_grad():
            p.sph_center += 1.5
        return p
    p_ref = moved()
    # phase 5's optimizer: Adam at 0.3 on the centres
    loss_ref = make_fit_step_kernel(
        scene, cam, cfg, target, torch.optim.Adam([p_ref.sph_center], lr=0.3),
        device=dev)(p_ref)
    params = moved()
    step = make_sharded_fit_step_kernel(
        scene, cam, cfg, target, torch.optim.Adam([params.sph_center],
                                                  lr=0.3), mesh)
    losses, counts = counted(lambda: [step(params) for _ in range(5)])
    losses = [float(x) for x in losses]
    print(f"path one-rank {dist.get_backend()} make_sharded_fit_step_kernel "
          f"config 3, 5 Adam steps: launches {counts}; losses "
          + " ".join(f"{x:.7g}" for x in losses))
    check(counts == {"render_packed": 5, "adjoint_packed": 5},
          f"the one-rank step launched {counts}")
    for k, n in counts.items():
        launches[k] += n
    same = losses[0] == float(loss_ref)
    print(f"check one-rank step: first loss {losses[0]!r} equals "
          f"make_fit_step_kernel's {float(loss_ref)!r} bit for bit: {same}")
    check(same, "the one-rank sharded step's first loss differs from "
          "make_fit_step_kernel's")
    check(losses[-1] < losses[0], "the one-rank sharded step's loss did not "
          "fall")
    row = scaling_sweep(scene, cam, cfg, mesh_sizes=[1], iters=4, reps=3)[0]
    print(f"time scaling_sweep world 1 config 3 {size}^2 d3: step "
          f"{row['step_time_s'] * 1e3:.4f} ms ({row['timing_method']}, "
          f"spread {row['timing_spread']}) = {row['rays_per_s']:.1f} rays/s, "
          f"loss {row['loss']:.7g} [{card}]")
    dist.destroy_process_group()
    del target, params, p_ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"phase 19: {time.perf_counter() - t19:.1f} s")


def scripts_phase(dev, card, launches, errs, fracs):
    """Phase 20: the cell scripts (ray_tracer_fragment_shader_tpu_torch.
    scripts), run by their own functions on the card, each with the launch
    counters zeroed just before it and read just after.  The depth sweep
    at full width and few iterations (K2, K3, K4, K5; every fwd+bwd row
    with live pixels), its depth-5 chain image, depth-5 two-phase loss and
    tables and depth-4 tree image against their plain versions, and one
    depth-5 step with mode="fused" (K6) against K3+K4; the reference's
    frame (K2 alone), held against the same adaptive loop run with the
    chain kernel's plain version on the same jitter; the fit demo's short
    form (no kernel; the loss falls, five files written).  Adds to
    ``launches``, ``errs`` and ``fracs``."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
        primary_rays, sample_jitter, screen_points)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    from ray_tracer_fragment_shader_tpu_torch.scripts import (
        bench_reference_demo as BD, depth_sweep as DS, make_fit_demo as FD)
    t20 = time.perf_counter()

    def counted(label, fn, want=(), absent=()):
        """``fn()`` with the counters zeroed; each kernel of ``want``
        launched, none of ``absent``; the counts added to ``launches``."""
        K.reset_launch_counts()
        out = fn()
        _sync(dev)
        counts = {k: c for k, c in K.LAUNCHES.items() if c}
        print(f"path {label}: launches {counts}")
        for k in want:
            check(counts.get(k, 0) > 0, f"{label}: never launched {k}")
        for k in absent:
            check(k not in counts, f"{label}: launched {k}")
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        return out

    def hold_image(kname, label, img, c, plain, budget):
        """A path's image against the plain version on its rays."""
        scene, camera, cfg = c["scene"], c["camera"], c["config"]
        _, v = primary_rays(camera, screen_points(camera, cfg.width,
                                                  cfg.height))
        ref = plain(K.pack_scene(scene.to(dev)), v.contiguous(),
                    camera.eye.tolist(), **K.render_kwargs(scene, cfg))
        r = compare(img, ref.reshape(img.shape), budget)
        errs[kname].append(r["max_abs_err"])
        fracs[kname].append(r["frac"])
        print(f"check {kname} {label}: {r['frac']:.6f} of pixels > "
              f"{FRAC_TOL} (budget {budget}), max abs err "
              f"{r['max_abs_err']:.4g}, mean {r['mean']:.6f} vs plain "
              f"{r['plain_mean']:.6f}")
        check(r["ok"], f"{kname} disagrees with its plain version on {label}")

    # -- 1. the depth sweep at full width, few iterations
    rows = counted(
        "depth sweep (1024^2 chain and two-phase fwd+bwd d2/3/5, 512^2 "
        "tree d2-4)",
        lambda: DS.sweep(iters=8, reps=1, mode="twophase", device=dev,
                         on_row=lambda r: print(
                             f"phase 20 depth sweep {json.dumps(r)} "
                             f"[{card}]")),
        want=["render_chain", "render_packed", "adjoint_packed",
              "render_tree"], absent=["fused_adjoint"])
    for r in rows:
        if r["kernel"] == "fused_fwd_bwd":
            check(r["live_pixels"] > 0,
                  f"depth sweep d{r['depth']}: a step with no live pixel")
    c = DS.chain_case(1024, 5, dev)
    hold_image("render_chain", "depth sweep chain 1024^2 d5",
               DS.render_frame(c, dev), c, K.render_chain_ref, 0.01)
    c = DS.tree_case(512, 4, dev)
    hold_image("render_tree", "depth sweep tree 512^2 d4",
               DS.render_frame(c, dev), c, K.render_tree_ref, 0.01)
    c = DS.fwd_bwd_case(1024, 5, dev)
    loss, grads = counted("depth sweep fwd+bwd 1024^2 d5, twophase",
                          lambda: DS.fwd_bwd_step(c, dev, mode="twophase"),
                          want=["render_packed", "adjoint_packed"])
    # the same inputs through the plain versions: K3's plain image and
    # residuals against K3's, K4's plain version on K3's outputs
    x = fit_inputs(K, AF, dev, presets.full_reflective(size=1024, depth=5),
                   dc=DS.MOVE)
    t, v, eye, kw = x["tables"], x["v"], x["eye"], x["kw"]
    img_ref, pk_ref = K.render_packed_ref(t, v, eye, pack=x["akw"]["pack"],
                                          **kw)
    r = compare(x["img"], img_ref, 0.01)
    errs["render_packed"].append(r["max_abs_err"])
    fracs["render_packed"].append(r["frac"])
    pk_frac = (x["pk"] != pk_ref).float().mean().item()
    print(f"check render_packed depth sweep 1024^2 d5: {r['frac']:.6f} of "
          f"pixels > {FRAC_TOL}, {pk_frac:.6f} of packed residuals differ "
          f"(budget 0.01 each)")
    check(r["ok"] and pk_frac <= 0.01, "render_packed at d5")
    ref = AF.adjoint_packed_ref(t, v, eye, x["img"], x["target"], x["mask"],
                                x["pk"], **x["akw"])
    errs["adjoint_packed"].append(hold_fields(
        "adjoint_packed", "depth sweep fwd+bwd 1024^2 d5 (path)", loss, grads,
        ref[0] / (v.shape[0] * 3), as_fields(AF, x, ref[1:])))
    loss6, grads6 = counted("depth sweep fwd+bwd 1024^2 d5, fused",
                            lambda: DS.fwd_bwd_step(c, dev, mode="fused"),
                            want=["fused_adjoint"],
                            absent=["render_packed", "adjoint_packed"])
    errs["fused_adjoint"].append(hold_fields(
        "fused_adjoint", "depth sweep fwd+bwd 1024^2 d5 (path)", loss6,
        grads6, loss, grads, against="K3+K4"))
    del c, x, t, v, ref, img_ref, pk_ref
    torch.cuda.empty_cache()

    # -- 2. the reference's own frame
    out = counted("reference frame 500^2 d5 16 spp adaptive",
                  lambda: BD.bench(device=dev), want=["render_chain"])
    print(f"phase 20 reference frame: frame_time_ms {out['frame_time_ms']} "
          f"(reps {out['frame_time_ms_reps']}), samples_rendered "
          f"{out['samples_rendered']}, rays_per_s {out['rays_per_s']} (all "
          f"16 samples), traced_rays_per_s {out['traced_rays_per_s']} "
          f"[{card}]")
    check(1 <= out["samples_rendered"] <= 16, "reference frame's samples")
    c = BD.demo_case(dev)
    cfg = c["config"]
    gen = torch.Generator(dev).manual_seed(cfg.seed)
    jit = torch.stack([sample_jitter(gen, cfg.width * cfg.height,
                                     cfg.jitter_scale).to(dev)
                       for _ in range(cfg.samples)])
    img = BD.frame(c, dev, jitter=jit)
    same = torch.equal(img, BD.frame(c, dev))
    print(f"check reference frame: the frame on the seeded jitter tensor "
          f"equals the bench's frame bit for bit: {same}")
    check(same, "reference frame: the jitter tensor is not the bench's")
    chain = K.render_chain
    K.render_chain = K.render_chain_ref     # the same loop, plain samples
    try:
        plain = counted("reference frame, plain chain",
                        lambda: BD.frame(c, dev, jitter=jit),
                        absent=["render_chain"])
    finally:
        K.render_chain = chain
    r = compare(img, plain, 0.02)
    errs["render_chain"].append(r["max_abs_err"])
    fracs["render_chain"].append(r["frac"])
    print(f"check render_chain reference frame 500^2 d5 16 spp adaptive "
          f"against the loop on the plain version: {r['frac']:.6f} of "
          f"pixels > {FRAC_TOL} (budget 0.02), max abs err "
          f"{r['max_abs_err']:.4g}")
    check(r["ok"], "reference frame disagrees with the plain loop")
    del img, plain, jit

    # -- 3. the fit demo, short form: no kernel
    fit_dir = os.path.join(OUT_DIR, "fit_demo_64")
    rep = counted("fit demo 64^2, 3 views, short form",
                  lambda: FD.fit_demo(size=64, out=fit_dir, device=dev,
                                      restarts=1, restart_steps=3,
                                      steps_per_sigma=5,
                                      light_polish_steps=5))
    check(not any(K.LAUNCHES.values()), "the fit demo launched a kernel")
    e0, e1 = rep["init_errors"], rep["final_errors"]
    print(f"phase 20 fit demo 64^2: loss {rep['loss_init']:.6g} -> "
          f"{rep['loss_fit']:.6g}, centre error {e0['center_err_max']:.4g} "
          f"-> {e1['center_err_max']:.4g}, light {e0['light_err_max']:.4g} "
          f"-> {e1['light_err_max']:.4g}, {rep['fit_wall_s']} s; files "
          f"{sorted(os.listdir(fit_dir))} [{card}]")
    check(rep["loss_fit"] < rep["loss_init"], "fit demo: the loss rose")
    check(set(os.listdir(fit_dir)) >= {"before.png", "target.png",
                                       "after.png", "triptych.png",
                                       "recovery.json"},
          "fit demo: files missing")
    torch.cuda.empty_cache()
    print(f"phase 20: {time.perf_counter() - t20:.1f} s")


def four_times(pk_fn, pp_fn, reps_k, reps_p):
    """(kernel ms, plain ms, runs) by CUDA events, timed plain, kernel,
    kernel, plain."""
    from ray_tracer_fragment_shader_tpu_torch.utils.timing import time_ms
    t_p1 = time_ms(pp_fn, reps_p)
    t_k1 = time_ms(pk_fn, reps_k)
    t_k2 = time_ms(pk_fn, reps_k)
    t_p2 = time_ms(pp_fn, reps_p)
    return (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2, (t_k1, t_k2, t_p1, t_p2)


def checker_edge_phase(dev, card, launches, errs, fracs):
    """Phase 21: the look-at scanline of even-size frames on the card.  A
    triangle's hit point is o + m*v in every kernel and plain version (the
    core's and the oracle's); at an even height the middle row's rays meet
    the board on a checker square's edge, where o + |v|*m*u picked the
    other square on about a third of the board pixels.  ``render_image_
    kernel`` (counters zeroed just before, read just after) renders the
    reference's 500^2 frame at one sample (K2), config 3 (K2) and
    fractional_glass 1024^2 d3 (K5); each frame's look-at row against its
    plain version on the row's rays and against the f64 oracle: every
    pixel over 1e-3 is counted, and fails the run unless its primary hit's
    material equals the oracle's, a later bounce meets the board on a
    square's edge (a tie no rounding settles) and the card's colour is
    within 1e-3 of the oracle's with one or more of those bounces on the
    other square (``oracle_pixels(..., ties=True)``); the level-0
    material plane of the residual form (residual K2 / K5) equals the
    oracle's primary materials on the whole row, and the row's planes
    equal the plain version's, as do the packed forward's (K3) on the
    chain scenes.  Then
    the kernels whose device code changed (K2, K3, K5, the residual forms,
    K4, K6, K7, K8) are timed as phase 8 times them, plain, kernel, kernel,
    plain, and everything is written to chiprun_out/chip_smoke/
    checker_edge.json.  Adds to ``launches``, ``errs`` and ``fracs``."""
    import numpy as np
    import torch
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.oracle import oracle_pixels
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
        Camera, primary_rays, screen_points)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    t21 = time.perf_counter()
    demo, demo_cam, demo_cfg = presets.reference_demo()
    cases = (
        ("reference_demo 500^2 d5 1spp", "render_chain",
         (demo, demo_cam, dataclasses.replace(demo_cfg, samples=1))),
        ("config 3 1024^2 d3", "render_chain",
         presets.full_reflective(size=1024, depth=3)),
        ("fractional_glass 1024^2 d3", "render_tree",
         presets.fractional_glass(size=1024, depth=3)))
    report = {"card": card, "scanlines": {}, "times": {}}
    for label, kname, (scene, cam, cfg) in cases:
        w, h = cfg.width, cfg.height
        j = h // 2
        camera = Camera.from_config(cam, w, h, device=dev)
        K.reset_launch_counts()
        img = K.render_image_kernel(scene, camera, cfg, device=dev)
        _sync(dev)
        counts = {k: c for k, c in K.LAUNCHES.items() if c}
        print(f"path render_image_kernel {label}: launches {counts}")
        check(counts.get(kname, 0) > 0, f"{label}: never launched {kname}")
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        tree = kname == "render_tree"
        # the row's rays, and the whole frame's for the residual forms
        _, v_all = primary_rays(camera, screen_points(camera, w, h))
        v_all = v_all.contiguous()
        v_row = v_all.reshape(h, w, 3)[j].contiguous()
        scene_c, tables, kw = AF.scene_tables(scene, cfg, dev)
        eye = camera.eye.tolist()
        row = img[j]
        plain = (K.render_tree_ref if tree else K.render_chain_ref)(
            tables, v_row, eye, **kw)
        r = compare(row, plain, 0.01)
        errs[kname].append(r["max_abs_err"])
        fracs[kname].append(r["frac"])
        print(f"check {kname} {label} row {j}: {r['frac']:.5f} of pixels > "
              f"{FRAC_TOL} from the plain version (budget 0.01), max abs "
              f"err {r['max_abs_err']:.4g}")
        check(r["ok"], f"{kname} disagrees with its plain version on "
                       f"{label}'s look-at row")
        # residual form: planes of the row against the plain version's
        rname = "render_tree_residuals" if tree else "render_chain_residuals"
        rimg, res = K.render_residuals(tables, v_all, eye, tree=tree, **kw)
        rimg_ref, res_ref = K.render_residuals_ref(tables, v_row, eye,
                                                   tree=tree, **kw)
        rows = {k: t.reshape(*t.shape[:-1], h, w)[..., j, :]
                for k, t in res.items()}
        same = {k: bool(torch.equal(rows[k], res_ref[k])) for k in rows}
        r = compare(rimg.reshape(h, w, 3)[j], rimg_ref, 0.01)
        errs[rname].append(r["max_abs_err"])
        fracs[rname].append(r["frac"])
        print(f"check {rname} {label} row {j}: planes equal the plain "
              f"version's {same}; image {r['frac']:.5f} of pixels > "
              f"{FRAC_TOL}, max abs err {r['max_abs_err']:.4g}")
        check(all(same.values()) and r["ok"],
              f"{rname} disagrees with its plain version on {label}'s "
              f"look-at row")
        if not tree:
            pack = K.pack_widths(tables["tri"].shape[0], scene_c.num_spheres,
                                 scene_c.num_materials, scene_c.num_lights)
            pimg, pk = K.render_packed(tables, v_all, eye, pack=pack, **kw)
            planes = K.unpack_residuals(pk.reshape(-1, h, w)[:, j], kw["nl"],
                                        pack)
            same_p = {k: bool(torch.equal(planes[k], res_ref[k]))
                      for k in planes}
            pimg_row = pimg.reshape(h, w, 3)[j]
            print(f"check render_packed {label} row {j}: unpacked planes "
                  f"equal the plain version's {same_p}; image equal to "
                  f"K2's row bit for bit: {torch.equal(pimg_row, row)}")
            check(all(same_p.values()) and torch.equal(pimg_row, row),
                  f"render_packed disagrees on {label}'s look-at row")
        # the oracle
        t0 = time.perf_counter()
        want, hits, alts = oracle_pixels(scene, cam, cfg,
                                         [(j, i) for i in range(w)],
                                         ties=True)
        mids = np.asarray([-1 if x is None else x.mat_id for x in hits])
        got = row.double().cpu().numpy()
        mid0 = rows["mid"][0].cpu().numpy()
        primary = np.flatnonzero((mids >= 0) & (mid0 != mids))
        over = np.flatnonzero(np.abs(got - want).max(-1) > FRAC_TOL)
        # each pixel over: the card's distance to the nearest of the
        # oracle's colours with its edge bounces on the other square
        near = {int(i): float(np.abs(alts[i] - got[i]).max(-1).min())
                if len(alts[i]) else None for i in over}
        ties = [i for i, d in near.items()
                if i not in primary and d is not None and d <= FRAC_TOL]
        other = [int(i) for i in over if i not in primary and i not in ties]
        entry = dict(row=j, width=w, over=len(over),
                     primary_material_mismatches=len(primary),
                     later_bounce_edge_ties=ties,
                     tie_err_vs_other_square=[near[i] for i in ties],
                     edge_bounce_sets=[len(alts[i]) for i in ties],
                     other=other,
                     max_abs_err_vs_oracle=float(
                         np.abs(got - want).max()),
                     oracle_s=time.perf_counter() - t0)
        report["scanlines"][label] = entry
        print(f"phase 21 scanline {label}: row {j} of {h}, {len(over)} of "
              f"{w} pixels over {FRAC_TOL} from the f64 oracle; primary "
              f"materials differing from the oracle's: {len(primary)} "
              f"(must be 0); pixels over whose path meets the board on a "
              f"square's edge after the primary hit and that are within "
              f"{FRAC_TOL} of the oracle's colour with the other square "
              f"there (ties): {len(ties)} {ties}, max distance "
              f"{max([near[i] for i in ties], default=0.0):.3g}; others "
              f"(must be none): {other} [{card}]")
        check(len(primary) == 0, f"{label}: the level-0 material differs "
                                 f"from the oracle's at {primary.tolist()}")
        check(not other, f"{label}: pixels {other} leave the f64 oracle")
        del img, v_all, res, rimg
        torch.cuda.empty_cache()

    # times of the kernels whose device code changed, as phase 8 times them
    def rays_of(preset):
        scene, cam, cfg = preset
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        _, v = primary_rays(camera, screen_points(camera, cfg.width,
                                                  cfg.height))
        return (K.pack_scene(scene.to(dev)), v.contiguous(),
                camera.eye.tolist(), K.render_kwargs(scene, cfg))

    fr3 = presets.full_reflective(size=1024, depth=3)
    fg3 = presets.fractional_glass(size=1024, depth=3)
    timed = {}
    for tree, preset in ((False, fr3), (True, fg3)):
        t, v, eye, kw = rays_of(preset)
        fwd = "render_tree" if tree else "render_chain"
        timed[fwd] = (lambda t=t, v=v, eye=eye, kw=kw, f=getattr(K, fwd):
                      f(t, v, eye, **kw),
                      lambda t=t, v=v, eye=eye, kw=kw,
                      f=getattr(K, fwd + "_ref"): f(t, v, eye, **kw), 3)
        timed[fwd + "_residuals"] = (
            lambda t=t, v=v, eye=eye, kw=kw, tree=tree:
            K.render_residuals(t, v, eye, tree=tree, **kw),
            lambda t=t, v=v, eye=eye, kw=kw, tree=tree:
            K.render_residuals_ref(t, v, eye, tree=tree, **kw), 2)
    x = fit_inputs(K, AF, dev, fr3)
    t, v, eye, kw, akw = x["tables"], x["v"], x["eye"], x["kw"], x["akw"]
    args4 = (t, v, eye, x["img"], x["target"], x["mask"], x["pk"])
    res8 = K.render_residuals(t, v, eye, tree=False, **kw)[1]
    g8 = (akw["g_scale"] * (x["img"] - x["target"])).contiguous()
    fkw = {k: akw[k] for k in ("nl", "depth", "atten", "want_trans")}
    args6, kw6 = fused_args(x)
    timed.update(
        render_packed=(lambda: K.render_packed(t, v, eye, pack=akw["pack"],
                                               **kw),
                       lambda: K.render_packed_ref(t, v, eye,
                                                   pack=akw["pack"], **kw),
                       2),
        adjoint_packed=(lambda: AF.adjoint_packed(*args4, **akw),
                        lambda: AF.adjoint_packed_ref(*args4, **akw), 2),
        fit_grads=(lambda: AF.fit_grads(t, v, eye, g8, res8, **fkw),
                   lambda: AF.fit_grads_ref(t, v, eye, g8, res8, **fkw), 1),
        fused_adjoint=(lambda: AF.fused_adjoint(*args6, **kw6),
                       lambda: AF.fused_adjoint_ref(*args6, **kw6), 1))
    x7 = fit_inputs(K, AF, dev, (demo, demo_cam,
                                 dataclasses.replace(demo_cfg, samples=1)))
    args7, kw7 = recompute_args(K, x7)
    timed["recompute_adjoint"] = (
        lambda: AF.recompute_adjoint(*args7, **kw7),
        lambda: AF.recompute_adjoint_ref(*args7, **kw7), 1)
    where = {"render_tree": "fractional_glass 1024^2 d3",
             "render_tree_residuals": "fractional_glass 1024^2 d3",
             "recompute_adjoint": "reference_demo 500^2 d5, one sample"}
    for kname, (kern, plain, reps_p) in timed.items():
        tk, tp, runs = four_times(kern, plain, 20, reps_p)
        label = where.get(kname, "config 3 1024^2 d3")
        report["times"][kname] = dict(case=label, ms=tk, plain_ms=tp,
                                      runs=list(runs))
        print(f"phase 21 time {kname} {label}: kernel {tk:.4f} ms "
              f"({runs[0]:.4f}, {runs[1]:.4f}); plain {tp:.2f} ms "
              f"({runs[2]:.2f}, {runs[3]:.2f}) [{card}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "checker_edge.json"), "w") as f:
        json.dump(report, f, indent=1)
    del x, x7, args4, args6, args7, res8, g8
    torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t21:.1f} s")


def host_ms(fn, reps: int) -> list:
    """Host-clock times of ``reps`` calls of ``fn``, each ending in a
    synchronize, after one warm-up call; ms, sorted."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def core_phase(dev, card):
    """Phase 18: the core renderer (core/renderer.py, plain PyTorch on the
    card, no kernel) and the fits built on its autograd.  Its images are
    held against the kernel path's, its config 3 gradients against
    ``render_image_diff``'s, and the counters must read zero across it;
    then ``fit_soft`` and the CLI's ``fit --views 3``, and the times of
    the naive-autodiff baseline beside the kernel path's."""
    import numpy as np
    import torch
    from ray_tracer_fragment_shader_tpu_torch import cli
    from ray_tracer_fragment_shader_tpu_torch.core.renderer import (
        render_image)
    from ray_tracer_fragment_shader_tpu_torch.core.topology import (
        same_topology)
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (FitParams,
                                                              l2_loss)
    from ray_tracer_fragment_shader_tpu_torch.diff.soft import fit_soft
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
        render_image_diff)
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (Camera,
                                                               sample_jitter)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    t18 = time.perf_counter()

    def core(fn):
        """Runs ``fn`` with the counters zeroed; none may count."""
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: c for k, c in K.LAUNCHES.items() if c}
        check(not counts, f"the core renderer launched kernels: {counts}")
        return out

    # -- 1. the core's images against the kernel path's, phase 2's budget
    demo, demo_cam, demo_cfg = presets.reference_demo()
    demo_cfg = dataclasses.replace(demo_cfg, adaptive=True)
    gen = torch.Generator(dev).manual_seed(0)
    P = demo_cfg.width * demo_cfg.height
    demo_jit = torch.stack([sample_jitter(gen, P, demo_cfg.jitter_scale)
                            for _ in range(demo_cfg.samples)])
    for label, (scene, cam, cfg), budget, jit in (
            ("config 3 full_reflective 1024^2 d3 (chain)",
             presets.full_reflective(size=1024, depth=3), 0.01, None),
            ("reference_demo 500^2 d5 16-spp adaptive (shared jitter)",
             (demo, demo_cam, demo_cfg), 0.02, demo_jit),
            ("fractional_glass 1024^2 d3 (tree)",
             presets.fractional_glass(size=1024, depth=3), 0.01, None)):
        with torch.no_grad():
            img = core(lambda: render_image(scene, cam, cfg, jitter=jit,
                                            device=dev))
        ref = K.render_image_kernel(scene, cam, cfg, jitter=jit, device=dev)
        r = compare(img, ref, budget)
        print(f"check core {label}: {r['frac']:.5f} of pixels > {FRAC_TOL} "
              f"from the kernel path's image (budget {budget}), max abs "
              f"err {r['max_abs_err']:.4g}, mean {r['mean']:.6f} vs "
              f"{r['plain_mean']:.6f} (rel {r['mean_rel']:.2e}); no kernel "
              f"launched")
        check(r["ok"], f"the core image differs from the kernel's: {label}")
    del demo_jit, img, ref

    # -- 2. config 3's uniform-cotangent gradients: core autograd against
    # render_image_diff (tests/test_adjoint.py:47-49's tolerances).  Each
    # render's image is kept, and the tables are taken under the uniform
    # cotangent 1/(3P) and under it restricted to three classes of pixels:
    # where the core chain and the kernel's residuals took another
    # topology (another primitive, material or shadow on some level:
    # core/topology.py), each side differentiates its own branch; where the
    # topology is the same but the colours part by more than 1e-3, the hit
    # is ill-conditioned (on the CPU at 128^2 the one such pixel, an
    # inter-reflection between two spheres, carries 0.79 of the rest's
    # centre table max and takes its error from 6.8e-4 to 2.9e-3:
    # tests/test_torch_core.py); the rest, the same topology with the
    # colours agreeing, is held.  At 32^2 the JAX test's
    # uniform cotangent drowns the first two classes; at 1024^2 their share
    # of a sphere-centre table is larger than its 5e-3
    scene, cam, cfg = presets.full_reflective(size=1024, depth=3)
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    out = {}
    for label, render in (("core", render_image),
                          ("render_image_diff", render_image_diff)):
        params = FitParams.from_scene(scene).to(dev)

        def fwd():
            return render(params.into_scene(scene), camera, cfg, device=dev)
        img = core(fwd) if label == "core" else fwd()
        out[label] = (params, img)
    (pc, ic), (pk, ik) = out["core"], out["render_image_diff"]
    _, res = K.render_forward_with_residuals(scene, camera, cfg, device=dev)
    same = core(lambda: same_topology(scene, camera, cfg, res))[..., None]
    parts = (ic - ik).abs().amax(-1, keepdim=True) > FRAC_TOL
    classes = {"uniform": torch.ones_like(same),
               "held": same & ~parts,
               "other topology": ~same,
               "ill-conditioned": same & parts}
    P3 = ic.numel()
    print(f"check core gradients config 3 1024^2 d3: "
          f"{classes['other topology'].float().mean().item():.6f} of pixels "
          f"where the core chain and the kernel's residuals take another "
          f"topology, {classes['ill-conditioned'].float().mean().item():.6f}"
          f" of the same topology whose colours part by > {FRAC_TOL}, "
          f"{parts.float().mean().item():.6f} whose colours part")
    grads = {}
    for cot, m in classes.items():
        w = m.expand_as(ic).float() / P3
        for label, (params, img) in out.items():
            g = torch.autograd.grad(img, [getattr(params, f) for f in FIELDS],
                                    grad_outputs=w, retain_graph=True)
            grads[cot, label] = dict(zip(FIELDS, g))
    # a third witness: the core's geometry gradient in float64, on the held
    # pixels where its colours agree with both float32 images within 1e-3
    # too; the float32 sides part from it by their own rounding
    geo = ("sph_center", "sph_radius")
    s64, cam64, cfg64 = presets.full_reflective(size=1024, depth=3,
                                                dtype=np.float64)
    s64 = s64.to(dev)
    l64 = [getattr(s64, f).detach().clone().requires_grad_() for f in geo]
    s64 = s64.replace(**dict(zip(geo, l64)))
    img64 = core(lambda: render_image(s64, Camera.from_config(
        cam64, cfg64.width, cfg64.height, dtype=torch.float64, device=dev),
        cfg64, device=dev))
    w64 = (classes["held"]
           & ((img64 - ic.double()).abs().amax(-1, keepdim=True) <= FRAC_TOL)
           & ((img64 - ik.double()).abs().amax(-1, keepdim=True)
              <= FRAC_TOL)).expand_as(img64).double() / P3
    g64 = {"float64": dict(zip(geo, torch.autograd.grad(img64, l64,
                                                        grad_outputs=w64)))}
    for label, (params, img) in out.items():
        g64[label] = dict(zip(geo, torch.autograd.grad(
            img, [getattr(params, f) for f in geo],
            grad_outputs=w64.float(), retain_graph=True)))
    print(f"check core gradients config 3 1024^2 d3, float64 witness: "
          f"{1.0 - w64[..., 0].gt(0).float().mean().item():.6f} of pixels "
          f"left out (the held class's and those where the core in float64 "
          f"parts by > {FRAC_TOL} from either)")
    del img64, s64, l64, w64
    torch.cuda.synchronize()
    for f in FIELDS:
        tol = 5e-3 if f in geo else 3e-2
        rels = {cot: rel_err(grads[cot, "render_image_diff"][f],
                             grads[cot, "core"][f]) for cot in classes}
        a = grads["held", "core"][f]
        if f in geo:
            r64 = [rel_err(g64[side][f].double(), g64["float64"][f])
                   for side in ("core", "render_image_diff")]
            print(f"check core gradient {f} config 3 1024^2 d3, float64 "
                  f"witness, max|diff|/max|float64|: the core {r64[0]:.3g}, "
                  f"render_image_diff {r64[1]:.3g}; between them "
                  f"{rel_err(g64['render_image_diff'][f], g64['core'][f]):.3g}")
        weight = {cot: grads[cot, "core"][f].abs().max().item()
                  / max(a.abs().max().item(), 1e-30)
                  for cot in ("other topology", "ill-conditioned")}
        print(f"check core gradient {f} config 3 1024^2 d3 against "
              f"render_image_diff, max|diff|/max|core|: uniform cotangent "
              f"{rels['uniform']:.3g}; held (same topology, colours "
              f"agreeing) {rels['held']:.3g} (tol {tol}); other topology "
              f"{rels['other topology']:.3g}, ill-conditioned "
              f"{rels['ill-conditioned']:.3g} (their max|core| "
              f"{weight['other topology']:.3g} and "
              f"{weight['ill-conditioned']:.3g} of the held's "
              f"{a.abs().max().item():.4g})")
        check(bool(torch.isfinite(a).all()) and a.abs().max().item() > 0,
              f"the core gradient {f} is zero or not finite")
        check(rels["held"] < tol,
              f"the core gradient {f} differs: {rels['held']:.3g}")
    del grads, out, pc, pk, ic, ik, same, parts, classes, res, g64

    # -- 3. the fits built on the core: fit_soft, and the CLI's multi-view
    # recipe (3 orbit views, 32-64-128 pyramid)
    fscene, fcam, fcfg = presets.fit_target(size=128)
    target = core(lambda: render_image(fscene, fcam, fcfg, device=dev))
    init = FitParams.from_scene(fscene)
    with torch.no_grad():
        init.sph_center += torch.tensor([4.0, -2.0, 3.0])
    _, hist = core(lambda: fit_soft(fscene, fcam, fcfg, target, params=init,
                                    steps=8, sigmas=(2.0,), device=dev))
    print(f"path fit_soft fit_target 128^2, 8 Adam steps: loss "
          f"{hist[0]:.6g} -> {hist[-1]:.6g} (min {min(hist):.6g})")
    check(all(math.isfinite(h) for h in hist) and min(hist) < hist[0],
          "fit_soft's loss did not fall")
    # the CLI's recipe with its restart race and light polish cut short
    # (cmd_fit imports fit_multiview when it runs)
    from ray_tracer_fragment_shader_tpu_torch.diff import multiview
    full_recipe = multiview.fit_multiview
    multiview.fit_multiview = functools.partial(
        full_recipe, restarts=2, restart_steps=3, light_polish_steps=5)
    t0 = time.perf_counter()
    try:
        _, hist = cli.main(["fit", "--views", "3", "--size", "128",
                            "--steps", "30", "--lr", "0.3", "--out-dir",
                            os.path.join(OUT_DIR, "fit_views3")])
    finally:
        multiview.fit_multiview = full_recipe
    torch.cuda.synchronize()
    print(f"path cli fit --views 3 --size 128: {len(hist)} losses "
          f"{hist[0]:.6g} -> {hist[-1]:.6g} (min {min(hist):.6g}), "
          f"{time.perf_counter() - t0:.1f} s")
    check(all(math.isfinite(h) for h in hist) and min(hist) < hist[0],
          "the multi-view fit's loss did not fall")

    # -- 4. the naive-autodiff baseline beside the kernel path, config 3
    params = FitParams.from_scene(scene).to(dev)
    target = K.render_image_kernel(scene, camera, cfg, device=dev)
    with torch.no_grad():
        params.sph_center += 1.5

    def core_step():
        params.zero_grad()
        l2_loss(params, scene, camera, cfg, target, device=dev).backward()

    @torch.no_grad()
    def core_frame():
        core(lambda: render_image(scene, camera, cfg, device=dev))

    @torch.no_grad()
    def kernel_frame():
        K.render_image_kernel(scene, camera, cfg, device=dev)

    prep = AF.prepare_fit_inputs(camera, cfg, target, device=dev)
    pairs = {  # what: ((core label, fn), (kernel path label, fn))
        "forward frame": (("core forward frame", core_frame),
                          ("kernel forward frame (K2)", kernel_frame)),
        "fwd+bwd step": (("core l2_loss fwd+bwd step",
                          lambda: core(core_step)),
                         ("kernel fwd+bwd step (K3+K4)",
                          lambda: AF.fit_value_and_grad(
                              params, scene, camera, cfg, target, prep=prep,
                              mode="twophase", device=dev)))}
    for what, sides in pairs.items():
        med = []
        for label, fn in sides:
            torch.cuda.reset_peak_memory_stats(dev)
            ms = host_ms(fn, 3)
            peak = torch.cuda.max_memory_allocated(dev)
            med.append(ms[1])
            print(f"time {label} config 3 1024^2 d3: {ms[1]:.3f} ms (host "
                  f"clock, median of 3: {[round(t, 3) for t in ms]}), "
                  f"{cfg.width * cfg.height / ms[1] * 1e-3:.2f} M rays/s, "
                  f"peak memory {peak / 2**30:.3f} GiB "
                  f"(max_memory_allocated); {card}")
        print(f"time kernel path over naive autodiff, {what} config 3: "
              f"{med[0] / med[1]:.1f}x ({med[0]:.3f} / {med[1]:.3f} ms); "
              f"{card}")
    del params, target, prep
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t18:.1f} s")


def probe_phase(dev, card, kernel_works, launches, errs, times, bounds):
    """Phase 13: K9, P1 and P2 against their plain versions; K9's rates
    for the four blends and the P1 mul rate against the card's ceiling;
    the bench, P1, P2 and P3 driven with the launch counters zeroed just
    before; the probes' times; and the bounds of K2-K8 on their timed
    inputs (``kernel_works``) at K9's rates for their blends.  Fills ``launches``, ``errs``, ``times`` and
    ``bounds`` for mix_chain, op_chain and bf16_chain; returns the extra
    keys of the kernels line ({kernel: {k9_bound_ms, k9_bound_by,
    k9_rate_ops_per_s}})."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch import bench
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu_torch.probes import (
        bf16_probe, common, op_probe, pressure_probe)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    from ray_tracer_fragment_shader_tpu_torch.utils import opcount
    from ray_tracer_fragment_shader_tpu_torch.utils import roofline as RL
    from ray_tracer_fragment_shader_tpu_torch.utils.timing import time_ms
    t13 = time.perf_counter()
    sms = PR.sm_count(dev)
    max_clock = float(PR.gpu_query("clocks.max.sm").split()[0])

    # the four blends, each as the bench (or, for the tree, its forward)
    # prices it at its own inputs
    fg = presets.fractional_glass(size=1024, depth=3)
    fg_cam = Camera.from_config(fg[1], fg[2].width, fg[2].height, device=dev)
    works = {
        "chain forward": bench.last_step_work(
            bench.knobs({"BENCH_FORWARD_ONLY": "1"}), dev),
        "two-phase fwd+bwd": bench.last_step_work(bench.knobs({}), dev),
        "fused fwd+bwd": bench.last_step_work(
            bench.knobs({"BENCH_ADJOINT": "fused"}), dev),
        "tree forward": opcount.step_work(fg[0], fg_cam, fg[2], None,
                                          device=dev),
    }
    blends, scheds = {}, {}
    for name, w in works.items():
        c = dict(w["fwd"])
        for k, v in w["bwd"].items():
            c[k] = c.get(k, 0.0) + v
        blends[name] = c
        scheds[name] = RL._rewrite_schedule(RL.mix_schedule(c))[0]
        tot = RL.flat_slots(c)
        print(f"blend {name:18s} ({'+'.join(w['kernels'])}): "
              + " ".join(f"{k} {v / tot:.4f}" for k, v in sorted(c.items()))
              + f"; schedule {PR.mix_defines(scheds[name])[0]}")
    check(len(set(scheds.values())) <= 4, "more than four K9 schedules")
    p3_ncs = (2, 8, 32, 96)
    two = scheds["two-phase fwd+bwd"]
    specs = ([("mix_probe.cu", PR.mix_defines(sc)) for sc in scheds.values()]
             + [("mix_probe.cu", PR.mix_defines(two, (nc,)))
                for nc in p3_ncs]
             + [("op_probe.cu", ()), ("bf16_probe.cu", ())])
    t0 = time.perf_counter()
    cuda_build.build_probes(specs)
    print(f"probe build: {len(set(specs))} libraries, "
          f"{time.perf_counter() - t0:.2f} s (all nvcc at once, -fmad=false)")
    for source, defines in dict.fromkeys(specs):
        kern = {"mix_probe.cu": "mix_kernel", "op_probe.cu": "op_kernel",
                "bf16_probe.cu": r"(?:f32|bf16)_kernel"}[source]
        res = PR.ptxas_resources(cuda_build.probe_log(source, defines), kern)
        regs = sorted({(r.get("registers"), r.get("spill_stores"))
                       for r in res.values()})
        print(f"  ptxas {source} {len(res)} kernels: (registers, spill "
              f"stores) {regs}")
    sass = PR.sass_opcodes(cuda_build.probe_library_path("op_probe.cu"),
                           "op_kernel")
    for inj in ("mul", "add", "mix"):
        ops = sass[(PR.INJECTS.index(inj), 4)]
        print(f"  SASS op_kernel<{inj}, nc=4>: "
              + " ".join(f"{k} {v}" for k, v in sorted(ops.items())))
        # (an HFMA2 of zeros is how the compiler moves a constant)
        check(ops.get("FFMA", 0) == 0,
              f"op_kernel<{inj}> holds fused multiply-adds")
    sass = PR.sass_opcodes(cuda_build.probe_library_path(
        "mix_probe.cu", PR.mix_defines(two)), "mix_kernel")
    print("  SASS mix_kernel<nc=2> (two-phase blend; IEEE div/sqrt "
          "sequences hold their own FFMA): " + " ".join(
              f"{k} {v}" for k, v in sorted(sass[(2,)].items())))
    # P2's census: what one chain step of each hot loop issues, by pipe
    census = bf16_probe.census()
    for key in (f"{i} {t} nc16" for i in PR.BF16_INJECTS
                for t in ("f32", "bf16")):
        c = census[key]
        print(f"  SASS census bf16_probe {key} a step: issue "
              f"{c['issue']:.3f}; " + " ".join(
                  f"{k} {v:.3f}" for k, v in c["pipes"].items())
              + "; issue at nc " + " ".join(
                  f"{k.split()[-1][2:]}:{v['issue']:.3f}"
                  for k, v in census.items()
                  if k.startswith(key.rsplit(" ", 1)[0] + " ")))
    for nc in PR.BF16_NCS:
        mul, mix = census[f"mul bf16 nc{nc}"], census[f"mix bf16 nc{nc}"]
        packed = (mul["pipes"].get("fp16x2", 0)
                  + mul["pipes"].get("fp16x2_mma", 0))
        check(abs(packed - 1.0) < 1e-9 and "fp32" not in mul["pipes"],
              f"bf16 mul nc {nc}: not one packed multiply a step {mul}")
        check(mul["pipes"].get("fp16x2_mma", 0) > 0,
              f"bf16 mul nc {nc}: nothing on HFMA2.MMA {mul}")
        p = mix["pipes"]
        check(p.get("fp32", 0) <= 4 + 1e-9
              and abs(p.get("mufu", 0) - 2) < 1e-9
              and abs(p.get("conv", 0) - 1) < 1e-9
              and abs(p.get("fp16x2", 0) + p.get("fp16x2_mma", 0) - 8)
              < 1e-9,
              f"bf16 mix nc {nc}: not 8 packed, 2 MUFU, 1 pack and no "
              f"unpacked arithmetic but rsqrtf's rescale a step {mix}")

    # K9, P1, P2 against their plain versions at grid 2, iters 8
    errs.update(mix_chain=[], op_chain=[], bf16_chain=[])
    x2 = RL.probe_input(2, dev)

    def twice_probe(fn, kname, label):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{kname} is not deterministic on {label}")
        return a
    for name, sc in scheds.items():
        for nc in (2, 8):
            got = twice_probe(lambda: PR.mix_chain(x2, iters=8, nc=nc,
                                                   sched=sc),
                              "mix_chain", name)
            errs["mix_chain"].append(hold_probe(
                "mix_chain", f"{name} nc={nc} iters=8", got,
                RL.mix_chain_ref(x2, iters=8, nc=nc, sched=sc), PROBE_TOL))
    for inj in PR.INJECTS:
        got = twice_probe(lambda: PR.op_chain(x2, inject=inj, iters=8, nc=4),
                          "op_chain", inj)
        errs["op_chain"].append(hold_probe(
            "op_chain", f"{inj} nc=4 iters=8", got,
            PR.op_chain_ref(x2, inject=inj, iters=8, nc=4), PROBE_TOL))
    n_p2 = 0
    for inj in PR.BF16_INJECTS:
        for bf16 in (False, True):
            for nc in PR.BF16_NCS:
                label = f"{inj} {'bf16' if bf16 else 'f32'} nc={nc} iters=8"
                got = twice_probe(lambda: PR.bf16_chain(
                    x2, inject=inj, bf16=bf16, iters=8, nc=nc),
                    "bf16_chain", label)
                ref = PR.bf16_chain_ref(x2, inject=inj, bf16=bf16, iters=8,
                                        nc=nc)
                errs["bf16_chain"].append(hold_probe(
                    "bf16_chain", label, got, ref,
                    BF16_TOL if bf16 else PROBE_TOL))
                check(torch.equal(got, ref),
                      f"bf16_chain {label} differs from bf16_chain_ref")
                n_p2 += 1
    print(f"P2: all {n_p2} instantiations (mul, mix; f32, bf16; nc "
          f"{PR.BF16_NCS}) bit-identical to bf16_chain_ref")
    print("all probes two launches bit-identical: True")

    # rates: K9 at the blends, the P1 mul chain against the ceiling
    x = RL.probe_input(sms * 8, dev)
    rates = {}
    with PR.ClockSampler() as clk:
        for name in blends:
            rates[name] = RL.mix_rate_details(blends[name], device=dev)
        t_mul, mul_sweep = op_probe._best("mul", 256, 3, x)
    clock = max(clk.samples) if clk.samples else max_clock
    ceiling = common.fp32_ceiling(sms, clock)
    for name, r in rates.items():
        print(f"rate K9 {name:18s}: {r['rate'] / 1e12:.4f} T budget ops/s "
              f"(nc {r['nc']}, {r['blocks_per_sm']} blocks/SM; "
              f"{r['rate'] / ceiling:.4f} of the FP32 ceiling) sweep "
              + " ".join(f"{k} {v / 1e12:.3f}" for k, v in r["sweep"].items())
              + f" [{card}]")
        check(r["rate"] <= CEILING_SHARE * ceiling,
              f"K9 {name} reads above the ceiling: folded")
    share = (1.0 / t_mul) / ceiling
    print(f"rate P1 mul: {1.0 / t_mul / 1e12:.4f} T ops/s = {share:.4f} of "
          f"{sms} SMs x 128 x {clock:.0f} MHz (sampled during the run: "
          f"{min(clk.samples or [0]):.0f}-{clock:.0f} MHz, max "
          f"{max_clock:.0f}) = {ceiling / 1e12:.3f} T; sweep (fs/step) "
          f"{mul_sweep} [{card}]")
    check(share <= CEILING_SHARE,
          f"P1 mul reads {share:.3f} of the FP32 ceiling: folded")

    # the main paths, each with the counters zeroed just before
    def drive(label, fn, want):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: c for k, c in K.LAUNCHES.items() if c}
        print(f"path {label}: launches {counts}")
        for k in want:
            check(counts.get(k, 0) > 0, f"{label}: never launched {k}")
        return out, counts
    RL._measure_mix_rate_cached.cache_clear()
    out, c = drive("bench (config 3 1024^2 d3 two-phase)",
                   lambda: bench.main([]),
                   ["mix_chain", "render_packed", "adjoint_packed"])
    check(out["metric"] == "rays_per_s_per_chip_fwd_bwd_1024x1024_depth3"
          and 0.0 < out["vs_baseline"] <= CEILING_SHARE
          and out["device"] == torch.cuda.get_device_name(0),
          f"bench: {out}")
    launches["mix_chain"] = c["mix_chain"]
    _, c = drive("P1 op_probe (iters 64)", lambda: op_probe.main(
        ["--iters", "64", "--reps", "1", "--out", os.path.join(
            REPO, common.OUT_DIR, "op_weights_smoke.json")]), ["op_chain"])
    launches["op_chain"] = c["op_chain"]
    p2, c = drive("P2 bf16_probe (iters 64)", lambda: bf16_probe.main(
        ["--iters", "64", "--reps", "1", "--out", os.path.join(
            REPO, common.OUT_DIR, "bf16_probe_smoke.json")]), ["bf16_chain"])
    launches["bf16_chain"] = c["bf16_chain"]
    for inj, row in p2["rows"].items():
        print(f"P2 {inj}: bf16/f32 speedup {row['bf16_speedup']:.4f}; "
              + "; ".join(
                  f"{t} {row[t + '_fs_per_step']:.3f} fs a step, bound "
                  f"{row[t + '_bound_fs_per_step']:.3f} ({row[t + '_bound_by']}"
                  f"), share {row[t + '_share_of_bound']:.4f}"
                  for t in ("f32", "bf16"))
              + f" (iters 64, one rep, clock {p2['bound_clock_mhz']:.0f} MHz)"
              f" [{card}]")
    _, c = drive(f"P3 pressure curve nc {p3_ncs}",
                 lambda: pressure_probe.curve(
                     blends["two-phase fwd+bwd"], p3_ncs, 64, 2, dev),
                 ["mix_chain"])
    launches["mix_chain"] += c["mix_chain"]

    # the probes' times at full width, against their plain versions
    best = rates["two-phase fwd+bwd"]
    xs = x[: sms * best["blocks_per_sm"] * 8]
    per_step = best["per_step"]
    timed = {
        "mix_chain": (lambda: PR.mix_chain(
            xs, iters=8, nc=best["nc"], sched=two,
            blocks=sms * best["blocks_per_sm"]),
            lambda: RL.mix_chain_ref(xs, iters=8, nc=best["nc"], sched=two),
            xs.numel() * best["nc"] * 8 * per_step, 1.0, PROBE_TOL,
            f"two-phase blend, nc {best['nc']}"),
        "op_chain": (lambda: PR.op_chain(x, inject="mix", iters=8, nc=16,
                                         blocks=sms * 8),
                     lambda: PR.op_chain_ref(x, inject="mix", iters=8,
                                             nc=16),
                     x.numel() * 16 * 8 * 12, 1.0, PROBE_TOL, "mix, nc 16"),
        # P2 (bf16 mix; bf16 mul below): bounds priced pipe by pipe
        "bf16_chain": (lambda: PR.bf16_chain(x, inject="mix", bf16=True,
                                             iters=8, nc=16, blocks=sms * 8),
                       lambda: PR.bf16_chain_ref(x, inject="mix", bf16=True,
                                                 iters=8, nc=16),
                       x.numel() * 16 * 8, None, BF16_TOL,
                       "bf16 mix, nc 16"),
        "bf16_chain mul": (lambda: PR.bf16_chain(
            x, inject="mul", bf16=True, iters=64, nc=32, blocks=sms * 8),
            lambda: PR.bf16_chain_ref(x, inject="mul", bf16=True, iters=64,
                                      nc=32),
            x.numel() * 32 * 64, None, BF16_TOL, "bf16 mul, nc 32"),
    }
    p2_extra = {}
    for kname, (kern, plain, ops, lanes, tol, label) in timed.items():
        n_el = xs.numel() if kname == "mix_chain" else x.numel()
        iters = 64 if kname == "bf16_chain mul" else 8
        got, ref = kern(), plain()
        err = hold_probe(kname.split()[0], f"{label} timed", got, ref, tol)
        check(lanes is not None or torch.equal(got, ref),
              f"{kname} {label} differs from bf16_chain_ref")
        del got, ref
        tp1 = time_ms(plain, 1)
        tk1, tk2 = time_ms(kern, 10), time_ms(kern, 10)
        tp2 = time_ms(plain, 1)
        tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
        if lanes is None:
            inj = "mul" if kname.endswith("mul") else "mix"
            b = common.chain_step_bound(common.P2_STEPS[(inj, True)], ops,
                                        sms, max_clock)
            bnd, how = b["seconds"] * 1e3, (
                f"{ops:.4g} element-steps, set by {b['by']}: " + ", ".join(
                    f"{k} {v * 1e3:.5f}" for k, v in b["pipes"].items()))
        else:
            bnd = ops / (lanes * common.fp32_ceiling(sms, max_clock)) * 1e3
            how = (f"{ops:.4g} budget ops at {lanes:.0f} x {sms} SMs x 128 "
                   f"x {max_clock:.0f} MHz")
        if kname == "bf16_chain mul":
            p2_extra.update(mul_ms=tk, mul_plain_ms=tp, mul_bound_ms=bnd,
                            mul_bound_pipe=b["by"], mul_max_abs_err=err,
                            mul_inputs=f"{n_el} elements, 32 chains, 64 "
                            f"iterations")
        else:
            errs[kname].append(err)
            times[kname], bounds[kname] = (tk, tp), (bnd, "operations")
            if lanes is None:
                p2_extra.update(bound_pipe=b["by"])
        print(f"time {kname} {label}, {n_el} elements, iters {iters}: "
              f"kernel {tk:.4f} ms ({tk1:.4f}, {tk2:.4f}); plain {tp:.2f} "
              f"ms; bound {bnd:.5f} ms ({how}); share {bnd / tk:.4f} "
              f"[{card}]")
    # the by-pipe bounds of the f32 rows, per element-step
    for inj in PR.BF16_INJECTS:
        b = common.chain_step_bound(common.P2_STEPS[(inj, False)], 1.0, sms,
                                    max_clock)
        print(f"bound P2 {inj} f32: {b['seconds'] * 1e15:.3f} fs an "
              f"element-step, set by {b['by']} [{card}]")

    # the kernels' bounds on their timed inputs: their class ops at K9's
    # rate for their blend, or their bytes, whichever is larger
    k9 = {}
    for kname, family in FAMILY.items():
        w = kernel_works[kname]
        rate = rates[family]["rate"]
        t_ops = RL.flat_slots(w["classes"]) / rate * 1e3
        t_bytes = w["bytes"] / opcount.PEAK_BYTES_PER_S * 1e3
        b = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        k9[kname] = dict(k9_bound_ms=b, k9_bound_by=by,
                         k9_rate_ops_per_s=rate)
        print(f"bound {kname:22s} data sheet {bounds[kname][0]:.5f}"
              f" ms ({bounds[kname][1]}); at K9's {family} rate "
              f"{rate / 1e12:.4f} T: {b:.5f} ms ({by}: "
              f"{RL.flat_slots(w['classes']):.4g} class ops {t_ops:.5f} ms, "
              f"{w['bytes']:.4g} B {t_bytes:.5f} ms); kernel "
              f"{times[kname][0]:.4f} ms = {b / times[kname][0]:.4f} of it "
              f"[{card}]")
    k9["bf16_chain"] = p2_extra
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")
    return k9


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ray_tracer_fragment_shader_tpu_torch import cli
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import (
        Camera, primary_rays, screen_points)
    from ray_tracer_fragment_shader_tpu_torch.scene import presets
    from ray_tracer_fragment_shader_tpu_torch.utils.timing import time_ms
    dev = torch.device("cuda", 0)

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    cuda_build.load()
    info = cuda_build.build_info
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s, built={info['built']}) "
          f"-> {os.path.relpath(info['path'], REPO)}")
    for line in info["log"].splitlines():
        if "entry function" in line or "registers" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernels against their plain versions at 128^2 ---------------
    def rays(scene, cam, cfg):
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        _, v = primary_rays(camera, screen_points(camera, cfg.width,
                                                  cfg.height))
        return (K.pack_scene(scene.to(dev)), v.contiguous(),
                camera.eye.tolist(), K.render_kwargs(scene, cfg))

    n = 128
    demo, demo_cam, demo_cfg = presets.reference_demo()
    fr, fr_cam, fr_cfg = presets.full_reflective(size=n, depth=3)
    cases = [
        ("full_reflective d3", "render_chain", fr, fr_cam, fr_cfg, 0.01),
        ("reference_demo d5 1spp", "render_chain", demo, demo_cam,
         dataclasses.replace(demo_cfg, width=n, height=n, samples=1), 0.02),
        ("procedural_spheres n64 d3", "render_chain",
         *presets.procedural_spheres(n=64, size=n, depth=3), 0.01),
        ("fractional_glass d2 (tree)", "render_tree",
         *presets.fractional_glass(size=n, depth=2), 0.01),
        ("full_reflective d3 forced tree", "render_tree", fr, fr_cam, fr_cfg,
         0.01),
    ]
    wrappers = {"render_chain": (K.render_chain, K.render_chain_ref),
                "render_tree": (K.render_tree, K.render_tree_ref)}
    errs = {k: [] for k in wrappers}
    fracs = {k: [] for k in wrappers}

    def hold(phase, kname, label, img, plain_img, budget):
        """Holds a kernel's image against its plain version's."""
        r = compare(img, plain_img.reshape(img.shape), budget)
        errs[kname].append(r["max_abs_err"])
        fracs[kname].append(r["frac"])
        h, w = img.shape[:2]
        print(f"{phase} {kname:12s} {label:38s} {h}x{w}: "
              f"{r['frac']:.5f} of pixels > {FRAC_TOL} (budget {budget}), "
              f"max abs err {r['max_abs_err']:.4g}, mean {r['mean']:.6f} vs "
              f"plain {r['plain_mean']:.6f} (rel {r['mean_rel']:.2e})")
        check(r["ok"], f"{kname} disagrees with its plain version on {label}")

    for label, kname, scene, cam, cfg, budget in cases:
        tables, v, eye, kw = rays(scene, cam, cfg)
        kern, plain = wrappers[kname]
        img = kern(tables, v, eye, **kw).reshape(n, n, 3)
        torch.cuda.synchronize()
        hold("check", kname, label, img, plain(tables, v, eye, **kw), budget)

    # ---- 3. the main path through the CLI -------------------------------
    os.makedirs(OUT_DIR, exist_ok=True)
    # (label, output file, CLI arguments, kernel the image is held against
    # and the preset call that gives its scene, or None for the jittered
    # adaptive demo)
    runs = [
        ("full_reflective 1024^2 d3", "full_reflective_1024_d3.png",
         ["--preset", "full_reflective", "--size", "1024", "--depth", "3"],
         ("render_chain", lambda: presets.full_reflective(size=1024,
                                                          depth=3))),
        ("reference_demo 500^2 d5 16spp adaptive", "reference_demo_500.png",
         ["--preset", "reference_demo", "--adaptive"], None),
        ("procedural_spheres n64 4096^2 d3", "procedural_spheres_4096.png",
         ["--preset", "procedural_spheres", "--size", "4096", "--depth", "3"],
         ("render_chain", lambda: presets.procedural_spheres(
             n=64, size=4096, depth=3))),
        ("full_reflective 1024^2 d3 tree", "full_reflective_1024_tree.png",
         ["--preset", "full_reflective", "--size", "1024", "--depth", "3",
          "--mode", "tree"],
         ("render_tree", lambda: presets.full_reflective(size=1024,
                                                         depth=3))),
    ]
    K.reset_launch_counts()
    images = {}
    for label, fname, args, _ in runs:
        images[label] = cli.main(["render", *args, "--out",
                                  os.path.join(OUT_DIR, fname)])
    torch.cuda.synchronize()
    launches = {k: K.LAUNCHES[k] for k in ("render_chain", "render_tree")}
    print(f"main path launches: {launches}")
    for kname, count in launches.items():
        check(count > 0, f"the main path never launched {kname}")
    for label, img in images.items():
        check(img.is_cuda, f"{label}: rendered off the GPU")
        check(bool(torch.isfinite(img).all()), f"{label}: non-finite pixels")
        check(img.mean().item() > 0.01, f"{label}: black image")
        print(f"main {label:40s} shape {tuple(img.shape)} "
              f"mean {img.mean().item():.6f} finite")
    for label, _, _, against in runs:
        if against is None:
            continue
        kname, preset = against
        tables, v, eye, kw = rays(*preset())
        hold("main", kname, label, images.pop(label),
             wrappers[kname][1](tables, v, eye, **kw), 0.01)
        del tables, v
        torch.cuda.empty_cache()

    # ---- 4. the fit kernels against their plain versions at 128^2 -------
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
        FitParams, make_fit_step_kernel)
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.utils import opcount
    errs.update(render_packed=[], adjoint_packed=[])
    fracs.update(render_packed=[])
    fit_cases = [
        ("full_reflective d3", lambda s: presets.full_reflective(size=s,
                                                                 depth=3)),
        ("procedural_spheres n64 d3",
         lambda s: presets.procedural_spheres(n=64, size=s, depth=3)),
        ("glass_chain d3", lambda s: presets.glass_chain(size=s, depth=3)),
    ]
    for label, make in fit_cases:
        x = fit_inputs(K, AF, dev, make(n))
        t, v, eye, kw = x["tables"], x["v"], x["eye"], x["kw"]
        torch.cuda.synchronize()
        img_ref, pk_ref = K.render_packed_ref(t, v, eye, pack=x["akw"]["pack"],
                                              **kw)
        hold("check", "render_packed", label, x["img"].reshape(n, n, 3),
             img_ref, 0.01)
        pk_frac = (x["pk"] != pk_ref).float().mean().item()
        same = torch.equal(x["img"], K.render_chain(t, v, eye, **kw))
        print(f"check render_packed {label}: {pk_frac:.5f} of packed "
              f"residuals differ from the plain version's (budget 0.01); "
              f"image bit-identical to render_chain: {same}")
        check(pk_frac <= 0.01, f"render_packed residuals on {label}")
        args = (t, v, eye, x["img"], x["target"], x["mask"], x["pk"])
        a = AF.adjoint_packed(*args, **x["akw"])
        b = AF.adjoint_packed(*args, **x["akw"])
        torch.cuda.synchronize()
        ident = all(torch.equal(p, q) for p, q in zip(a, b))
        print(f"check adjoint_packed {label}: two launches bit-identical: "
              f"{ident}")
        check(ident, f"adjoint_packed is not deterministic on {label}")
        errs["adjoint_packed"].append(hold_adjoint(AF, label, x, a))
        del x, a, b
    torch.cuda.empty_cache()

    # ---- 5. the fit path -------------------------------------------------
    fr3 = presets.full_reflective(size=1024, depth=3)
    c5 = presets.procedural_spheres(n=64, size=2048, depth=3)
    fit_runs = {}
    K.reset_launch_counts()
    for label, preset in (("config 3 1024^2 d3", fr3),
                          ("config 5 2048^2 d3", c5)):
        scene, cam, cfg = preset
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        target = K.render_image_kernel(scene, camera, cfg, device=dev)
        params = FitParams.from_scene(scene).to(dev)
        with torch.no_grad():
            params.sph_center += 1.5
        fit_runs[label] = (preset, *AF.fit_value_and_grad(
            params, scene, camera, cfg, target, mode="twophase", device=dev))
        if label.startswith("config 3"):
            step = make_fit_step_kernel(
                scene, camera, cfg, target,
                torch.optim.Adam([params.sph_center], lr=0.3), device=dev)
            steps = [float(step(params)) for _ in range(5)]
            print(f"fit {label}: 5 Adam steps of make_fit_step_kernel, "
                  f"loss {' -> '.join(f'{x:.6g}' for x in steps)}")
            check(steps[-1] < steps[0], f"{label}: the loss did not fall")
    fit_dir = os.path.join(OUT_DIR, "fit_512")
    # --lr 0.1: at the CLI's default geometry rate of 0.5 this recipe's
    # loss rises after a few steps, in the JAX package's CLI as in the port
    _, history = cli.main(["fit", "--size", "512", "--steps", "20",
                           "--lr", "0.1", "--out-dir", fit_dir])
    torch.cuda.synchronize()
    fit_launches = {k: K.LAUNCHES[k]
                    for k in ("render_packed", "adjoint_packed")}
    print(f"fit path launches: {fit_launches}")
    for kname, count in fit_launches.items():
        check(count > 0, f"the fit path never launched {kname}")
    launches.update(fit_launches)
    check(history[-1] < history[0] and all(map(math.isfinite, history)),
          f"CLI fit at 512^2: the loss did not fall ({history})")
    print(f"fit config 4 512^2 through the CLI: loss {history[0]:.6g} -> "
          f"{history[-1]:.6g} in 20 steps; files "
          f"{sorted(os.listdir(fit_dir))}")
    for label, (preset, loss, grads) in fit_runs.items():
        for f in FIELDS:
            check(bool(torch.isfinite(grads[f]).all()),
                  f"{label}: non-finite {f} gradient")
        # the same inputs through the plain version: the packed kernel's
        # own image and residuals of the moved scene (it is deterministic)
        x = fit_inputs(K, AF, dev, preset)
        sq, dsph, dmat, dlight = out = AF.adjoint_packed(
            x["tables"], x["v"], x["eye"], x["img"], x["target"], x["mask"],
            x["pk"], **x["akw"])
        ns, m = (x["tables"][k].shape[0] for k in ("sph", "mat"))
        nl = x["akw"]["nl"]
        g_c = AF.grads_to_fitparams(x["params"], preset[0], dict(
            sph_center=dsph[:ns, 0:3], sph_radius=dsph[:ns, 3],
            mat_ambient=dmat[:m, 0:3], mat_diffuse=dmat[:m, 3:6],
            mat_specular=dmat[:m, 6:9], light_pos=dlight[:nl, 0:3]))
        same = (torch.equal(sq / (x["v"].shape[0] * 3), loss)
                and all(torch.equal(g_c[f], grads[f]) for f in FIELDS))
        print(f"fit {label}: loss {loss.item():.7g}; fit_value_and_grad "
              f"equals a second packed+adjoint launch bit for bit: {same}")
        check(same, f"{label}: fit_value_and_grad is not reproducible")
        errs["adjoint_packed"].append(hold_adjoint(AF, label, x, out))
        del x, out, dsph, dmat, dlight
        torch.cuda.empty_cache()
    del fit_runs
    torch.cuda.empty_cache()

    # ---- 6. K6 and K7 against their plain versions at 128^2 -------------
    from ray_tracer_fragment_shader_tpu_torch.diff.fit import (
        default_fit_optimizer, fit)
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import sample_jitter
    errs.update(fused_adjoint=[], recompute_adjoint=[])
    frac_case = ("fractional_glass d3 (tree)",
                 lambda s: presets.fractional_glass(size=s, depth=3))
    for label, make in fit_cases + [frac_case]:
        x = fit_inputs(K, AF, dev, make(n))
        args, kw6 = fused_args(x)
        a = twice(lambda: AF.fused_adjoint(*args, **kw6), "fused_adjoint",
                  label)
        errs["fused_adjoint"].append(hold_grads(
            "fused_adjoint", label, a, AF.fused_adjoint_ref(*args, **kw6)))
        if not x["tree"]:
            hold_grads("fused_adjoint", label, a, AF.adjoint_packed(
                x["tables"], x["v"], x["eye"], x["img"], x["target"],
                x["mask"], x["pk"], **x["akw"]), against="K3+K4")
        args7, kw7 = recompute_args(K, x)
        b = twice(lambda: AF.recompute_adjoint(*args7, **kw7),
                  "recompute_adjoint", label)
        errs["recompute_adjoint"].append(hold_grads(
            "recompute_adjoint", label, b,
            AF.recompute_adjoint_ref(*args7, **kw7)))
        del x, a, b, args, args7
    torch.cuda.empty_cache()

    # ---- 7. this slice's paths at full width ----------------------------
    slice_launches = {"fused_adjoint": 0, "recompute_adjoint": 0}

    def drive(label, fn, want, absent=(), into=None):
        """Runs one path with the launch counters zeroed just before; each
        kernel of ``want`` must have launched, none of ``absent``.  The
        counts of the kernels ``into`` names (default: this phase's) are
        added to it."""
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        print(f"path {label}: launches "
              f"{ {k: c for k, c in counts.items() if c} }")
        for k in want:
            check(counts[k] > 0, f"{label}: the path never launched {k}")
        for k in absent:
            check(counts[k] == 0, f"{label}: the path launched {k}")
        acc = slice_launches if into is None else into
        for k in acc:
            acc[k] += counts[k]
        return out, counts

    def seeded(cfg):
        return torch.Generator(dev).manual_seed(cfg.seed)

    # fused chain: config 3, mode="fused"
    x = fit_inputs(K, AF, dev, fr3)
    params = x["params"].to(dev)
    (loss, grads), _ = drive(
        "fused chain, config 3 1024^2 d3",
        lambda: AF.fit_value_and_grad(params, x["scene"], x["camera"],
                                      x["cfg"], x["target"], mode="fused",
                                      device=dev),
        want=["fused_adjoint"], absent=["render_packed", "adjoint_packed"])
    args, kw6 = fused_args(x)
    direct = AF.fused_adjoint(*args, **kw6)
    P3 = x["v"].shape[0]
    same = (torch.equal(direct[0] / (P3 * 3), loss) and all(
        torch.equal(as_fields(AF, x, direct[1:])[f], grads[f])
        for f in FIELDS))
    print(f"path fused chain: loss {loss.item():.7g}; equals a direct K6 "
          f"launch bit for bit: {same}")
    check(same, "fused chain: fit_value_and_grad is not reproducible")
    errs["fused_adjoint"].append(hold_grads(
        "fused_adjoint", "config 3 1024^2 d3 (path)", direct,
        AF.fused_adjoint_ref(*args, **kw6)))
    del x, args, direct, params
    torch.cuda.empty_cache()

    # the tree fit: fractional_glass 1024^2 d3 through fit(), 5 Adam steps
    # over every leaf (tests/test_adjoint_tree.py:84-108)
    fg3 = presets.fractional_glass(size=1024, depth=3)
    start = FitParams.from_scene(fg3[0])
    with torch.no_grad():
        start.mat_diffuse.mul_(1.6).add_(0.05)
    x = fit_inputs(K, AF, dev, fg3, params=start)
    params = FitParams.from_scene(fg3[0]).to(dev)
    params.load_state_dict(start.state_dict())
    (_, history), _ = drive(
        "tree fit, fractional_glass 1024^2 d3",
        lambda: fit(fg3[0], x["camera"], fg3[2], x["target"], steps=5,
                    params=params, optimizer=torch.optim.Adam(
                        params.parameters(), lr=0.02), device=dev),
        want=["fused_adjoint"], absent=["render_packed", "adjoint_packed"])
    print(f"path tree fit: 5 Adam steps of fit(), loss "
          f"{' -> '.join(f'{v:.6g}' for v in history)}")
    check(history[-1] < history[0] and all(map(math.isfinite, history)),
          "tree fit: the loss did not fall")
    args, kw6 = fused_args(x)
    direct = AF.fused_adjoint(*args, **kw6)
    check(float(direct[0] / (x["v"].shape[0] * 3)) == history[0],
          "tree fit: the first step's loss is not K6's")
    errs["fused_adjoint"].append(hold_grads(
        "fused_adjoint", "fractional_glass 1024^2 d3 (path, first step)",
        direct, AF.fused_adjoint_ref(*args, **kw6)))
    del x, args, direct, params
    torch.cuda.empty_cache()

    # the reference's frame: 500^2 d5, 16 samples adaptive, differentiated
    demo_a = dataclasses.replace(demo_cfg, adaptive=True)
    supersampled = [
        ("reference frame, reference_demo 500^2 d5 16 spp adaptive",
         (demo, demo_cam, demo_a), "render_chain", 3),
        ("tree supersampled, fractional_glass 512^2 d3 4 spp",
         (lambda s, c, f: (s, c, dataclasses.replace(f, samples=4)))(
             *presets.fractional_glass(size=512, depth=3)), "render_tree",
         0)]
    sampled_runs = {}
    for label, preset, render_k, adam_steps in supersampled:
        scene, cam, cfg = preset
        camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
        P = cfg.width * cfg.height
        gen = seeded(cfg)
        jit = torch.stack([sample_jitter(gen, P, cfg.jitter_scale).to(dev)
                           for _ in range(cfg.samples)])
        target = K.render_image_kernel(scene, camera, cfg, jitter=jit,
                                       device=dev)
        start = FitParams.from_scene(scene)
        with torch.no_grad():
            start.sph_center += 1.5
        params = FitParams.from_scene(scene).to(dev)
        params.load_state_dict(start.state_dict())
        (loss, grads), counts = drive(
            label, lambda: AF.fit_value_and_grad(
                params, scene, camera, cfg, target, generator=seeded(cfg),
                device=dev),
            want=[render_k, "recompute_adjoint"])
        rendered = counts[render_k]
        check(rendered == counts["recompute_adjoint"] <= cfg.samples,
              f"{label}: {counts} launches for {cfg.samples} samples")
        if adam_steps:
            opt = default_fit_optimizer(params)

            def adam():
                out = []
                for _ in range(adam_steps):
                    opt.zero_grad()
                    lv, gv = AF.fit_value_and_grad(
                        params, scene, camera, cfg, target,
                        generator=seeded(cfg), device=dev)
                    for f in FIELDS:
                        getattr(params, f).grad = gv[f]
                    opt.step()
                    out.append(float(lv))
                return out
            steps, _ = drive(label + ", Adam steps", adam,
                             want=[render_k, "recompute_adjoint"])
            print(f"path {label}: {adam_steps} Adam steps "
                  f"(default_fit_optimizer), loss {float(loss):.6g} -> "
                  f"{' -> '.join(f'{v:.6g}' for v in steps)}")
            check(all(map(math.isfinite, steps)), f"{label}: loss not finite")
        ref_loss, ref, accepts = sampled_plain(AF, K, dev, preset, start,
                                              jit)
        if cfg.adaptive:
            shares = [round(a.float().mean().item(), 4) for a in accepts]
            print(f"path {label}: {rendered} of {cfg.samples} samples "
                  f"rendered; accept shares {shares}")
            check(len(accepts) == rendered and any(0 < a < 1 for a in shares),
                  f"{label}: the accept planes are not mixed")
        errs["recompute_adjoint"].append(hold_fields(
            "recompute_adjoint", label + " (path)", loss, grads, ref_loss,
            ref))
        sampled_runs[label] = (preset, camera, target, start, rendered)
        del params, grads, ref, accepts, jit
        torch.cuda.empty_cache()
    print(f"this slice's paths launched {slice_launches}")
    launches.update(slice_launches)

    # ---- 8. times --------------------------------------------------------
    timed = {
        "render_chain": ("full_reflective 1024^2 d3",
                         rays(*presets.full_reflective(size=1024, depth=3))),
        "render_tree": ("fractional_glass 1024^2 d3",
                        rays(*presets.fractional_glass(size=1024, depth=3))),
    }
    times, bounds = {}, {}
    works = {}  # each kernel's work on its timed inputs, for phase 13

    for kname, (label, (tables, v, eye, kw)) in timed.items():
        kern, plain = wrappers[kname]
        hold("timed", kname, label,
             kern(tables, v, eye, **kw).reshape(1024, 1024, 3),
             plain(tables, v, eye, **kw), 0.01)
        tk, tp, runs = four_times(lambda: kern(tables, v, eye, **kw),
                                  lambda: plain(tables, v, eye, **kw), 20, 3)
        work = opcount.forward_work(tables, v, eye,
                                    tree=kname == "render_tree", **kw)
        bounds[kname] = opcount.bound_ms(work["ops"], work["bytes"])
        works[kname] = work
        P = v.shape[0]
        times[kname] = (tk, tp)
        print(f"time {kname:12s} {label}: kernel {tk:.4f} ms "
              f"({runs[0]:.4f}, {runs[1]:.4f}) = {P / tk / 1e3:.1f} M rays/s; "
              f"plain {tp:.2f} ms ({runs[2]:.2f}, {runs[3]:.2f}) = "
              f"{P / tp / 1e3:.2f} M rays/s; speed-up {tp / tk:.1f}x; "
              f"bound {bounds[kname][0]:.5f} ms ({bounds[kname][1]}: "
              f"{work['ops']:.4g} FP32 ops, {work['bytes']:.4g} B) [{card}]")

    for label, preset in (("config 3 1024^2 d3", fr3),
                          ("config 5 2048^2 d3", c5)):
        x = fit_inputs(K, AF, dev, preset)
        t, v, eye, kw, akw = x["tables"], x["v"], x["eye"], x["kw"], x["akw"]
        args = (t, v, eye, x["img"], x["target"], x["mask"], x["pk"])
        tk3, tp3, r3 = four_times(
            lambda: K.render_packed(t, v, eye, pack=akw["pack"], **kw),
            lambda: K.render_packed_ref(t, v, eye, pack=akw["pack"], **kw),
            20, 2)
        tk4, tp4, r4 = four_times(lambda: AF.adjoint_packed(*args, **akw),
                                  lambda: AF.adjoint_packed_ref(*args, **akw),
                                  20, 2)
        w3 = opcount.forward_work(t, v, eye, packed=True, **kw)
        w4 = opcount.adjoint_work(t, x["img"], x["target"], x["mask"],
                                  x["pk"], pack=akw["pack"], nl=akw["nl"],
                                  depth=akw["depth"],
                                  want_trans=akw["want_trans"])
        b3 = opcount.bound_ms(w3["ops"], w3["bytes"])
        b4 = opcount.bound_ms(w4["ops"], w4["bytes"])
        params = x["params"].to(dev)
        prep = AF.prepare_fit_inputs(x["camera"], x["cfg"], x["target"],
                                     device=dev)

        def step():
            return AF.fit_value_and_grad(params, x["scene"], x["camera"],
                                         x["cfg"], x["target"], prep=prep,
                                         mode="twophase", device=dev)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        t_step = (time.perf_counter() - t0) / 10 * 1e3
        P = v.shape[0]
        print(f"time render_packed   {label}: kernel {tk3:.4f} ms "
              f"({r3[0]:.4f}, {r3[1]:.4f}); plain {tp3:.2f} ms ({r3[2]:.2f}, "
              f"{r3[3]:.2f}); bound {b3[0]:.5f} ms ({b3[1]}: "
              f"{w3['ops']:.4g} FP32 ops, {w3['bytes']:.4g} B) [{card}]")
        print(f"time adjoint_packed  {label}: kernel {tk4:.4f} ms "
              f"({r4[0]:.4f}, {r4[1]:.4f}); plain {tp4:.2f} ms ({r4[2]:.2f}, "
              f"{r4[3]:.2f}); bound {b4[0]:.5f} ms ({b4[1]}: "
              f"{w4['ops']:.4g} FP32 ops, {w4['bytes']:.4g} B; "
              f"{w4['live_pixels']} pixels with a cotangent, "
              f"{w4['hit_levels']} hit levels) [{card}]")
        print(f"time fwd+bwd step    {label}: fit_value_and_grad "
              f"{t_step:.4f} ms on the host clock = {P / t_step / 1e3:.1f} M "
              f"rays/s; K3+K4 {tk3 + tk4:.4f} ms = "
              f"{P / (tk3 + tk4) / 1e3:.1f} M rays/s [{card}]")
        if label.startswith("config 3"):
            times["render_packed"] = (tk3, tp3)
            times["adjoint_packed"] = (tk4, tp4)
            bounds["render_packed"], bounds["adjoint_packed"] = b3, b4
            works.update(render_packed=w3, adjoint_packed=w4)
        del x, args, prep
        torch.cuda.empty_cache()

    # K6 and K7, their plain versions, K6 against K3+K4, and each path's
    # step on the host clock
    def step_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def k3k4(x):
        img, pk = K.render_packed(x["tables"], x["v"], x["eye"],
                                  pack=x["akw"]["pack"], **x["kw"])
        return AF.adjoint_packed(x["tables"], x["v"], x["eye"], img,
                                 x["target"], x["mask"], pk, **x["akw"])

    k6_cases = [("config 3 1024^2 d3", fr3, True),
                ("config 5 2048^2 d3", c5, False),
                ("fractional_glass 1024^2 d3", fg3, True)]
    for label, preset, with_plain in k6_cases:
        x = fit_inputs(K, AF, dev, preset)
        args, kw6 = fused_args(x)
        P = x["v"].shape[0]
        if with_plain:
            tk, tp, r = four_times(lambda: AF.fused_adjoint(*args, **kw6),
                                   lambda: AF.fused_adjoint_ref(*args, **kw6),
                                   20, 1)
            plain_txt = f"plain {tp:.2f} ms ({r[2]:.2f}, {r[3]:.2f}); "
        else:
            tk, tp = time_ms(lambda: AF.fused_adjoint(*args, **kw6), 20), None
            plain_txt = "plain not timed (K3+K4's plain K4 is timed); "
        w6 = opcount.fused_work(x["tables"], x["v"], x["eye"], tree=x["tree"],
                                target=x["target"], mask=x["mask"],
                                **x["kw"])
        b6 = opcount.bound_ms(w6["ops"], w6["bytes"])
        print(f"time fused_adjoint   {label}: kernel {tk:.4f} ms; "
              f"{plain_txt}bound {b6[0]:.5f} ms ({b6[1]}: "
              f"{w6['ops']:.4g} FP32 ops, {w6['bytes']:.4g} B; "
              f"{w6['live_pixels']} pixels with a cotangent, "
              f"{w6['adjoint_nodes']} adjoint nodes) [{card}]")
        if not x["tree"]:
            # two-phase and fused, alternated: K3+K4, K6, K6, K3+K4
            t6, t34, r = four_times(lambda: AF.fused_adjoint(*args, **kw6),
                                    lambda: k3k4(x), 20, 20)
            hold_grads("fused_adjoint", label, AF.fused_adjoint(*args, **kw6),
                       k3k4(x), against="K3+K4")
            print(f"time K6 against K3+K4 {label}: K6 {t6:.4f} ms "
                  f"({r[0]:.4f}, {r[1]:.4f}); K3+K4 {t34:.4f} ms "
                  f"({r[2]:.4f}, {r[3]:.4f}); K6/(K3+K4) {t6 / t34:.3f} "
                  f"[{card}]")
        if label.startswith("config 3"):
            times["fused_adjoint"] = (tk, tp)
            bounds["fused_adjoint"] = b6
            works["fused_adjoint"] = w6
        params = x["params"].to(dev)
        prep = AF.prepare_fit_inputs(x["camera"], x["cfg"], x["target"],
                                     device=dev)
        t_step = step_ms(lambda: AF.fit_value_and_grad(
            params, x["scene"], x["camera"], x["cfg"], x["target"],
            prep=prep, mode="fused", device=dev), 10)
        print(f"time fused step      {label}: fit_value_and_grad(mode="
              f"\"fused\") {t_step:.4f} ms on the host clock = "
              f"{P / t_step / 1e3:.1f} M rays/s; K6 {tk:.4f} ms [{card}]")
        del x, args, params, prep
        torch.cuda.empty_cache()

    demo1 = dataclasses.replace(demo_cfg, samples=1)
    k7_cases = [("reference_demo 500^2 d5, one sample", (demo, demo_cam,
                                                         demo1)),
                ("fractional_glass 512^2 d3, one sample",
                 presets.fractional_glass(size=512, depth=3))]
    for label, preset in k7_cases:
        x = fit_inputs(K, AF, dev, preset)
        args7, kw7 = recompute_args(K, x)
        errs["recompute_adjoint"].append(hold_grads(
            "recompute_adjoint", label + " (timed)",
            AF.recompute_adjoint(*args7, **kw7),
            AF.recompute_adjoint_ref(*args7, **kw7)))
        tk, tp, r = four_times(lambda: AF.recompute_adjoint(*args7, **kw7),
                               lambda: AF.recompute_adjoint_ref(*args7, **kw7),
                               20, 1)
        w7 = opcount.fused_work(x["tables"], x["v"], x["eye"], tree=x["tree"],
                                g=args7[3], **x["kw"])
        b7 = opcount.bound_ms(w7["ops"], w7["bytes"])
        print(f"time recompute_adjoint {label}: kernel {tk:.4f} ms "
              f"({r[0]:.4f}, {r[1]:.4f}); plain {tp:.2f} ms ({r[2]:.2f}, "
              f"{r[3]:.2f}); bound {b7[0]:.5f} ms ({b7[1]}: "
              f"{w7['ops']:.4g} FP32 ops, {w7['bytes']:.4g} B; "
              f"{w7['live_pixels']} pixels with a cotangent, "
              f"{w7['adjoint_nodes']} adjoint nodes) [{card}]")
        if label.startswith("reference_demo"):
            times["recompute_adjoint"] = (tk, tp)
            bounds["recompute_adjoint"] = b7
            works["recompute_adjoint"] = w7
        del x, args7
        torch.cuda.empty_cache()

    for label, (preset, camera, target, start, rendered) in \
            sampled_runs.items():
        scene, _, cfg = preset
        params = FitParams.from_scene(scene).to(dev)
        params.load_state_dict(start.state_dict())
        t_step = step_ms(lambda: AF.fit_value_and_grad(
            params, scene, camera, cfg, target, generator=seeded(cfg),
            device=dev), 3)
        n_rays = cfg.width * cfg.height * rendered
        print(f"time sampled step    {label}: fit_value_and_grad "
              f"{t_step:.4f} ms on the host clock, {rendered} samples "
              f"rendered = {n_rays / t_step / 1e3:.1f} M rays/s [{card}]")
        del params
    torch.cuda.empty_cache()

    # ---- 9. the residual forwards and K8 against their plain versions --
    from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint import (
        l2_loss_kernel)
    errs.update(render_chain_residuals=[], render_tree_residuals=[],
                fit_grads=[])
    fracs.update(render_chain_residuals=[], render_tree_residuals=[])

    def hold_residuals(phase, label, tables, v, eye, kw, tree, side):
        """The residual forward against its plain version: planes equal,
        the image within phase 2's budget.  Returns (img, planes)."""
        kname = "render_tree_residuals" if tree else "render_chain_residuals"
        img, res = K.render_residuals(tables, v, eye, tree=tree, **kw)
        torch.cuda.synchronize()
        img_ref, res_ref = K.render_residuals_ref(tables, v, eye, tree=tree,
                                                  **kw)
        hold(phase, kname, label, img.reshape(side, side, 3), img_ref, 0.01)
        diff = {k: (res[k] != res_ref[k]).float().mean().item() for k in res}
        plain = (K.render_tree if tree else K.render_chain)(tables, v, eye,
                                                            **kw)
        print(f"{phase} {kname} {label}: planes differing from the plain "
              f"version's {diff} (must be 0); image bit-identical to "
              f"{'render_tree' if tree else 'render_chain'}: "
              f"{torch.equal(img, plain)}")
        check(all(d == 0.0 for d in diff.values()),
              f"{kname} planes differ from the plain version's on {label}")
        return img, res

    def split_inputs(x):
        """K8's inputs on ``x``: the residual forward of the moved scene and
        the cotangent (2/denom)(img - target), in K4's order."""
        img, res = K.render_residuals(x["tables"], x["v"], x["eye"],
                                      tree=False, **x["kw"])
        g = (x["akw"]["g_scale"] * (img - x["target"])).contiguous()
        fkw = {k: x["akw"][k] for k in ("nl", "depth", "atten",
                                         "want_trans")}
        return (x["tables"], x["v"], x["eye"], g, res), fkw

    def k4_of(x):
        return AF.adjoint_packed(x["tables"], x["v"], x["eye"], x["img"],
                                 x["target"], x["mask"], x["pk"],
                                 **x["akw"])[1:]

    def against_k4(label, got, k4):
        """K8's tables against K4's on the same inputs: equal bit for bit
        is expected (one chain_adjoint, one cotangent order)."""
        same = all(torch.equal(a, b) for a, b in zip(got, k4))
        worst = max((a - b).abs().max().item() for a, b in zip(got, k4))
        print(f"check fit_grads {label}: tables equal K4's bit for bit: "
              f"{same} (max|K8 - K4| {worst:.3g})")
        hold_grads("fit_grads", label, got, k4, against="K4")
        return same

    for label, make in fit_cases + [frac_case]:
        scene, cam, cfg = make(n)
        hold_residuals("check", label, *rays(scene, cam, cfg),
                       not scene.chain_exact, n)
    for label, make in fit_cases:
        x = fit_inputs(K, AF, dev, make(n))
        args8, fkw = split_inputs(x)
        a = twice(lambda: AF.fit_grads(*args8, **fkw), "fit_grads", label)
        errs["fit_grads"].append(hold_grads(
            "fit_grads", label, a, AF.fit_grads_ref(*args8, **fkw)))
        against_k4(label, a, k4_of(x))
        del x, args8, a
    torch.cuda.empty_cache()

    # ---- 10. this slice's paths at full width ---------------------------
    split_launches = {"render_chain_residuals": 0,
                      "render_tree_residuals": 0, "fit_grads": 0}
    x = fit_inputs(K, AF, dev, fr3)
    params = FitParams.from_scene(fr3[0]).to(dev)
    params.load_state_dict(x["params"].state_dict())
    opt = default_fit_optimizer(params)
    first = {}

    def split_steps():
        out = []
        for _ in range(5):
            opt.zero_grad()
            lv, gv = AF.fit_value_and_grad(params, x["scene"], x["camera"],
                                           x["cfg"], x["target"],
                                           mode="split", device=dev)
            first.setdefault("loss", lv)
            first.setdefault("grads", gv)
            for f in FIELDS:
                getattr(params, f).grad = gv[f]
            opt.step()
            out.append(float(lv))
        return out
    steps, _ = drive("split fit, config 3 1024^2 d3, 5 Adam steps",
                     split_steps, want=["render_chain_residuals", "fit_grads"],
                     absent=["render_packed", "adjoint_packed",
                             "fused_adjoint"], into=split_launches)
    print(f"path split fit: 5 Adam steps (default_fit_optimizer), loss "
          f"{' -> '.join(f'{v:.6g}' for v in steps)}")
    check(all(map(math.isfinite, steps)), "split fit: loss not finite")
    start = x["params"].to(dev)
    l4, g4 = AF.fit_value_and_grad(start, x["scene"], x["camera"], x["cfg"],
                                   x["target"], mode="twophase", device=dev)
    hold_fields("fit_grads", "config 3 1024^2 d3 (path, first step)",
                first["loss"], first["grads"], l4, g4, against="two-phase")
    print("path split fit: first step's gradients equal the two-phase "
          "path's bit for bit: "
          f"{all(torch.equal(first['grads'][f], g4[f]) for f in FIELDS)}")

    # render_image_diff at config 3: gradients to FitParams and the camera
    pd = FitParams.from_scene(fr3[0]).to(dev)
    pd.load_state_dict(x["params"].state_dict())
    cam_g = dataclasses.replace(x["camera"], **{
        f.name: getattr(x["camera"], f.name).clone().requires_grad_()
        for f in dataclasses.fields(x["camera"])})

    def diff_step():
        loss = l2_loss_kernel(pd, x["scene"], cam_g, x["cfg"], x["target"],
                              device=dev)
        loss.backward()
        return loss.detach()
    loss_d, _ = drive("render_image_diff, config 3 1024^2 d3", diff_step,
                      want=["render_chain_residuals"],
                      absent=["fit_grads", "render_packed",
                              "adjoint_packed"], into=split_launches)
    l8, g8 = AF.fit_value_and_grad(start, x["scene"], x["camera"], x["cfg"],
                                   x["target"], mode="split", device=dev)
    hold_fields("render_chain_residuals", "render_image_diff config 3 "
                "1024^2 d3 (path)", loss_d,
                {f: getattr(pd, f).grad for f in FIELDS}, l8, g8,
                against="K8")
    cam_grads = {f.name: getattr(cam_g, f.name).grad
                 for f in dataclasses.fields(cam_g)}
    print("path render_image_diff: camera gradients "
          + " ".join(f"{k} {v.tolist()}" for k, v in cam_grads.items()))
    check(all(v is not None and bool(torch.isfinite(v).all())
              for v in cam_grads.values()),
          "render_image_diff: a camera tensor has no finite gradient")
    del x, params, opt, first, start, pd, cam_g
    torch.cuda.empty_cache()

    # config 5 2048^2: one split step held against two-phase
    x = fit_inputs(K, AF, dev, c5)
    params = x["params"].to(dev)
    (l5, g5), _ = drive(
        "split step, config 5 2048^2 d3",
        lambda: AF.fit_value_and_grad(params, x["scene"], x["camera"],
                                      x["cfg"], x["target"], mode="split",
                                      device=dev),
        want=["render_chain_residuals", "fit_grads"], into=split_launches)
    l5t, g5t = AF.fit_value_and_grad(params, x["scene"], x["camera"],
                                     x["cfg"], x["target"], mode="twophase",
                                     device=dev)
    hold_fields("fit_grads", "config 5 2048^2 d3 (path)", l5, g5, l5t, g5t,
                against="two-phase")
    print("path split step config 5: gradients equal the two-phase path's "
          f"bit for bit: {all(torch.equal(g5[f], g5t[f]) for f in FIELDS)}")
    del x, params, g5, g5t
    torch.cuda.empty_cache()

    # render_image_diff on the tree (residual K5) against K6's tree tables
    x = fit_inputs(K, AF, dev, fg3)
    pt = FitParams.from_scene(fg3[0]).to(dev)
    pt.load_state_dict(x["params"].state_dict())

    def tree_diff_step():
        loss = l2_loss_kernel(pt, fg3[0], x["camera"], fg3[2], x["target"],
                              device=dev)
        loss.backward()
        return loss.detach()
    loss_t, _ = drive("render_image_diff, fractional_glass 1024^2 d3 (tree)",
                      tree_diff_step, want=["render_tree_residuals"],
                      absent=["fused_adjoint"], into=split_launches)
    args, kw6 = fused_args(x)
    k6 = AF.fused_adjoint(*args, **kw6)
    hold_fields("render_tree_residuals", "render_image_diff "
                "fractional_glass 1024^2 d3 (path)", loss_t,
                {f: getattr(pt, f).grad for f in FIELDS},
                k6[0] / (x["v"].shape[0] * 3), as_fields(AF, x, k6[1:]),
                against="K6")
    del x, pt, args, k6
    torch.cuda.empty_cache()
    print(f"this slice's paths launched {split_launches}")
    launches.update(split_launches)

    # ---- 11. the BASELINE gradient bar on the card ----------------------
    from ray_tracer_fragment_shader_tpu_torch import grad_bar
    check(grad_bar.main(["--out", os.path.join(REPO, grad_bar.OUT)]) == 0,
          f"grad bar: a check's max-abs-err > {grad_bar.BAR} [{card}]")

    # ---- 12. times of this slice's kernels and paths ---------------------
    for kname, label, preset in (
            ("render_chain_residuals", "config 3 1024^2 d3", fr3),
            ("render_tree_residuals", "fractional_glass 1024^2 d3", fg3)):
        tables, v, eye, kw = rays(*preset)
        tree = kname == "render_tree_residuals"
        hold_residuals("timed", label, tables, v, eye, kw, tree, 1024)
        tk, tp, r = four_times(
            lambda: K.render_residuals(tables, v, eye, tree=tree, **kw),
            lambda: K.render_residuals_ref(tables, v, eye, tree=tree, **kw),
            20, 2)
        work = opcount.forward_work(tables, v, eye, tree=tree, residuals=True,
                                    **kw)
        times[kname], bounds[kname] = (tk, tp), opcount.bound_ms(
            work["ops"], work["bytes"])
        works[kname] = work
        print(f"time {kname} {label}: kernel {tk:.4f} ms ({r[0]:.4f}, "
              f"{r[1]:.4f}); plain {tp:.2f} ms ({r[2]:.2f}, {r[3]:.2f}); "
              f"bound {bounds[kname][0]:.5f} ms ({bounds[kname][1]}: "
              f"{work['ops']:.4g} FP32 ops, {work['bytes']:.4g} B) [{card}]")
        del tables, v
    for label, preset in (("config 3 1024^2 d3", fr3),
                          ("config 5 2048^2 d3", c5)):
        x = fit_inputs(K, AF, dev, preset)
        args8, fkw = split_inputs(x)
        errs["fit_grads"].append(hold_grads(
            "fit_grads", label + " (timed)", AF.fit_grads(*args8, **fkw),
            k4_of(x), against="K4"))
        # K4, K8, K8, K4
        t8, t4, r = four_times(lambda: AF.fit_grads(*args8, **fkw),
                               lambda: k4_of(x), 20, 20)
        w8 = opcount.fit_grads_work(x["tables"], args8[3], args8[4],
                                    nl=fkw["nl"], depth=fkw["depth"],
                                    want_trans=fkw["want_trans"])
        b8 = opcount.bound_ms(w8["ops"], w8["bytes"])
        print(f"time fit_grads {label}: K8 {t8:.4f} ms ({r[0]:.4f}, "
              f"{r[1]:.4f}); K4 alternated {t4:.4f} ms ({r[2]:.4f}, "
              f"{r[3]:.4f}); K8/K4 {t8 / t4:.3f}; bound {b8[0]:.5f} ms "
              f"({b8[1]}: {w8['ops']:.4g} FP32 ops, {w8['bytes']:.4g} B; "
              f"{w8['live_pixels']} pixels with a cotangent, "
              f"{w8['hit_levels']} hit levels) [{card}]")
        P = x["v"].shape[0]
        params = x["params"].to(dev)
        if label.startswith("config 3"):
            errs["fit_grads"].append(hold_grads(
                "fit_grads", label + " (timed, plain)",
                AF.fit_grads(*args8, **fkw),
                AF.fit_grads_ref(*args8, **fkw)))
            tp = (time_ms(lambda: AF.fit_grads_ref(*args8, **fkw), 1)
                  + time_ms(lambda: AF.fit_grads_ref(*args8, **fkw), 1)) / 2
            print(f"time fit_grads {label}: plain {tp:.2f} ms [{card}]")
            times["fit_grads"], bounds["fit_grads"] = (t8, tp), b8
            works["fit_grads"] = w8
            pd = FitParams.from_scene(preset[0]).to(dev)
            pd.load_state_dict(x["params"].state_dict())

            def diff_step():
                pd.zero_grad()
                l2_loss_kernel(pd, x["scene"], x["camera"], x["cfg"],
                               x["target"], device=dev).backward()
            t_diff = step_ms(diff_step, 5)
            print(f"time render_image_diff step {label}: l2_loss_kernel "
                  f"fwd+bwd {t_diff:.4f} ms on the host clock = "
                  f"{P / t_diff / 1e3:.1f} M rays/s [{card}]")
            del pd
        t_split = step_ms(lambda: AF.fit_value_and_grad(
            params, x["scene"], x["camera"], x["cfg"], x["target"],
            mode="split", device=dev), 10)
        t_two = step_ms(lambda: AF.fit_value_and_grad(
            params, x["scene"], x["camera"], x["cfg"], x["target"],
            mode="twophase", device=dev), 10)
        print(f"time split step {label}: fit_value_and_grad(mode=\"split\") "
              f"{t_split:.4f} ms on the host clock = {P / t_split / 1e3:.1f} "
              f"M rays/s; two-phase (no prep) {t_two:.4f} ms; K8 {t8:.4f} ms "
              f"[{card}]")
        del x, args8, params
        torch.cuda.empty_cache()

    # ---- 13. the probes, the bench, and bounds at K9's rates -----------
    k9 = probe_phase(dev, card, works, launches, errs, times, bounds)

    # ---- 14. bf16_shading and the unpacked K6/K7 -------------------------
    bf16_phase(dev, card, launches, errs, fracs, times, bounds, k9)

    # ---- 15. the compacted, sparse adjoints; trees to depth 10 ------------
    sparse_phase(dev, card, launches, errs)

    # ---- 16. the chain forward redesigned for the card -------------------
    chain_phase(dev, card, launches, errs, fracs, k9)

    # ---- 17. K6 redesigned for the card, and K5 --------------------------
    k6_phase(dev, card, launches, errs)

    # ---- 18. the core renderer and the fits on its autograd ---------------
    core_phase(dev, card)

    # ---- 19. the multi-rank paths: band render, band steps, one-rank NCCL -
    parallel_phase(dev, card, launches, errs)

    # ---- 20. the cell scripts: depth sweep, reference frame, fit demo ----
    scripts_phase(dev, card, launches, errs, fracs)

    # ---- 21. the look-at scanline of even-size frames against the oracle --
    checker_edge_phase(dev, card, launches, errs, fracs)

    kernels = []
    for k in list(KERNEL_SOURCES) + list(BF16_ROWS):
        source, replaces = KERNEL_SOURCES[BF16_ROWS.get(k, k)]
        kernels.append(dict(
            name=k, route="cuda", source=source,
            replaces=replaces, launches=launches[k],
            max_abs_err=max(errs[k]), ms=times[k][0], plain_ms=times[k][1],
            bound_ms=bounds[k][0], bound_by=bounds[k][1], library_ms=None))
        if k in fracs:
            kernels[-1]["max_mismatch_frac"] = max(fracs[k])
        if k in k9:
            kernels[-1].update(k9[k])
        if k in BF16_ROWS:
            kernels[-1]["variant"] = f"bf16_shading ({BF16_CODE})"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
