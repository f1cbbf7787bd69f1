"""The adjoint kernels K4, K6, K7 and K8 on the card: the one harness that
builds their inputs and cotangents and holds them against their plain
versions (``chip_smoke.py`` phase 15 and ``tests/test_torch_gpu.py`` use
it), and their times, beside another checkout's port package in the same
process.

    python -m ray_tracer_fragment_shader_tpu_torch.adjoint_ab \
        [--other DIR] [--out FILE] [--no-paths] [--cpu] [--size N]

The inputs are those of PERF.md's rows (``chip_smoke.py`` phase 8): the
scene's sphere centres moved by 1.5, the target the unmoved scene's render.
K4 at config 3 (full_reflective 1024^2 d3) and config 5 (procedural_spheres
n=64 2048^2 d3); K8 on the same inputs under K4's cotangent; K6 at config
3, config 5 and on fractional_glass 1024^2 d3 (the tree); K7 at
reference_demo 500^2 d5 (one sample) and fractional_glass 512^2 d3; K6 and
K7 in bf16 at config 3.  The cotangents (``cotangent``):

* ``real``: the moved scene's L2 cotangent;
* ``zero``: the target 0.01 off everywhere and the cotangent scale 0, so
  every pixel's cotangent is 0 and K4's and K6's loss is the full sum; its
  time is the kernel's fixed cost (launch, zeroing, the reduction);
* ``live``: the target 0.01 off everywhere, so every pixel's cotangent is
  nonzero and every pixel that hits runs its adjoint;
* ``one``: as ``live`` with the mask 0 but on one pixel, the hit pixel
  nearest the frame's centre (the plain forwards cannot make another live
  from their own last bits).

For each kernel and cotangent the script prints the live pixels, the CUDA-
event time over 20 launches (``utils/timing.py``) and the wrapper's host
time a call (the median of 20 calls enqueued behind a device sleep: what
a caller's thread spends before the launches are queued).  It then times
the paths a user runs on the host clock (``scan_diff_median``, median of
5): the config 3 fwd+bwd step, two-phase (K3+K4) and split (residual
K2+K8); the reference's 500^2 d5 16-spp adaptive frame differentiated
(16 K7); and ``render_image_diff``'s fwd+bwd on fractional_glass 1024^2
d3 (the tree replay).  With ``--other DIR`` (a checkout holding
``ray_tracer_fragment_shader_tpu_torch/``, e.g. the parent commit unpacked
with ``git archive``) that package is built from its own sources; every
kernel time is taken alternated other, this, this, other, and the kernels'
outputs compared (bit-equal, and max|diff|/max|this| per table); every
path in 10 pairs, alternating which runs first, with the medians, the
pairs this package won and the other's interquartile range.  Prints
the card's name and power limit first and one JSON line last (also
written to ``--out``).  Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from .utils.timing import (SLEEP_CYCLES_PER_S, scan_diff_median, step_runner,
                           time_ms)

PKG = "ray_tracer_fragment_shader_tpu_torch"
OUT = os.path.join("chiprun_out", "adjoint_ab_h100.json")
REPS = 20
COTANGENTS = ("real", "zero", "live", "one")
#: pairs of parent and change a path is timed in, with ``--other``
PATH_PAIRS = 10
#: max|kernel - plain| / max|plain| per gradient table; the loss's relative
#: difference (tests/test_adjoint_fused.py:51's tolerances)
GRAD_REL_TOL = 1e-3
LOSS_REL_TOL = 1e-5


def modules(pkg: str = PKG) -> SimpleNamespace:
    """The modules of the port package ``pkg`` this script drives."""
    sub = dict(AF="kernels.adjoint_fused", K="kernels.render",
               adjoint="kernels.adjoint", bench="bench", fit="diff.fit",
               rays="ops.rays", presets="scene.presets",
               cuda_build="kernels.cuda_build")
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}")
                              for k, m in sub.items()})


def load_other(root: str) -> SimpleNamespace:
    """The port package under ``root``, imported as ``other_port`` so that
    both packages live in one process; it builds its own library into its
    own ``_build/``."""
    pkg_dir = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        "other_port", os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return modules("other_port")


# ------------------------------------------------------- inputs, cotangents

def inputs(preset, dev, bf16: bool = False) -> dict:
    """The adjoints' inputs on ``preset`` (scene, camera config, config)
    with its sphere centres moved by 1.5 and the unmoved scene's render as
    the target: the tables, rays ``v``, ``eye``, render keywords ``kw``,
    ``target``, ``mask``, ``tree``, ``g_scale`` (2 / (3P)), the frame's
    ``width``, the moved scene's own render ``own``, and on chain scenes
    the pack holds the adjoint keywords ``akw`` and the packed forward's
    image and residuals (``img``, ``pk``)."""
    M = modules()
    scene, cam, cfg = preset
    cfg = dataclasses.replace(cfg, bf16_shading=bf16)
    camera = M.rays.Camera.from_config(cam, cfg.width, cfg.height,
                                       device=dev)
    target = M.K.render_image_kernel(scene, camera, cfg, device=dev)
    params = M.fit.FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.5
    moved = params.into_scene(scene)
    prep = M.AF.prepare_fit_inputs(camera, cfg, target, device=dev)
    v, eye = prep["v"], prep["eye"]
    scene_c, tables, kw = M.AF.scene_tables(moved, cfg, dev)
    x = dict(tables=tables, v=v, eye=eye, kw=kw, target=prep["target"],
             mask=prep["mask"], tree=not scene_c.chain_exact,
             g_scale=2.0 / (v.shape[0] * 3), width=cfg.width)
    render = M.K.render_tree if x["tree"] else M.K.render_chain
    x["own"] = render(tables, v, eye, **kw)
    if not x["tree"] and M.K.pack_fits(tables["tri"].shape[0],
                                       scene_c.num_spheres,
                                       scene_c.num_materials, kw["nl"]):
        x["akw"] = M.AF.kernel_inputs(moved, cfg, v.shape[0], device=dev)[3]
        x["img"], x["pk"] = M.K.render_packed(tables, v, eye,
                                              pack=x["akw"]["pack"], **kw)
    return x


def residuals(x) -> dict:
    """The residual forward's planes of ``x`` (made once)."""
    if "res" not in x:
        x["res"] = modules().K.render_residuals(
            x["tables"], x["v"], x["eye"], tree=x["tree"], **x["kw"])[1]
    return x["res"]


def one_pixel(x) -> int:
    """The pixel nearest the frame's centre whose primary ray hits (the
    residual forward's ``bi[0] >= 0``)."""
    if "one" not in x:
        P, W = x["v"].shape[0], x["width"]
        idx = torch.arange(P, device=x["v"].device)
        H = P // W
        d2 = ((idx // W - H // 2) ** 2 + (idx % W - W // 2) ** 2).float()
        d2 = torch.where(residuals(x)["bi"][0] >= 0, d2, float("inf"))
        x["one"] = int(torch.argmin(d2))
        if not bool(torch.isfinite(d2[x["one"]])):
            raise ValueError("no primary ray of the frame hits")
    return x["one"]


def cotangent(x, cot: str):
    """(target, mask, g_scale) of K6 and K7 under ``cot``, and K4's target
    (the real one, else its own packed image 0.01 off)."""
    target, mask, gs = x["target"], x["mask"], x["g_scale"]
    if cot == "zero":
        target, gs = x["own"] + 0.01, 0.0
    elif cot in ("live", "one"):
        target = x["own"] + 0.01
    if cot == "one":
        mask = torch.zeros_like(mask)
        mask[one_pixel(x)] = 1.0
    target4 = x.get("img")
    if target4 is not None:
        target4 = x["target"] if cot == "real" else target4 + 0.01
    return target, mask, gs, target4


def calls(x, cot: str) -> dict:
    """{key: (wrapper name, args, keywords)} of K6 and K7, on chain
    scenes K8, and where the pack holds them K4 and K8 under K4's
    cotangent (``k8_under_k4``), on ``x`` under the cotangent ``cot``;
    ``run`` launches one."""
    t, v, eye, kw = x["tables"], x["v"], x["eye"], x["kw"]
    target, mask, gs, target4 = cotangent(x, cot)
    g = (gs * ((x["own"] - target) * mask[:, None])).contiguous()
    out = {"fused_adjoint": ("fused_adjoint", (t, v, eye, target, mask),
                             dict(tree=x["tree"], g_scale=gs, **kw)),
           "recompute_adjoint": ("recompute_adjoint", (t, v, eye, g),
                                 dict(tree=x["tree"], **kw))}
    if x["tree"]:
        return out
    res = residuals(x)
    fkw = {k: kw[k] for k in ("nl", "depth", "atten", "want_trans")}
    out["fit_grads"] = ("fit_grads", (t, v, eye, g, res), fkw)
    if "akw" not in x:
        return out
    img, pk = x["img"], x["pk"]
    g4 = (gs * ((img - target4) * mask[:, None])).contiguous()
    out.update(
        adjoint_packed=("adjoint_packed", (t, v, eye, img, target4, mask, pk),
                        dict(x["akw"], g_scale=gs)),
        k8_under_k4=("fit_grads", (t, v, eye, g4, res), fkw))
    return out


def k6_kernels(M, x) -> list:
    """[(kernel name, template arguments, blocks of 256 a SM)] of each
    kernel instantiation K6 (``fused_adjoint``) runs on ``x`` in package
    ``M``: on the chain the records forward and the records adjoint where
    the package has them, else (and on the tree) the one-dispatch kernel
    at the tree's depth cap; blocks a SM at ``x``'s shared memory."""
    from .forward_ab import occupancy
    lib = M.cuda_build.load()
    kw, tree = x["kw"], x["tree"]
    wt, bf16, depth = int(kw["want_trans"]), int(kw["bf16"]), kw["depth"]
    flat = M.K._flat_tables(x["tables"], kw["nl"])
    ns, m = x["tables"]["sph"].shape[0], x["tables"]["mat"].shape[0]
    ncols = 1 + 4 * ns + 9 * m + 3 * kw["nl"]
    smem_t = 4 * flat.numel()
    smem_a = 4 * (flat.numel() + M.AF.ADJOINT_THREADS // 32 * ncols
                  + M.AF.ADJOINT_STAGE_FLOATS)
    if not tree and hasattr(lib, "rtfs_records_occupancy"):
        return [("render_chain_kernel", (wt, 3, bf16),
                 occupancy(M, "chain_occupancy", wt, 3, bf16, smem_t)),
                ("records_adjoint_kernel", (wt,),
                 occupancy(M, "records_occupancy", wt, smem_a))]
    cap = (next(c for c in M.AF.TREE_ADJOINT_DEPTH_CAPS if depth <= c)
           if tree else 0)
    return [("fused_adjoint_kernel", (int(tree), 0, wt, bf16, cap),
             occupancy(M, "fused_occupancy", int(tree), 0, wt, bf16, depth,
                       smem_a))]


def k6_all(M, smem_t: int, smem_a: int) -> list:
    """``k6_kernels``' triples for every K6 instantiation in package
    ``M``'s build log, blocks a SM at ``smem_t`` bytes of tables (a
    forward) or ``smem_a`` of tables and sums (an adjoint)."""
    from .forward_ab import occupancy, ptxas_kernels
    log = M.cuda_build.build_info.get("log", "")
    out = [("fused_adjoint_kernel", a,
            occupancy(M, "fused_occupancy", a[0], 0, a[2], a[3], a[4],
                      smem_a))
           for a in ptxas_kernels(log, "fused_adjoint_kernel") if a[1] == 0]
    if hasattr(M.cuda_build.load(), "rtfs_records_occupancy"):
        out += [("render_chain_kernel", a,
                 occupancy(M, "chain_occupancy", *a, smem_t))
                for a in ptxas_kernels(log, "render_chain_kernel")
                if a[1] == 3]
        out += [("records_adjoint_kernel", a,
                 occupancy(M, "records_occupancy", *a, smem_a))
                for a in ptxas_kernels(log, "records_adjoint_kernel")]
    return out


def forward_calls(x) -> dict:
    """{wrapper name: zero-argument launch} of the forward kernels on
    ``x``'s inputs: K2 and K3 on a chain scene, K5 on a tree scene."""
    t, v, eye, kw = x["tables"], x["v"], x["eye"], x["kw"]
    if x["tree"]:
        return {"render_tree": lambda M: M.K.render_tree(t, v, eye, **kw)}
    out = {"render_chain": lambda M: M.K.render_chain(t, v, eye, **kw)}
    if "akw" in x:
        out["render_packed"] = lambda M: M.K.render_packed(
            t, v, eye, pack=x["akw"]["pack"], **kw)
    return out


def run(M, call, plain: bool = False):
    """Launches ``call`` (a value of ``calls``) through module ``M``'s
    wrapper, or its plain version with ``plain``."""
    name, args, kw = call
    return getattr(M, name + ("_ref" if plain else ""))(*args, **kw)


def live_pixels(x, call) -> int:
    """The pixels whose cotangent ``call`` (on ``x``) makes nonzero."""
    name, a, kw = call
    if name == "adjoint_packed":
        d = (a[3] - a[4]) * a[5][:, None] * kw["g_scale"]
    elif name == "fused_adjoint":
        d = (x["own"] - a[3]) * a[4][:, None] * kw["g_scale"]
    else:
        d = a[3]
    return int((d != 0).any(-1).sum())


def _need(cond, msg):
    if not cond:
        raise AssertionError(msg)


def hold(x, cot: str, M=None) -> dict:
    """Each kernel of ``calls(x, cot)`` launched twice (bit-identical) and
    held against its plain version: the loss within LOSS_REL_TOL relative,
    each table within GRAD_REL_TOL of max|plain|, so a table the plain
    version leaves 0 is exactly 0.  Under ``zero`` every plain table is 0
    and K4's loss the full sum; under ``one`` some plain table is not 0.
    K8 under K4's cotangent equals K4 bit for bit, and so does K6 on the
    chain (its loss too).  Raises AssertionError;
    returns {key: dict(loss_rel, worst (the largest max|diff|/max|plain|),
    diffs (max|diff| per table), plain_max)}."""
    M = M or modules().AF
    got, report = {}, {}
    for key, call in calls(x, cot).items():
        a, b = run(M, call), run(M, call)
        torch.cuda.synchronize()
        _need(all(torch.equal(p, q) for p, q in zip(a, b)),
              f"{key} under {cot}: two launches differ")
        got[key] = a
        if key == "k8_under_k4":
            continue
        ref = run(M, call, plain=True)
        r = dict(loss_rel=None, worst=0.0, diffs=[])
        if len(a) == 4:
            r["loss_rel"] = abs(a[0].item() - ref[0].item()) / max(
                abs(ref[0].item()), 1e-30)
            _need(r["loss_rel"] <= LOSS_REL_TOL,
                  f"{key} under {cot}: loss rel {r['loss_rel']:.3g}")
            a, ref = a[1:], ref[1:]
        r["plain_max"] = max(q.abs().max().item() for q in ref)
        for p, q in zip(a, ref):
            scale, d = q.abs().max().item(), (p - q).abs().max().item()
            _need(d <= GRAD_REL_TOL * scale,
                  f"{key} under {cot}: max|diff| {d} against max|plain| "
                  f"{scale}")
            r["diffs"].append(d)
            r["worst"] = max(r["worst"], d / scale if scale > 0 else d)
        if cot == "zero":
            _need(r["plain_max"] == 0, f"{key}: a plain table is not 0 "
                  f"under the zero cotangent")
        if cot == "one":
            _need(r["plain_max"] > 0, f"{key}: every plain table is 0 under "
                  f"the one-pixel cotangent (pixel {one_pixel(x)})")
        report[key] = r
    if "k8_under_k4" in got:
        _need(all(torch.equal(p, q) for p, q in zip(
            got["k8_under_k4"], got["adjoint_packed"][1:])),
              f"K8 is not K4 bit for bit under {cot}")
    if "adjoint_packed" in got and hasattr(M, "fused_records_ref"):
        _need(all(torch.equal(p, q) for p, q in zip(
            got["fused_adjoint"], got["adjoint_packed"])),
              f"K6 is not K3+K4 bit for bit under {cot}")
    if cot == "zero" and "adjoint_packed" in got:
        _need(got["adjoint_packed"][0].item() > 0,
              "K4's loss is not the full sum under the zero cotangent")
    return report


# ------------------------------------------------------------------ timing

def host_ms(fn, reps: int) -> float:
    """The host's time a call of ``fn`` (ms), the median of ``reps`` calls
    enqueued while a device sleep holds the card: the wrapper's checks,
    allocations and launch calls, without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.2 * SLEEP_CYCLES_PER_S))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    ts.sort()
    return ts[len(ts) // 2] * 1e3


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _compare(a, b):
    """(bit-equal, max over tables of max|a - b| / max|b|)."""
    rel = 0.0
    for p, q in zip(a, b):
        scale = q.abs().max().item()
        d = (p - q).abs().max().item()
        rel = max(rel, d / scale if scale > 0 else d)
    return all(torch.equal(p, q) for p, q in zip(a, b)), rel


def _alternated(time_of, this, other):
    """{ms: [this, this], other_ms: [other, other]}: other, this, this,
    other (this alone without ``other``)."""
    if other is None:
        return dict(ms=[time_of(this)])
    o1, t1, t2, o2 = (time_of(this if k in (1, 2) else other)
                      for k in range(4))
    return dict(ms=[t1, t2], other_ms=[o1, o2])


def path_steps(M, dev) -> dict:
    """{path: zero-arg step} of the paths a user runs, built with package
    ``M``'s own modules: the config 3 fwd+bwd step (two-phase, split), the
    reference's 500^2 d5 16-spp adaptive frame differentiated, and
    ``render_image_diff``'s fwd+bwd on fractional_glass 1024^2 d3."""
    steps = {}
    s = M.bench.setup(M.presets.full_reflective(size=1024, depth=3), False,
                      dev)
    prep = M.AF.prepare_fit_inputs(s["camera"], s["config"], s["target"],
                                   device=dev)
    for mode in ("twophase", "split"):
        steps[f"config 3 1024^2 d3 fwd+bwd, {mode}"] = (
            lambda mode=mode: M.AF.fit_value_and_grad(
                s["params"], s["scene"], s["camera"], s["config"],
                s["target"], prep=prep if mode == "twophase" else None,
                mode=mode, device=dev))
    scene, cam, cfg = M.presets.reference_demo()
    cfg = dataclasses.replace(cfg, adaptive=True)
    camera = M.rays.Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    gen = torch.Generator(dev).manual_seed(cfg.seed)
    P = cfg.width * cfg.height
    jit = torch.stack([M.rays.sample_jitter(gen, P, cfg.jitter_scale).to(dev)
                       for _ in range(cfg.samples)])
    target = M.K.render_image_kernel(scene, camera, cfg, jitter=jit,
                                     device=dev)
    params = M.fit.FitParams.from_scene(scene).to(dev)
    with torch.no_grad():
        params.sph_center += 1.5
    steps["reference_demo 500^2 d5 16 spp adaptive, fwd+bwd"] = (
        lambda: M.AF.fit_value_and_grad(params, scene, camera, cfg, target,
                                        jitter=jit, device=dev))
    fg = M.bench.setup(M.presets.fractional_glass(size=1024, depth=3), False,
                       dev)

    def diff_step():
        loss = M.adjoint.l2_loss_kernel(fg["params"], fg["scene"],
                                        fg["camera"], fg["config"],
                                        fg["target"], device=dev)
        loss.backward()
    steps["render_image_diff fractional_glass 1024^2 d3, fwd+bwd"] = \
        diff_step
    return steps


def cases(P, size=None) -> list:
    """(label, (scene, camera config, config), bf16, kernels) of the timed
    rows, every frame at ``size``^2 if given."""
    def sized(preset):
        if size is None:
            return preset
        scene, cam, cfg = preset
        return scene, cam, dataclasses.replace(cfg, width=size, height=size)
    demo, demo_cam, demo_cfg = P.reference_demo()
    fr3 = P.full_reflective(size=1024, depth=3)
    c5 = P.procedural_spheres(n=64, size=2048, depth=3)
    return [(label, sized(preset), bf16, kernels)
            for label, preset, bf16, kernels in (
        ("config 3 1024^2 d3", fr3, False,
         ("adjoint_packed", "fit_grads", "fused_adjoint")),
        ("config 5 2048^2 d3", c5, False,
         ("adjoint_packed", "fit_grads", "fused_adjoint")),
        ("fractional_glass 1024^2 d3", P.fractional_glass(size=1024, depth=3),
         False, ("fused_adjoint",)),
        ("reference_demo 500^2 d5, one sample",
         (demo, demo_cam, dataclasses.replace(demo_cfg, samples=1)), False,
         ("recompute_adjoint",)),
        ("fractional_glass 512^2 d3", P.fractional_glass(size=512, depth=3),
         False, ("recompute_adjoint",)),
        ("config 3 1024^2 d3 bf16", fr3, True,
         ("fused_adjoint", "recompute_adjoint")))]


def cpu_rows(this, other, size: int) -> list:
    """Every row's kernels under every cotangent through the plain
    versions on the CPU, at ``size``^2: each output of ``this`` package
    against ``other``'s, bit for bit."""
    rows = []
    for label, preset, bf16, kernels in cases(this.presets, size):
        x = inputs(preset, torch.device("cpu"), bf16)
        for cot in COTANGENTS:
            fns = calls(x, cot)
            for kernel in kernels:
                a = run(this.AF, fns[kernel])
                b = a if other is None else run(other.AF, fns[kernel])
                equal, rel = _compare(a, b)
                rows.append(dict(kernel=kernel, input=label, cotangent=cot,
                                 live_pixels=live_pixels(x, fns[kernel]),
                                 equal_to_other=equal, rel_to_other=rel))
                print(f"{kernel:18s} {label:38s} {cot:4s} live "
                      f"{rows[-1]['live_pixels']:6d}: equal {equal}, rel "
                      f"{rel:.2e} [cpu]")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="adjoint_ab")
    ap.add_argument("--other", default=None,
                    help="a checkout whose port package is timed alongside")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true",
                    help="compare the two packages' plain versions on the "
                         "CPU: no times")
    ap.add_argument("--size", type=int, default=None,
                    help="every frame at this size squared")
    ap.add_argument("--no-paths", action="store_true",
                    help="time the kernels only, not the paths")
    args = ap.parse_args(argv)
    this = modules()
    other = load_other(args.other) if args.other else None
    if args.cpu:
        rows = cpu_rows(this, other, args.size or 16)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card="cpu", other=args.other, rows=rows), f,
                      indent=1)
        print(json.dumps(dict(card="cpu", rows=len(rows), unequal=sum(
            not r["equal_to_other"] for r in rows))))
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("adjoint_ab needs a CUDA GPU (or --cpu)")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    this.cuda_build.load()
    for line in this.cuda_build.build_info.get("log", "").splitlines():
        if ("adjoint" in line or "fit_grads" in line or "live" in line
                or "stack frame" in line or "registers" in line):
            print("  ptxas:", line.strip())
    from .forward_ab import print_resources
    rows, resources = [], []
    # every K6 instantiation, at config 3's shared memory (full_reflective:
    # 464 floats of tables, 52 columns)
    for tag, Mod in (("this", this), ("other", other)):
        if Mod is not None:
            resources += [dict(r, input="every instantiation", package=tag)
                          for r in print_resources(
                              f"K6 ({tag})", k6_all(Mod, 4 * 464, 4 * (
                                  464 + 8 * 52 + Mod.AF.ADJOINT_STAGE_FLOATS)),
                              Mod, card)]
    for label, preset, bf16, kernels in cases(this.presets, args.size):
        x = inputs(preset, dev, bf16)
        if "fused_adjoint" in kernels:
            for tag, Mod in (("this", this), ("other", other)):
                if Mod is not None:
                    resources += [dict(r, input=label, package=tag)
                                  for r in print_resources(
                                      f"K6 {label} ({tag})",
                                      k6_kernels(Mod, x), Mod, card)]
            # the forward kernels on the same inputs
            for kernel, fn in forward_calls(x).items():
                row = dict(kernel=kernel, input=label, cotangent=None)
                row.update(_alternated(
                    lambda Mod: time_ms(lambda: fn(Mod), REPS), this, other))
                ms = sum(row["ms"]) / len(row["ms"])
                txt = f"{kernel:18s} {label:38s} forward: {ms:.4f} ms"
                if other is not None:
                    o = sum(row["other_ms"]) / 2
                    txt += f"; other {o:.4f} ms (this/other {ms / o:.3f})"
                print(txt + f" [{card}]")
                rows.append(row)
        for cot in ("real", "zero", "live"):
            fns = calls(x, cot)
            for kernel in kernels:
                call = fns[kernel]
                row = dict(kernel=kernel, input=label, cotangent=cot,
                           live_pixels=live_pixels(x, call),
                           pixels=x["v"].shape[0])
                row.update(_alternated(
                    lambda Mod: time_ms(lambda: run(Mod.AF, call), REPS),
                    this, other))
                host = _alternated(
                    lambda Mod: host_ms(lambda: run(Mod.AF, call), REPS),
                    this, other)
                row["host_ms"] = host["ms"]
                ms = sum(row["ms"]) / len(row["ms"])
                h = sum(row["host_ms"]) / len(row["host_ms"])
                txt = (f"{kernel:18s} {label:38s} {cot:4s} live "
                       f"{row['live_pixels']:8d}: {ms:.4f} ms, host "
                       f"{h:.4f} ms")
                if other is not None:
                    row["other_host_ms"] = host["other_ms"]
                    row["equal_to_other"], row["rel_to_other"] = _compare(
                        run(this.AF, call), run(other.AF, call))
                    o = sum(row["other_ms"]) / 2
                    oh = sum(row["other_host_ms"]) / 2
                    txt += (f"; other {o:.4f} ms, host {oh:.4f} ms (this/"
                            f"other {ms / o:.3f}, host {h / oh:.3f}); equal "
                            f"{row['equal_to_other']}, rel "
                            f"{row['rel_to_other']:.2e}")
                print(txt + f" [{card}]")
                rows.append(row)
        del x, fns
        torch.cuda.empty_cache()

    # the paths a user runs, on the host clock; with another package,
    # PATH_PAIRS pairs, alternating which of the two runs first
    iters = {"reference_demo": 16, "render_image_diff": 4}
    built = {"this": {} if args.no_paths else path_steps(this, dev)}
    if other is not None and not args.no_paths:
        built["other"] = path_steps(other, dev)
    paths = []
    for path in built["this"]:
        n = next((v for k, v in iters.items() if path.startswith(k)), 32)
        row = dict(path=path, iters=n, ms=[], device_allocs=0)

        def step_ms(Mod):
            fn = built["this" if Mod is this else "other"][path]
            r1, rn = step_runner(lambda k: fn(), n, dev)
            a0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
            dt = scan_diff_median(r1, rn, n, reps=5)["dt"] * 1e3
            row["device_allocs"] += (torch.cuda.memory_stats()
                                     .get("num_device_alloc", 0) - a0)
            return dt
        if other is None:
            row["ms"].append(step_ms(this))
        else:
            row["other_ms"] = []
            for k in range(PATH_PAIRS):
                for Mod in ((other, this) if k % 2 == 0 else (this, other)):
                    (row["ms"] if Mod is this else row["other_ms"]).append(
                        step_ms(Mod))
        ms = _median(row["ms"])
        txt = f"path {path}: {ms:.4f} ms"
        if other is not None:
            o = _median(row["other_ms"])
            q = sorted(row["other_ms"])
            row["wins"] = sum(t < u for t, u in zip(row["ms"],
                                                    row["other_ms"]))
            row["other_iqr_ms"] = q[3 * len(q) // 4] - q[len(q) // 4]
            txt += (f"; other {o:.4f} ms (medians of {PATH_PAIRS} pairs, "
                    f"this/other {ms / o:.3f}; this faster in {row['wins']} "
                    f"pairs; other's interquartile range "
                    f"{row['other_iqr_ms']:.4f} ms)")
        print(txt + f"; device allocations {row['device_allocs']} [{card}]")
        paths.append(row)
    out = dict(card=card, reps=REPS, other=args.other, rows=rows,
               resources=resources, paths=paths)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
