"""Fit jobs: a closed loop of fit jobs on one chip.  Each job starts from
the seeded scene with every sphere centre moved by a seeded offset of
length ``move`` and runs ``steps_per_job`` Adam steps of the program's fit
step (``diff.fit.make_fit_step_kernel``, in the mix's ``fit_mode``),
reading the loss after each step as ``fit()`` does, towards the
reference's frame of the unmoved scene.

Set-up runs the first ``checked_steps`` steps of job 0 through the
window's own call; the window goes on from there.  ``judge`` compares
those steps, and the first step of a window job drawn from the seed, with
the reference's loss, gradients and Adam from the same parameters.
"""
from __future__ import annotations

import importlib
import json
import math
import statistics
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import harness, inputs, opcount, program, reference

KIND = "fit"
#: the faults of ``faults.py`` a fit cell can have, and those read on the
#: chip ("state_unchanged" reads 1 on the change by construction)
FAULTS = ("state_unchanged", "half_batch", "answer_altered")
CHIP_FAULTS = ("half_batch", "answer_altered")
#: the seeded fit jobs made ahead (a longer window reuses them in turn)
JOBS = 256


class FitSession:
    """The program's fit step, built once: its parameters, its Adam and
    its step."""

    def __init__(self, config: dict, traffic: dict, arrays, meta, camera,
                 target, device, control: bool = False):
        # the package's ``diff.fit`` is also a function's name there
        F = importlib.import_module(f"{program.PORT}.diff.fit")
        from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
        cfg = program.render_config(config, control)
        self.scene = program.scene(arrays, meta, device)
        cam = Camera.from_config(program.camera_config(camera), cfg.width,
                                 cfg.height, device=device)
        self.params = F.FitParams.from_scene(self.scene).to(device)
        self.opt = F.default_fit_optimizer(
            self.params, geom_lr=traffic["geom_lr"],
            light_lr=traffic["light_lr"], mat_lr=traffic["mat_lr"])
        self._step = F.make_fit_step_kernel(self.scene, cam, cfg, target,
                                            self.opt, device=device)
        self.beta1 = self.opt.param_groups[0]["betas"][0]

    def reset(self, leaves: Dict[str, torch.Tensor]) -> None:
        """A new job: the parameters set to ``leaves``, Adam's state
        cleared."""
        with torch.no_grad():
            for k in reference.LEAVES:
                getattr(self.params, k).copy_(leaves[k])
        self.opt.state.clear()

    def step(self) -> float:
        return float(self._step(self.params))

    def values(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self.params, k).detach().clone()
                for k in reference.LEAVES}

    def first_grad(self) -> Dict[str, torch.Tensor]:
        """The gradient Adam got at a job's first step, from its first
        moment after that step."""
        return {k: (self.opt.state[getattr(self.params, k)]["exp_avg"]
                    / (1.0 - self.beta1)).detach().clone()
                for k in reference.LEAVES}

    def close(self) -> None:
        """Drops the program's state (its step holds the prepared rays and
        target)."""
        self.params = self.opt = self._step = self.scene = None

    def frame(self, leaves, camera, config):
        """The program's forward frame of its scene at ``leaves``."""
        from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
        scene = self.scene.replace(**{k: leaves[k] for k in reference.LEAVES})
        return K.render_image_kernel(scene, program.camera_config(camera),
                                     program.render_config(config),
                                     device=self.scene.device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, log=print) -> dict:
    with program.fit_mode(cell.traffic.get("fit_mode")):
        return _run(cell, seed, seconds, trace, device, t_start, control,
                    log)


def _run(cell, seed, seconds, trace, device, t_start, control, log) -> dict:
    config, traffic = cell.config, cell.traffic
    W, H, depth = config["width"], config["height"], config["max_depth"]
    camera = config["camera"]
    stamp = harness.stamper(t_start)
    stamp("set-up starts")
    arrays = inputs.scene_arrays(config["scene"], seed, cell.bench_dir)
    meta = inputs.scene_meta(arrays)
    offsets = torch.as_tensor(inputs.job_offsets(arrays, seed, JOBS,
                                                 traffic["move"]),
                              device=device)
    base = reference.scene_leaves(arrays, device)

    def job_leaves(j: int) -> Dict[str, torch.Tensor]:
        out = dict(base)
        out["sph_center"] = base["sph_center"] + offsets[j % JOBS]
        return out

    # the target, the reference's frame of the unmoved scene: the
    # reference's work, left out of set-up
    stamp("inputs made")
    t_ref = time.perf_counter()
    target = reference.render(arrays, base, camera, W, H, depth=depth,
                              device=device)[0].reshape(H, W, 3)
    harness.sync(device)
    ref_s = time.perf_counter() - t_ref
    stamp(f"target made by the reference in {ref_s:.3f} s")
    harness.free(device)
    harness.reset_memory_peak(device)
    sess = FitSession(config, traffic, arrays, meta, camera, target, device,
                      control)
    stamp("the program's fit step built")
    n_check = int(traffic["checked_steps"])
    per_job = int(traffic["steps_per_job"])
    sess.reset(job_leaves(0))
    setup = dict(losses=[])
    for s in range(n_check):
        setup["losses"].append(sess.step())
        if s == 0:
            setup["grad"] = sess.first_grad()
    setup["after"] = sess.values()
    harness.sync(device)
    setup_s = time.perf_counter() - t_start - ref_s
    stamp("set-up's steps done")

    jobs: Dict[int, dict] = {}
    losses: List[float] = []
    ends: List[float] = []
    with harness.traced(trace, device) as box:
        t0 = time.perf_counter()
        job, k = 0, n_check
        while True:
            if k == per_job:
                job, k = job + 1, 0
                sess.reset(job_leaves(job))
            losses.append(sess.step())
            if k == 0:
                jobs[job] = dict(loss=losses[-1], grad=sess.first_grad(),
                                 after=sess.values())
            k += 1
            now = time.perf_counter()
            ends.append(now)
            if now - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = harness.memory_peak(device)

    # each job's live pixels at its first step: the program's forward frame
    # of the job's parameters against the target, off the window
    with torch.no_grad():
        live = {j: int(((sess.frame(job_leaves(j), camera, config)
                         - target) != 0).any(-1).sum())
                for j in [0] + sorted(jobs)}
    log(f"live pixels at each fit job's first step (of {W * H}): "
        + json.dumps(live))

    def work(j: int) -> dict:
        """K3's and K4's work at job ``j``'s first step."""
        lv = job_leaves(j)
        tab = reference.tables(arrays, lv, device)
        img, topo, counts = reference.render(arrays, lv, camera, W, H,
                                             depth=depth, device=device,
                                             count=True)
        k3 = opcount.forward_work(counts, W * H, depth=depth,
                                  lights=tab["nl"], packed=True)
        k4 = opcount.adjoint_work(
            topo, ((img - target.reshape(-1, 3)) != 0).any(-1),
            nt=tab["nt"], ns=tab["ns"], materials=int(tab["mat"].shape[0]),
            lights=tab["nl"], depth=depth)
        return dict(k3=k3, k4=k4, ops=k3["ops"] + k4["ops"])

    # the first step of each job the window started: its index there
    probes = {j * per_job - n_check: (lambda j=j: work(j))
              for j in sorted(jobs) if j >= 1}
    record = harness.Record(
        cell=cell, kind=KIND, chips=cell.chips, width=W, height=H,
        setup_s=setup_s, window_s=window_s, units=len(losses),
        latencies_s=np.diff([t0] + ends).tolist(), trace=box.get("trace"),
        probes=probes)
    return dict(
        units=len(losses), window_s=window_s, memory_peak=peak,
        failed=sum(1 for x in losses if not math.isfinite(x)),
        record=record, release=sess.close,
        judge=lambda: judge(cell, seed, arrays, camera, target, job_leaves,
                            setup, jobs))


def _leaf_norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(d[k].double().norm()) for k in reference.LEAVES}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              skip: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    pn, rn = _leaf_norms(prog), _leaf_norms(ref)
    keep = [k for k in reference.LEAVES if k not in skip]
    med = statistics.median(rn[k] for k in keep)
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in keep}


def _top(vals: List[float]) -> float:
    """The largest of ``vals``; inf where one is not finite."""
    return max(vals) if all(math.isfinite(v) for v in vals) else math.inf


def _worst(gaps: Dict[str, float]) -> float:
    return _top(list(gaps.values()))


def quiet_leaves(grads: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """Leaves whose reference gradient is nought to rounding: under a
    thousandth of the median leaf's norm.  Adam moves them by round-off
    alone, so their change is not compared."""
    n = _leaf_norms(grads)
    med = statistics.median(n.values())
    return tuple(k for k in reference.LEAVES if n[k] < 1e-3 * med)


def judge(cell, seed: int, arrays, camera, target, job_leaves,
          setup: dict, jobs: Dict[int, dict]) -> dict:
    """The numbers that decide ``correct`` in a fit cell, each with its
    limit: the loss of the set-up's first step and of a window job's first
    step (drawn from the seed), the first gradient Adam got, and the
    parameters' change after the set-up's steps and after the window job's
    first step, against the reference's own loss, gradients and Adam from
    the same parameters."""
    config, traffic = cell.config, cell.traffic
    W, H, depth = config["width"], config["height"], config["max_depth"]
    lrs = {"sph_center": traffic["geom_lr"], "sph_radius": traffic["geom_lr"],
           "light_pos": traffic["light_lr"], "mat_diffuse": traffic["mat_lr"],
           "mat_specular": traffic["mat_lr"], "mat_ambient": traffic["mat_lr"]}

    def follow(leaves, n):
        """The reference's n steps from ``leaves``: losses, the first
        gradients, the parameters after them."""
        adam = reference.Adam(lrs)
        p = {k: leaves[k].clone() for k in reference.LEAVES}
        out = dict(losses=[])
        for s in range(n):
            loss, grads, live = reference.loss_and_grads(
                arrays, p, camera, W, H, target, depth=depth)
            out["losses"].append(loss)
            if s == 0:
                out["grad"], out["live"] = grads, live
            p = adam.step(p, grads)
        out["after"] = p
        return out

    def change(after, start):
        return {k: after[k].double() - start[k].double()
                for k in reference.LEAVES}

    n_check = len(setup["losses"])
    start0 = job_leaves(0)
    ref0 = follow(start0, n_check)
    skip = quiet_leaves(ref0["grad"])
    detail = dict(
        loss_steps=[abs(a - b) / abs(b) for a, b in
                    zip(setup["losses"], ref0["losses"])],
        grad_leaves=leaf_gaps(setup["grad"], ref0["grad"]),
        change_leaves=leaf_gaps(change(setup["after"], start0),
                                change(ref0["after"], start0), skip),
        ref_live=ref0["live"], quiet=list(skip))
    # the loss at the parameters both sides start from: a later step's
    # loss follows Adam's amplification of rounding (PERF.md)
    loss_gaps = [detail["loss_steps"][0]]
    grad_gaps = [_worst(detail["grad_leaves"])]
    change_gaps = [_worst(detail["change_leaves"])]
    window_jobs = sorted(j for j in jobs if j >= 1)
    if window_jobs:
        g = inputs.rng(seed, inputs.SAMPLE)
        picked = window_jobs[int(g.integers(len(window_jobs)))]
        start = job_leaves(picked)
        rj = follow(start, 1)
        got = jobs[picked]
        detail.update(
            picked_job=picked,
            loss_job=abs(got["loss"] - rj["losses"][0]) / abs(rj["losses"][0]),
            grad_leaves_job=leaf_gaps(got["grad"], rj["grad"]),
            change_leaves_job=leaf_gaps(change(got["after"], start),
                                        change(rj["after"], start),
                                        quiet_leaves(rj["grad"])))
        loss_gaps.append(detail["loss_job"])
        grad_gaps.append(_worst(detail["grad_leaves_job"]))
        change_gaps.append(_worst(detail["change_leaves_job"]))
    limits = traffic["limits"]
    nums = dict(loss=_top(loss_gaps), grad=_top(grad_gaps),
                change=_top(change_gaps))
    checks = {k: dict(value=v, limit=limits[k]) for k, v in nums.items()}
    return dict(checks=checks, **detail)
