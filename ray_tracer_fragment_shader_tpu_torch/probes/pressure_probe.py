"""P3: K9's issue rate against the chains each thread holds -- the port of
the JAX package's ``scripts/pressure_probe.py`` (the register-pressure
curve).

``measure_mix_rate`` takes the best rate over 2-16 chains a thread, a
register-resident ceiling.  Real kernels hold far more live values; this
sweeps the chain count ``nc`` of K9 (csrc/mix_probe.cu) far past it, each
``nc`` built into a library of its own (all nvcc started together), and
records beside each rate what ptxas gave the instantiation (registers, of
at most 255 a thread, and spill bytes) and the blocks of 256 threads an SM
holds: where registers run out, where spills start, where occupancy falls.
The blend is the bench's default step's (config 3 1024^2 depth 3,
two-phase fwd+bwd: ``bench.last_step_work``), so its schedule is the one
the bench's K9 builds.  Iterations scale down with ``nc`` as in the JAX
probe (:77); each rate is the best over the most blocks per SM that fit
and half of that.

Usage (on the card):
    python -m ray_tracer_fragment_shader_tpu_torch.probes.pressure_probe \\
        [--iters 256] [--reps 3] [--ncs 2,4,...,96]
"""
from __future__ import annotations

import argparse
import os

from ..kernels import cuda_build
from ..kernels import probe as PR
from . import common


def curve(counts, ncs, iters: int, reps: int, device) -> dict:
    """{nc: dict(rate, registers, spill bytes, occupancy, blocks_per_sm,
    iters)} of K9 on the blend ``counts``."""
    from ..utils.roofline import (_rewrite_schedule, budget_per_step,
                                  mix_schedule, probe_input)
    sched, leftover = _rewrite_schedule(mix_schedule(counts))
    per_step = budget_per_step(sched, leftover)
    specs = [("mix_probe.cu", PR.mix_defines(sched, (nc,))) for nc in ncs]
    cuda_build.build_probes(specs)
    sms = PR.sm_count(device)
    x = probe_input(sms * 8, device)
    out = {}
    for nc, (_, defines) in zip(ncs, specs):
        n_iters = max(iters // max(nc // 8, 1), 64)  # bound runtime
        occ = PR.occupancy("mix_probe.cu", (nc,), defines)
        r = PR.sweep_best(lambda xs, n, b: PR.mix_chain(
            xs, iters=n, nc=nc, sched=sched, ncs=(nc,), blocks=b), x,
            PR.bps_candidates(occ), n_iters, reps, nc * per_step, sms)
        res = PR.ptxas_resources(cuda_build.probe_log("mix_probe.cu",
                                                      defines),
                                 "mix_kernel").get((nc,), {})
        out[nc] = dict(rate=r["rate"], occupancy=occ,
                       blocks_per_sm=r["blocks_per_sm"], iters=n_iters,
                       **res)
        print(f"nc={nc:3d} rate={r['rate'] / 1e12:7.3f} T budget-ops/s "
              f"registers={res.get('registers')} spill "
              f"{res.get('spill_stores')}/{res.get('spill_loads')} B "
              f"occupancy={occ} blocks/SM", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pressure_probe")
    ap.add_argument("--iters", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ncs", type=str,
                    default="2,4,6,8,12,16,24,32,48,64,96")
    ap.add_argument("--out", default=os.path.join(common.OUT_DIR,
                                                  "pressure_curve.json"))
    args = ap.parse_args(argv)

    from .. import bench
    from ..kernels.render import resolve_device
    dev = resolve_device(None)
    work = bench.last_step_work(bench.knobs({}), dev)
    counts = dict(work["fwd"])
    for k, v in work["bwd"].items():
        counts[k] = counts.get(k, 0.0) + v
    ncs = [int(t) for t in args.ncs.split(",")]
    with PR.ClockSampler() as clk:
        rows = curve(counts, ncs, args.iters, args.reps, dev)
    out = dict(card=common.card(clk.samples),
               blend="config 3 1024^2 d3 two-phase fwd+bwd (the bench's)",
               counts=counts, iters=args.iters, reps=args.reps,
               rate_vs_chains=rows)
    common.write(args.out, out)
    return out


if __name__ == "__main__":
    main()
