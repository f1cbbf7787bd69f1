"""P1: per-op-class issue costs on the card, in FP32 issue slots -- the port
of the JAX package's ``scripts/vpu_op_probe.py``.

Method (saturated pure-class chains): for each class, csrc/op_probe.cu
runs ``nc`` independent dependent chains whose step is one instruction (or
sequence) of that class, for each ``nc`` of ``NC_SWEEP`` and at the most
blocks per SM that fit and half of that (``kernels/probe.py::op_time``);
the best is the class's saturated time per chain step.  Its cost is the
ratio to the pure ``mul`` chain, less the known support multiplies:

    w(class) = t_step(class) / t_step(mul) - SUPPORT_MULS[class]

Built-in checks, in the JSON:

* the ``mul`` rate against the card's FP32 ceiling without fused
  multiply-add, SMs x 128 lanes x the SM clock sampled during the run (a
  share above 1.05 means the chain was folded, and ``chip_smoke.py``
  fails on it);
* ``recip_nr_check``: the measured Newton-reciprocal chain against
  ``recip`` + 3 basic;
* ``additivity_check``: the render-ratio ``mix`` chain (8 basic + 2 select
  + 1 cmp + 1 rsqrt a step) against the sum of its parts: whether class
  costs add on this card.

On the card: ``recip`` is rcp.approx.f32, ``recip_nr`` adds one Newton step,
``div`` and ``sqrt`` are IEEE, ``rsqrt`` is rsqrtf; ``sass`` holds each
class's opcode counts (nc=4) as cuobjdump reads them.  Every time is
iteration-count differenced on the device (``utils/timing.py::
launch_diff_s``), median of ``--reps``.

Usage (on the card):
    python -m ray_tracer_fragment_shader_tpu_torch.probes.op_probe \\
        [--iters 4096] [--reps 3]
"""
from __future__ import annotations

import argparse
import json
import os

from ..kernels import cuda_build
from ..kernels import probe as PR
from . import common

NC_SWEEP = PR.OP_NCS
# ops per chain step and how many of them are 'basic' support ops whose
# cost is subtracted (priced at the measured mul slot)
OPS_PER_ITER = dict(mul=1, add=2, max=2, sel=2, cmpsel=4, abs=2, sign=2,
                    rsqrt=1, sqrt=1, div=1, recip=1, recip_nr=4, floor=3,
                    mix=12)
SUPPORT_MULS = dict(mul=0, add=0, max=1, sel=1, cmpsel=2, abs=1, sign=1,
                    rsqrt=0, sqrt=0, div=0, recip=0, recip_nr=3, floor=2,
                    mix=0)
CLASSES = ["add", "max", "sel", "cmpsel", "abs", "sign", "rsqrt", "sqrt",
           "div", "recip", "recip_nr", "floor"]


def _best(inject, iters, reps, x, ncs=NC_SWEEP, bf16=None):
    """(best seconds per chain step, {nc: fs per step}) over the chain
    counts: the minimum is the saturated issue throughput."""
    times = {nc: PR.op_time(inject, nc, iters, reps, x, bf16=bf16)
             ["s_per_step"] for nc in ncs}
    return min(times.values()), {k: round(v * 1e15, 3)
                                 for k, v in times.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="op_probe")
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(common.OUT_DIR,
                                                  "op_weights.json"))
    args = ap.parse_args(argv)

    from ..kernels.render import resolve_device
    from ..utils.roofline import probe_input
    dev = resolve_device(None)
    x = probe_input(PR.sm_count(dev) * 8, dev)
    with PR.ClockSampler() as clk:
        t_mul, mul_sweep = _best("mul", args.iters, args.reps, x)
        raw, sweeps = {"mul": 1.0}, {"mul": mul_sweep}
        for cls in CLASSES:
            t, sw = _best(cls, args.iters, args.reps, x)
            raw[cls] = round(t / t_mul - SUPPORT_MULS[cls], 4)
            sweeps[cls] = sw
            print(f"{cls:10s} step={t / t_mul:7.3f} slots "
                  f"-{SUPPORT_MULS[cls]} support -> {raw[cls]:7.3f}   "
                  f"sweep={json.dumps(sw)}", flush=True)
        t_mix, mix_sweep = _best("mix", args.iters, args.reps, x)
    dev_card = common.card(clk.samples)
    slot_rate = 1.0 / t_mul
    clock = (dev_card["sm_clock_mhz"]["max"] if clk.samples
             else dev_card["max_sm_clock_mhz"])
    ceiling = common.fp32_ceiling(dev_card["sm_count"], clock)
    print(f"mul sweep (fs/step): {json.dumps(mul_sweep)} rate="
          f"{slot_rate:.4e} ops/s = {slot_rate / ceiling:.4f} of "
          f"{dev_card['sm_count']} SMs x 128 x {clock} MHz "
          f"[{dev_card['nvidia_smi']}]")

    basic = max(raw["add"] / 2.0, raw["max"], 1.0)  # add chain = 2 basic ops
    weights = dict(
        basic=round(basic, 4),
        cmp=max(round(raw["cmpsel"] - raw["sel"], 4), 0.25),
        select=max(raw["sel"], 0.25),
        abs=max(raw["abs"], 0.25),
        sign=max(raw["sign"], 0.25),
        rsqrt=max(raw["rsqrt"], 0.25),
        sqrt=max(raw["sqrt"], 0.25),
        div=max(raw["div"], 0.25),
        recip_nr=max(round(raw["recip"] + 3.0 * basic, 4), 0.25),
        floor=max(raw["floor"], 0.25),
    )
    # composite cross-check: the measured NR chain vs the priced sum
    nr_check = dict(measured_slots=round(raw["recip_nr"] + 3.0, 3),
                    priced_slots=weights["recip_nr"],
                    ratio=round((raw["recip_nr"] + 3.0)
                                / max(weights["recip_nr"], 1e-9), 4))
    pred = (8 * weights["basic"] + 2 * weights["select"] + weights["cmp"]
            + weights["rsqrt"])
    meas = t_mix / t_mul
    additivity = dict(predicted_slots_per_step=round(pred, 4),
                      measured_slots_per_step=round(meas, 4),
                      ratio=round(meas / pred, 4), sweep=mix_sweep)
    print("additivity:", json.dumps(additivity))

    lib = cuda_build.probe_library_path("op_probe.cu")
    sass = PR.sass_opcodes(lib, "op_kernel")
    regs = PR.ptxas_resources(cuda_build.probe_log("op_probe.cu"),
                              "op_kernel")
    out = dict(card=dev_card,
               fp32_ceiling_ops_per_s=ceiling,
               slot_rate_ops_per_s=slot_rate,
               mul_share_of_ceiling=slot_rate / ceiling,
               method="saturated pure-class chains, nc swept %s at the most "
                      "blocks per SM that fit and half, iteration-count "
                      "differenced by CUDA events, median of %d, iters %d; "
                      "probes/op_probe.py" % (list(NC_SWEEP), args.reps,
                                              args.iters),
               raw_slots=raw, sweeps_fs_per_step=sweeps, weights=weights,
               recip_nr_check=nr_check, additivity_check=additivity,
               sass_nc4={PR.INJECTS[k[0]]: v for k, v in sass.items()
                         if k[1] == 4},
               ptxas={f"{PR.INJECTS[k[0]]}/{k[1]}": v
                      for k, v in regs.items()})
    common.write(args.out, out)
    return out


if __name__ == "__main__":
    main()
