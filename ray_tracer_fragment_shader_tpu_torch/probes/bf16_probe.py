"""P2: bf16 against f32 chain rates on the card -- the port of the JAX
package's ``scripts/bf16_probe.py``, the data ``RenderConfig.bf16_shading``
waits on.

The kernels are issue-bound (PERF.md), so bf16 shading math helps only if
the card issues bf16 arithmetic faster than f32.  csrc/bf16_probe.cu runs
the ``mul`` chain and the render-ratio ``mix`` chain (8 basic + 2 select +
1 cmp + 1 rsqrt a step) in f32 (an element a chain) and in bf16 (a packed
pair a chain), chain counts swept (``kernels/probe.py::BF16_NCS``), the
best taken, per element and step.  On Hopper the bf16x2 multiply, add,
compare and select issue packed; ``rsqrt`` upcasts to f32 (MUFU) and packs
back (csrc/bf16_probe.cu).  The JAX probe's conclusion was about a TPU
v5e, whose compiler rejects bf16 compares; this one is about this card.

Each row also holds its bound priced pipe by pipe
(``probes/common.py::chain_step_bound`` over ``P2_STEPS``, at the SM clock
sampled during the run): the least time an element-step could take, the
pipe that sets it, and the measured time's share of it.  ``census`` holds,
for every instantiation, what one chain step of its hot loop issues, by
pipe and by opcode, as cuobjdump reads the SASS
(``kernels/probe.py::step_census``).

Usage (on the card):
    python -m ray_tracer_fragment_shader_tpu_torch.probes.bf16_probe \\
        [--iters 4096] [--reps 3]
"""
from __future__ import annotations

import argparse
import os

from ..kernels import cuda_build
from ..kernels import probe as PR
from . import common
from .op_probe import _best


def census() -> dict:
    """{"<inject> <f32|bf16> nc<N>": step census} of every instantiation
    of csrc/bf16_probe.cu."""
    lib = cuda_build.probe_library_path("bf16_probe.cu")
    out = {}
    for kern, dtype in (("f32_kernel", "f32"), ("bf16_kernel", "bf16")):
        for (inj, nc), c in sorted(PR.step_census(lib, kern).items()):
            out[f"{PR.BF16_INJECTS[inj]} {dtype} nc{nc}"] = c
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="bf16_probe")
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(common.OUT_DIR,
                                                  "bf16_probe.json"))
    args = ap.parse_args(argv)

    from ..kernels.render import resolve_device
    from ..utils.roofline import probe_input
    dev = resolve_device(None)
    x = probe_input(PR.sm_count(dev) * 8, dev)
    times = {}
    with PR.ClockSampler() as clk:
        for inject in PR.BF16_INJECTS:
            for bf16 in (False, True):
                times[(inject, bf16)] = _best(inject, args.iters, args.reps,
                                              x, ncs=PR.BF16_NCS, bf16=bf16)
    card = common.card(clk.samples)
    clock = (card["sm_clock_mhz"]["max"] if clk.samples
             else card["max_sm_clock_mhz"])
    rows = {}
    for inject in PR.BF16_INJECTS:
        row = {}
        for bf16 in (False, True):
            t, sweep = times[(inject, bf16)]
            b = common.chain_step_bound(common.P2_STEPS[(inject, bf16)], 1.0,
                                        card["sm_count"], clock)
            tag = "bf16" if bf16 else "f32"
            row.update({f"{tag}_fs_per_step": round(t * 1e15, 3),
                        f"{tag}_bound_fs_per_step": round(
                            b["seconds"] * 1e15, 3),
                        f"{tag}_bound_by": b["by"],
                        f"{tag}_share_of_bound": round(b["seconds"] / t, 4),
                        f"{tag}_sweep": sweep})
        row["bf16_speedup"] = round(row["f32_fs_per_step"]
                                    / row["bf16_fs_per_step"], 4)
        rows[inject] = row
        print(f"{inject}: f32 {row['f32_fs_per_step']:.3f} fs/step "
              f"({row['f32_share_of_bound']:.4f} of its "
              f"{row['f32_bound_by']} bound), bf16 "
              f"{row['bf16_fs_per_step']:.3f} fs/step "
              f"({row['bf16_share_of_bound']:.4f} of its "
              f"{row['bf16_bound_by']} bound), speedup "
              f"{row['bf16_speedup']:.4f}x [{card['nvidia_smi']}]",
              flush=True)
    out = dict(card=card, iters=args.iters, reps=args.reps,
               bound_clock_mhz=clock, rows=rows, census=census())
    common.write(args.out, out)
    return out


if __name__ == "__main__":
    main()
