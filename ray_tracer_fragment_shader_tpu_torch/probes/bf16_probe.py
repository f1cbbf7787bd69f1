"""P2: bf16 against f32 chain rates on the card -- the port of the JAX
package's ``scripts/bf16_probe.py``, the data ``RenderConfig.bf16_shading``
waits on.

The kernels are issue-bound (PERF.md), so bf16 shading math helps only if
the card issues bf16 arithmetic faster than f32.  csrc/bf16_probe.cu runs
the ``mul`` chain and the render-ratio ``mix`` chain (8 basic + 2 select +
1 cmp + 1 rsqrt a step) in f32 (an element a chain) and in bf16 (a packed
pair a chain), chain counts swept, the best taken, per element and step.
On Hopper the bf16x2 multiply, add, compare and select issue packed;
``rsqrt`` upcasts to f32 (MUFU) and packs back (csrc/bf16_probe.cu).  The
JAX probe's conclusion was about a TPU v5e, whose compiler rejects bf16
compares; this one is about this card.  ``sass`` holds each kernel's
opcode counts (nc=4) as cuobjdump reads them, to show what runs packed.

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
    rows = {}
    with PR.ClockSampler() as clk:
        for inject in PR.BF16_INJECTS:
            t32, sw32 = _best(inject, args.iters, args.reps, x, bf16=False)
            t16, sw16 = _best(inject, args.iters, args.reps, x, bf16=True)
            ratio = t32 / t16  # >1: bf16 faster
            rows[inject] = dict(f32_fs_per_step=round(t32 * 1e15, 3),
                                bf16_fs_per_step=round(t16 * 1e15, 3),
                                bf16_speedup=round(ratio, 4),
                                f32_sweep=sw32, bf16_sweep=sw16)
            print(f"{inject}: f32 {t32 * 1e15:.3f} fs/step, bf16 "
                  f"{t16 * 1e15:.3f} fs/step, speedup {ratio:.4f}x",
                  flush=True)
    lib = cuda_build.probe_library_path("bf16_probe.cu")
    out = dict(card=common.card(clk.samples), iters=args.iters,
               reps=args.reps, rows=rows,
               sass_nc4={kern: {PR.BF16_INJECTS[k[0]]: v for k, v in
                                PR.sass_opcodes(lib, kern).items()
                                if k[1] == 4}
                         for kern in ("f32_kernel", "bf16_kernel")})
    common.write(args.out, out)
    return out


if __name__ == "__main__":
    main()
