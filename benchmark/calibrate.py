"""The readings that set the limits of ``correct``, on the chip: a cell run
over many seeds with the program as its configuration states, over some
seeds with the program's own lower precision (the control:
``RenderConfig(bf16_shading=True)``, the shadow sweep and the Phong blend
in bfloat16), and over some seeds with each fault the cell can have
(``faults.py``, those the traffic kind names in ``CHIP_FAULTS``), all in
one process, each run's window ``--seconds`` long:

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        --controls 3 --fault-seeds 3 --seconds 3.5 --out <dir>

Prints one JSON line a run (its ``checks`` and ``detail``) and writes them
to ``<out>/<cell>.jsonl``; the benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

#: first seed: past 2^31, as the checks' seeds are
SEED0 = 2 ** 31 + 7919


def specs(faults, seeds: int, controls: int, fault_seeds: int, first: int):
    """The runs: ``seeds`` sound ones, ``controls`` controls and
    ``fault_seeds`` of each of ``faults``, as (seed, control, fault)."""
    out = [(first + i, False, None) for i in range(seeds)]
    out += [(first + 1000 + i, True, None) for i in range(controls)]
    for f, name in enumerate(faults):
        out += [(first + 2000 + 100 * f + i, False, name)
                for i in range(fault_seeds)]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.5)
    p.add_argument("--first-seed", type=int, default=SEED0)
    p.add_argument("--out", default=".bench_cache/calibration")
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    runs = specs(harness.kind_module(cell.traffic["kind"]).CHIP_FAULTS,
                 args.seeds, args.controls, args.fault_seeds,
                 args.first_seed)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{cell.name}.jsonl")
    torch.set_num_threads(1)
    with open(path, "w") as f:
        for seed, control, fault in runs:
            result = harness.run_cell(cell, seed, args.seconds, False,
                                      time.perf_counter(), control=control,
                                      fault=fault)
            line = dict(seed=seed, control=control, fault=fault,
                        correct=result["correct"],
                        attempted=result["attempted"],
                        failed=result["failed"],
                        checks={k: c["value"] for k, c in
                                result["checks"].items()},
                        detail=result["detail"])
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            f.flush()


if __name__ == "__main__":
    main()
