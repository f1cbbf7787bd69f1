"""What the probes share: the card's description beside every rate, and
writing a probe's JSON."""
from __future__ import annotations

import json
import os
from typing import List

import torch

#: where the probes write (listed in .gitignore)
OUT_DIR = os.path.join("chiprun_out", "roofline_h100")


def card(samples_mhz: List[float] = ()) -> dict:
    """The card: its name, nvidia-smi's name and power limit, SM count, the
    maximum SM clock, and the SM clock sampled during the run (MHz)."""
    from ..kernels.probe import gpu_query, sm_count
    out = dict(device=torch.cuda.get_device_name(0),
               nvidia_smi=gpu_query("name,power.limit"),
               sm_count=sm_count(),
               max_sm_clock_mhz=float(gpu_query(
                   "clocks.max.sm").split()[0]))
    if samples_mhz:
        s = sorted(samples_mhz)
        out["sm_clock_mhz"] = dict(min=s[0], median=s[len(s) // 2],
                                   max=s[-1], samples=len(s))
    return out


def fp32_ceiling(sms: int, clock_mhz: float) -> float:
    """FP32 operations a second with no fused multiply-add: 128 lanes an SM
    issuing one a clock."""
    return sms * 128 * clock_mhz * 1e6


#: thread-instructions a clock an SM of each pipe on compute capability 9.0
#: (the CUDA C Programming Guide's table of arithmetic throughput): FP32 add
#: and multiply; packed 16-bit add, multiply and compare (128
#: instructions, 256 results); compare, select and bit operations; the MUFU
#: (reciprocal square root); conversions from f32 to a smaller type
PIPE_RATES = dict(fp32=128, fp16x2=128, alu=64, mufu=16, conv=16)
#: warp-instructions a clock an SM: one from each of the 4 sub-partitions
ISSUE_RATE = 4
#: P2's step as written (the JAX ``scripts/bf16_probe.py::_step``): the
#: instructions of one thread's chain step by pipe, and the elements it
#: covers.  f32 ``mix``: 7 multiplies and adds, the compare and two selects,
#: one rsqrt.  bf16 ``mix`` (a packed pair): the 7 multiplies and adds and
#: the compare packed, the two selects as bit blends, the rsqrt once a half
#: in f32 with its unpack (two bit operations) and pack (one conversion).
#: The kernels' rsqrtf also rescales a subnormal argument (a compare and
#: two multiplies an rsqrt in the SASS census,
#: ``kernels/probe.py::step_census``), which the step as written does not
#: need
P2_STEPS = {
    ("mul", False): dict(elements=1, fp32=1),
    ("mul", True): dict(elements=2, fp16x2=1),
    ("mix", False): dict(elements=1, fp32=7, alu=3, mufu=1),
    ("mix", True): dict(elements=2, fp16x2=8, alu=4, mufu=2, conv=1),
}


def chain_step_bound(step: dict, element_steps: float, sms: int,
                     clock_mhz: float) -> dict:
    """The least time the card could take for ``element_steps`` chain steps
    of one element, each thread-step issuing ``step`` (instructions by
    pipe of ``PIPE_RATES``, covering ``step["elements"]`` elements): the
    largest of each pipe's time and the issue time (all the instructions
    at ``ISSUE_RATE`` warp-instructions a clock an SM).  Returns
    ``seconds``, ``by`` (the pipe that sets it; a pipe before issue on a
    tie) and ``pipes`` {pipe or "issue": seconds}."""
    clock = sms * clock_mhz * 1e6
    thread_steps = element_steps / step["elements"]
    counts = {p: n for p, n in step.items() if p != "elements"}
    unknown = set(counts) - set(PIPE_RATES)
    if unknown:
        raise ValueError(f"no rate for pipes {sorted(unknown)}")
    pipes = {p: thread_steps * n / (PIPE_RATES[p] * clock)
             for p, n in counts.items()}
    pipes["issue"] = (thread_steps * sum(counts.values()) / 32
                      / (ISSUE_RATE * clock))
    by = max(pipes, key=pipes.get)  # the first of equals: a pipe
    return dict(seconds=pipes[by], by=by, pipes=pipes)


def write(path: str, out: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", path)
