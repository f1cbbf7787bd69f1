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


def write(path: str, out: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", path)
