"""What the cell scripts share: the card beside every number."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def card_of(dev: torch.device) -> Tuple[str, Optional[str]]:
    """(device name, power limit as nvidia-smi gives it) of ``dev``; off the
    card ("cpu", None)."""
    if dev.type != "cuda":
        return "cpu", None
    from ..kernels.probe import gpu_query
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return (torch.cuda.get_device_name(index),
            gpu_query("power.limit", index))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

