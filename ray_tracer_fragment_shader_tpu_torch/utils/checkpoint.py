"""Checkpoints of the fit's parameters as npz files — the counterpart of
the JAX package's ``utils/checkpoint.py`` (its npz half).

Each leaf is stored under the key JAX's ``jax.tree_util.keystr`` gives its
path (``.sph_center`` for an attribute, ``['k']`` for a dict key), so
either package reads the other's files.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def _flatten_with_paths(tree: Any) -> Dict[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return {f".{name}": p for name, p in tree.named_parameters()}
    return {f"[{k!r}]": v for k, v in tree.items()}


def save_checkpoint(path: str, tree: Any) -> None:
    """npz checkpoint of an ``nn.Module``'s parameters or a dict of
    tensors, leaf arrays keyed by tree path."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in _flatten_with_paths(tree).items()})


def restore_checkpoint(path: str, like: Any) -> Any:
    """A copy of ``like`` holding the checkpoint's values, each cast to the
    dtype and device of ``like``'s leaf."""
    out = copy.deepcopy(like)
    with np.load(path) as data:
        with torch.no_grad():
            for key, leaf in _flatten_with_paths(out).items():
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key}")
                leaf.copy_(torch.from_numpy(data[key]).to(leaf.dtype))
    return out
