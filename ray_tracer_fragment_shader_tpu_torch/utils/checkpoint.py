"""Checkpoints of the fit's parameters — the counterpart of the JAX
package's ``utils/checkpoint.py``.

The npz pair stores each leaf under the key JAX's ``jax.tree_util.keystr``
gives its path (``.sph_center`` for an attribute, ``['k']`` for a dict
key), so either package reads the other's files.  The JAX package's orbax
pair (multi-host checkpoints of sharded pytrees) becomes the
``torch.distributed.checkpoint`` pair (``save_checkpoint_dcp``,
``restore_checkpoint_dcp``), which ships with torch: with a process group
up, every rank calls it, and the replicated leaves are written once.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed
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


def _state_dict(tree: Any) -> Dict[str, Any]:
    return tree.state_dict() if isinstance(tree, nn.Module) else dict(tree)


def save_checkpoint_dcp(path: str, tree: Any) -> None:
    """``torch.distributed.checkpoint`` checkpoint (a directory) of an
    ``nn.Module``'s state dict or a (nested) dict of tensors; with a
    process group up, every rank calls it (JAX: save_checkpoint_orbax)."""
    import torch.distributed.checkpoint as dcp
    dcp.save(_state_dict(tree), checkpoint_id=path,
             no_dist=not torch.distributed.is_initialized())


def restore_checkpoint_dcp(path: str, like: Any) -> Any:
    """A copy of ``like`` (an ``nn.Module`` or a dict of tensors) holding
    ``save_checkpoint_dcp``'s values, in ``like``'s dtypes and devices
    (JAX: restore_checkpoint_orbax)."""
    import torch.distributed.checkpoint as dcp
    out = copy.deepcopy(like)
    sd = _state_dict(out)
    dcp.load(sd, checkpoint_id=path,
             no_dist=not torch.distributed.is_initialized())
    if isinstance(out, nn.Module):
        out.load_state_dict(sd)
        return out
    return sd
