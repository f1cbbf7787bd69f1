"""Numerical guards — the counterpart of the JAX package's
``utils/guards.py`` (SURVEY.md section 5, "Race detection / sanitizers").
JAX's ``checked_render`` runs the render under ``checkify``'s float checks,
which flag each operation that makes a NaN or divides by zero; here the
rendered output is checked with ``torch.isfinite`` (a CUDA kernel's inner
operations are out of PyTorch's reach), raising ``FloatingPointError`` as
JAX's does."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every tensor or array in a nest of dicts, lists,
    tuples, dataclasses and ``nn.Module`` parameters, with JAX's
    ``keystr`` paths (``['k']``, ``[0]``, ``.field``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield f"{path}.{name}", p
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield path, tree


def assert_finite(tree: Any, name: str = "output") -> None:
    """Raises ``FloatingPointError`` naming the first floating-point leaf
    of ``tree`` that holds a NaN or an infinity."""
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def checked_render(render_fn: Callable, *args, **kwargs):
    """Runs ``render_fn(*args, **kwargs)`` and returns its output; raises
    ``FloatingPointError`` where the output holds a NaN or an
    infinity."""
    out = render_fn(*args, **kwargs)
    assert_finite(out)
    return out
