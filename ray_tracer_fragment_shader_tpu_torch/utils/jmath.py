"""Guarded math helpers on tensors.

Every ``sqrt``/division whose operand can be invalid on a masked-out lane
uses the double-``where`` form, so the dead lane yields 0 (and a zero
gradient under autograd) instead of NaN.
"""
from __future__ import annotations

import torch


def safe_sqrt(x, valid=None):
    """sqrt(x) where ``x`` may be negative on masked-out lanes: computed as
    sqrt(where(valid, x, 1)), then 0 on the dead lanes."""
    if valid is None:
        valid = x > 0.0
    x_safe = torch.where(valid, x, torch.ones_like(x))
    return torch.where(valid, torch.sqrt(x_safe), torch.zeros_like(x))


def safe_div(num, den, valid=None, eps=0.0):
    """num/den with the dead lanes neutralised."""
    if valid is None:
        valid = torch.abs(den) > eps
    q = num / torch.where(valid, den, torch.ones_like(den))
    return torch.where(valid, q, torch.zeros_like(q))


def dot3(a, b, dim=-1):
    return torch.sum(a * b, dim=dim)


def norm3(v, dim=-1):
    """|v|, 0 (with a zero gradient) at v == 0."""
    sq = dot3(v, v, dim=dim)
    return safe_sqrt(sq, sq > 0.0)


def safe_normalize(v, dim=-1):
    """v/|v|, returning 0 for zero vectors."""
    sq = dot3(v, v, dim=dim)
    valid = sq > 0.0
    sq_safe = torch.where(valid, sq, torch.ones_like(sq))
    inv = torch.where(valid, 1.0 / torch.sqrt(sq_safe), torch.zeros_like(sq))
    return v * inv.unsqueeze(dim)


def cross3(a, b):
    return torch.linalg.cross(a, b, dim=-1)
