"""Row gathers by id with a parallel, deterministic backward.

The JAX package selects rows by one-hot reductions over [P, N] (a TPU
idiom: per-ray gathers run on the TPU's scalar path).  On the GPU the port
gathers rows directly (PR 1's decision); a one-hot sum adds only zeros, so
the forward values are the same.  The backward of ``table[idx]`` itself,
an accumulating ``index_put_``, adds the rays that share a row one after
another on the GPU, and most rays share a few rows (the floor's, and row 0
for every unselected lane): ``GatherRows`` sums them as one-hot products
over fixed chunks instead.  The core renderer's intersection
(ops/intersect.py) and the fixed-topology replay (kernels/adjoint.py) both
gather through it.
"""
from __future__ import annotations

import torch

#: rays whose cotangents one [chunk, rows] one-hot product sums at once in
#: the gather's backward
GATHER_CHUNK = 1 << 18


class GatherRows(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's cotangents as one-hot
    products over fixed chunks of rays: a fixed order, so deterministic,
    and parallel."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = g.reshape(g.shape[0], -1)
        out = flat.new_zeros((ctx.rows, flat.shape[1]))
        for s in range(0, idx.shape[0], GATHER_CHUNK):
            i = idx[s:s + GATHER_CHUNK]
            hot = flat.new_zeros((i.shape[0], ctx.rows)).scatter_(
                1, i[:, None], 1.0)
            out.addmm_(hot.T, flat[s:s + GATHER_CHUNK])
        return out.reshape(ctx.rows, *g.shape[1:]), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an int64 id per ray (``GatherRows``)."""
    return GatherRows.apply(table, idx)
