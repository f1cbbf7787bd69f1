"""Speed of light of the CUDA kernels, priced at an issue rate the card
measures for their own mix of operations -- the counterpart of the JAX
package's ``utils/roofline.py``.

    SOL time      = (class operations of the call) / (K9's rate for its blend)
    sol_fraction  = SOL time / measured time

The numerator comes from ``utils/opcount.py``: the operations each kernel
runs on these inputs, counted by hand from the CUDA sources in classes
(``basic`` + - *, IEEE ``div``, ``sqrt``, ``rsqrt``, ``cmp``, ``select``,
``abs``, ``floor``).  The denominator is measured by K9
(``kernels/csrc/mix_probe.cu``, ``measure_mix_rate``): register-resident
dependent chains whose 256-op class schedule is made from those same
counts (``mix_schedule``: largest-remainder allocation, interleaved), built
with the kernels' own ``-fmad=false``, with the chains per thread and the
blocks per SM swept and the best taken, timed by iteration-count
differencing on the device.  One budget op of the chain is one unit of the
count, so numerator and denominator share their units.

Why not the data sheet: the kernels' FP32 ceiling without fused
multiply-add is half of the 67 TFLOP/s that counts an FMA as two, and their
compares, selects, IEEE divisions, square roots and MUFU reciprocal square
roots each issue at their own rates.  ``utils/opcount.py::bound_ms`` keeps
the data-sheet bound beside this one.

The schedule code (``_MIX_CLASSES`` .. ``_rewrite_schedule``) is the JAX
package's, copied: it is pure Python, but the JAX module imports jax.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels.render import resolve_device

# classes the mix chain can emit; anything else (tiny "other:*" residue)
# folds into basic
_MIX_CLASSES = ("basic", "select", "cmp", "abs", "sign", "rsqrt", "sqrt",
                "div", "recip_nr", "floor")
_MIX_BLOCK_OPS = 256   # budget ops per chain iteration
#: the tile the chains read their scalars from (8 rows x 256 lanes)
TILE_ROWS, TILE_COLS = 8, 256


def flat_slots(counts: Dict[str, float]) -> float:
    return float(sum(counts.values()))


def mix_schedule(counts: Dict[str, float],
                 block_ops: int = _MIX_BLOCK_OPS) -> Tuple[str, ...]:
    """Largest-remainder integer allocation of ``block_ops`` budget ops over
    the op classes of ``counts``, interleaved proportionally (Bresenham) so
    heavy classes don't run in bursts.  Classes whose share rounds to zero
    are dropped.

    One budget op = one numerator-count unit: the ``recip_nr`` entry emits
    approx-reciprocal + one Newton step (4 instructions) but consumes ONE
    budget op, exactly as a count of one ``recip_nr`` per reciprocal site
    -- numerator and denominator stay in the same units."""
    tot = sum(counts.values())
    shares = {k: 0.0 for k in _MIX_CLASSES}
    for k, v in counts.items():
        shares[k if k in _MIX_CLASSES else "basic"] += v / tot
    alloc = {k: int(s * block_ops) for k, s in shares.items()}
    rema = sorted(shares, key=lambda k: (shares[k] * block_ops) % 1.0,
                  reverse=True)
    for k in rema:
        if sum(alloc.values()) >= block_ops:
            break
        alloc[k] += 1
    alloc = {k: n for k, n in alloc.items() if n > 0}
    # proportional interleave
    sched, err = [], {k: 0.0 for k in alloc}
    for _ in range(sum(alloc.values())):
        for k in err:
            err[k] += alloc[k]
        k = max(err, key=err.get)
        err[k] -= sum(alloc.values())
        sched.append(k)
    return tuple(sched)


# extra instructions _emit issues beyond the budget op itself, charged to
# the basic budget during schedule rewriting (keeps units exact)
_EXTRA_BASIC = dict(sign=1, floor=3)


def _rewrite_schedule(sched):
    """Charge _EXTRA_BASIC support instructions against the basic budget:
    each 'sign' emits sign+mul, so one following 'basic' entry is removed
    per extra instruction (schedule stays the same budget-op total).
    Returns ``(schedule, leftover)`` where ``leftover`` is unpaid debt
    (support instructions with no later 'basic' entry to remove).  Each
    support mul is a basic-class instruction: when its debt is paid the
    removed 'basic' entry keeps the per-pass unit count at the budget,
    but unpaid debt means the chain executes that many EXTRA basic-unit
    instructions beyond the budget — the caller must add ``leftover`` to
    the per-step unit count or the measured rate is misstated."""
    out, owed = [], 0
    for cls in sched:
        if cls == "basic" and owed > 0:
            owed -= 1
            continue
        owed += _EXTRA_BASIC.get(cls, 0)
        out.append(cls)
    return tuple(out), owed


def folded_ops(sched) -> int:
    """Budget ops of ``sched`` that no compiler runs: a ``cmp`` whose bool
    a later ``cmp`` replaces before any ``select`` reads it (dead code; the
    last one feeds the tail select), and a ``select`` or ``abs`` right
    after one of its own class (idempotent).  The JAX schedule keeps them
    (``_rewrite_schedule``); on the card nvcc drops them, so K9 counts only
    the ops it runs (``budget_per_step``)."""
    n, pending, prev = 0, False, None
    for cls in sched:
        if cls == "cmp":
            n += pending
            pending = True
        elif cls == "select":
            pending = False
            n += prev == "select"
        elif cls == "abs":
            n += prev == "abs"
        prev = cls
    return n


def budget_per_step(sched, leftover: int) -> int:
    """Budget ops one chain runs per iteration of ``sched`` (rewritten,
    with its unpaid ``leftover``): the 256 of the block, the tail select
    consuming the bool, the unpaid _EXTRA_BASIC debt (extra basic-unit
    instructions actually executed), less ``folded_ops``."""
    return _MIX_BLOCK_OPS + 1 + leftover - folded_ops(sched)


def _emit_ref(cls: str, y, b, c, d, k: int):
    """One budget op of class ``cls`` on ``y`` (the JAX ``_emit`` with
    ``fast=False``: ``recip_nr`` is an exact 1/y plus one Newton step).
    ``b`` is the bool of the most recent ``cmp``; ``c``, ``d`` the tile's
    scalars."""
    if cls == "basic":
        return (y * c if k % 2 == 0 else y + d), b
    if cls == "cmp":
        return y, y > d
    if cls == "select":
        return torch.where(b, y, d), b
    if cls == "abs":
        return torch.abs(y), b
    if cls == "sign":
        return torch.sign(y) * d, b
    if cls == "rsqrt":
        return torch.rsqrt(y), b
    if cls == "sqrt":
        return torch.sqrt(y), b
    if cls == "div":
        return c / y, b
    if cls == "recip_nr":
        r = 1.0 / y
        return r * (2.0 - y * r), b
    if cls == "floor":
        return torch.floor(y * 1.618) * d + c * 0.25, b
    raise ValueError(cls)


def tiles(x: torch.Tensor) -> torch.Tensor:
    """``x`` [8*G, 256] f32 as its G tiles [G, 8, 256]; raises on another
    shape."""
    if (x.dim() != 2 or x.shape[1] != TILE_COLS or x.shape[0] % TILE_ROWS
            or x.shape[0] == 0 or x.dtype != torch.float32):
        raise ValueError(f"the chains take f32 [8*G, 256], got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.reshape(-1, TILE_ROWS, TILE_COLS)


def mix_chain_ref(x: torch.Tensor, *, iters: int, nc: int,
                  sched) -> torch.Tensor:
    """The plain version of K9 (the JAX ``_mix_kernel`` with ``fast=False``):
    for each element of ``x`` [8*G, 256], ``nc`` chains from
    x*(1 + 0.001 i) run ``iters`` iterations of ``sched`` (class names),
    each iteration starting its compare bool from bfix = x > d and ending
    in one select on it; returns the chains' sum, [8*G, 256].  ``c`` and
    ``d`` are each 8x256 tile's [0,0] and [0,1]."""
    xt = tiles(x)
    c, d = xt[:, :1, :1], xt[:, :1, 1:2]
    bfix = xt > d
    ys = [xt * (1.0 + 0.001 * i) for i in range(nc)]
    for _ in range(iters):
        outs = []
        for y in ys:
            b = bfix
            for k, cls in enumerate(sched):
                y, b = _emit_ref(cls, y, b, c, d, k)
            outs.append(torch.where(b, y, d))
        ys = outs
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc.reshape(x.shape)


def probe_input(num_tiles: int, device) -> torch.Tensor:
    """The probes' input, as the JAX probes make it: 0.5 + 0.2 U[0,1) from
    numpy's default_rng(0), [8*num_tiles, 256] f32."""
    rng = np.random.default_rng(0)
    x = 0.5 + 0.2 * rng.random((TILE_ROWS * num_tiles, TILE_COLS))
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def _measure_mix_rate_cached(sched: Tuple[str, ...], per_step: int,
                             iters: int, reps: int, device: str) -> dict:
    if device == "cpu":
        # the plain chain at two tiles on the host clock: a check that the
        # schedule runs, for the tests; not a device rate
        x = probe_input(2, "cpu")
        deltas = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            mix_chain_ref(x, iters=iters, nc=2, sched=sched)
            t1 = time.perf_counter()
            mix_chain_ref(x, iters=2 * iters, nc=2, sched=sched)
            t2 = time.perf_counter()
            deltas.append(max((t2 - t1) - (t1 - t0), 1e-12))
        deltas.sort()
        rate = x.numel() * 2 * iters * per_step / deltas[len(deltas) // 2]
        return dict(rate=rate, nc=2, blocks_per_sm=None, sweep={})
    from ..kernels import probe
    return probe.mix_rate_sweep(sched, per_step, iters=iters, reps=reps,
                                device=torch.device(device))


def mix_rate_details(counts: Dict[str, float], iters: int = None,
                     reps: int = 5, device=None) -> dict:
    """``measure_mix_rate`` with the sweep: ``rate`` (budget ops/s), the
    best ``nc`` and ``blocks_per_sm``, ``sweep`` {"NCxBPS": rate},
    ``schedule`` and ``per_step``."""
    dev = resolve_device(device)
    if iters is None:
        iters = 64 if dev.type == "cuda" else 2
    sched, leftover = _rewrite_schedule(mix_schedule(counts))
    per_step = budget_per_step(sched, leftover)
    dev_key = "cpu" if dev.type == "cpu" else str(torch.device(
        "cuda", dev.index if dev.index is not None
        else torch.cuda.current_device()))
    out = dict(_measure_mix_rate_cached(sched, per_step, iters, reps,
                                        dev_key))
    out.update(schedule=sched, per_step=per_step)
    return out


def measure_mix_rate(counts: Dict[str, float], iters: int = None,
                     reps: int = 5, device=None) -> float:
    """Sustained issue rate (budget ops/s) of register-resident dependent
    chains with the op-class ratio of ``counts`` -- the SOL denominator.
    On the card (the default) K9 runs with 2, 4, 8 and 16 chains a thread
    at the most blocks per SM that fit and half of that, timed by
    iteration-count differencing (``iters`` and 2*``iters``, CUDA events),
    median of ``reps``; the best is taken.  With ``device="cpu"`` the plain
    chain runs on the host clock: a check that the schedule runs, for the
    tests, not a rate of any device."""
    return mix_rate_details(counts, iters, reps, device)["rate"]


def sol_report(counts_fwd: Dict[str, float], counts_bwd: Dict[str, float],
               pixels: int, fwd_s: float = None, fwd_bwd_s: float = None,
               *, device=None, iters: int = None,
               reps: int = 5) -> Dict[str, float]:
    """Roofline summary of a measured time: the class operations of the
    call's forward (``counts_fwd``) and backward (``counts_bwd``), as
    ``utils/opcount.py`` counts them on its inputs, per pixel; K9's rate
    for the blend timed; the speed-of-light times and the achieved
    ``sol_fraction``s (the JAX ``sol_report``'s fields).  ``fwd_s`` prices
    the forward alone, ``fwd_bwd_s`` the whole step."""
    f_f, b_f = flat_slots(counts_fwd), flat_slots(counts_bwd)
    out = dict(ops_per_pixel_fwd=f_f / pixels,
               ops_per_pixel_bwd=b_f / pixels,
               counts_fwd=dict(counts_fwd), counts_bwd=dict(counts_bwd))
    if fwd_s is not None:
        rate = measure_mix_rate(counts_fwd, iters, reps, device)
        sol = f_f / rate
        out["mix_rate_fwd_ops_per_s"] = rate
        out["sol_fwd_s"] = sol
        out["sol_fraction_fwd"] = sol / fwd_s
    if fwd_bwd_s is not None:
        tot = dict(counts_fwd)
        for k, v in counts_bwd.items():
            tot[k] = tot.get(k, 0.0) + v
        rate = measure_mix_rate(tot, iters, reps, device)
        sol = (f_f + b_f) / rate
        out["mix_rate_fwd_bwd_ops_per_s"] = rate
        out["sol_fwd_bwd_s"] = sol
        out["sol_fraction_fwd_bwd"] = sol / fwd_bwd_s
    return out
