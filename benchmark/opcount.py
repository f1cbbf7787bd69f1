"""The work a kernel call needs on its inputs, for the roofline shares: a
frozen copy of the program's hand counts (``utils/opcount.py`` as it stood
when the benchmark was written), applied to the primitive tests, hits and
live pixels that the reference's own forward finds on the same inputs.

Operations: each FP32 + - * /, sqrt and rsqrt of the device function that
a unit names is one (compares, selects and fabs none), so an FMA-able pair
counts two, as the card's peak rate does.  Bytes: each input the call
needs read once, each output written once.  The bound of a call is the
larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s (NVIDIA's
data sheet for the H100 SXM at 700 W, FP32 outside the tensor cores).
"""
from __future__ import annotations

from typing import Dict

import torch

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: FP32 operations a unit (the device function each prices)
UNITS = dict(
    TRI_TEST=41,      # tri_hit
    SPH_TEST=19,      # sph_hit
    RAY_SETUP=10,     # ray_setup
    HIT_ATTRS=27,     # hit_attrs
    DIRS=14,          # secondary_dirs, reflected direction
    SHADE_LIGHT=56,   # shade, one light without its shadow sweep
    CHAIN_STEP=11,    # the chain's child select and throughput
    PROLOGUE=15,      # the adjoint's cotangent and squared-error term
    PRIMAL=29,        # node_primal, common part
    PRIMAL_TRI=13,    # node_primal, triangle hit
    PRIMAL_SPH=31,    # node_primal, sphere hit
    REV_LIGHT=124,    # node_reverse, one lit light
    REV_TAIL=28,      # node_reverse, reflection and cosi adjoints
    REV_TRI=47,       # node_reverse, triangle hit
    REV_SPH=96,       # node_reverse, sphere hit
    SCATTER=13,       # one hit level's sphere and material sums
)


def ops(units: Dict[str, int]) -> float:
    return float(sum(n * UNITS[u] for u, n in units.items()))


def bound_ms(n_ops: float, n_bytes: float) -> float:
    """The least time of a call, in ms."""
    return max(n_ops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S) * 1e3


def forward_work(counts: Dict[str, int], pixels: int, *, depth: int,
                 lights: int, packed: bool) -> Dict[str, float]:
    """Operations and bytes of the chain forward over ``pixels`` primary
    rays (the plain render K2, or with ``packed`` K3, which also writes one
    residual word a level), from the reference's ``trace(count=True)``
    counts: the closest-hit sweeps' tests (the origin primitive skipped),
    the any-hit shadow sweeps' tests up to the first occluder, the visits
    and the hits."""
    hits = counts["hits"]
    units = dict(RAY_SETUP=counts["visits"],
                 TRI_TEST=counts["tri"] + counts["shadow_tri"],
                 SPH_TEST=counts["sph"] + counts["shadow_sph"],
                 HIT_ATTRS=hits, DIRS=hits, CHAIN_STEP=hits,
                 SHADE_LIGHT=lights * hits)
    n_bytes = pixels * 24 + (pixels * 4 * (depth + 1) if packed else 0)
    return dict(ops=ops(units), bytes=float(n_bytes))


def adjoint_work(topo: Dict[str, torch.Tensor], live: torch.Tensor, *,
                 nt: int, ns: int, materials: int, lights: int,
                 depth: int) -> Dict[str, float]:
    """Operations and bytes of the two-phase adjoint (K4) over the frame
    whose topology ``topo`` (the reference's ``bi`` [D+1,P], ``lit``
    [L,D+1,P]) the packed forward recorded, ``live`` [P] the pixels whose
    cotangent is nonzero: the prologue for every pixel; for the live ones
    the primal and reverse sweeps of each hit level before the first miss
    with their lit lights, and the column sums.  Bytes: image, target and
    mask of every pixel; for the live ones the residual levels up to the
    first miss and, where level 0 hits, the ray; the gradient tables once."""
    P = live.shape[0]
    bi = topo["bi"].long()
    hit = bi >= 0
    lead = torch.cumprod(hit.int(), 0).bool() & live[None, :]
    is_tri = bi < nt
    n_lead = lead.sum(0)
    level = torch.arange(depth + 1, device=bi.device)[:, None]
    fwd = lead & (level < n_lead[None, :] - 1)
    lits = topo["lit"] & lead[None]
    n_tri = int((lead & is_tri).sum()) + int((fwd & is_tri).sum())
    n_sph = int((lead & ~is_tri).sum()) + int((fwd & ~is_tri).sum())
    n_hit = int(lead.sum())
    units = dict(PROLOGUE=P, PRIMAL=n_tri + n_sph, PRIMAL_TRI=n_tri,
                 PRIMAL_SPH=n_sph, REV_LIGHT=int(lits.sum()),
                 REV_TAIL=n_hit, REV_TRI=int((lead & is_tri).sum()),
                 REV_SPH=int((lead & ~is_tri).sum()), SCATTER=n_hit)
    levels = int(torch.clamp(n_lead + 1, max=depth + 1)[live].sum())
    columns = 1 + 4 * ns + 9 * materials + 3 * lights
    n_bytes = (P * (12 + 12 + 4) + 4 * levels + 12 * int((n_lead > 0).sum())
               + 4 * columns)
    return dict(ops=ops(units), bytes=float(n_bytes), live=int(live.sum()))
