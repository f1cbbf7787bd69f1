"""The work a kernel call needs on its inputs: FP32 operations and device
bytes, for the roofline bound that ``chip_smoke.py`` reports beside each
kernel's time (K2/K5 and their residual forms ``forward_work``, K4
``adjoint_work``, K6/K7 ``fused_work``, K8 ``fit_grads_work``).

Operations are counted by hand from the CUDA sources, as written: each
``+ - * /``, ``sqrtf`` and ``rsqrtf`` is one, comparisons, selects and
``fabsf`` none (so an FMA-contractible pair counts 2, as the card's peak
rate does).  The per-unit counts below name the device function they
price.  The counts multiply the units that THESE inputs run, found by
replaying the kernels' control flow with their plain versions: node
visits, primitive tests per closest-hit sweep (the excluded origin
primitive skipped), shadow-sweep tests up to the first occluder for the
any-hit sweep, lit lights, hit levels and pixels with a nonzero cotangent
in the adjoint.  Work that a kernel does beyond what the function needs
is its own overhead, left out so that it shows as a lower share:
``hit_attrs`` recomputes a triangle winner's plane parameter (12 + - *
and a division a triangle hit) that the sweep already formed, to keep no
register live across the sweep.  Bytes count each input that the function needs read once
(in the adjoint: a ray and residual levels only where the cotangent is
nonzero) and each output written once.  The bound is the larger of
ops / 67 TFLOP/s (the bf16 operations at twice that) and bytes / 3.35 TB/s
(H100 SXM, FP32 and bf16 outside the tensor cores, at 700 W).

Each work function also returns ``classes``: its operations by class, the
numerator ``utils/roofline.py`` prices at the rate K9 measures for their
blend.  ``CLASSES`` splits each per-unit count, hand-counted from the same
device function: ``basic`` (+ - *), ``div`` (IEEE /, also a reciprocal),
``sqrt`` and ``rsqrt`` make up the count above (so ``ops`` and the
data-sheet bound stay as they were); ``cmp`` (float and integer compares,
a combined ``&&`` of two being one predicate instruction), ``select``,
``abs`` (``fabsf``) and ``floor`` (``truncf``) are the instructions it
leaves out.  A branch, a table load and the loop counters are not counted.

The ``bf16_shading`` forms (tile_ops.cuh's ``tri_hit_bf16``,
``sph_hit_bf16``, the ray cast of ``occluded_any<true>`` and the bf16
blend of ``shade``; the ``*_BF16`` units) count each bfloat16 + - * and
each conversion between f32 and bf16 that the function needs per ray as
one ``basic``: the conversions of the ray and of the blend's per-pixel
operands, not those of the scene's table values, which it needs once per
scene (the kernels cast them per test all the same).  ``BF16_OPS`` says
how many of a unit's ``basic`` are bfloat16, which the data-sheet bound
prices at twice the FP32 rate; K9's pricing keeps them ``basic``: the
card's bf16 arithmetic measured no faster than f32 on scalar chains (P2,
PERF.md).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.render import (_PlainOps, n_tree_nodes, render_residuals_ref,
                              unpack_residuals)

#: H100 SXM peaks (NVIDIA data sheet, 700 W)
PEAK_FP32_FLOPS = 67e12
#: bfloat16 outside the tensor cores: two lanes an instruction, twice FP32
PEAK_BF16_FLOPS = 2 * PEAK_FP32_FLOPS
PEAK_BYTES_PER_S = 3.35e12

# --- tile_ops.cuh (forward), FP32 operations per unit ----------------------
TRI_TEST = 41      # tri_hit
SPH_TEST = 19      # sph_hit
RAY_SETUP = 10     # ray_setup
HIT_ATTRS = 27     # hit_attrs
DIRS = 14          # secondary_dirs, reflected direction
SNELL = 20         # secondary_dirs, transmitted direction (WANT_TRANS)
SHADE_LIGHT = 56   # shade, one light without its shadow sweep
CHAIN_STEP = 11    # render_chain.cu child select and throughput
TREE_PUSH = 12     # render_tree.cu, one pushed child
# the bf16_shading forms: the f32 unit's operations, some in bf16, plus
# the conversions of per-ray values
TRI_TEST_BF16 = 46     # tri_hit_bf16
SPH_TEST_BF16 = 21     # sph_hit_bf16
SHADE_LIGHT_BF16 = 67  # shade with the bf16 blend, one light
SWEEP_CAST_BF16 = 9    # occluded_any<true>: the ray cast once per sweep
# --- adjoint_ops.cuh / adjoint_packed.cu -----------------------------------
PROLOGUE = 15        # cotangent and squared-error term, per pixel
PRIMAL = 29          # node_primal, common part
PRIMAL_TRI = 13      # node_primal, triangle hit
PRIMAL_SPH = 31      # node_primal, sphere hit (distance and normal)
PRIMAL_SNELL = 19    # node_primal, transmitted direction
REV_LIGHT = 124      # node_reverse, one lit light
REV_TAIL = 28        # node_reverse, reflection and cosi adjoints
REV_TRI = 47         # node_reverse, triangle hit
REV_SPH = 96         # node_reverse, sphere hit
REV_SNELL = 22       # snell_reverse
SCATTER = 13         # one hit level's sphere and material sums
TREE_CHILD = 3       # adjoint_ops.cuh::tree_adjoint, one child's weight

#: each unit's operations by class (see the module docstring); basic, div,
#: sqrt and rsqrt add up to the unit's count above
CLASSES = {
    # tri_hit: the 1/ndv division, 5 compares + the sweep's two gates, the
    # plane_ok select, fabsf
    "TRI_TEST": dict(basic=40, div=1, cmp=7, select=1, abs=1),
    # sph_hit: sqrtf; disc>0, disc>=0, dist>=small + the two gates
    "SPH_TEST": dict(basic=18, sqrt=1, cmp=5, select=1),
    "RAY_SETUP": dict(basic=9, rsqrt=1, cmp=1, select=1),
    # rsqrtf of the normal, three truncf of the checker parity, the
    # hit/kind/checker selects of the point, the normal and the material
    "HIT_ATTRS": dict(basic=26, rsqrt=1, cmp=7, select=15, floor=3),
    "DIRS": dict(basic=14),
    "SNELL": dict(basic=19, sqrt=1, cmp=1, select=2),
    # its ray_setup, the attenuation's division, 1/|sv|, two fabsf
    "SHADE_LIGHT": dict(basic=53, div=1, rsqrt=2, cmp=3, select=4, abs=2),
    "CHAIN_STEP": dict(basic=11, cmp=3, select=7),
    "TREE_PUSH": dict(basic=12, cmp=1),
    # the dot products, hit point and barycentrics in bf16; mm's
    # subtraction, product and 1/ndv and sb+tb in f32; ndv, ndo, sb and tb
    # back to f32 and mm to bf16 (its 16 table casts not counted)
    "TRI_TEST_BF16": dict(basic=45, div=1, cmp=7, select=1, abs=1),
    # the offsets and two dot products in bf16; disc and the root in f32;
    # ud and |d|^2 back (its 3 table casts not counted)
    "SPH_TEST_BF16": dict(basic=20, sqrt=1, cmp=5, select=1),
    # the blend's 6 a channel in bf16; SHADE_LIGHT's rest, per channel
    # w*L and the += in f32; ndots, udotr and per channel thr, w*L and
    # the product converted (its 9 material casts not counted)
    "SHADE_LIGHT_BF16": dict(basic=64, div=1, rsqrt=2, cmp=3, select=4,
                             abs=2),
    # origin, direction and unit direction to bf16
    "SWEEP_CAST_BF16": dict(basic=9),
    "PROLOGUE": dict(basic=15, cmp=3),
    # safe_sqrt(|v|^2), safe_recip(|v|), the kind compare
    "PRIMAL": dict(basic=27, sqrt=1, div=1, cmp=3, select=2),
    "PRIMAL_TRI": dict(basic=11, div=2, cmp=1, select=2, abs=1),
    "PRIMAL_SPH": dict(basic=27, sqrt=2, div=2, cmp=4, select=3),
    "PRIMAL_SNELL": dict(basic=17, sqrt=1, div=1, cmp=3, select=3),
    # inv_sqrt(d2), 1/(atten+d2), two sgn (2 compares and a select each),
    # the lit bit, two fabsf
    "REV_LIGHT": dict(basic=121, sqrt=1, div=2, cmp=6, select=3, abs=2),
    "REV_TAIL": dict(basic=28),
    "REV_TRI": dict(basic=47, select=1),
    "REV_SPH": dict(basic=96, select=1),
    "REV_SNELL": dict(basic=22),
    # the sums, and the record's sphere and material matches
    "SCATTER": dict(basic=13, cmp=2),
    "TREE_CHILD": dict(basic=3, cmp=2, select=6),
}
#: the classes that make up a unit's count
COUNTED = ("basic", "div", "sqrt", "rsqrt")
#: of each bf16 unit's ``basic``, the bfloat16 + - * (as CLASSES says)
BF16_OPS = {"TRI_TEST_BF16": 37, "SPH_TEST_BF16": 13, "SHADE_LIGHT_BF16": 18}


def _price(units: Dict[str, int]) -> Tuple[float, Dict[str, float]]:
    """(operations, operations by class) of ``units`` {unit name: how many
    times it runs}."""
    ops = sum(n * globals()[u] for u, n in units.items())
    classes: Dict[str, float] = {}
    for u, n in units.items():
        for k, c in CLASSES[u].items():
            classes[k] = classes.get(k, 0.0) + float(n * c)
    return float(ops), classes


def _add(units: Dict[str, int], **counts) -> Dict[str, int]:
    for u, n in counts.items():
        units[u] = units.get(u, 0) + int(n)
    return units


def bound_ms(ops: float, nbytes: float,
             bf16_ops: float = 0.0) -> Tuple[float, str]:
    """(least time in ms, "operations" or "bytes": which term bounds) of
    ``ops`` operations, ``bf16_ops`` of them bfloat16, and ``nbytes``."""
    t_ops = (ops - bf16_ops) / PEAK_FP32_FLOPS + bf16_ops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _shadow_lane_tests(ops: _PlainOps, px, py, pz, bi, hitm, light,
                       any_hit: bool):
    """(triangle tests, sphere tests) of one light's shadow sweep, per lane
    (int tensors), and the lanes whose shadow ray is cast: up to the first
    occluder for the any-hit sweep (its bf16 form under ``ops.bf16``), all
    of them for the nearest-occluder sweep."""
    svx, svy, svz = light[0] - px, light[1] - py, light[2] - pz
    vlen2 = svx * svx + svy * svy + svz * svz
    ok = hitm & (vlen2 > 0.0)
    inv = torch.rsqrt(torch.where(ok, vlen2, 1.0))
    ux, uy, uz = svx * inv, svy * inv, svz * inv
    if any_hit and ops.bf16:
        ob = tuple(x.bfloat16() for x in (px, py, pz))
        vb = tuple(x.bfloat16() for x in (svx, svy, svz))
        ub = tuple(x.bfloat16() for x in (ux, uy, uz))
        tri_hit = lambda i: ops._tri_hit_bf16(i, ob, vb, ok, bi)
        sph_hit = lambda i: ops._sph_hit_bf16(i, ob, ub, ok, bi)
    else:
        tri_hit = lambda i: ops._tri_hit(i, px, py, pz, svx, svy, svz, ok,
                                         bi)[0]
        sph_hit = lambda i: ops._sph_hit(i, px, py, pz, ux, uy, uz, ok,
                                         bi)[0]
    found = torch.zeros_like(ok)
    n_tri = torch.zeros(ok.shape, dtype=torch.int64, device=ok.device)
    n_sph = torch.zeros_like(n_tri)
    for i in range(ops.nt):
        if ops.tri[i][19] > 0.5:
            active = ok & ~found & (bi != float(i))
            n_tri += active
            if any_hit:
                found |= active & tri_hit(i)
    for i in range(ops.ns):
        if ops.sph[i][5] > 0.5:
            active = ok & ~found & (bi != float(i + ops.nt))
            n_sph += active
            if any_hit:
                found |= active & sph_hit(i)
    return n_tri, n_sph, ok


def forward_work(tables, v, eye, *, tree: bool = False, packed: bool = False,
                 residuals: bool = False, nl: int, depth: int, small: float,
                 atten: float, checker_mats, want_trans: bool,
                 bf16: bool = False,
                 lanes: Optional[list] = None) -> Dict[str, float]:
    """Operations and bytes of one chain (``tree=False``) or tree kernel
    call on [P,3] primary directions ``v`` — what csrc/render_chain.cu or
    render_tree.cu runs on these inputs, in its bf16_shading form with
    ``bf16`` (``bf16_ops`` of the operations then bfloat16).  ``packed``
    adds the packed plane's bytes (4 per level), ``residuals`` the
    unpacked planes' ((2+nl)*4 per level or preorder node), written for
    every pixel; neither adds operations.  With ``lanes`` (a list), each
    node visit appends its tests per lane: ``closest`` [P] and ``shadow``,
    one [P] per light (``lane_efficiency`` reads them)."""
    P = v.shape[0]
    ops = _PlainOps(tables, num_pixels=P, nl=nl, small=small, atten=atten,
                    checker_mats=checker_mats, all_opaque=not want_trans,
                    bf16=bf16)
    n_tri_ok = sum(1 for t in ops.tri if t[19] > 0.5)
    n_sph_ok = sum(1 for s in ops.sph if s[5] > 0.5)
    # the shadow tests apart: their bf16 form under bf16 and any-hit
    work = dict(visits=0, hits=0, tri_tests=0, sph_tests=0,
                shadow_tri_tests=0, shadow_sph_tests=0, any_hit_sweeps=0)

    def visit(o, d, excl, alive, thr, col):
        """One trace_node over the ``alive`` lanes."""
        n_alive = int(alive.sum())
        work["visits"] += n_alive
        work["tri_tests"] += n_tri_ok * n_alive - int(
            (alive & (excl >= 0) & (excl < ops.nt)).sum())
        work["sph_tests"] += n_sph_ok * n_alive - int(
            (alive & (excl >= ops.nt)).sum())
        out = ops.node(*o, *d, excl, alive, thr, col, want_trans)
        hitm, bi, p = out[0], out[1], out[2]
        work["hits"] += int(hitm.sum())
        shadow = []
        for light in ops.light:
            t, s, ok = _shadow_lane_tests(ops, *p, bi, hitm, light,
                                          not want_trans)
            work["shadow_tri_tests"] += int(t.sum())
            work["shadow_sph_tests"] += int(s.sum())
            work["any_hit_sweeps"] += int(ok.sum()) if not want_trans else 0
            shadow.append(t + s)
        if lanes is not None:
            closest = torch.where(alive, n_tri_ok + n_sph_ok
                                  - (excl >= 0).long(), 0)
            lanes.append(dict(closest=closest, shadow=shadow))
        return out

    one = ops.full(1.0)
    thr, col = (one,) * 3, (ops.full(0.0),) * 3
    o = tuple(ops.full(float(e)) for e in eye)
    d = (v[:, 0], v[:, 1], v[:, 2])
    alive = torch.ones(P, dtype=torch.bool, device=v.device)
    if not tree:
        excl = ops.full(-1.0)
        for _ in range(depth + 1):
            hitm, bi, p, mats, dirs, _, _ = visit(o, d, excl, alive, thr, col)
            take_t = mats[:, 13] > 0.5
            d = tuple(torch.where(take_t, t, r)
                      for t, r in zip(dirs[3:], dirs[:3]))
            branch = torch.where(take_t, d[0] * d[0] + d[1] * d[1]
                                 + d[2] * d[2] > 0.0, mats[:, 14] > 0.5)
            alive = hitm & branch
            o, excl = p, bi
    else:
        def node(o, d, excl, alive, level):
            hitm, bi, p, mats, dirs, _, _ = visit(o, d, excl, alive, thr, col)
            if level == depth:
                return
            for gate, dd in ((mats[:, 13], dirs[3:]), (mats[:, 14], dirs[:3])):
                child = hitm & (gate != 0.0)
                if bool(child.any()):
                    node(p, tuple(x * gate for x in dd), bi, child, level + 1)
        node(o, d, ops.full(-1.0), alive, 0)
    hits = work["hits"]
    sweep_bf16 = bf16 and not want_trans
    b = "_BF16" if sweep_bf16 else ""
    units = _add({}, RAY_SETUP=work["visits"], TRI_TEST=work["tri_tests"],
                 SPH_TEST=work["sph_tests"], HIT_ATTRS=hits, DIRS=hits,
                 SNELL=hits if want_trans else 0,
                 **{"TREE_PUSH" if tree else "CHAIN_STEP": hits})
    _add(units, **{"TRI_TEST" + b: work["shadow_tri_tests"],
                   "SPH_TEST" + b: work["shadow_sph_tests"],
                   "SHADE_LIGHT_BF16" if bf16 else "SHADE_LIGHT": nl * hits,
                   "SWEEP_CAST_BF16": work["any_hit_sweeps"] if sweep_bf16
                   else 0})
    flops, classes = _price(units)
    K = n_tree_nodes(depth) if tree else depth + 1
    nbytes = (P * 24 + (P * 4 * (depth + 1) if packed else 0)
              + (P * 4 * (2 + nl) * K if residuals else 0))
    return dict(work, ops=flops, classes=classes, units=units,
                bytes=float(nbytes),
                bf16_ops=float(sum(n * BF16_OPS.get(u, 0)
                                   for u, n in units.items())))


#: the lanes of a warp: the chain kernel's 256-thread blocks trace pixels
#: p = 32 w .. 32 w + 31 in warp w
WARP = 32


def lane_efficiency(tables, v, eye, *, nl: int, depth: int, small: float,
                    atten: float, checker_mats, want_trans: bool,
                    bf16: bool = False) -> Dict[str, dict]:
    """How full the lanes of the chain kernel's warps are in its two sweeps
    (one pixel a lane, tile_ops.cuh::chain_forward), from the plain version
    on these inputs (``forward_work``'s replay): ``closest`` and
    ``shadow``, each with ``tests`` (primitive tests over all lanes, the
    excluded origin primitive skipped; shadow tests up to the first
    occluder where the sweep is any-hit), ``warp_steps`` (the sum over
    warps of the most tests one lane of the warp runs: one closest-hit
    sweep per warp and level, one shadow sweep per warp, level and light)
    and ``efficiency``, tests / (WARP x warp_steps).  A ragged last warp
    counts its missing lanes idle."""
    lanes: list = []
    forward_work(tables, v, eye, nl=nl, depth=depth, small=small,
                 atten=atten, checker_mats=checker_mats,
                 want_trans=want_trans, bf16=bf16, lanes=lanes)
    P = v.shape[0]
    pad = -P % WARP

    def per_warp(t):
        return torch.nn.functional.pad(t, (0, pad)).reshape(-1, WARP)
    out = {}
    for sweep in ("closest", "shadow"):
        tests = steps = 0
        for rec in lanes:
            for t in (rec[sweep] if sweep == "shadow" else [rec[sweep]]):
                tests += int(t.sum())
                steps += int(per_warp(t).max(1).values.sum())
        out[sweep] = dict(tests=tests, warp_steps=steps,
                          efficiency=tests / (WARP * steps) if steps else 1.0)
    return out


def _chain_adjoint_ops(bi, lit, g_live, *, nt: int, depth: int,
                       want_trans: bool) -> Tuple[Dict[str, int],
                                                  torch.Tensor]:
    """The units of adjoint_ops.cuh::chain_adjoint over the pixels with a
    nonzero cotangent (``g_live``), from the residual planes ``bi``
    [depth+1, P] and ``lit`` [nl, depth+1, P]: the primal and reverse
    sweeps of each hit level before the first miss, with their lit lights,
    and one add per gradient term.  Also returns ``lead``, the [depth+1, P]
    mask of those levels."""
    hit = bi >= 0.0
    lead = torch.cumprod(hit.int(), 0).bool() & g_live[None, :]
    is_tri = bi < nt
    level = torch.arange(depth + 1, device=bi.device)[:, None]
    # the primal pass visits every hit level but the last; the reverse all
    fwd = lead & (level < lead.sum(0)[None, :] - 1)
    lits = (lit > 0.5) & lead[None]      # [nl, D+1, P]
    n_tri = int((lead & is_tri).sum()) + int((fwd & is_tri).sum())
    n_sph = int((lead & ~is_tri).sum()) + int((fwd & ~is_tri).sum())
    n_hit = int(lead.sum())
    # levels with a child (lv < depth) take the Snell record and reverse
    n_snell = (int(fwd.sum()) + int(lead[:depth].sum())) if want_trans else 0
    n_snell_rev = int(lead[:depth].sum()) if want_trans else 0
    units = _add({}, PRIMAL=n_tri + n_sph, PRIMAL_TRI=n_tri,
                 PRIMAL_SPH=n_sph, PRIMAL_SNELL=n_snell,
                 REV_SNELL=n_snell_rev, REV_LIGHT=int(lits.sum()),
                 REV_TAIL=n_hit, REV_TRI=int((lead & is_tri).sum()),
                 REV_SPH=int((lead & ~is_tri).sum()), SCATTER=n_hit)
    return units, lead


def _tree_adjoint_ops(bi, lit, g_live, *, nt: int, depth: int,
                      want_trans: bool) -> Tuple[Dict[str, int], int]:
    """The units of adjoint_ops.cuh::tree_adjoint over the pixels with
    a nonzero cotangent, from the residual planes ``bi`` [K, P] and ``lit``
    [nl, K, P] of the K preorder nodes (a node that hits was reached: a
    child whose gate is 0 or whose parent missed holds bi = -1).  Per hit
    node: one primal and one reverse sweep with its lit lights (the Snell
    record and its reverse where it has children), one more primal and a
    weight per child it visits, one add per gradient term.  Also returns
    the number of hit nodes."""
    levels = []

    def walk(level):
        levels.append(level)
        if level < depth:
            walk(level + 1)
            walk(level + 1)
    walk(0)
    hit = (bi >= 0.0) & g_live[None, :]
    is_tri = bi < nt
    units: Dict[str, int] = {}
    n_hit = 0
    for k, level in enumerate(levels):
        h = hit[k]
        n, n_t = int(h.sum()), int((h & is_tri[k]).sum())
        n_hit += n
        n_lit = int(((lit[:, k] > 0.5) & h[None]).sum())
        snell = n if want_trans and level < depth else 0
        _add(units, PRIMAL=n, REV_TAIL=n, SCATTER=n, PRIMAL_TRI=n_t,
             REV_TRI=n_t, PRIMAL_SPH=n - n_t, REV_SPH=n - n_t,
             REV_LIGHT=n_lit, PRIMAL_SNELL=snell, REV_SNELL=snell)
        if level < depth:
            # the children it visits: k+1 (transmitted), k+2^(depth-level)
            for c in (k + 1, k + 2 ** (depth - level)):
                v = h & hit[c]
                n_c, n_ct = int(v.sum()), int((v & is_tri[k]).sum())
                _add(units, PRIMAL=n_c, TREE_CHILD=n_c,
                     PRIMAL_SNELL=n_c if want_trans else 0,
                     PRIMAL_TRI=n_ct, PRIMAL_SPH=n_c - n_ct)
    return units, n_hit


def adjoint_work(tables, img, target, mask, pk, *, pack, nl: int,
                 depth: int, want_trans: bool) -> Dict[str, float]:
    """FP32 operations and bytes of one csrc/adjoint_packed.cu call on these
    inputs: the prologue for every pixel; for the pixels with a nonzero
    cotangent, the chain adjoint (``_chain_adjoint_ops``).  Bytes: img,
    target and mask of every pixel; for the pixels with a nonzero
    cotangent, the residual levels up to the first miss (or all depth+1)
    and, where level 0 hits, the ray; the gradient tables once.  The
    kernel's column reduction is not counted: it is overhead of this
    design, not work the function needs."""
    P = img.shape[0]
    nt = tables["tri"].shape[0]
    g_live = ((img - target) * mask[:, None] != 0.0).any(-1)
    res = unpack_residuals(pk, nl, pack)
    units, lead = _chain_adjoint_ops(res["bi"], res["lit"], g_live, nt=nt,
                                     depth=depth, want_trans=want_trans)
    flops, classes = _price(_add(units, PROLOGUE=P))
    n_lead = lead.sum(0)
    pk_levels = int(torch.clamp(n_lead + 1, max=depth + 1)[g_live].sum())
    nbytes = (P * (12 + 12 + 4) + 4 * pk_levels
              + 12 * int((n_lead > 0).sum()) + 4 * _ncols(tables, nl))
    return dict(hit_levels=int(lead.sum()), live_pixels=int(g_live.sum()),
                ops=flops, classes=classes, bytes=float(nbytes))


def _ncols(tables, nl: int) -> int:
    """Gradient columns: the loss, 4 per sphere, 9 per material, 3 per
    light."""
    return 1 + 4 * tables["sph"].shape[0] + 9 * tables["mat"].shape[0] \
        + 3 * nl


def fused_work(tables, v, eye, *, tree: bool, target=None, mask=None,
               g=None, **kw) -> Dict[str, float]:
    """FP32 operations and bytes of one csrc/adjoint_fused.cu call on these
    inputs: K6 (``target`` and ``mask`` given) or K7 (the cotangent ``g``
    given), on the chain or the tree (``tree``).  K6: the forward of every
    pixel (``forward_work``), the prologue, and the adjoint of the pixels
    whose cotangent is nonzero; it reads ray, target and mask and writes
    no image.  K7: the forward and the adjoint of the pixels whose ``g`` is
    nonzero only; it reads every pixel's ``g`` and their rays.  Both write
    the gradient tables once; the column reduction is not counted.  The
    keyword arguments are ``render_kwargs``'s."""
    P = v.shape[0]
    nt = tables["tri"].shape[0]
    nl, depth, want_trans = kw["nl"], kw["depth"], kw["want_trans"]
    live = (g != 0.0).any(-1) if g is not None else None
    vf = v if g is None else v[live]
    fwd = forward_work(tables, vf, eye, tree=tree, **kw)
    img, res = render_residuals_ref(tables, vf, eye, tree=tree, **kw)
    units = dict(fwd["units"])
    if g is None:
        live = ((img - target) * mask[:, None] != 0.0).any(-1)
        g_live = live
        _add(units, PROLOGUE=P)
        nbytes = P * (12 + 12 + 4)
    else:
        g_live = torch.ones(vf.shape[0], dtype=torch.bool, device=v.device)
        nbytes = P * 12 + 12 * vf.shape[0]
    count = _tree_adjoint_ops if tree else _chain_adjoint_ops
    adj, hits = count(res["bi"], res["lit"], g_live, nt=nt, depth=depth,
                      want_trans=want_trans)
    if not tree:
        hits = int(hits.sum())
    flops, classes = _price(_add(units, **adj))
    return dict(fwd, ops=flops, classes=classes, classes_fwd=fwd["classes"],
                units=units, bytes=float(nbytes + 4 * _ncols(tables, nl)),
                live_pixels=int(g_live.sum()), adjoint_nodes=hits)


def fit_grads_work(tables, g, res, *, nl: int, depth: int,
                   want_trans: bool) -> Dict[str, float]:
    """FP32 operations and bytes of one csrc/fit_grads.cu call (K8) on
    these inputs: the chain adjoint of the pixels whose cotangent ``g``
    [P,3] is nonzero (``_chain_adjoint_ops``) on the residual planes
    ``res`` (bi, mid [depth+1, P], lit [nl, depth+1, P]).  Bytes: every
    pixel's ``g``; for the pixels with a nonzero one, ``bi`` of each level
    up to the first miss (or all depth+1), ``mid`` and the lit flags of the
    levels that hit, and, where level 0 hits, the ray; the gradient tables
    once.  The column reduction is not counted, as in ``adjoint_work``."""
    P = g.shape[0]
    nt = tables["tri"].shape[0]
    g_live = (g != 0.0).any(-1)
    units, lead = _chain_adjoint_ops(res["bi"], res["lit"], g_live, nt=nt,
                                     depth=depth, want_trans=want_trans)
    flops, classes = _price(units)
    n_lead = lead.sum(0)
    bi_levels = int(torch.clamp(n_lead + 1, max=depth + 1)[g_live].sum())
    nbytes = (12 * P + 4 * bi_levels + 4 * (1 + nl) * int(lead.sum())
              + 12 * int((n_lead > 0).sum()) + 4 * _ncols(tables, nl))
    return dict(hit_levels=int(lead.sum()), live_pixels=int(g_live.sum()),
                ops=flops, classes=classes, bytes=float(nbytes))


def step_work(scene, camera, config, target=None, *, mode: str = "twophase",
              device=None) -> Dict[str, object]:
    """What one bench step runs on these inputs: the forward render
    (``target`` None) or the fwd+bwd of ``fit_value_and_grad`` in ``mode``
    (``"twophase"`` K3 + K4, ``"fused"`` K6, ``"split"`` the residual K2 +
    K8; a fractional-transparency scene takes K6's tree, as the fit does).
    ``scene`` is the scene the step renders (``params.into_scene``).
    Returns ``fwd`` and ``bwd``, the forward's and the backward's
    operations by class; ``kernels``, the kernels it launches; and
    ``launch``, a zero-arg callable that launches those kernels once on
    the same inputs (for their device time)."""
    from ..kernels import adjoint_fused as AF
    from ..kernels import render as K
    from ..ops.rays import primary_rays, screen_points
    dev = K.resolve_device(device)
    P = config.width * config.height
    if target is None:
        cam = camera.to(dev)
        _, v = primary_rays(cam, screen_points(cam, config.width,
                                               config.height))
        v, eye = v.contiguous(), cam.eye.tolist()
    else:
        prep = AF.prepare_fit_inputs(camera, config, target, device=dev)
        v, eye = prep["v"], prep["eye"]
    scene_c, t, kw, akw = AF.kernel_inputs(scene, config, P, device=dev)
    tree = not scene_c.chain_exact
    if target is None:
        w = forward_work(t, v, eye, tree=tree, **kw)
        render = K.render_tree if tree else K.render_chain
        return dict(fwd=w["classes"], bwd={},
                    kernels=["render_tree" if tree else "render_chain"],
                    launch=lambda: render(t, v, eye, **kw))
    tgt, mask = prep["target"], prep["mask"]
    if tree:
        mode = "fused"
    if mode == "twophase":
        img, pk = K.render_packed(t, v, eye, pack=akw["pack"], **kw)
        w3 = forward_work(t, v, eye, packed=True, **kw)
        w4 = adjoint_work(t, img, tgt, mask, pk, pack=akw["pack"],
                          nl=akw["nl"], depth=akw["depth"],
                          want_trans=akw["want_trans"])

        def launch():
            i, p = K.render_packed(t, v, eye, pack=akw["pack"], **kw)
            return AF.adjoint_packed(t, v, eye, i, tgt, mask, p, **akw)
        return dict(fwd=w3["classes"], bwd=w4["classes"],
                    kernels=["render_packed", "adjoint_packed"],
                    launch=launch)
    if mode == "fused":
        w6 = fused_work(t, v, eye, tree=tree, target=tgt, mask=mask, **kw)
        bwd = {k: c - w6["classes_fwd"].get(k, 0.0)
               for k, c in w6["classes"].items()}
        return dict(fwd=w6["classes_fwd"], bwd=bwd,
                    kernels=["fused_adjoint"],
                    launch=lambda: AF.fused_adjoint(
                        t, v, eye, tgt, mask, tree=tree,
                        g_scale=akw["g_scale"], **kw))
    if mode != "split":
        raise ValueError(f"unknown fit mode {mode!r}")
    fkw = {k: akw[k] for k in ("nl", "depth", "atten", "want_trans")}

    def split_inputs():
        img, res = K.render_residuals(t, v, eye, tree=False, **kw)
        return (akw["g_scale"] * (img - tgt)).contiguous(), res
    g, res = split_inputs()
    wf = forward_work(t, v, eye, residuals=True, **kw)
    w8 = fit_grads_work(t, g, res, nl=akw["nl"], depth=akw["depth"],
                        want_trans=akw["want_trans"])
    return dict(fwd=wf["classes"], bwd=w8["classes"],
                kernels=["render_chain_residuals", "fit_grads"],
                launch=lambda: AF.fit_grads(t, v, eye, *split_inputs(),
                                            **fkw))


def tree_lane_efficiency(tables, v, eye, *, nl: int, depth: int,
                         small: float, atten: float, checker_mats,
                         want_trans: bool, bf16: bool = False) -> dict:
    """How full the lanes of the tree kernel's warps are (one pixel a lane,
    tile_ops.cuh::tree_forward, whose loop traces one node of the lane's
    stack a trip), from the plain version's residual planes on these
    inputs: ``nodes`` (nodes traced over all lanes: the root, and each
    child whose parent hits and whose gate, the parent material's
    take_trans or refl_ok, is set), ``warp_trips`` (the sum over warps of
    the most nodes one lane of the warp traces) and ``efficiency``, nodes /
    (WARP x warp_trips).  A ragged last warp counts its missing lanes
    idle."""
    _, res = render_residuals_ref(tables, v, eye, tree=True, nl=nl,
                                  depth=depth, small=small, atten=atten,
                                  checker_mats=checker_mats,
                                  want_trans=want_trans, bf16=bf16)
    bi, mid = res["bi"], res["mid"].long()
    mat = tables["mat"]
    traced = torch.ones_like(bi[0], dtype=torch.int64)

    def visit(idx: int, level: int):
        nonlocal traced
        if level == depth:
            return
        hit = bi[idx] >= 0
        for col, child in ((13, idx + 1), (14, idx + (1 << (depth - level)))):
            gate = mat[mid[idx], col] != 0.0
            traced = traced + (hit & gate).long()
            visit(child, level + 1)
    visit(0, 0)
    pad = -traced.shape[0] % WARP
    per_warp = torch.nn.functional.pad(traced, (0, pad)).reshape(-1, WARP)
    nodes = int(traced.sum())
    trips = int(per_warp.max(1).values.sum())
    return dict(nodes=nodes, warp_trips=trips,
                efficiency=nodes / (WARP * trips) if trips else 1.0)
