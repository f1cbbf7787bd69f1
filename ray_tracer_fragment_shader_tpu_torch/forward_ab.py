"""The chain forward on the card beside another checkout's: K2, K3 and
residual K2 (f32 and bf16), and K5, K6 and K7, timed in one process and
compared bit for bit; the chain kernel's SASS census, ptxas resources and
occupancy; its warps' lane efficiency; and the tree kernel K5's resources
and lane efficiency (``tree_rows``).

    python -m ray_tracer_fragment_shader_tpu_torch.forward_ab \
        [--other DIR] [--out FILE] [--sass-dir DIR] [--cpu] [--size N]
        [--only LABEL]

Forward inputs (one sample, the camera's centre rays): config 3
(full_reflective 1024^2 d3) and config 5 (procedural_spheres n=64 2048^2
d3), where each form is timed; glass_chain 1024^2 d3 (the nearest-occluder
path), pack_overflow 512^2 d1 as a chain scene (15 lights: K2 and residual
K2, K3 refuses it) and reference_demo 500^2 d5, one sample; and the tree
forward K5 on fractional_glass 1024^2 d3.  The adjoints on
``adjoint_ab.py``'s inputs under the real cotangent: K6 at config 3,
config 5 2048^2 and on fractional_glass 1024^2 d3, K7 at reference_demo
500^2 d5 (one sample) and fractional_glass 512^2 d3.  Every row in f32
and bf16.

With ``--other DIR`` (a checkout holding the port package, e.g. the
parent commit unpacked with ``git archive`` into a gitignored directory)
that package is imported beside this one (``adjoint_ab.load_other``) and
built from its own sources; each kernel is timed other, this, this,
other (CUDA events over 20 launches behind a device sleep,
``utils/timing.py::time_ms``), and every output of the two (image,
packed plane, residual planes, loss and gradient tables) is compared bit
for bit.

The census (``chain_census``) reads each package's library with
``cuobjdump -sass``: for each innermost loop of the chain kernel's
instantiations, its instructions by class (FP32, bf16, MUFU, LDS, other
memory, integer and predicate, conversion, warp, branch) and the triangle
and sphere tests it holds (its MUFU.RCP and MUFU.RSQ), so instructions a
test; and ptxas's registers, stack frame and spills, and the blocks an SM
holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, where the
package's library has the entry).  The raw SASS of the chain kernel goes
to ``--sass-dir``.  ``lane_efficiency`` (utils/opcount.py: how full
the warps' lanes are in the sweeps, counted from the plain version) runs
at config 3 and config 5 2048^2.

Prints the card's name and power limit first and one JSON line last (the
whole record goes to ``--out``).  Needs one CUDA GPU, but with ``--cpu``,
which compares the two packages' plain versions on the CPU (``--size``
sets every frame's side), with no times and no census.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import time

import torch

from . import adjoint_ab
from .utils.timing import time_ms

OUT = os.path.join("chiprun_out", "forward_ab_h100.json")
SASS_DIR = os.path.join("chiprun_out", "forward_ab_sass")
REPS = 20
#: the instantiations (want_trans, form: 0 image, 1 packed, 2 residuals;
#: bf16) whose census is printed: the all-opaque image in f32 and bf16,
#: K3, and the transmitting image
CENSUS_KEYS = ("0,0,0", "0,0,1", "0,1,0", "1,0,0")
#: FP32 instructions a primitive test issues at least (a triangle test
#: about 50, a sphere test about 25): fewer, and a trip skipped the test
#: (its gates' branch in the parent design) or is no test at all
#: (load_scene's reciprocals of the triangle denominators)
MIN_TEST_FP32 = 20
#: SASS opcode classes of the census, by the opcode's leading letters
#: (first match wins)
OP_CLASSES = (
    ("mufu", ("MUFU",)),
    ("lds", ("LDS",)),
    ("other_mem", ("LDG", "STG", "LDL", "STL", "LD", "ST", "LDC", "ULDC",
                   "ATOM", "RED", "STS", "LDSM")),
    ("convert", ("F2F", "F2I", "I2F", "F2FP", "I2FP", "FRND")),
    ("bf16", ("HADD2", "HMUL2", "HFMA2", "HSETP2", "HMNMX2", "HSET2")),
    ("fp32", ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET",
              "FCHK", "FSWZADD")),
    ("warp", ("VOTE", "SHFL", "MATCH", "REDUX", "WARPSYNC", "BAR")),
    ("branch", ("BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
                "BREAK", "BMOV", "YIELD", "KILL", "NOP")),
    ("int_pred", ("IADD", "IMAD", "ISETP", "LOP", "PLOP", "SEL", "SHF",
                  "LEA", "MOV", "P2R", "R2P", "IABS", "PRMT", "POPC", "FLO",
                  "BREV", "IMNMX", "S2R", "CS2R", "S2UR", "UIADD", "UMOV",
                  "ULOP", "USEL", "UISETP", "ULEA", "USHF", "UPRMT", "IDP",
                  "VIADD", "VIMNMX", "R2UR", "UIMAD", "ISCADD", "SGXT",
                  "BMSK")),
)


# ------------------------------------------------------------------ inputs

def forward_input(M, preset, dev, bf16: bool) -> dict:
    """One sample of ``preset`` through package ``M``'s host code: the
    tables, rays ``v``, ``eye``, render keywords ``kw``, ``pack`` (None
    where the scene overflows it) and ``tree``."""
    scene, cam, cfg = preset
    cfg = dataclasses.replace(cfg, bf16_shading=bf16, samples=1,
                              adaptive=False)
    camera = M.rays.Camera.from_config(cam, cfg.width, cfg.height,
                                       device=dev)
    scene_c, tables, kw = M.AF.scene_tables(scene, cfg, dev)
    _, v = M.rays.primary_rays(camera, M.rays.screen_points(
        camera, cfg.width, cfg.height))
    try:
        pack = M.K.pack_widths(tables["tri"].shape[0], scene_c.num_spheres,
                               scene_c.num_materials, scene_c.num_lights)
    except ValueError:
        pack = None
    return dict(tables=tables, v=v.contiguous(), eye=camera.eye.tolist(),
                kw=kw, pack=pack, tree=not scene_c.chain_exact)


def forward_calls(x) -> dict:
    """{wrapper key: (wrapper name, args, keywords)} of the forwards that
    take ``x``: the chain forms (K3 where the pack holds the scene), or the
    tree's."""
    a, kw = (x["tables"], x["v"], x["eye"]), x["kw"]
    if x["tree"]:
        return {"render_tree": ("render_tree", a, kw),
                "render_tree_residuals": ("render_residuals", a,
                                          dict(kw, tree=True))}
    out = {"render_chain": ("render_chain", a, kw),
           "render_chain_residuals": ("render_residuals", a,
                                      dict(kw, tree=False))}
    if x["pack"] is not None:
        out["render_packed"] = ("render_packed", a, dict(kw, pack=x["pack"]))
    return out


def flat_outputs(out) -> list:
    """A wrapper's result as a list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [t for o in out for t in flat_outputs(o)]


def run_forward(M, call):
    name, args, kw = call
    return getattr(M.K, name)(*args, **kw)


# ------------------------------------------------------------------ census

def _op_class(op: str) -> str:
    for cls, prefixes in OP_CLASSES:
        if any(op.startswith(p) for p in prefixes):
            return cls
    return "other"


def parse_sass(text: str, kernel: str) -> dict:
    """{mangled name: [(address, opcode, text)]} of the functions of
    ``cuobjdump -sass`` output whose name holds ``kernel``; labels
    (``.L_x_N:``) become ``("label", name)`` entries."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur is not None:
                funcs[cur] = []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            funcs[cur].append(("label", m.group(1), line))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            funcs[cur].append((int(m.group(1), 16), m.group(2), line))
    return funcs


def innermost_loops(ins: list) -> list:
    """The innermost loops of one function's instructions: [(start, end)]
    address ranges closed by a backward branch that hold no other loop."""
    labels, pending = {}, []
    for e in ins:
        if e[0] == "label":
            pending.append(e[1])
        else:
            for lb in pending:
                labels[lb] = e[0]
            pending = []
    loops = []
    for addr, op, line in (e for e in ins if e[0] != "label"):
        if not op.startswith(("BRA", "JMP")):
            continue
        m = re.search(r"`\((\.L_x_\d+)\)", line)
        if m:
            target = labels.get(m.group(1))
        else:
            m = re.search(rf"{op}\s+(0x[0-9a-f]+)", line)
            target = int(m.group(1), 16) if m else None
        if target is not None and target <= addr:
            loops.append((target, addr))
    return [lp for lp in loops
            if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                       for o in loops)]


def _target(line: str, op: str, labels: dict):
    """A branch's target address, or None."""
    m = re.search(r"`\((\.L_x_\d+)\)", line)
    if m:
        return labels.get(m.group(1))
    m = re.search(rf"{re.escape(op)}\s+(?:!?U?P\d,\s*)?(0x[0-9a-f]+)", line)
    return int(m.group(1), 16) if m else None


def fast_trip(body: list, labels: dict, *, rcp: int = 0, rsq: int = 0,
              forbid: str = "", min_fp32: int = 0):
    """The fewest instructions one trip through an innermost loop's
    ``body`` issues that runs at least ``rcp`` MUFU.RCP and ``rsq``
    MUFU.RSQ, none of the opcode ``forbid`` and at least ``min_fp32`` FP32
    instructions, never calling a slow path: a walk from the loop's head to
    its back edge along its forward branches (a predicated branch may fall
    through).  Returns its opcodes, or None where no such trip exists."""
    addr = [e[0] for e in body]
    index = {a: i for i, a in enumerate(addr)}
    n = len(body)
    INF = float("inf")

    def step(state, op):
        a, b, f = state
        return (min(rcp, a + op.startswith("MUFU.RCP")),
                min(rsq, b + op.startswith("MUFU.RSQ")),
                min(min_fp32, f + (_op_class(op) == "fp32")))
    done = (rcp, rsq, min_fp32)
    best: dict = {}   # (i, state) -> (instructions to the back edge, next)

    def walk(i, state):
        key = (i, state)
        if key in best:
            return best[key][0]
        best[key] = (INF, None)
        a, op, line = body[i]
        if (op.startswith(("CALL", "EXIT"))
                or (forbid and op.startswith(forbid))):
            return INF
        now = step(state, op)
        cands = []
        if op.startswith(("BRA", "JMP")):
            t = _target(line, op, labels)
            if t is not None and t <= a:
                if t == addr[0] and now == done:
                    cands.append((1, None))   # the back edge: one trip
            elif t in index:
                cands.append((1 + walk(index[t], now), (index[t], now)))
            if "@" in line.split(op)[0] and i + 1 < n:
                cands.append((1 + walk(i + 1, now), (i + 1, now)))
        elif i + 1 < n:
            cands.append((1 + walk(i + 1, now), (i + 1, now)))
        if cands:
            best[key] = min(cands, key=lambda c: c[0])
        return best[key][0]

    import sys
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 20 * n + 1000))
    try:
        if walk(0, (0, 0, 0)) == INF:
            return None
    finally:
        sys.setrecursionlimit(limit)
    ops, node = [], (0, (0, 0, 0))
    while node is not None:
        ops.append(body[node[0]][1])
        node = best[node][1]
    return ops


def loop_census(ins: list) -> list:
    """Each innermost loop's instructions by class and, for a primitive
    test loop, the instructions a test issues on its fast trips
    (``fast_trip``): a triangle loop holds a MUFU.RCP (its 1/ndv) a test,
    a sphere loop a MUFU.RSQ (sqrtf's) a test, which only a hit runs.
    ``per_test`` holds "triangle", or "sphere hit" (every test of the trip
    hits) and "sphere miss" (none does; at least MIN_TEST_FP32 FP32
    instructions a test, so the trip runs the tests rather than their
    gates' skip), each with its classes and ``all``, over the tests a trip
    holds (``tests``, several where the compiler unrolled the loop)."""
    labels, pending = {}, []
    for e in ins:
        if e[0] == "label":
            pending.append(e[1])
        else:
            for lb in pending:
                labels[lb] = e[0]
            pending = []
    rows = []
    for start, end in sorted(innermost_loops(ins)):
        body = [e for e in ins if e[0] != "label" and start <= e[0] <= end]
        classes: dict = {}
        for _, op, _ in body:
            c = _op_class(op)
            classes[c] = classes.get(c, 0) + 1
        row = dict(start=hex(start), end=hex(end), instructions=len(body),
                   classes=classes, per_test={})
        n_rcp = sum(op.startswith("MUFU.RCP") for _, op, _ in body)
        n_rsq = sum(op.startswith("MUFU.RSQ") for _, op, _ in body)
        trips = {}
        if n_rcp and not n_rsq:
            trips["triangle"] = (n_rcp, fast_trip(
                body, labels, rcp=n_rcp, min_fp32=MIN_TEST_FP32 * n_rcp))
        elif n_rsq and not n_rcp:
            trips["sphere hit"] = (n_rsq, fast_trip(
                body, labels, rsq=n_rsq, min_fp32=MIN_TEST_FP32 * n_rsq))
            trips["sphere miss"] = (n_rsq, fast_trip(
                body, labels, forbid="MUFU.RSQ",
                min_fp32=MIN_TEST_FP32 * n_rsq))
        for kind, (tests, path) in trips.items():
            if path is None:
                continue
            per: dict = {}
            for op in path:
                c = _op_class(op)
                per[c] = per.get(c, 0) + 1 / tests
            per["all"] = len(path) / tests
            per["tests"] = tests
            row["per_test"][kind] = per
        rows.append(row)
    return rows


def template_args(mangled: str) -> tuple:
    """The integer template arguments of a kernel's mangled name (bools,
    ints and enum values, in order)."""
    return tuple(int(a) for a in re.findall(
        r"L(?:b|i|NS_\d+[A-Za-z]+E)(-?\d+)E", mangled))


def ptxas_kernels(log: str, kernel: str) -> dict:
    """{template arguments: dict(registers, stack, spill_stores,
    spill_loads)} of each instantiation of ``kernel`` in a ptxas -v log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = (template_args(m.group(1))
                   if re.search(rf"\d{kernel}I", m.group(1)) else None)
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            cur = None
    return out


def ptxas_chain(log: str) -> dict:
    """{instantiation: dict(registers, stack, spill_stores, spill_loads)}
    of the chain kernel in a ptxas -v log."""
    return {",".join(map(str, k)): v
            for k, v in ptxas_kernels(log, "render_chain_kernel").items()}


def inst_key(mangled: str) -> str:
    """``want_trans,form,bf16`` of a chain kernel instantiation."""
    return ",".join(map(str, template_args(mangled)))


def occupancy(M, entry: str, *args) -> object:
    """Blocks of 256 a SM from package ``M``'s C entry ``rtfs_<entry>``
    (``*args`` then an int out), or "not available" where it has none."""
    lib = M.cuda_build.load()
    fn = getattr(lib, f"rtfs_{entry}", None)
    if fn is None:
        return "not available"
    n = ctypes.c_int(0)
    M.cuda_build.check(lib, fn(*args, ctypes.byref(n)), entry)
    return n.value


def print_resources(label: str, kernels: list, M, card: str) -> list:
    """Prints and returns, for each (name, template arguments, blocks a
    SM) of ``kernels``, ptxas's registers, stack frame and spills of that
    instantiation in package ``M``'s build log."""
    log = M.cuda_build.build_info.get("log", "")
    rows = []
    for name, args, blocks in kernels:
        res = ptxas_kernels(log, name).get(tuple(args), {})
        rows.append(dict(kernel=name, args=list(args), blocks_per_sm=blocks,
                         **res))
        print(f"resources {label} {name}<{','.join(map(str, args))}>: "
              f"{res.get('registers')} registers, stack {res.get('stack')} "
              f"B, spills {res.get('spill_stores')}/{res.get('spill_loads')}"
              f" B; {blocks} blocks of 256 a SM [{card}]")
    return rows


def chain_census(M, sass_dir=None, tag="this") -> dict:
    """The chain kernel's census in package ``M``'s library (see the module
    docstring); the raw SASS of each instantiation into ``sass_dir``."""
    from torch.utils.cpp_extension import CUDA_HOME
    lib_path = M.cuda_build.build_info.get("path") or \
        M.cuda_build.library_path()
    res = subprocess.run([os.path.join(CUDA_HOME or "", "bin", "cuobjdump"),
                          "-sass", lib_path], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr[:2000]}")
    funcs = parse_sass(res.stdout, "render_chain_kernel")
    out = dict(loops={}, ptxas=ptxas_chain(
        M.cuda_build.build_info.get("log", "")), occupancy={})
    for name, ins in funcs.items():
        key = inst_key(name)
        out["loops"][key] = loop_census(ins)
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, f"{tag}_{key.replace(',', '_')}"
                                   ".sass"), "w") as f:
                f.write("\n".join(e[2] for e in ins) + "\n")
    for key in out["loops"]:
        out["occupancy"][key] = occupancy(
            M, "chain_occupancy", *(int(a) for a in key.split(",")), 4096)
    return out


def print_census(label: str, c: dict, card: str) -> None:
    """The census of CENSUS_KEYS' instantiations: ptxas's resources, the
    blocks a SM holds and each test loop's instructions a test."""
    for key in CENSUS_KEYS:
        if key not in c["loops"]:
            continue
        res = c["ptxas"].get(key, {})
        print(f"census {label} render_chain_kernel<{key}>: ptxas {res}; "
              f"blocks/SM at 4 KB tables "
              f"{c['occupancy'].get(key, 'not available')} [{card}]")
        for row in c["loops"][key]:
            for kind, pt in row["per_test"].items():
                print(f"  loop {row['start']}-{row['end']} "
                      f"({row['instructions']} instructions), {kind} "
                      f"test: {pt['all']:.1f} instructions a test on its "
                      f"fast trip ({pt['tests']} a trip): "
                      + " ".join(f"{k} {v:.1f}" for k, v in sorted(pt.items())
                                 if k not in ("all", "tests")))


# ------------------------------------------------------------- lane counts

def lane_rows(M, dev, card: str) -> list:
    """``opcount.lane_efficiency`` (from the plain version) at config 3 and
    config 5 2048^2."""
    from .utils import opcount
    P = M.presets
    rows = []
    for label, preset in (
            ("config 3 1024^2 d3", P.full_reflective(size=1024, depth=3)),
            ("config 5 2048^2 d3", P.procedural_spheres(n=64, size=2048,
                                                        depth=3))):
        x = forward_input(M, preset, dev, False)
        kw = {k: v for k, v in x["kw"].items() if k != "bf16"}
        eff = opcount.lane_efficiency(x["tables"], x["v"], x["eye"], **kw)
        rows.append(dict(input=label, **eff))
        print(f"lanes {label}: closest-hit {eff['closest']['efficiency']:.4f}"
              f" ({eff['closest']['tests']} tests, "
              f"{eff['closest']['warp_steps']} warp steps), shadow "
              f"{eff['shadow']['efficiency']:.4f} ({eff['shadow']['tests']}"
              f" tests, {eff['shadow']['warp_steps']} warp steps) [{card}]")
    return rows


def tree_rows(this, other, dev, card: str) -> list:
    """K5 on fractional_glass 1024^2 d3 (f32 and bf16): each package's
    registers, stack, spills and blocks a SM of the tree kernel's image
    form, and the tree lanes (``opcount.tree_lane_efficiency``, from the
    plain version: nodes traced over 32 x the warps' loop trips)."""
    from .utils import opcount
    preset = this.presets.fractional_glass(size=1024, depth=3)
    rows = []
    for bf16 in (False, True):
        x = forward_input(this, preset, dev, bf16)
        smem = 4 * this.K._flat_tables(x["tables"], x["kw"]["nl"]).numel()
        args = (int(x["kw"]["want_trans"]), 0, int(bf16))
        for tag, Mod in (("this", this), ("other", other)):
            if Mod is not None:
                rows += [dict(r, package=tag, bf16=bf16)
                         for r in print_resources(
                             f"K5 fractional_glass 1024^2 d3 ({tag})",
                             [("render_tree_kernel", args,
                               occupancy(Mod, "tree_occupancy", *args,
                                         smem))], Mod, card)]
        if not bf16:
            kw = {k: v for k, v in x["kw"].items() if k != "bf16"}
            eff = opcount.tree_lane_efficiency(x["tables"], x["v"], x["eye"],
                                               **kw)
            rows.append(dict(input="fractional_glass 1024^2 d3", **eff))
            print(f"tree lanes fractional_glass 1024^2 d3: {eff['nodes']} "
                  f"nodes traced in {eff['warp_trips']} warp loop trips, "
                  f"lane efficiency {eff['efficiency']:.4f} [{card}]")
        del x
    return rows


# ------------------------------------------------------------------- main

def _sized(preset, size):
    """``preset`` with its frame ``size``^2 where ``size`` is given."""
    if size is None:
        return preset
    scene, cam, cfg = preset
    return scene, cam, dataclasses.replace(cfg, width=size, height=size)


def cases(P, size=None) -> list:
    """(label, preset) of the forward inputs, at ``size``^2 if given."""
    demo = P.reference_demo()
    return [(label, _sized(preset, size)) for label, preset in (
        ("config 3 1024^2 d3", P.full_reflective(size=1024, depth=3)),
        ("config 5 2048^2 d3", P.procedural_spheres(n=64, size=2048,
                                                    depth=3)),
        ("glass_chain 1024^2 d3", P.glass_chain(size=1024, depth=3)),
        ("pack_overflow 512^2 d1 (chain)", P.pack_overflow(
            size=512, fractional=False)),
        ("reference_demo 500^2 d5, one sample", demo),
        ("fractional_glass 1024^2 d3", P.fractional_glass(size=1024,
                                                          depth=3)))]


def adjoint_cases(P, size=None) -> list:
    """(label, preset, kernel) of the adjoint rows, at ``size``^2 if
    given."""
    demo, demo_cam, demo_cfg = P.reference_demo()
    return [(label, _sized(preset, size), kernel)
            for label, preset, kernel in (
        ("config 3 1024^2 d3", P.full_reflective(size=1024, depth=3),
         "fused_adjoint"),
        ("config 5 2048^2 d3", P.procedural_spheres(n=64, size=2048,
                                                    depth=3),
         "fused_adjoint"),
        ("fractional_glass 1024^2 d3", P.fractional_glass(size=1024,
                                                          depth=3),
         "fused_adjoint"),
        ("reference_demo 500^2 d5, one sample",
         (demo, demo_cam, dataclasses.replace(demo_cfg, samples=1)),
         "recompute_adjoint"),
        ("fractional_glass 512^2 d3", P.fractional_glass(size=512, depth=3),
         "recompute_adjoint"))]


def _row(kernel, label, bf16, fn_of, this, other, card, timed):
    """One row: ``fn_of(M)`` returns a zero-argument launch through package
    ``M`` that returns its outputs; timed alternated with ``timed``, and
    the outputs of the two packages compared bit for bit."""
    row = dict(kernel=kernel, input=label, bf16=bf16)
    txt = f"{kernel:22s} {label:36s} {'bf16' if bf16 else 'f32 '}:"
    if timed:
        row.update(adjoint_ab._alternated(
            lambda Mod: time_ms(fn_of(Mod), REPS), this, other))
        ms = sum(row["ms"]) / len(row["ms"])
        txt += f" {ms:.4f} ms"
        if other is not None:
            o = sum(row["other_ms"]) / 2
            txt += f"; other {o:.4f} ms (this/other {ms / o:.3f})"
    if other is not None:
        a, b = flat_outputs(fn_of(this)()), flat_outputs(fn_of(other)())
        row["equal_to_other"] = len(a) == len(b) and all(
            torch.equal(p, q) for p, q in zip(a, b))
        txt += f"; bit-equal {row['equal_to_other']}"
    print(txt + f" [{card}]")
    return row


def compare_rows(this, other, dev, card, *, size=None, timed=True,
                 only=None) -> list:
    """Every forward and adjoint row (see the module docstring) on
    ``dev``, at ``size``^2 if given, or those whose input's label holds
    ``only``; on the CPU the plain versions run, untimed."""
    rows = []
    for label, preset in cases(this.presets, size):
        if only and only not in label:
            continue
        for bf16 in (False, True):
            x = forward_input(this, preset, dev, bf16)
            for kernel, call in forward_calls(x).items():
                rows.append(_row(
                    kernel, label, bf16,
                    lambda Mod, call=call: (lambda: run_forward(Mod, call)),
                    this, other, card, timed))
            del x
    for label, preset, kernel in adjoint_cases(this.presets, size):
        if only and only not in label:
            continue
        for bf16 in (False, True):
            x = adjoint_ab.inputs(preset, dev, bf16)
            call = adjoint_ab.calls(x, "real")[kernel]
            rows.append(_row(
                kernel, label, bf16,
                lambda Mod: (lambda: adjoint_ab.run(Mod.AF, call)),
                this, other, card, timed))
            del x
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="forward_ab")
    ap.add_argument("--other", default=None,
                    help="a checkout whose port package is timed alongside")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--sass-dir", default=SASS_DIR)
    ap.add_argument("--cpu", action="store_true",
                    help="compare the two packages' plain versions on the "
                         "CPU: no times, no census")
    ap.add_argument("--size", type=int, default=None,
                    help="every frame at this size squared")
    ap.add_argument("--only", default=None,
                    help="the rows whose input's label holds this, and no "
                         "census or lane counts but the tree's")
    args = ap.parse_args(argv)
    this = adjoint_ab.modules()
    other = adjoint_ab.load_other(args.other) if args.other else None
    if args.cpu:
        rows = compare_rows(this, other, torch.device("cpu"), "cpu",
                            size=args.size, timed=False)
        out = dict(card="cpu", other=args.other, rows=rows)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("forward_ab needs a CUDA GPU (or --cpu)")
        dev = torch.device("cuda")
        card = subprocess.run(["nvidia-smi", "--id=0",
                               "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
        print(card)
        t0 = time.perf_counter()
        this.cuda_build.load()
        if other is not None:
            other.cuda_build.load()
        print(f"build and load: {time.perf_counter() - t0:.1f} s")
        census, lanes = {}, []
        if not args.only:
            census["this"] = chain_census(this, args.sass_dir, "this")
            print_census("this", census["this"], card)
            if other is not None:
                census["other"] = chain_census(other, args.sass_dir, "other")
                print_census("other", census["other"], card)
            lanes = lane_rows(this, dev, card)
        trees = tree_rows(this, other, dev, card)
        rows = compare_rows(this, other, dev, card, size=args.size,
                            only=args.only)
        out = dict(card=card, reps=REPS, other=args.other, census=census,
                   lanes=lanes, tree=trees, rows=rows)
    unequal = [f"{r['kernel']} {r['input']} {'bf16' if r['bf16'] else 'f32'}"
               for r in out["rows"] if not r.get("equal_to_other", True)]
    if other is not None and out["rows"]:
        print(f"bit-identical to the other package: {not unequal}"
              + (f" (differ: {unequal})" if unequal else ""))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(card=out["card"], rows=len(out["rows"]),
                          unequal=unequal)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
