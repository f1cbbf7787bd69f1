"""The issue-rate probes on the card: the counterparts of the JAX package's
``utils/roofline.py::_mix_kernel`` (K9), ``scripts/vpu_op_probe.py``'s
chains (P1) and ``scripts/bf16_probe.py``'s (P2), and the sweeps that time
them.

One wrapper per kernel:

* ``mix_chain`` -- K9 (csrc/mix_probe.cu): ``nc`` dependent chains per
  element over a 256-op class schedule compiled in, for ``iters``
  iterations; the chains' sum.  Plain version:
  ``utils/roofline.py::mix_chain_ref``.  P3 (probes/pressure_probe.py)
  runs it too.
* ``op_chain`` -- P1 (csrc/op_probe.cu): pure one-class chains, 14
  classes (``INJECTS``).  Plain version: ``op_chain_ref``.
* ``bf16_chain`` -- P2 (csrc/bf16_probe.cu): the ``mul`` and ``mix``
  chains in f32 or bf16.  Plain version: ``bf16_chain_ref``.

Each takes ``x`` [8*G, 256] f32 in 8x256 tiles, whose scalars the chains
read per tile (``utils/roofline.py::tiles``).  Given CPU tensors a wrapper
runs its plain version; given CUDA tensors it launches its kernel (built
at first use, ``kernels/cuda_build.py::load_probe``) or raises.  Each
launch adds one to its count in ``render.LAUNCHES``.

``mix_rate_sweep`` (K9) and ``op_time`` (P1, P2) time the kernels by
iteration-count differencing on the device (``utils/timing.py::
launch_diff_s``) over chains per thread and blocks per SM, and keep the
best, as the JAX probes swept their chain counts.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from ..utils.roofline import _MIX_CLASSES, mix_chain_ref, probe_input, tiles
from ..utils.timing import launch_diff_s
from . import cuda_build
from .render import LAUNCHES

#: chain counts K9 may be built with (csrc/mix_probe.cu::kNcChoices)
NC_CHOICES = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96)
#: chain counts ``measure_mix_rate`` sweeps
MIX_NCS = (2, 4, 8, 16)
#: P1's classes (csrc/op_probe.cu::Inject), in order
INJECTS = ("mul", "add", "max", "sel", "cmpsel", "abs", "sign", "rsqrt",
           "sqrt", "div", "recip", "recip_nr", "floor", "mix")
#: P2's classes (csrc/bf16_probe.cu::Inject)
BF16_INJECTS = ("mul", "mix")
#: chain counts of P1 (csrc/op_probe.cu::kNcs)
OP_NCS = (4, 8, 12, 16)
#: chain counts of P2 (csrc/bf16_probe.cu::kNcs): 32 lets the f32 `mul`
#: chain, the ratio's denominator, reach its FP32 rate
BF16_NCS = (4, 8, 12, 16, 32)
THREADS = 256


# ------------------------------------------------------------ plain versions

def op_step(inject: str, y, c, d, bfix):
    """One chain step of P1's class ``inject`` (the JAX
    ``vpu_op_probe.py::_step``); ``recip`` is an exact 1/y here, which the
    card's rcp.approx.f32 approximates to about an ulp."""
    if inject == "mul":
        return y * c
    if inject == "add":
        return (d - y) + c * 0.25
    if inject == "max":
        return torch.maximum(y, d) * c
    if inject == "sel":
        return torch.where(bfix, y, d) * c
    if inject == "cmpsel":
        return torch.where(y > d, y * 0.98, y * 1.01)
    if inject == "abs":
        return torch.abs(y) * (-c)
    if inject == "sign":
        return torch.sign(y) * d
    if inject == "rsqrt":
        return torch.rsqrt(y)
    if inject == "sqrt":
        return torch.sqrt(y)
    if inject == "div":
        return c / y
    if inject == "recip":
        return 1.0 / y
    if inject == "recip_nr":
        r = 1.0 / y
        return r * (2.0 - y * r)
    if inject == "floor":
        return torch.floor(y * 1.618) * d
    if inject == "mix":
        y = torch.where(y > d, y * c, y + d)
        y = torch.where(bfix, y * c + d, y)
        y = torch.rsqrt(y * c + d * 0.1)
        return y * c
    raise ValueError(inject)


def op_chain_ref(x: torch.Tensor, *, inject: str, iters: int,
                 nc: int) -> torch.Tensor:
    """The plain version of P1 (the JAX ``vpu_op_probe.py::_chain_kernel``):
    ``nc`` chains per element from x*(1 + 0.001 i), ``iters`` steps of
    ``inject``, summed; c = 2*tile[0,0], d = tile[0,1]."""
    xt = tiles(x)
    c, d = xt[:, :1, :1] * 2.0, xt[:, :1, 1:2]
    bfix = xt > d
    ys = [xt * (1.0 + 0.001 * i) for i in range(nc)]
    for _ in range(iters):
        ys = [op_step(inject, y, c, d, bfix) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc.reshape(x.shape)


def bf16_step(inject: str, y, c, d, d32, d01, bfix):
    """One chain step of P2 (the JAX ``bf16_probe.py::_step``): the compare
    is f32 (``y > d32``) and ``rsqrt`` runs in f32 in either type."""
    if inject == "mul":
        return y * c
    if inject != "mix":
        raise ValueError(inject)
    bf16 = y.dtype == torch.bfloat16
    cond = (y.float() if bf16 else y) > d32
    y = torch.where(cond, y * c, y + d)
    y = torch.where(bfix, y * c + d, y)
    arg = y * c + d01
    y = torch.rsqrt(arg.float()).to(y.dtype) if bf16 else torch.rsqrt(arg)
    return y * c


def bf16_chain_ref(x: torch.Tensor, *, inject: str, bf16: bool, iters: int,
                   nc: int) -> torch.Tensor:
    """The plain version of P2 (the JAX ``bf16_probe.py::_chain_kernel``):
    the chains in bf16 (``bf16``) or f32, c = 2*tile[0,0], d = tile[0,1]
    and d*0.1 formed in f32 and rounded to the chain's type; the sum in the
    chain's type, returned as f32 [8*G, 256]."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    xt = tiles(x)
    d32 = xt[:, :1, 1:2]
    c = (xt[:, :1, :1] * 2.0).to(dtype)
    d, d01 = d32.to(dtype), (d32 * 0.1).to(dtype)
    bfix = xt > d32
    xd = xt.to(dtype)
    ys = [xd * torch.tensor(1.0 + 0.001 * i, dtype=dtype, device=x.device)
          for i in range(nc)]
    for _ in range(iters):
        ys = [bf16_step(inject, y, c, d, d32, d01, bfix) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc.float().reshape(x.shape)


# ------------------------------------------------------------------ wrappers

def mix_defines(sched: Sequence[str], ncs: Sequence[int] = MIX_NCS
                ) -> Tuple[str, ...]:
    """The ``-D`` defines of K9's build for schedule ``sched`` and the
    chain counts ``ncs``: the class ids as one token ``s<digits>`` (nvcc
    splits a define's value at commas) and a mask over ``NC_CHOICES``."""
    ids = "".join(str(_MIX_CLASSES.index(k)) for k in sched)
    bad = [n for n in ncs if n not in NC_CHOICES]
    if bad or not ncs:
        raise ValueError(f"chain counts {bad or ncs} not among {NC_CHOICES}")
    mask = sum(1 << NC_CHOICES.index(n) for n in set(ncs))
    return (f"RTFS_MIX_SCHED=s{ids}", f"RTFS_MIX_NC_MASK={mask}")


def _cuda_input(entry: str, x: torch.Tensor) -> None:
    tiles(x)
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: kernels run on CUDA tensors, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{entry}: x must be contiguous")


def _blocks(x: torch.Tensor, blocks) -> int:
    """One thread an element, or the ``blocks`` given."""
    return blocks if blocks is not None else -(-x.numel() // THREADS)


def _launch(entry: str, lib, x: torch.Tensor, iters: int, inst: Sequence[int],
            blocks) -> torch.Tensor:
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"rtfs_{entry}")(
            x.data_ptr(), out.data_ptr(), x.numel(), int(iters), *inst,
            _blocks(x, blocks), ctypes.c_void_p(stream))
    cuda_build.check_probe(lib, rc, entry)
    LAUNCHES[entry] += 1
    return out


def _check_iters(iters: int) -> None:
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def mix_chain(x: torch.Tensor, *, iters: int, nc: int, sched: Sequence[str],
              ncs: Sequence[int] = MIX_NCS, blocks=None) -> torch.Tensor:
    """K9 on ``x`` [8*G, 256] f32: ``nc`` chains (one of ``ncs``, the
    instantiations of the library built for ``sched``) per element for
    ``iters`` iterations; returns the chains' sums.  CUDA tensors launch
    csrc/mix_probe.cu with ``blocks`` blocks of 256 threads (default: a
    thread an element); CPU tensors run ``mix_chain_ref``."""
    _check_iters(iters)
    if x.device.type == "cpu":
        return mix_chain_ref(x, iters=iters, nc=nc, sched=sched)
    _cuda_input("mix_chain", x)
    if nc not in ncs:
        raise ValueError(f"nc={nc} is not among the library's {tuple(ncs)}")
    lib = cuda_build.load_probe("mix_probe.cu", mix_defines(sched, ncs))
    return _launch("mix_chain", lib, x, iters, (nc,), blocks)


def op_chain(x: torch.Tensor, *, inject: str, iters: int, nc: int,
             blocks=None) -> torch.Tensor:
    """P1 on ``x``: ``nc`` (one of ``OP_NCS``) chains of class ``inject``
    per element.  CUDA tensors launch csrc/op_probe.cu; CPU tensors run
    ``op_chain_ref``."""
    _check_iters(iters)
    if inject not in INJECTS:
        raise ValueError(f"unknown class {inject!r}")
    if x.device.type == "cpu":
        return op_chain_ref(x, inject=inject, iters=iters, nc=nc)
    _cuda_input("op_chain", x)
    if nc not in OP_NCS:
        raise ValueError(f"nc={nc} is not among {OP_NCS}")
    lib = cuda_build.load_probe("op_probe.cu")
    return _launch("op_chain", lib, x, iters, (INJECTS.index(inject), nc),
                   blocks)


def bf16_chain(x: torch.Tensor, *, inject: str, bf16: bool, iters: int,
               nc: int, blocks=None) -> torch.Tensor:
    """P2 on ``x``: ``nc`` (one of ``BF16_NCS``) ``mul`` or ``mix`` chains per
    element in bf16 (``bf16``; a thread's chain holds two neighbouring
    elements) or f32.  CUDA tensors launch csrc/bf16_probe.cu; CPU tensors
    run ``bf16_chain_ref``."""
    _check_iters(iters)
    if inject not in BF16_INJECTS:
        raise ValueError(f"unknown class {inject!r}")
    if x.device.type == "cpu":
        return bf16_chain_ref(x, inject=inject, bf16=bf16, iters=iters,
                              nc=nc)
    _cuda_input("bf16_chain", x)
    if nc not in BF16_NCS:
        raise ValueError(f"nc={nc} is not among {BF16_NCS}")
    lib = cuda_build.load_probe("bf16_probe.cu")
    return _launch("bf16_chain", lib, x, iters,
                   (BF16_INJECTS.index(inject), int(bf16), nc), blocks)


def occupancy(source: str, inst: Sequence[int], defines=()) -> int:
    """Blocks of 256 threads of one instantiation (``inst``: the C entry's
    instantiation arguments) one SM holds at once."""
    lib = cuda_build.load_probe(source, defines)
    entry = {"mix_probe.cu": "mix_occupancy", "op_probe.cu": "op_occupancy",
             "bf16_probe.cu": "bf16_occupancy"}[source]
    n = ctypes.c_int(0)
    rc = getattr(lib, f"rtfs_{entry}")(*inst, ctypes.byref(n))
    cuda_build.check_probe(lib, rc, entry)
    return n.value


# ------------------------------------------------------------------ timing

def sm_count(device=None) -> int:
    return torch.cuda.get_device_properties(
        device if device is not None else 0).multi_processor_count


def sweep_best(launch, x_full: torch.Tensor, bps_list, iters: int,
               reps: int, per_element_iter: float, sms: int) -> dict:
    """Times ``launch(x, iters, blocks)`` on the first ``sms*bps`` tiles of
    ``x_full`` (a block a tile, 8 elements a thread) for each blocks per SM
    in ``bps_list``, by ``launch_diff_s``; returns the best as ``rate``
    (``per_element_iter`` ops an element and iteration, per second) with
    ``blocks_per_sm`` and the ``sweep`` {bps: rate}."""
    sweep = {}
    for bps in bps_list:
        xs = x_full[: sms * bps * 8]
        dt = launch_diff_s(lambda n: launch(xs, n, sms * bps), iters, reps)
        sweep[bps] = xs.numel() * per_element_iter * iters / dt
    best = max(sweep, key=sweep.get)
    return dict(rate=sweep[best], blocks_per_sm=best, sweep=sweep)


def bps_candidates(occ: int) -> List[int]:
    """Blocks per SM to try: the most that fit, and half of that."""
    return sorted({max(occ, 1), max(occ // 2, 1)})


def mix_rate_sweep(sched: Sequence[str], per_step: int, *, iters: int,
                   reps: int, ncs: Sequence[int] = MIX_NCS,
                   device=None) -> dict:
    """K9's rate for ``sched`` on the card: for each chain count of
    ``ncs`` and each of ``bps_candidates``, ``per_step`` budget ops an
    element-chain iteration over the time ``launch_diff_s`` measures;
    returns the best ``rate`` (budget ops/s), its ``nc`` and
    ``blocks_per_sm``, and the ``sweep`` {"NCxBPS": rate}."""
    dev = device if device is not None else torch.device("cuda")
    sms = sm_count(dev)
    x = probe_input(sms * 8, dev)
    defines = mix_defines(sched, ncs)
    sweep, best = {}, None
    for nc in ncs:
        occ = occupancy("mix_probe.cu", (nc,), defines)
        r = sweep_best(lambda xs, n, b: mix_chain(
            xs, iters=n, nc=nc, sched=sched, ncs=ncs, blocks=b), x,
            bps_candidates(occ), iters, reps, nc * per_step, sms)
        for bps, rate in r["sweep"].items():
            sweep[f"{nc}x{bps}"] = rate
        if best is None or r["rate"] > best["rate"]:
            best = dict(rate=r["rate"], nc=nc,
                        blocks_per_sm=r["blocks_per_sm"])
    return dict(best, sweep=sweep)


def op_time(inject: str, nc: int, iters: int, reps: int, x: torch.Tensor,
            bf16=None) -> dict:
    """Seconds per (element x iteration) of P1's ``inject`` chain (or P2's,
    with ``bf16`` True/False) at ``nc`` chains, the best over
    ``bps_candidates``; also its blocks per SM and occupancy.  ``x`` holds
    at least 8 tiles an SM."""
    sms = sm_count(x.device)
    if bf16 is None:
        occ = occupancy("op_probe.cu", (INJECTS.index(inject), nc))

        def launch(xs, n, b):
            return op_chain(xs, inject=inject, iters=n, nc=nc, blocks=b)
    else:
        occ = occupancy("bf16_probe.cu",
                        (BF16_INJECTS.index(inject), int(bf16), nc))

        def launch(xs, n, b):
            return bf16_chain(xs, inject=inject, bf16=bf16, iters=n, nc=nc,
                              blocks=b)
    r = sweep_best(launch, x, bps_candidates(occ), iters, reps, nc, sms)
    return dict(s_per_step=1.0 / r["rate"], blocks_per_sm=r["blocks_per_sm"],
                occupancy=occ)


# ------------------------------------------------------- what was compiled

def ptxas_resources(log: str, kernel: str) -> Dict[Tuple[int, ...], dict]:
    """Registers and spill bytes of each instantiation of ``kernel`` in a
    ptxas -v log, keyed by its integer template arguments."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            current = None
            if re.search(rf"\d{kernel}I", name):
                current = tuple(int(a) for a in re.findall(
                    r"Li(-?\d+)E", name))
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[current].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            current = None
    return out


def sass_text(library: str) -> str:
    """A built library's SASS as ``cuobjdump -sass`` prints it."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr[:2000]}")
    return res.stdout


def sass_instructions(text: str, kernel: str
                      ) -> Dict[Tuple[int, ...], List[Tuple[int, str, str]]]:
    """The instructions of each instantiation of ``kernel`` in SASS
    ``text``, keyed by its integer template arguments: (address, opcode,
    the instruction as printed)."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            current = None
            if re.search(rf"\d{kernel}I", name):
                current = tuple(int(a) for a in re.findall(
                    r"Li(-?\d+)E", name))
                out[current] = []
            continue
        if current is None:
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)[^;]*);", line)
        if m:
            out[current].append((int(m.group(1), 16), m.group(3),
                                 m.group(2).strip()))
    return out


def sass_opcodes(library: str, kernel: str) -> Dict[Tuple[int, ...], dict]:
    """Opcode counts of each instantiation of ``kernel`` in a built
    library's SASS (``cuobjdump -sass``), keyed by its integer template
    arguments: what the compiler made of each class (FFMA where it fused,
    MUFU, FSEL, HFMA2 ...).  An opcode is counted by its first word
    (``HMUL2`` for ``HMUL2.BF16_V2``)."""
    out = {}
    for key, ins in sass_instructions(sass_text(library), kernel).items():
        counts: dict = {}
        for _, op, _ in ins:
            op = op.split(".")[0]
            counts[op] = counts.get(op, 0) + 1
        out[key] = counts
    return out


def hot_loop(ins: List[Tuple[int, str, str]]) -> List[Tuple[int, str, str]]:
    """The body of the largest innermost loop that touches no memory in
    one function's own instructions (``sass_instructions``): a span from a
    backward branch's target to the branch, holding no other backward
    branch and no load or store (a chain loop, not a grid-stride loop).
    Out-of-line functions the kernel calls, which cuobjdump lists inside
    it from the CALL's target to the RET, are left out."""
    called = []
    for addr, op, text in ins:
        m = re.search(r"\bCALL\S*\s+0x([0-9a-f]+)", text)
        if op.startswith("CALL") and m:
            start = int(m.group(1), 16)
            end = min((a for a, o, _ in ins if o.startswith("RET")
                       and a >= start), default=start)
            called.append((start, end))
    ins = [x for x in ins if not any(a <= x[0] <= b for a, b in called)]
    loops = []
    for addr, op, text in ins:
        m = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", text)
        if op == "BRA" and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in loops)]
    bodies = [[x for x in ins if a <= x[0] <= b] for a, b in inner]
    bodies = [b for b in bodies
              if not any(op.startswith(("LD", "ST")) for _, op, _ in b)]
    return max(bodies, key=len, default=[])


def sass_pipe(op: str) -> str:
    """The pipe an sm_90 opcode (as ``sass_instructions`` gives it) issues
    to, by the names of ``probes/common.py::PIPE_RATES``: ``fp16x2_mma``
    the HFMA2.MMA form, ``fp16x2`` the other packed 16-bit arithmetic and
    compares, ``fp32``, ``mufu``, ``conv``, ``control`` the loop's integer
    add, compare and branch, ``alu`` the rest (bit operations, selects, f32
    compares, 16x2 integer min)."""
    if ".MMA" in op:
        return "fp16x2_mma"
    if op.startswith(("HMUL2", "HADD2", "HFMA2", "HSET2", "HSETP2",
                      "HMNMX2")):
        return "fp16x2"
    if op.startswith(("FMUL", "FADD", "FFMA")):
        return "fp32"
    if op.startswith("MUFU"):
        return "mufu"
    if op.startswith(("F2FP", "F2F", "I2F", "F2I")):
        return "conv"
    if op.startswith(("BRA", "ISETP", "IADD3")):
        return "control"
    return "alu"


def step_census(library: str, kernel: str, unroll: int = 4
                ) -> Dict[Tuple[int, ...], dict]:
    """The instructions one chain step issues in each instantiation of
    ``kernel`` (template arguments ending in the chain count ``nc``): its
    hot loop's (``hot_loop``) by pipe (``sass_pipe``) and by opcode, over
    the ``unroll * nc`` steps the loop body holds."""
    out = {}
    for key, ins in sass_instructions(sass_text(library), kernel).items():
        body = hot_loop(ins)
        steps = unroll * key[-1]
        pipes: dict = {}
        ops: dict = {}
        for _, op, _ in body:
            pipes[sass_pipe(op)] = pipes.get(sass_pipe(op), 0) + 1
            ops[op] = ops.get(op, 0) + 1
        out[key] = dict(
            pipes={k: v / steps for k, v in sorted(pipes.items())},
            opcodes={k: v / steps for k, v in sorted(ops.items())},
            issue=len(body) / steps, body=len(body))
    return out


class ClockSampler:
    """Samples the SM clock (MHz) with nvidia-smi every ``period_ms`` while
    the ``with`` block runs, and stops the sampler at its end."""

    def __init__(self, period_ms: int = 100, index: int = 0):
        self.cmd = ["nvidia-smi", f"--id={index}",
                    "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                    f"--loop-ms={period_ms}"]
        self.samples: List[float] = []

    def __enter__(self):
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            line = line.strip()
            if line.replace(".", "", 1).isdigit():
                self.samples.append(float(line))

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.thread.join(timeout=30)
        return False


def gpu_query(fields: str, index: int = 0) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` of card
    ``index``."""
    res = subprocess.run(["nvidia-smi", f"--id={index}",
                          f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()
