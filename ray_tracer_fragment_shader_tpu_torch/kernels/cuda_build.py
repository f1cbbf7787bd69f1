"""Build the CUDA kernels into a shared library with nvcc and bind it with
ctypes (no PyTorch headers, so a build takes seconds).

The library is built at first use from the sources under ``csrc/`` into
``ray_tracer_fragment_shader_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the sources and flags: a changed source builds anew, an
unchanged one loads the existing file.  Each ``.cu`` compiles in its own
nvcc process, all started together, and one more nvcc links the objects.
The linker writes to a temporary file that is renamed into place, so two
processes building at once cannot leave a torn library behind.

The probe kernels (K9, P1, P2: ``PROBE_SOURCES``) build apart, one small
library per source and set of ``-D`` defines (``load_probe``), named by a
hash of the source, its flags and the defines: K9's op-class schedule is a
define, so each schedule has a library of its own and a new one never
rebuilds the render kernels'.  ``build_probes`` starts the nvcc of every
missing library at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("tile_ops.cuh", "render_chain.cu", "render_tree.cu",
           "adjoint_ops.cuh", "adjoint_packed.cu", "adjoint_fused.cu",
           "fit_grads.cu")
#: the issue-rate probes, each built alone (``load_probe``)
PROBE_SOURCES = ("mix_probe.cu", "op_probe.cu", "bf16_probe.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of each source: -fmad=false everywhere, so every kernel rounds as
#: its plain version does, with no fused multiply-add; the forwards pick the
#: plain version's hit topology and the adjoints replay it
#: (csrc/adjoint_ops.cuh, csrc/tile_ops.cuh; fma_ab.py measures the cost).
#: The probes take the same flag, so they issue what the kernels they price
#: can issue: K9's `basic` class alternates y*c and y+d, one FFMA pair when
#: contraction is on
SOURCE_FLAGS = {s: ("-fmad=false",) for s in SOURCES + PROBE_SOURCES
                if s.endswith(".cu")}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RENDER_ARGS = ([_P] + [_I] * 4        # tables; ns nt m nl
                + [_P, _P, _I]         # v out num_pixels
                + [_F] * 3 + [_I]      # eye; depth
                + [_F] * 2             # small atten
                + [_I] * 4)            # white_id black_id want_trans bf16
#: argtypes of each C entry (the stream pointer comes last in each)
_ENTRIES = {
    "rtfs_render_chain": _RENDER_ARGS + [_P],
    "rtfs_render_tree": _RENDER_ARGS + [_P],
    # + pk, bw_bi, bw_mid
    "rtfs_render_packed": _RENDER_ARGS + [_P, _F, _F, _P],
    # + res (the unpacked residual planes)
    "rtfs_render_chain_residuals": _RENDER_ARGS + [_P, _P],
    "rtfs_render_tree_residuals": _RENDER_ARGS + [_P, _P],
    # + rec rec_n target mask g_scale ballots counts loss_rows (K6's chain
    # forward)
    "rtfs_render_chain_records": _RENDER_ARGS + [_P] * 4 + [_F] + [_P] * 4,
    # tables; ns nt m nl; v img target mask pk; ids count; num_pixels; eye;
    # depth; atten g_scale bw_bi bw_mid; want_trans; partial num_blocks;
    # stream
    "rtfs_adjoint_packed": ([_P] + [_I] * 4 + [_P] * 5 + [_P] * 2 + [_I]
                            + [_F] * 3 + [_I] + [_F] * 4 + [_I]
                            + [_P, _I, _P]),
    # img target mask g; g_scale; num_pixels; ballots counts offsets
    # loss_rows ids count; stream
    "rtfs_live_list": [_P] * 4 + [_F, _I] + [_P] * 6 + [_P],
    # ballots counts; num_pixels; offsets ids count; stream
    "rtfs_live_ids": [_P] * 2 + [_I] + [_P] * 3 + [_P],
    # partial num_rows ns m nl count loss_rows num_loss_rows out stream
    "rtfs_adjoint_reduce": [_P] + [_I] * 4 + [_P, _P, _I, _P, _P],
    # tables; ns nt m nl; v target mask; num_pixels; eye; depth; small
    # atten; white_id black_id want_trans tree bf16; g_scale; img rec rec_n
    # ballots counts offsets loss_rows ids count; partial num_blocks; stream
    "rtfs_fused_adjoint": ([_P] + [_I] * 4 + [_P] * 3 + [_I] + [_F] * 3
                           + [_I] + [_F] * 2 + [_I] * 5 + [_F] + [_P] * 9
                           + [_P, _I, _P]),
    # as rtfs_fused_adjoint with the cotangent g and the live list (ids
    # count) for target and mask, and no g_scale
    "rtfs_recompute_adjoint": ([_P] + [_I] * 4 + [_P] * 2 + [_P] * 2 + [_I]
                               + [_F] * 3 + [_I] + [_F] * 2 + [_I] * 5
                               + [_P, _I, _P]),
    # want_trans form bf16 smem_bytes blocks (render_chain.cu)
    "rtfs_chain_occupancy": [_I] * 4 + [_P],
    # want_trans form bf16 smem_bytes blocks (render_tree.cu)
    "rtfs_tree_occupancy": [_I] * 4 + [_P],
    # tree external_g want_trans bf16 depth smem_bytes blocks (the
    # one-dispatch kernel); want_trans smem_bytes blocks (K6's chain
    # adjoint) (adjoint_fused.cu)
    "rtfs_fused_occupancy": [_I] * 6 + [_P],
    "rtfs_records_occupancy": [_I] * 2 + [_P],
    # tables; ns nt m nl; v g bi mid lit; ids count; num_pixels; eye;
    # depth; atten; want_trans; partial num_blocks; stream
    "rtfs_fit_grads": ([_P] + [_I] * 4 + [_P] * 5 + [_P] * 2 + [_I]
                       + [_F] * 3 + [_I] + [_F] + [_I] + [_P, _I, _P]),
}
#: argtypes of each probe library's C entries: x out n iters, the
#: instantiation (K9: nc; P1: inject nc; P2: inject bf16 nc), blocks,
#: stream; the occupancy entries take the instantiation and an int* out
PROBE_ENTRIES = {
    "mix_probe.cu": {"rtfs_mix_chain": [_P, _P, _I, _I, _I, _I, _P],
                     "rtfs_mix_occupancy": [_I, _P]},
    "op_probe.cu": {"rtfs_op_chain": [_P, _P, _I, _I, _I, _I, _I, _P],
                    "rtfs_op_occupancy": [_I, _I, _P]},
    "bf16_probe.cu": {"rtfs_bf16_chain": [_P, _P, _I, _I, _I, _I, _I, _I,
                                          _P],
                      "rtfs_bf16_occupancy": [_I, _I, _I, _P]},
}

_lock = threading.Lock()
_lib = None
_probe_libs: dict = {}
#: what the last build or load did: library path, seconds, compiler log
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are built with nvcc at first use")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}")
    return path


def library_path() -> str:
    flags = {s: f for s, f in SOURCE_FLAGS.items() if s in SOURCES}
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode()
                       + repr(sorted(flags.items())).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librtfs_kernels_{h.hexdigest()[:16]}.so")


def _run_each(cmds):
    """Runs the commands at once; returns each one's output, or raises
    with the first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


def _run_all(cmds) -> str:
    """Runs the commands at once; returns their joined output."""
    return "".join(_run_each(cmds))


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in SOURCES if s.endswith(".cu")]
    objs = [f"{tmp}.{s}.o" for s in cus]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS[s], "-c", "-o", o,
                     os.path.join(CSRC_DIR, s)] for s, o in zip(cus, objs)])
    log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    build_info.update(seconds=time.perf_counter() - t0, log=log, built=True)
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{path}.log")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The kernels' library, built first if this source set has no build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        else:
            log = ""
            if os.path.exists(f"{path}.log"):
                with open(f"{path}.log") as f:
                    log = f.read()
            build_info.update(seconds=0.0, log=log, built=False)
        build_info["path"] = path
        lib = ctypes.CDLL(path)
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rtfs_error_string.argtypes = [ctypes.c_int]
        lib.rtfs_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, entry: str) -> None:
    """Raises if a C entry returned a CUDA error (its launch was refused)."""
    if rc != 0:
        msg = lib.rtfs_error_string(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


# ------------------------------------------------------------------ probes

def probe_library_path(source: str, defines=()) -> str:
    """The library of probe ``source`` built with ``-D`` ``defines``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SOURCE_FLAGS[source]).encode()
                       + repr(tuple(defines)).encode())
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"librtfs_{stem}_{h.hexdigest()[:16]}.so")


def build_probes(specs) -> None:
    """Builds each ``(source, defines)`` of ``specs`` that has no library
    yet, one nvcc each, all started together.  A library's compiler log
    (ptxas's registers and spills per kernel) is kept beside it as
    ``<library>.log``."""
    todo = {}
    for source, defines in specs:
        path = probe_library_path(source, defines)
        if not os.path.exists(path):
            todo[path] = (source, tuple(defines))
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS[source],
             *(f"-D{d}" for d in defines), "-shared", "-o", f"{path}.{tag}",
             os.path.join(CSRC_DIR, source)]
            for path, (source, defines) in todo.items()]
    for path, log in zip(todo, _run_each(cmds)):
        with open(f"{path}.log.{tag}", "w") as f:
            f.write(log)
        os.replace(f"{path}.log.{tag}", f"{path}.log")
        os.replace(f"{path}.{tag}", path)


def probe_log(source: str, defines=()) -> str:
    """The compiler log of a built probe library."""
    with open(probe_library_path(source, defines) + ".log") as f:
        return f.read()


def load_probe(source: str, defines=()) -> ctypes.CDLL:
    """The probe library of ``source`` and ``defines``, built first if it
    has no build."""
    key = (source, tuple(defines))
    with _lock:
        lib = _probe_libs.get(key)
        if lib is not None:
            return lib
        build_probes([key])
        lib = ctypes.CDLL(probe_library_path(source, defines))
        for name, argtypes in PROBE_ENTRIES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rtfs_probe_error_string.argtypes = [ctypes.c_int]
        lib.rtfs_probe_error_string.restype = ctypes.c_char_p
        _probe_libs[key] = lib
        return lib


def check_probe(lib: ctypes.CDLL, rc: int, entry: str) -> None:
    """Raises if a probe's C entry returned a CUDA error."""
    if rc != 0:
        msg = lib.rtfs_probe_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")
