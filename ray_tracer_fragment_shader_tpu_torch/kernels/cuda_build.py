"""Build the CUDA kernels into a shared library with nvcc and bind it with
ctypes (no PyTorch headers, so a build takes seconds).

The library is built at first use from the sources under ``csrc/`` into
``ray_tracer_fragment_shader_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the sources and flags: a changed source builds anew, an
unchanged one loads the existing file.  The compiler writes to a temporary
file that is renamed into place, so two processes building at once cannot
leave a torn library behind.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("tile_ops.cuh", "render_chain.cu", "render_tree.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ENTRY_ARGS = (
    [ctypes.c_void_p]                      # tables
    + [ctypes.c_int] * 4                   # ns nt m nl
    + [ctypes.c_void_p, ctypes.c_void_p]   # v out
    + [ctypes.c_int]                       # num_pixels
    + [ctypes.c_float] * 3                 # eye
    + [ctypes.c_int]                       # depth
    + [ctypes.c_float] * 2                 # small atten
    + [ctypes.c_int] * 3                   # white_id black_id want_trans
    + [ctypes.c_void_p])                   # stream

_lock = threading.Lock()
_lib = None
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librtfs_kernels_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC_DIR, s) for s in SOURCES if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr, built=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
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
            build_info.update(seconds=0.0, log="", built=False)
        build_info["path"] = path
        lib = ctypes.CDLL(path)
        for name in ("rtfs_render_chain", "rtfs_render_tree"):
            fn = getattr(lib, name)
            fn.argtypes = _ENTRY_ARGS
            fn.restype = ctypes.c_int
        lib.rtfs_error_string.argtypes = [ctypes.c_int]
        lib.rtfs_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
