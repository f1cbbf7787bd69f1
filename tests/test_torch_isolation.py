"""The port never imports JAX: importing every module of
ray_tracer_fragment_shader_tpu_torch leaves jax and flax out of
sys.modules, and the kernel wrappers hold no try/except that could turn a
failed build or launch into a silent fallback; every CUDA source is built,
and each of its C entries hands its launch's error code back."""
import os
import pkgutil
import re
import subprocess
import sys

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
import ray_tracer_fragment_shader_tpu_torch as port

PORT_DIR = os.path.dirname(port.__file__)
REPO = os.path.dirname(PORT_DIR)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tracer_fragment_shader_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ray_tracer_fragment_shader_tpu'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 10
    assert bad.strip() == "[]"


def test_kernel_paths_have_no_fallback():
    for name in ("render.py", "cuda_build.py", "adjoint.py",
                 "adjoint_fused.py", "probe.py"):
        with open(os.path.join(PORT_DIR, "kernels", name)) as f:
            src = f.read()
        assert not re.search(r"^\s*(try\s*:|except\b)", src, re.M), name


def test_kernel_sources_are_built_and_report_their_launches():
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    csrc = os.path.join(PORT_DIR, "kernels", "csrc")
    names = sorted(os.listdir(csrc))
    assert set(names) == (set(cuda_build.SOURCES)
                          | set(cuda_build.PROBE_SOURCES)), names
    entries = set()
    for name in names:
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        assert not re.search(r"\b(try|catch)\b", src), name
        # each C entry returns the launch's cudaError_t (directly or through
        # the launcher that checks it)
        for entry, body in re.findall(
                r'extern "C" int (rtfs_\w+)\(.*?\)\s*\{(.*?)\n\}', src,
                re.S):
            entries.add(entry)
            if entry != "rtfs_error_string":
                assert re.search(r"cudaGetLastError|launch_render|"
                                 r"launch_fused", body), entry
    probe_entries = {e for v in cuda_build.PROBE_ENTRIES.values() for e in v}
    assert entries == set(cuda_build._ENTRIES) | probe_entries, entries


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    imports = re.findall(r"^\s*(?:import|from)\s+([\w.]+)", src, re.M)
    roots = {m.split(".")[0] for m in imports}
    assert not roots & {"jax", "jaxlib", "flax",
                        "ray_tracer_fragment_shader_tpu"}, roots


def test_every_module_is_found():
    names = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")}
    assert {"ray_tracer_fragment_shader_tpu_torch.kernels.render",
            "ray_tracer_fragment_shader_tpu_torch.kernels.adjoint",
            "ray_tracer_fragment_shader_tpu_torch.kernels.adjoint_fused",
            "ray_tracer_fragment_shader_tpu_torch.diff.fit",
            "ray_tracer_fragment_shader_tpu_torch.utils.checkpoint",
            "ray_tracer_fragment_shader_tpu_torch.cli",
            "ray_tracer_fragment_shader_tpu_torch.scene.flat",
            "ray_tracer_fragment_shader_tpu_torch.oracle.numpy_ref",
            "ray_tracer_fragment_shader_tpu_torch.oracle.gradcheck",
            "ray_tracer_fragment_shader_tpu_torch.grad_bar"} <= names


def test_parallel_utils_and_native_oracle_import_no_jax_and_build_in_build():
    """The multi-rank paths, the utils and the C++ oracle's binding run on
    the card's machine: they are among the modules test_port_imports_no_jax
    imports (no JAX nor the JAX package), and hold no try/except that
    could hide a failed collective, build or launch;
    the oracle's library is built only under the port's gitignored
    ``_build/`` (never beside the JAX package's source)."""
    new = ["parallel", "parallel.mesh", "parallel.shard",
           "parallel.multihost", "utils.logging", "utils.guards",
           "utils.profiling", "utils.checkpoint", "oracle.native"]
    names = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")}
    # found by the walk, so test_port_imports_no_jax imports each of them
    assert {f"{port.__name__}.{n}" for n in new} <= names
    for n in new:
        path = os.path.join(PORT_DIR, *n.split(".")) + (
            "/__init__.py" if n == "parallel" else ".py")
        with open(path) as f:
            src = f.read()
        assert not re.search(r"^\s*(try\s*:|except\b)", src, re.M), path
    from ray_tracer_fragment_shader_tpu_torch.oracle import native
    assert native.BUILD_DIR == os.path.join(PORT_DIR, "_build")
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    assert native.SRC == os.path.join(PORT_DIR, "oracle", "cpp",
                                      "reference_oracle.cpp")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "ray_tracer_fragment_shader_tpu_torch/_build/" in f.read()


def test_oracle_and_grad_bar_import_no_jax():
    """The card's machine has no JAX: the port's oracle copy and the grad
    bar it referees import none of it, nor the JAX package (whose
    oracle imports jax through its scene module)."""
    code = (
        "import sys\n"
        "import ray_tracer_fragment_shader_tpu_torch.grad_bar\n"
        "import ray_tracer_fragment_shader_tpu_torch.oracle.gradcheck\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ray_tracer_fragment_shader_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    with open(os.path.join(PORT_DIR, "grad_bar.py")) as f:
        assert not re.search(r"^\s*(try\s*:|except\b)", f.read(), re.M)


def test_split_mode_sources_and_entries_are_listed():
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    assert "fit_grads.cu" in cuda_build.SOURCES
    assert {"rtfs_render_chain_residuals", "rtfs_render_tree_residuals",
            "rtfs_fit_grads"} <= set(cuda_build._ENTRIES)


def test_bench_and_probes_import_no_jax_and_have_no_fallback():
    """The bench and the probes run on the card's machine, which has no
    JAX; a failed probe build or launch must fail them, never fall back."""
    code = (
        "import sys\n"
        "import ray_tracer_fragment_shader_tpu_torch.bench\n"
        "import ray_tracer_fragment_shader_tpu_torch.probes.op_probe\n"
        "import ray_tracer_fragment_shader_tpu_torch.probes.bf16_probe\n"
        "import ray_tracer_fragment_shader_tpu_torch.probes.pressure_probe\n"
        "import ray_tracer_fragment_shader_tpu_torch.probes."
        "roofline_validate\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ray_tracer_fragment_shader_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    paths = [os.path.join(PORT_DIR, "bench.py"),
             os.path.join(PORT_DIR, "utils", "roofline.py")]
    probes = os.path.join(PORT_DIR, "probes")
    paths += [os.path.join(probes, n) for n in sorted(os.listdir(probes))
              if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not re.search(r"^\s*(try\s*:|except\b)", src, re.M), path
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    assert set(cuda_build.PROBE_SOURCES) == set(cuda_build.PROBE_ENTRIES)
    # built as the kernels they price: no fused multiply-add
    for name in cuda_build.PROBE_SOURCES:
        assert cuda_build.SOURCE_FLAGS[name] == ("-fmad=false",), name


def test_bf16_variant_sources_entries_and_ab_script():
    """The bf16_shading variants are instantiations of the listed sources,
    each built with -fmad=false (so each bf16 multiply and add rounds
    alone, as the plain version's); every render and one-dispatch fit
    entry takes the ``bf16`` flag; bf16_ab.py imports no JAX and holds no
    try/except."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    for name in cuda_build.SOURCES:
        if name.endswith(".cu"):
            assert cuda_build.SOURCE_FLAGS[name] == ("-fmad=false",), name
    csrc = os.path.join(PORT_DIR, "kernels", "csrc")
    for name, entries in (("render_chain.cu", ("rtfs_render_chain",
                                               "rtfs_render_packed",
                                               "rtfs_render_chain_residuals")),
                          ("render_tree.cu", ("rtfs_render_tree",
                                              "rtfs_render_tree_residuals")),
                          ("adjoint_fused.cu", ("rtfs_fused_adjoint",
                                                "rtfs_recompute_adjoint"))):
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        assert "BF16" in src, name
        for entry in entries:
            sig = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S)
            assert sig and re.search(r"\bint bf16\b", sig.group(1)), entry
    with open(os.path.join(csrc, "tile_ops.cuh")) as f:
        src = f.read()
    # each bf16 operation through an intrinsic that is never contracted
    assert "__hfma" not in src and "__hmul_rn" in src and "__hadd_rn" in src
    code = ("import sys\n"
            "import ray_tracer_fragment_shader_tpu_torch.bf16_ab\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ray_tracer_fragment_shader_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    with open(os.path.join(PORT_DIR, "bf16_ab.py")) as f:
        assert not re.search(r"^\s*(try\s*:|except\b)", f.read(), re.M)


def test_compacted_adjoints_share_the_live_list_and_add_no_floats_atomically():
    """K4, K7 and K8 take the live list (ids, count) that rtfs_live_list
    builds; no adjoint source adds floats atomically; the wrappers' block
    cap, stage size and tree caps are the sources'; adjoint_ab.py holds no
    try/except."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import cuda_build
    assert "rtfs_live_list" in cuda_build._ENTRIES
    csrc = os.path.join(PORT_DIR, "kernels", "csrc")
    srcs = {}
    for name in ("adjoint_ops.cuh", "adjoint_packed.cu", "adjoint_fused.cu",
                 "fit_grads.cu"):
        with open(os.path.join(csrc, name)) as f:
            srcs[name] = f.read()
        assert "atomicAdd" not in srcs[name], name
    for name, entry in (("adjoint_packed.cu", "rtfs_adjoint_packed"),
                        ("adjoint_fused.cu", "rtfs_recompute_adjoint"),
                        ("fit_grads.cu", "rtfs_fit_grads")):
        sig = re.search(rf'extern "C" int {entry}\((.*?)\)', srcs[name],
                        re.S).group(1)
        assert re.search(r"const int\* ids,\s*const int\* count", sig), entry
    ops = srcs["adjoint_ops.cuh"]
    assert re.search(rf"kAdjGridCap = {AF.ADJOINT_GRID_CAP};", ops)
    assert re.search(r"kRecFloats = 13;", ops)
    assert AF.ADJOINT_STAGE_FLOATS == (AF.ADJOINT_THREADS // 32) * 32 * 13
    caps = re.search(r"kTreeAdjDepthCaps\[\] = \{([\d, ]+)\}",
                     srcs["adjoint_fused.cu"]).group(1)
    assert tuple(int(c) for c in caps.split(",")) == \
        AF.TREE_ADJOINT_DEPTH_CAPS
    with open(os.path.join(PORT_DIR, "adjoint_ab.py")) as f:
        assert not re.search(r"^\s*(try\s*:|except\b)", f.read(), re.M)
