"""What a run loads: never JAX nor the JAX package (top-level names
compared whole: the program's name begins with the JAX package's), and
the reference nothing of the program."""
import _bench_setup  # noqa: F401

import ast
import glob
import json
import os
import subprocess
import sys

from _bench_setup import ROOT

BENCH = os.path.join(ROOT, "benchmark")
JAX_SIDE = {"jax", "jaxlib", "flax", "ray_tracer_fragment_shader_tpu"}
PORT = "ray_tracer_fragment_shader_tpu_torch"
#: the yardstick: none of it may take anything from the program
YARDSTICK = ("reference.py", "inputs.py", "opcount.py", "stats.py",
             "scenes/procedural_spheres.py")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_source_imports_jax():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 10
    for f in files:
        assert not set(_imports(f)) & JAX_SIDE, f


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        assert PORT not in set(_imports(os.path.join(BENCH, name))), name


def test_a_run_loads_no_jax_and_the_reference_alone_not_the_program():
    """A whole run in a fresh process (a fit cell, on the CPU), and the
    reference imported alone."""
    code = f"""
import sys, json, time
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads(1)
from benchmark import reference, inputs
alone = sorted({{m.split('.')[0] for m in sys.modules}})
sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})
import _bench_setup
res = _bench_setup.run_small("config5_spheres64.fit_4096", size=8,
                             seconds=0.2)
print(json.dumps(dict(alone=alone, correct=res["correct"],
                      after=sorted({{m.split('.')[0] for m in sys.modules}}))))
"""
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert PORT not in got["alone"]
    assert not set(got["alone"]) & JAX_SIDE
    assert got["correct"]
    assert PORT in got["after"]
    assert not set(got["after"]) & JAX_SIDE
