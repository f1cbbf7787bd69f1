"""The ``slow`` marks of the root conftest.py: ``-m slow`` selects exactly
the tests its ``SLOW`` lists, each of them found in the six JAX-reference
files, so a renamed test cannot slip back into tier 1 or out of it."""
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["tests/test_adjoint.py", "tests/test_adjoint_fused.py",
         "tests/test_adjoint_tree.py", "tests/test_bf16_shading.py",
         "tests/test_parallel_pallas.py", "tests/test_scaling.py"]


def _slow():
    spec = importlib.util.spec_from_file_location(
        "root_conftest", os.path.join(REPO, "conftest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.SLOW


def test_minus_m_slow_selects_exactly_the_listed_tests():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m", "slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", *FILES],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    selected = {line.strip() for line in proc.stdout.splitlines()
                if "::" in line}
    assert selected == _slow(), out
