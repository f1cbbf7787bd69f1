"""The per-test time limit (tests/time_limit.py) under the tier-1 command's
pytest-xdist options: a test past the limit fails with every thread's stack
dumped, and the worker lives on to run the rest of its file."""
import os
import re
import subprocess
import sys
import textwrap
import time

TESTS = os.path.dirname(os.path.abspath(__file__))

CHILD_CONFTEST = f"""
import sys
sys.path.insert(0, {TESTS!r})
from time_limit import TimeLimit


def pytest_configure(config):
    config.pluginmanager.register(TimeLimit(2), "time_limit")
"""

CHILD_TESTS = """
import time


def test_sleeps_past_the_limit():
    time.sleep(60)


def test_runs_after():
    assert True
"""


def test_limit_fails_the_test_and_the_worker_runs_on(tmp_path):
    (tmp_path / "conftest.py").write_text(textwrap.dedent(CHILD_CONFTEST))
    (tmp_path / "test_pair.py").write_text(textwrap.dedent(CHILD_TESTS))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "test_pair.py", "-v",
         "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
         "--dist", "loadfile", "-p", "no:randomly"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    elapsed = time.monotonic() - start
    out = proc.stdout + proc.stderr

    assert proc.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    failed = re.search(r"\[(gw\d+)\].*FAILED test_pair.py::"
                       r"test_sleeps_past_the_limit", out)
    passed = re.search(r"\[(gw\d+)\].*PASSED test_pair.py::test_runs_after",
                       out)
    assert failed and passed, out
    assert failed.group(1) == passed.group(1), out
    assert "call ran past the time limit of 2 s" in out, out
    assert "most recent call first" in out, out
    assert re.search(r'test_pair.py", line \d+ in test_sleeps_past_the_limit',
                     out), out
    assert "node down" not in out, out
    assert elapsed < 30, elapsed
