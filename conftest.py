"""Tier-1 policy for the test suite: a time limit on every test, and the
JAX-reference tests that are left out of tier 1 as ``slow``.

Tier 1 runs ``python -m pytest tests/ -m 'not slow' -n 6 --dist loadfile``
(ROADMAP.md, Tier-1 verify); ``python -m pytest -m slow tests/`` runs the
tests listed in ``SLOW`` on their own.
"""
import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

# Seconds each phase of a test (setup, call, teardown) may take before it
# fails with every thread's stack dumped: over 3x the slowest tier-1 test
# under the tier-1 command's six workers, tests/test_golden.py's
# reference_demo case at 296-376 s on 8 cores.  The tier-1 command itself is
# cut at 1470 s, so the limit ends a hang before that cut only if the hang
# starts in the run's first four minutes or so.
LIMIT = 1200

# JAX-reference tests that run the JAX package's Pallas kernels in interpret
# mode on the CPU and take minutes each: every test over 200 s of setup plus
# call under tier 1's contention, then the slowest of a file until its kept
# tests take at most 400 s.  Each behaviour they check has a port test in
# tier 1 (CHANGES.md names each).
SLOW = frozenset(f"tests/{t}" for t in (
    "test_adjoint.py::test_pallas_fit_descends",
    "test_adjoint_fused.py::test_matches_replay_adjoint",
    "test_adjoint_fused.py::test_single_kernel_matches_two_phase",
    "test_adjoint_fused.py::test_twophase_packed_matches_fused",
    "test_adjoint_fused.py::test_fused_fit_descends",
    "test_adjoint_fused.py::test_prepared_inputs_match_inline",
    "test_adjoint_fused.py::test_prep_provenance_checked",
    "test_adjoint_fused.py::test_make_fit_step_pallas_descends",
    "test_adjoint_fused.py::test_adaptive_matches_replay_backward_per_sample",
    "test_adjoint_tree.py::test_tree_l2_fit_descends",
    "test_adjoint_tree.py::test_fused_tree_adjoint_matches_xla_replay",
    "test_bf16_shading.py::test_bf16_shading_parity_bars[full_reflective]",
    "test_parallel_pallas.py::"
    "test_sharded_pallas_forward_matches_single_device",
    "test_parallel_pallas.py::test_sharded_pallas_fit_step_tree_scene",
    "test_scaling.py::test_scaling_sweep_pallas_fast_path",
))


def _time_limit():
    spec = importlib.util.spec_from_file_location(
        "time_limit", os.path.join(HERE, "tests", "time_limit.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TimeLimit


def pytest_configure(config):
    config.pluginmanager.register(_time_limit()(LIMIT), "time_limit")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # tryfirst: the marks must be on before ``-m`` deselects by them
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
