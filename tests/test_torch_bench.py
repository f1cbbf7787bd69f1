"""The port's bench (ray_tracer_fragment_shader_tpu_torch/bench.py) on the
CPU, through the kernels' plain versions, at 32^2 depth 1: one JSON line
with the JAX bench's metric name and keys, ``vs_baseline`` null (no device
rate off the card, as the JAX bench's is null off the TPU), and the JAX
knobs the port does not have refused with ``ValueError``."""
import json

import pytest

from ray_tracer_fragment_shader_tpu_torch import bench, cli

SMALL = {"BENCH_SIZE": "32", "BENCH_DEPTH": "1", "BENCH_ITERS": "2",
         "BENCH_REPS": "1"}
# the JAX bench's JSON keys (root bench.py), without its SOL block
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "ray_accounting",
            "device", "backend", "adjoint", "block", "step_time_ms",
            "step_time_ms_reps", "timing"}


@pytest.fixture
def small(monkeypatch):
    for k in list(bench.UNPORTED) + ["BENCH_BACKEND", "BENCH_ADJOINT",
                                     "BENCH_PRESET", "BENCH_FORWARD_ONLY"]:
        monkeypatch.delenv(k, raising=False)
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


@pytest.mark.parametrize("adjoint", ["twophase", "fused2"])
def test_bench_prints_one_json_line_with_the_jax_metric(small, capsys,
                                                        adjoint):
    small.setenv("BENCH_ADJOINT", adjoint)
    out = bench.main([], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["metric"] == "rays_per_s_per_chip_fwd_bwd_32x32_depth1"
    assert JAX_KEYS <= set(out) and "power_limit" in out
    assert out["vs_baseline"] is None and out["device"] == "cpu"
    assert out["adjoint"] == adjoint and out["unit"] == "rays/s"
    assert out["value"] > 0 and len(out["step_time_ms_reps"]) == 1
    assert out["timing"]["iters"] == 2


def test_cli_bench_forward_only(small, capsys):
    small.setenv("BENCH_FORWARD_ONLY", "1")
    out = cli.main(["bench", "--cpu", "--size", "32", "--depth", "1"])
    assert out["metric"] == "rays_per_s_per_chip_fwd_32x32_depth1"
    assert out["adjoint"] is None and out["vs_baseline"] is None
    assert json.loads(capsys.readouterr().out.strip()) == out


@pytest.mark.parametrize("key,value", [
    ("BENCH_BACKEND", "xla"), ("BENCH_BLOCK_H", "8"),
    ("BENCH_BLOCK_W", "512"), ("BENCH_CHUNK", "4096"),
    ("BENCH_ADJOINT", "xla"),
])
def test_unported_knobs_raise(small, key, value):
    small.setenv(key, value)
    with pytest.raises(ValueError, match=key):
        bench.main([], device="cpu")
