"""The port's bench (ray_tracer_fragment_shader_tpu_torch/bench.py) on the
CPU, through the kernels' plain versions, at 32^2 depth 1: one JSON line
with the JAX bench's metric name and keys, ``vs_baseline`` null (no device
rate off the card, as the JAX bench's is null off the TPU), the core
renderer's and the replay's steps behind the JAX bench's knobs, and the
tile knobs the port does not have refused with ``ValueError``."""
import importlib
import json

import pytest

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch import bench, cli
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K

SMALL = {"BENCH_SIZE": "32", "BENCH_DEPTH": "1", "BENCH_ITERS": "2",
         "BENCH_REPS": "1"}
# the JAX bench's JSON keys (root bench.py), without its SOL block
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "ray_accounting",
            "device", "backend", "adjoint", "block", "step_time_ms",
            "step_time_ms_reps", "timing"}


@pytest.fixture
def small(monkeypatch):
    for k in list(bench.UNPORTED) + ["BENCH_BACKEND", "BENCH_ADJOINT",
                                     "BENCH_PRESET", "BENCH_FORWARD_ONLY",
                                     "BENCH_CHUNK"]:
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
    ("BENCH_BLOCK_H", "8"), ("BENCH_BLOCK_W", "512"),
    ("BENCH_BACKEND", "tpu"),
])
def test_unported_knobs_raise(small, key, value):
    small.setenv(key, value)
    with pytest.raises(ValueError, match=key):
        bench.main([], device="cpu")


@pytest.mark.parametrize("env,path,adjoint", [
    ({"BENCH_BACKEND": "xla"}, "core", "autograd"),
    ({"BENCH_BACKEND": "xla", "BENCH_CHUNK": "300"}, "core", "autograd"),
    ({"BENCH_BACKEND": "xla", "BENCH_ADJOINT": "fused"}, "core",
     "autograd"),
    ({"BENCH_ADJOINT": "xla"}, "replay", "xla"),
    ({"BENCH_ADJOINT": "replay"}, "replay", "replay"),
], ids=["xla", "xla-chunk", "xla-fused", "adjoint-xla", "adjoint-replay"])
def test_core_and_replay_knobs_run(small, capsys, monkeypatch, env, path,
                                   adjoint):
    """``BENCH_BACKEND=xla`` steps the core renderer's ``l2_loss`` by
    autograd (whatever the adjoint, as the JAX bench), ``BENCH_CHUNK`` sets
    its chunk size, and any adjoint but the three kernel modes runs
    ``l2_loss_kernel`` (the JAX bench's ``l2_loss_pallas``); no op count
    covers either, so the SOL fields are null."""
    from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint as A
    # the module (diff/__init__.py's ``fit`` is the function)
    F = importlib.import_module(
        "ray_tracer_fragment_shader_tpu_torch.diff.fit")
    calls = {"core": 0, "replay": 0}
    for mod, name, key in ((F, "l2_loss", "core"),
                           (A, "l2_loss_kernel", "replay")):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    for k, v in env.items():
        small.setenv(k, v)
    out = bench.main([], device="cpu")
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert out["metric"] == "rays_per_s_per_chip_fwd_bwd_32x32_depth1"
    assert calls[path] >= 3 and calls[{"core": "replay",
                                       "replay": "core"}[path]] == 0
    assert out["adjoint"] == adjoint and out["value"] > 0
    assert out["backend"] == ("core" if path == "core" else "plain")
    assert out["vs_baseline"] is None and out["sol_fraction"] is None
    assert out["peak_memory_bytes"] is None  # no device memory off the card
    if path == "core":
        assert out["chunk_size"] == int(env.get("BENCH_CHUNK", 65536))
        assert out["block"] is None


def test_core_forward_only(small, capsys):
    small.setenv("BENCH_BACKEND", "xla")
    small.setenv("BENCH_FORWARD_ONLY", "1")
    before = dict(K.LAUNCHES)
    out = bench.main([], device="cpu")
    assert out["metric"] == "rays_per_s_per_chip_fwd_32x32_depth1"
    assert out["backend"] == "core" and out["adjoint"] is None
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="no op count"):
        bench.last_step_work(bench.knobs({"BENCH_BACKEND": "xla"}), "cpu")
    # forward only, the kernels' forward has its count whatever the adjoint
    work = bench.last_step_work(bench.knobs({
        "BENCH_FORWARD_ONLY": "1", "BENCH_ADJOINT": "replay",
        "BENCH_SIZE": "16", "BENCH_DEPTH": "1"}), "cpu")
    assert work["kernels"] == ["render_chain"] and not work["bwd"]
