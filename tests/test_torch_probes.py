"""The plain versions of the card's probes P1 (kernels/probe.py::
op_chain_ref) and P2 (bf16_chain_ref) against the JAX package's
``scripts/vpu_op_probe.py::_chain_kernel`` and
``scripts/bf16_probe.py::_chain_kernel`` in Pallas interpret mode: one
8x256 tile, two chains, four steps, on inputs from numpy's
default_rng(0).  On the CPU the wrappers run these plain versions.

Tolerances (max|diff| / max|JAX|): 1e-6 for the f32 chains (the same
operations in the same order; ulps from rsqrt/sqrt); for ``recip`` 2^-6
and ``recip_nr`` 4*2^-16, because JAX's interpret mode lowers
``pl.reciprocal(approx=True)`` to a bf16 reciprocal (two bf16 roundings a
step, four steps; one Newton step squares that error), where the port's
plain version divides exactly as the card's rcp.approx.f32 nearly does;
2^-7 for the bf16 chains (one bf16 rounding of rsqrt's result).

The JAX scripts set a persistent compilation cache when imported; the
fixture restores the config after loading them.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"recip": 2.0 ** -6, "recip_nr": 4 * 2.0 ** -16}
BF16_TOL = 2.0 ** -7


def _load_script(name):
    prev = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", prev[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev[1])
    return mod


def _x():
    rng = np.random.default_rng(0)
    return (0.5 + 0.2 * rng.random((8, 256))).astype(np.float32)


def _run(kernel, **kw):
    x = jnp.asarray(_x())
    tile = pl.BlockSpec((8, 256), lambda i: (i, 0))
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, iters=4, nc=2, **kw), grid=(1,),
        in_specs=[tile], out_specs=tile, interpret=True,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(x))


@pytest.fixture(scope="module")
def jax_p1():
    mod = _load_script("vpu_op_probe")
    return {inj: _run(mod._chain_kernel, inject=inj) for inj in PR.INJECTS}


@pytest.fixture(scope="module")
def jax_p2():
    mod = _load_script("bf16_probe")
    return {(inj, bf16): _run(mod._chain_kernel, inject=inj,
                              dtype=jnp.bfloat16 if bf16 else jnp.float32)
            for inj in PR.BF16_INJECTS for bf16 in (False, True)}


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("inject", PR.INJECTS)
def test_op_chain_plain_matches_jax(jax_p1, inject):
    before = dict(K.LAUNCHES)
    got = PR.op_chain(torch.from_numpy(_x()), inject=inject, iters=4,
                      nc=2).numpy()
    assert K.LAUNCHES == before  # CPU tensors never launch
    ref = jax_p1[inject]
    assert np.isfinite(got).all() and got.shape == ref.shape
    if inject == "floor":  # y*1.618 < 2 twice over: every chain reaches 0
        assert np.array_equal(got, ref)
    else:
        assert _rel(got, ref) <= TOL.get(inject, 1e-6)


@pytest.mark.parametrize("inject,bf16", [(i, b) for i in PR.BF16_INJECTS
                                         for b in (False, True)])
def test_bf16_chain_plain_matches_jax(jax_p2, inject, bf16):
    got = PR.bf16_chain(torch.from_numpy(_x()), inject=inject, bf16=bf16,
                        iters=4, nc=2).numpy()
    ref = jax_p2[(inject, bf16)]
    assert np.isfinite(got).all() and got.dtype == np.float32
    assert _rel(got, ref) <= (BF16_TOL if bf16 else 1e-6)


def test_probe_wrappers_check_their_inputs():
    x = torch.from_numpy(_x())
    with pytest.raises(ValueError):
        PR.op_chain(x[:4], inject="mul", iters=1, nc=2)  # not 8x256 tiles
    with pytest.raises(ValueError):
        PR.op_chain(x, inject="fma", iters=1, nc=2)
    with pytest.raises(ValueError):
        PR.bf16_chain(x, inject="div", bf16=True, iters=1, nc=2)
    with pytest.raises(ValueError):
        PR.mix_chain(x.double(), iters=1, nc=2, sched=("basic",))
    with pytest.raises(ValueError):
        PR.mix_chain(x, iters=-1, nc=2, sched=("basic",))
    with pytest.raises(ValueError):
        PR.mix_chain(x.to("meta"), iters=1, nc=2, sched=("basic",))


def test_mix_defines_name_the_schedule_without_commas():
    sched = ("basic", "cmp", "select", "div")
    d = PR.mix_defines(sched, (2, 16))
    assert d[0] == "RTFS_MIX_SCHED=s0217" and "," not in "".join(d)
    assert d[1] == "RTFS_MIX_NC_MASK=%d" % ((1 << 1) | (1 << 6))
    with pytest.raises(ValueError):
        PR.mix_defines(sched, (3,))


def test_ptxas_log_gives_registers_and_spills_per_instantiation():
    log = ("ptxas info    : Function properties for "
           "_ZN4rtfs10mix_kernelILi96EEEvPKfPfii\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 255 registers, used 0 barriers\n"
           "ptxas info    : Function properties for "
           "_ZN4rtfs9op_kernelILi3ELi8EEEvPKfPfii\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 26 registers, used 0 barriers\n")
    assert PR.ptxas_resources(log, "mix_kernel") == {
        (96,): dict(spill_stores=8, spill_loads=4, registers=255)}
    assert PR.ptxas_resources(log, "op_kernel") == {
        (3, 8): dict(spill_stores=0, spill_loads=0, registers=26)}
