"""P2's bound priced pipe by pipe (probes/common.py::chain_step_bound), on
hand-worked cases at the card's 132 SMs and 1980 MHz.  No JAX, no card:
each test takes well under a second.

At the probes' timed inputs (132 x 8 tiles of 2048 elements, 16 chains,
8 iterations) a run holds 2,162,688 x 16 x 8 = 276,824,064 element-steps.
"""
import pytest

from ray_tracer_fragment_shader_tpu_torch.probes import common as C

SMS, MHZ = 132, 1980.0
CLOCK = SMS * MHZ * 1e6
ELEMENT_STEPS = 2_162_688 * 16 * 8


def bound(inject, bf16):
    return C.chain_step_bound(C.P2_STEPS[(inject, bf16)], ELEMENT_STEPS,
                              SMS, MHZ)


def test_f32_mul_is_set_by_the_fp32_lanes():
    b = bound("mul", False)
    assert b["by"] == "fp32"  # issue ties it: one instruction a step
    assert b["seconds"] == pytest.approx(ELEMENT_STEPS / (128 * CLOCK))
    assert b["seconds"] * 1e3 == pytest.approx(0.0082747, rel=1e-4)
    assert b["pipes"]["issue"] == pytest.approx(b["seconds"])


def test_bf16_mul_is_set_by_the_packed_lanes_at_two_elements():
    b = bound("mul", True)
    assert b["by"] == "fp16x2"
    assert b["seconds"] == pytest.approx(ELEMENT_STEPS / (2 * 128 * CLOCK))
    assert b["seconds"] == pytest.approx(bound("mul", False)["seconds"] / 2)


def test_bf16_mix_is_set_by_the_mufu():
    """Two rsqrt a pair, one an element, at 16 a clock an SM: 2.768e8 /
    (16 x 132 x 1980 MHz) = 0.0662 ms, above the issue time of its 15
    instructions a pair (0.0621 ms)."""
    b = bound("mix", True)
    assert b["by"] == "mufu"
    assert b["seconds"] == pytest.approx(ELEMENT_STEPS / (16 * CLOCK))
    assert b["seconds"] * 1e3 == pytest.approx(0.0662, abs=5e-5)
    assert b["pipes"]["issue"] * 1e3 == pytest.approx(
        ELEMENT_STEPS / 2 * 15 / 32 / (4 * CLOCK) * 1e3)
    assert b["pipes"]["issue"] < b["seconds"]


def test_f32_mix_is_set_by_issue():
    """11 instructions an element: 11 / 32 warp-instructions at 4 a clock
    an SM, 0.0910 ms, above its 7 FP32 (0.0579), one MUFU (0.0662) and 3
    compare-and-select (0.0497) times."""
    b = bound("mix", False)
    assert b["by"] == "issue"
    assert b["seconds"] == pytest.approx(ELEMENT_STEPS * 11 / 32
                                         / (4 * CLOCK))
    assert b["seconds"] * 1e3 == pytest.approx(0.0910, abs=5e-5)
    assert b["pipes"]["fp32"] * 1e3 == pytest.approx(0.0579, abs=5e-5)
    assert max(v for k, v in b["pipes"].items() if k != "issue") < \
        b["seconds"]


def test_a_step_of_many_cheap_instructions_is_set_by_issue():
    """Two FP32 and one bit operation a step: each pipe is busy for two
    thirds of the time its three instructions take to issue."""
    b = C.chain_step_bound(dict(elements=1, fp32=2, alu=1), 32 * 4 * CLOCK,
                           SMS, MHZ)
    assert b["by"] == "issue"
    assert b["seconds"] == pytest.approx(3.0)
    assert b["pipes"]["fp32"] == pytest.approx(2.0)
    assert b["pipes"]["alu"] == pytest.approx(2.0)


def test_unknown_pipe_is_refused():
    with pytest.raises(ValueError):
        C.chain_step_bound(dict(elements=1, tensor=1), 1.0, SMS, MHZ)


# -------------------------------------------------- the SASS census (P2)

def _sass(lines):
    """Instructions in ``cuobjdump -sass``'s layout, addresses from 0."""
    return "\n".join(f"        /*{16 * i:04x}*/                   {t} ;"
                     f"                       /* 0x000000000000 */"
                     for i, t in enumerate(lines))


#: a bf16 chain kernel of two chains, its loop unrolled by 4: a grid-stride
#: loop (loads and stores) around the chain loop (8 steps: 4 packed
#: multiplies, 4 on HFMA2.MMA, the counter), then an out-of-line function
#: (CALL to RET) whose loop is larger
_KERNEL = _sass([
    "LDC R1, c[0x0][0x28]",                                  # 0x000
    "LDG.E.CONSTANT R2, desc[UR8][R6.64]",                   # 0x010
    "HMUL2.BF16_V2 R3, R3, R2",                              # 0x020 loop
    "HFMA2.MMA.BF16_V2 R4, R4, R2, -RZ",
    "HMUL2.BF16_V2 R3, R3, R2",
    "HFMA2.MMA.BF16_V2 R4, R4, R2, -RZ",
    "HMUL2.BF16_V2 R3, R3, R2",
    "HFMA2.MMA.BF16_V2 R4, R4, R2, -RZ",
    "HMUL2.BF16_V2 R3, R3, R2",
    "HFMA2.MMA.BF16_V2 R4, R4, R2, -RZ",
    "IADD3 R9, R9, -0x4, RZ",
    "ISETP.NE.AND P1, PT, R9, RZ, PT",
    "@P1 BRA 0x20",                                          # 0x0c0
    "@P2 CALL.REL.NOINC 0x120",                              # 0x0d0
    "STG.E desc[UR8][R8.64], R3",                            # 0x0e0
    "@!P0 BRA 0x10",                                         # 0x0f0
    "EXIT",                                                  # 0x100
    "BRA 0x110",                                             # 0x110
    "MUFU.RSQ R5, R5",                                       # 0x120 callee
    "FMUL R5, R5, 4096",
    "FSETP.GEU.AND P3, PT, |R5|, 1.1754943508222875e-38, PT",
    "F2FP.BF16.F32.PACK_AB R5, R6, R5",
    "LOP3.LUT R6, R5, 0xffff0000, RZ, 0xc0, !PT",
    "HSET2.BF16_V2.GT.AND R7, R5, R4.H0_H0, PT",
    "HADD2.BF16_V2 R5, R5, R4.H1_H1",
    "SHF.L.U32 R6, R5, 0x10, RZ",
    "VIMNMX.S16x2 R8, R8, R5, PT",
    "MUFU.RSQ R5, R5",
    "MUFU.RSQ R5, R5",
    "MUFU.RSQ R5, R5",
    "MUFU.RSQ R5, R5",
    "@P3 BRA 0x120",                                         # 0x1f0
    "RET.REL.NODEC R18 0x0",
])
_LIB = ("\tcode for sm_90a\n\t\tFunction : _ZN4rtfs11bf16_kernelILi0ELi2EEEvPKfPfii\n"
        "\t.headerflags\t@\"EF_CUDA_SM90\"\n" + _KERNEL + "\n"
        "\t\tFunction : _ZN4rtfs10f32_kernelILi0ELi2EEEvPKfPfii\n"
        + _sass(["EXIT"]) + "\n")


def test_sass_instructions_split_by_instantiation():
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    ins = PR.sass_instructions(_LIB, "bf16_kernel")
    assert list(ins) == [(0, 2)]
    addr, op, text = ins[(0, 2)][12]
    assert (addr, op, text) == (0xC0, "BRA", "@P1 BRA 0x20")
    assert ins[(0, 2)][3][1] == "HFMA2.MMA.BF16_V2"
    assert list(PR.sass_instructions(_LIB, "f32_kernel")) == [(0, 2)]


def test_hot_loop_is_the_chain_loop_not_the_grid_loop_or_a_callee():
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    body = PR.hot_loop(PR.sass_instructions(_LIB, "bf16_kernel")[(0, 2)])
    assert [a for a, _, _ in body] == list(range(0x20, 0xD0, 0x10))


def test_sass_pipes():
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    want = {"HMUL2.BF16_V2": "fp16x2", "HADD2.BF16_V2": "fp16x2",
            "HSET2.BF16_V2.GT.AND": "fp16x2", "HMUL2": "fp16x2",
            "HFMA2.MMA.BF16_V2": "fp16x2_mma", "HFMA2.MMA": "fp16x2_mma",
            "FMUL": "fp32", "FADD": "fp32", "MUFU.RSQ": "mufu",
            "F2FP.BF16.F32.PACK_AB": "conv", "BRA": "control",
            "ISETP.NE.AND": "control", "IADD3": "control",
            "LOP3.LUT": "alu", "SHF.L.U32": "alu", "VIMNMX.S16x2": "alu",
            "FSETP.GEU.AND": "alu", "PRMT": "alu"}
    assert {op: PR.sass_pipe(op) for op in want} == want


def test_step_census_counts_a_step(monkeypatch):
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    monkeypatch.setattr(PR, "sass_text", lambda library: _LIB)
    c = PR.step_census("lib.so", "bf16_kernel")[(0, 2)]
    assert c["body"] == 11
    assert c["pipes"] == {"control": 3 / 8, "fp16x2": 0.5,
                          "fp16x2_mma": 0.5}
    assert c["issue"] == pytest.approx(11 / 8)
    assert c["opcodes"]["HMUL2.BF16_V2"] == 0.5
    # the f32 instantiation has no loop: an empty census
    e = PR.step_census("lib.so", "f32_kernel")[(0, 2)]
    assert e["body"] == 0 and e["pipes"] == {}


def test_bf16_chain_plain_takes_every_chain_count():
    """On the CPU the wrapper runs its plain version, at P2's new chain
    count 32 too, and counts no launch."""
    import torch
    from ray_tracer_fragment_shader_tpu_torch.kernels import probe as PR
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.utils.roofline import (
        probe_input)
    x = probe_input(1, "cpu")
    before = dict(K.LAUNCHES)
    assert PR.BF16_NCS[-1] == 32
    y = PR.bf16_chain(x, inject="mul", bf16=True, iters=2, nc=32)
    assert torch.equal(y, PR.bf16_chain_ref(x, inject="mul", bf16=True,
                                            iters=2, nc=32))
    assert K.LAUNCHES == before
