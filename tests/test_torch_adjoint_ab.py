"""K6's records and the adjoints' A/B harness on the CPU: the plain model
of the record scratch K6's chain forward writes (``fused_records_ref``)
against the plain residual forward's planes on the live pixels, the tree
kernel's lane count against a hand count, the ptxas log parser, and
``adjoint_ab.py``'s CPU path (the port against itself, every kernel under
every cotangent) at 8^2.  No JAX."""
import json
import os

import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch import adjoint_ab, forward_ab
from ray_tracer_fragment_shader_tpu_torch.kernels import adjoint_fused as AF
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.scene import presets
from ray_tracer_fragment_shader_tpu_torch.utils import opcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

SCENES = {
    "full_reflective d3": lambda: presets.full_reflective(size=12, depth=3),
    "glass_chain d3": lambda: presets.glass_chain(size=12, depth=3),
    "procedural_spheres d5": lambda: presets.procedural_spheres(
        n=16, size=12, depth=5),
    "pack_overflow d1, 15 lights": lambda: presets.pack_overflow(
        size=12, fractional=False),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_records_model_holds_the_residual_planes_of_live_pixels(name):
    """Each live pixel's records are its levels that hit, in order, each
    with the residual planes' bi, mid and lit bits at that level; every
    later level of the pixel misses, and the rest of its slot is
    unwritten."""
    x = adjoint_ab.inputs(SCENES[name](), CPU)
    assert not x["tree"]
    target, mask, gs, _ = adjoint_ab.cotangent(x, "live")
    live = ((gs * (x["own"] - target) * mask[:, None]) != 0).any(-1)
    assert bool(live.any())
    rec_n, rec = AF.fused_records_ref(x["tables"], x["v"], x["eye"],
                                      **x["kw"])
    res = adjoint_ab.residuals(x)
    levels = x["kw"]["depth"] + 1
    assert rec.shape == (levels, x["v"].shape[0], 4)
    most = 0
    for p in torch.nonzero(live).flatten().tolist():
        n = int(rec_n[p])
        assert rec[:n, p, 3].tolist() == list(range(n))
        for k in range(n):
            assert rec[k, p, 0] == res["bi"][k, p] >= 0
            assert rec[k, p, 1] == res["mid"][k, p]
            bits = sum(int(res["lit"][li, k, p]) << li
                       for li in range(x["kw"]["nl"]))
            assert rec[k, p, 2] == bits
        assert bool((res["bi"][n:, p] == -1).all())
        assert bool((rec[n:, p] == -1).all())
        most = max(most, n)
    assert most >= 2  # some pixel hits past its first level


def test_tree_lanes_at_depth_0_count_one_node_a_pixel():
    """At depth 0 each lane traces its root alone: nodes = P, one loop
    trip a warp, and a ragged last warp's missing lanes idle."""
    scene, cam, cfg = presets.fractional_glass(size=10, depth=0)
    x = forward_ab.forward_input(adjoint_ab.modules(), (scene, cam, cfg),
                                 CPU, False)
    kw = {k: v for k, v in x["kw"].items() if k != "bf16"}
    eff = opcount.tree_lane_efficiency(x["tables"], x["v"], x["eye"], **kw)
    assert eff == dict(nodes=100, warp_trips=4, efficiency=100 / 128)
    deep = opcount.tree_lane_efficiency(
        x["tables"], x["v"], x["eye"], **dict(kw, depth=3))
    assert deep["nodes"] > 100 and 0 < deep["efficiency"] <= 1


LOG = """ptxas info    : Function properties for _ZN4rtfs22records_adjoint_kernelILb1EEEvPKfNS_9AdjParamsES2_S2_S2_S2_PKNS_10NodeRecordEPKiS8_S8_Pfi
    1056 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 1056 bytes cumulative stack size
ptxas info    : Function properties for _ZN4rtfs19render_chain_kernelILb1ELNS_8ChainOutE3ELb0EEEvPKfNS_6ParamsES3_Pfi
    528 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 528 bytes cumulative stack size
"""


def test_ptxas_parser_reads_each_instantiation():
    assert forward_ab.ptxas_kernels(LOG, "records_adjoint_kernel") == {
        (1,): dict(stack=1056, spill_stores=0, spill_loads=0,
                   registers=96)}
    assert forward_ab.ptxas_kernels(LOG, "render_chain_kernel") == {
        (1, 3, 0): dict(stack=528, spill_stores=0, spill_loads=0,
                        registers=80)}


def test_harness_cpu_path_against_itself(tmp_path):
    out = tmp_path / "ab.json"
    assert adjoint_ab.main(["--cpu", "--size", "8", "--other", REPO,
                            "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert {r["kernel"] for r in rows} == {
        "adjoint_packed", "fit_grads", "fused_adjoint", "recompute_adjoint"}
    assert len(rows) == 44 and all(r["equal_to_other"] for r in rows)
    assert {r["cotangent"] for r in rows} == set(adjoint_ab.COTANGENTS)
