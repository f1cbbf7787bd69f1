"""The chain forward's A/B harness and lane counts on the CPU: the lane
efficiency of the one-pixel-a-lane sweeps against a hand count on a
2-sphere, 64-pixel frame, the SASS census on a synthetic listing, and
``forward_ab.py``'s CPU path (the port against itself, every output
compared) at 32^2."""
import json
import os

import numpy as np
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu_torch import forward_ab
from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
from ray_tracer_fragment_shader_tpu_torch.kernels.adjoint_fused import (
    scene_tables)
from ray_tracer_fragment_shader_tpu_torch.config import RenderConfig
from ray_tracer_fragment_shader_tpu_torch.scene.builder import SceneBuilder
from ray_tracer_fragment_shader_tpu_torch.utils import opcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: primary rays that hit sphere A, per warp of the 64-pixel frame
HITS = (20, 8)


def two_sphere_frame(depth: int = 0):
    """Sphere A straight ahead of an eye at the origin, sphere B off to the
    side, one light above: 64 rays, the first HITS[w] of warp w toward A,
    the rest away from both.  Every shadow ray from A is lit."""
    scene = (SceneBuilder(scene_radius=None)
             .add_sphere((0.0, 0.0, -10.0), radius=1.0)
             .add_sphere((5.0, 0.0, -10.0), radius=1.0)
             .add_light_world((0.0, 5.0, 0.0))
             .build())
    cfg = RenderConfig(width=8, height=8, max_depth=depth)
    _, tables, kw = scene_tables(scene, cfg, "cpu")
    v = np.zeros((64, 3), np.float32)
    for w, n in enumerate(HITS):
        v[32 * w:32 * w + n] = (0.0, 0.0, -1.0)
        v[32 * w + n:32 * w + 32] = (0.0, 0.0, 1.0)
    return tables, torch.from_numpy(v), [0.0, 0.0, 0.0], kw


def test_two_sphere_frame_hits_as_designed():
    tables, v, eye, kw = two_sphere_frame()
    _, res = K.render_residuals_ref(tables, v, eye, tree=False, **kw)
    # primitive ids: the triangle table's one padding row is id 0
    assert tables["tri"].shape[0] == 1 and tables["tri"][0, 19] == 0.0
    want = torch.full((64,), -1.0)
    for w, n in enumerate(HITS):
        want[32 * w:32 * w + n] = 1.0
    assert torch.equal(res["bi"][0], want)
    assert bool((res["lit"][0, 0][want == 1.0] == 1.0).all())


def test_lane_efficiency_against_a_hand_count():
    tables, v, eye, kw = two_sphere_frame()
    eff = opcount.lane_efficiency(tables, v, eye,
                                  **{k: x for k, x in kw.items()
                                     if k != "bf16"})
    # closest hit: all 64 lanes test both spheres, 2 steps a warp
    assert eff["closest"] == dict(tests=128, warp_steps=4, efficiency=1.0)
    # shadow: a hit lane tests B alone (A is its origin), 1 step a warp
    assert eff["shadow"] == dict(tests=28, warp_steps=2,
                                 efficiency=28 / 64)


SASS = """
        Function : _ZN4rtfs19render_chain_kernelILb0ELNS_8ChainOutE1ELb1EEEvPKfNS_6ParamsES3_Pfi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FMUL R6, R4, R5 ;
        /*0030*/                   FADD R6, R6, R7 ;
        /*0040*/                   MUFU.RCP R8, R6 ;
        /*0050*/               @P0 BRA `(.L_x_0) ;
        /*0060*/                   EXIT ;
"""


def test_census_counts_a_synthetic_loop(monkeypatch):
    monkeypatch.setattr(forward_ab, "MIN_TEST_FP32", 2)
    funcs = forward_ab.parse_sass(SASS, "render_chain_kernel")
    (name, ins), = funcs.items()
    assert forward_ab.inst_key(name) == "0,1,1"
    (row,) = forward_ab.loop_census(ins)
    assert (row["start"], row["end"]) == ("0x10", "0x50")
    assert list(row["per_test"]) == ["triangle"]
    assert row["classes"] == dict(lds=1, fp32=2, mufu=1, branch=1)
    assert row["per_test"]["triangle"]["all"] == 5.0


def test_harness_cpu_path_against_itself(tmp_path):
    out = tmp_path / "ab.json"
    assert forward_ab.main(["--cpu", "--size", "32", "--other", REPO,
                            "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    kernels = {r["kernel"] for r in rows}
    assert kernels == {"render_chain", "render_packed",
                       "render_chain_residuals", "render_tree",
                       "render_tree_residuals", "fused_adjoint",
                       "recompute_adjoint"}
    assert len(rows) == 42 and all(r["equal_to_other"] for r in rows)
