"""The metric arithmetic: the rate over a whole window, the p95 over all
frames, the busy union and idle gaps, the quartile spread, the trace's
split into units, and the frozen operation counts against the program's
own at a tiny size."""
import _bench_setup  # noqa: F401

import statistics

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, opcount, reference, stats
from _bench_setup import SEED, small_cell


def test_rate_is_all_work_over_all_seconds():
    assert stats.rate(120, 2.0) == 60.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_value():
    xs = list(np.random.default_rng(1).exponential(size=1001))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([3.0], 95) == 3.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4.0
    assert stats.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert stats.gaps([], 1, 2) == [(1, 2)]


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == (q3 - q1) / med


def test_trace_units_busy_and_breakdown():
    dev = [("k", 10, 20), ("a", 20, 25), ("k", 40, 50), ("a", 55, 60)]
    host = [("step", 0, 100), ("sync", 26, 39)]
    tr = harness.Trace(dev, host, (0, 100))
    assert tr.busy_s == 30e-9
    assert tr.units("k") == [[("k", 10, 20), ("a", 20, 25)],
                             [("k", 40, 50), ("a", 55, 60)]]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k", 20e-9]
    gaps = dict(b["idle_gaps"])
    assert gaps["sync"] == pytest.approx(15e-9)
    assert gaps["step"] == pytest.approx(55e-9)


def test_probes_roofline_and_step_mfu_take_each_probes_own_work():
    """Each probe unit's work over its own launches (roofline) and over its
    own span of the device's time line (the whole step's share)."""
    ms = 1_000_000
    k = harness.CHAIN_KERNEL
    dev = [(k, 0, 4 * ms), ("adjoint_packed_kernel", 5 * ms, 6 * ms),
           (k, 10 * ms, 12 * ms), ("adjoint_packed_kernel", 13 * ms, 15 * ms),
           (k, 20 * ms, 23 * ms)]
    tr = harness.Trace(dev, [], (0, 25 * ms))
    calls = []

    def work(ops, nbytes):
        def count():
            calls.append(ops)
            w = dict(ops=ops, bytes=nbytes)
            return dict(k3=w, k4=w, ops=2 * ops)
        return count
    rec = harness.Record(cell=None, kind="fit", chips=1, width=1, height=1,
                         setup_s=0.0, window_s=0.025, units=3,
                         latencies_s=[], trace=tr,
                         probes={0: work(67e9, 0), 2: work(134e9, 0)})
    # bounds 1 ms and 2 ms; K3 took 4 ms and 3 ms
    assert harness.roofline(rec, "k3", k) == pytest.approx(100 * 3 / 7)
    # K4 ran in unit 0 only (1 ms against its 1 ms bound)
    assert harness.roofline(rec, "k4", *harness.K4_KERNELS) == \
        pytest.approx(100.0)
    # spans 10 ms (to the next unit) and 5 ms (to the window's end)
    assert harness.step_mfu(rec) == pytest.approx(
        100 * 2 * 201e9 / (0.015 * opcount.PEAK_FP32_FLOPS))
    assert sorted(calls) == [67e9, 134e9]
    rec.units = 4     # the trace no longer splits into the window's units
    rec._probed = None
    assert harness.roofline(rec, "k3", k) is None
    assert harness.step_mfu(rec) is None


def test_frozen_counts_equal_the_programs():
    """``opcount`` on the reference's counts gives the program's own
    ``utils/opcount.py`` figures for K3 (packed forward) and K4."""
    port = pytest.importorskip("ray_tracer_fragment_shader_tpu_torch")
    from ray_tracer_fragment_shader_tpu_torch.kernels import (
        adjoint_fused as AF)
    from ray_tracer_fragment_shader_tpu_torch.kernels import render as K
    from ray_tracer_fragment_shader_tpu_torch.utils import opcount as P
    cell = small_cell("config5_spheres64.fit_4096", 16)
    cfg = cell.config
    W, D = cfg["width"], cfg["max_depth"]
    arrays = inputs.scene_arrays(cfg["scene"], SEED)
    base = reference.scene_leaves(arrays, "cpu")
    target, _, _ = reference.render(arrays, base, cfg["camera"], W, W,
                                    depth=D, device="cpu")
    leaves = dict(base)
    leaves["sph_center"] = base["sph_center"] + torch.from_numpy(
        inputs.job_offsets(arrays, SEED, 1, 1.5)[0])
    img, topo, counts = reference.render(arrays, leaves, cfg["camera"], W, W,
                                         depth=D, device="cpu", count=True)
    tab = reference.tables(arrays, leaves, "cpu")
    mine_f = opcount.forward_work(counts, W * W, depth=D, lights=tab["nl"],
                                  packed=True)
    mine_a = opcount.adjoint_work(topo, ((img - target) != 0).any(-1),
                                  nt=tab["nt"], ns=tab["ns"],
                                  materials=int(tab["mat"].shape[0]),
                                  lights=tab["nl"], depth=D)
    # the program's counts on the same inputs
    from ray_tracer_fragment_shader_tpu_torch.config import (CameraConfig,
                                                             RenderConfig)
    from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera
    scene = port.FlatScene.from_numpy(arrays, **inputs.scene_meta(arrays))
    scene = scene.replace(**leaves)
    cam = cfg["camera"]
    camera = Camera.from_config(
        CameraConfig(eye=tuple(cam["eye"]), look_at=tuple(cam["look_at"]),
                     up=tuple(cam["up"]), pixel_scale=cam["pixel_scale"]),
        W, W)
    rcfg = RenderConfig(width=W, height=W, max_depth=D, samples=1)
    prep = AF.prepare_fit_inputs(camera, rcfg, target.reshape(W, W, 3),
                                 device="cpu")
    _, t, kw, akw = AF.kernel_inputs(scene, rcfg, W * W, device="cpu")
    theirs_f = P.forward_work(t, prep["v"], prep["eye"], packed=True, **kw)
    pimg, pk = K.render_packed(t, prep["v"], prep["eye"], pack=akw["pack"],
                               **kw)
    theirs_a = P.adjoint_work(t, pimg, prep["target"], prep["mask"], pk,
                              pack=akw["pack"], nl=akw["nl"],
                              depth=akw["depth"],
                              want_trans=akw["want_trans"])
    assert mine_f["ops"] == theirs_f["ops"]
    assert mine_f["bytes"] == theirs_f["bytes"]
    assert mine_a["ops"] == theirs_a["ops"]
    assert mine_a["bytes"] == theirs_a["bytes"]
    assert opcount.bound_ms(mine_f["ops"], mine_f["bytes"]) == \
        pytest.approx(P.bound_ms(theirs_f["ops"], theirs_f["bytes"])[0])
