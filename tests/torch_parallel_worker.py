"""One rank of the 2-process gloo group of tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py <rank> <world> <port> <out_dir>

Each rank brings the group up through ``initialize_multihost`` (gloo, on
the CPU) and runs every collective check of the port's ``parallel/``:
the ``all_gather`` renders, both sharded fit steps against the
single-process values it computes itself, their descent over 8 steps, the
``torch.distributed.checkpoint`` pair, ``scaling_sweep([1, 2])`` and
``dryrun_multichip(2)``.  Each check prints one JSON line,
``{"check": name, "rank": r, ...}``; the test reads them.  Imports torch
and the port only (no JAX), so the ranks start quickly.
"""
import dataclasses
import json
import os
import sys

rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)   # as the port's test modules (torch_cpu_threads.py)

from ray_tracer_fragment_shader_tpu_torch.core.renderer import (  # noqa: E402
    render_image, render_pixels)
from ray_tracer_fragment_shader_tpu_torch.diff.fit import (  # noqa: E402
    FitParams, l2_loss, make_fit_step_kernel, make_sharded_fit_step,
    make_sharded_fit_step_kernel)
from ray_tracer_fragment_shader_tpu_torch.kernels.render import (  # noqa: E402
    render_image_kernel)
from ray_tracer_fragment_shader_tpu_torch.ops.rays import Camera  # noqa: E402
from ray_tracer_fragment_shader_tpu_torch.parallel import (  # noqa: E402
    make_mesh, render_image_sharded, replicated, row_sharded,
    sharded_value_and_grad)
from ray_tracer_fragment_shader_tpu_torch.parallel.multihost import (  # noqa: E402
    dryrun_multichip, initialize_multihost, scaling_sweep)
from ray_tracer_fragment_shader_tpu_torch.parallel.shard import (  # noqa: E402
    _pixel_index_arrays, pad_pixels)
from ray_tracer_fragment_shader_tpu_torch.scene import presets  # noqa: E402
from ray_tracer_fragment_shader_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint_dcp, save_checkpoint_dcp)

CPU = "cpu"
SIZE = 32


def emit(check, **kw):
    print(json.dumps(dict(check=check, rank=rank, **kw)), flush=True)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def max_abs(a, b):
    return float((a - b).abs().max())


initialize_multihost(coordinator_address=f"localhost:{port}",
                     num_processes=world, process_id=rank, backend="gloo")
mesh = make_mesh()
emit("init", world=dist.get_world_size(), mesh_rank=mesh.rank,
     mesh_size=mesh.size, backend=dist.get_backend(),
     device=str(mesh.device))
emit("replicated", got=replicated(torch.full((3,), float(rank + 7)),
                                  mesh).tolist(),
     rows=row_sharded(torch.arange(2 * world), mesh).tolist())

# -- the all_gather renders: row bands with a padding row, flat shards
# with padding pixels, against the single-process renders
scene, camcfg, cfg = presets.three_spheres_ground(size=SIZE)
cfg = dataclasses.replace(cfg, width=24, height=21)
cam = Camera.from_config(camcfg, 24, 21)
band = render_image_sharded(scene, cam, cfg, mesh, backend="kernel")
full = render_image_kernel(scene, cam, cfg, device=CPU)
emit("render_kernel", shape=list(band.shape), equal=bool(torch.equal(
    band, full)), max_abs=max_abs(band, full))
scene, camcfg, cfg = presets.single_sphere(size=SIZE)
cfg = dataclasses.replace(cfg, width=27, height=35, chunk_size=1024)
cam = Camera.from_config(camcfg, 27, 35)
flat = render_image_sharded(scene, cam, cfg, mesh)
full = render_image(scene, cam, cfg, device=CPU)
emit("render_core", shape=list(flat.shape), max_abs=max_abs(flat, full))

# -- the kernel band step against the single-process kernel step
# (tests/test_parallel_pallas.py:45-76): loss and one Adam step
scene, camcfg, cfg = presets.fit_target(size=SIZE)
cam = Camera.from_config(camcfg, SIZE, SIZE)
target = render_image_kernel(scene, cam, cfg, device=CPU)


def moved(dc=2.0, radius=1.1):
    p = FitParams.from_scene(scene)
    with torch.no_grad():
        p.sph_center += dc
        p.sph_radius *= radius
    return p


p_s, p_m = moved(), moved()
loss_s = make_fit_step_kernel(scene, cam, cfg, target,
                              torch.optim.Adam(p_s.parameters(), lr=0.1),
                              device=CPU)(p_s)
loss_m = make_sharded_fit_step_kernel(
    scene, cam, cfg, target, torch.optim.Adam(p_m.parameters(), lr=0.1),
    mesh)(p_m)
emit("kernel_step", loss=float(loss_m), loss_single=float(loss_s),
     loss_rel=rel(loss_m, loss_s),
     params_ok=all(torch.allclose(getattr(p_m, f), getattr(p_s, f),
                                  rtol=2e-4, atol=2e-6)
                   for f in FitParams.FIELDS))

# -- descent: 8 steps of each sharded step from centres + 2
# (tests/test_parallel.py:47-69, tests/test_parallel_pallas.py:79-98)
p = moved(radius=1.0)
step = make_sharded_fit_step_kernel(
    scene, cam, cfg, target, torch.optim.Adam(p.parameters(), lr=0.1), mesh)
emit("kernel_descent", losses=[float(step(p)) for _ in range(8)])
target_core = render_image_sharded(scene, cam, cfg, mesh)
p = moved(radius=1.0)
step = make_sharded_fit_step(scene, cam, cfg, pad_pixels(target_core, world),
                             torch.optim.Adam(p.parameters(), lr=0.05), mesh)
emit("core_descent", losses=[float(step(p)) for _ in range(8)])

# -- the core step's loss at 27x35 (not a multiple of the ranks) against
# the unsharded l2_loss (tests/test_parallel.py:72-102): lr 0
cfg35 = dataclasses.replace(cfg, width=27, height=35, chunk_size=1024)
cam35 = Camera.from_config(camcfg, 27, 35)
target35 = render_image(scene, cam35, cfg35, device=CPU)
p = moved(dc=0.0)
with torch.no_grad():
    loss_single = l2_loss(p, scene, cam35, cfg35, target35, device=CPU)
loss = make_sharded_fit_step(scene, cam35, cfg35, pad_pixels(target35, world),
                             torch.optim.SGD(p.parameters(), lr=0.0),
                             mesh)(p)
emit("core_loss", loss=float(loss), loss_single=float(loss_single),
     loss_rel=rel(loss, loss_single))

# -- sharded_value_and_grad: the mean of the ranks' per-shard losses
# equals the whole frame's mean (equal shards: 32^2 over 2 ranks)
cfg32 = dataclasses.replace(cfg, chunk_size=1024)
target32 = render_image(scene, cam, cfg32, device=CPU)
ii, jj, _ = _pixel_index_arrays(SIZE, SIZE, world)


def shard_mean(params, batch):
    i, j, tgt = batch
    flat = render_pixels(params.into_scene(scene), cam, SIZE, SIZE, cfg32,
                         ij=(i, j), device=CPU)
    return torch.mean((flat - tgt) ** 2)


p = moved(dc=0.0)
value, grads = sharded_value_and_grad(shard_mean, mesh)(
    p, (ii, jj, target32.reshape(-1, 3)))
single = l2_loss(p, scene, cam, cfg32, target32, device=CPU)
g_single = torch.autograd.grad(single, [getattr(p, f)
                                        for f in FitParams.FIELDS])
emit("value_and_grad", value_rel=rel(value, single.detach()),
     grad_rel=max(max_abs(grads[f], g) / max(float(g.abs().max()), 1e-30)
                  for f, g in zip(FitParams.FIELDS, g_single)))

# -- the torch.distributed.checkpoint pair, every rank saving and loading
p = moved()
path = os.path.join(out_dir, "dcp_ckpt")
save_checkpoint_dcp(path, p)
back = restore_checkpoint_dcp(path, FitParams.from_scene(scene))
emit("checkpoint", equal=all(torch.equal(getattr(back, f), getattr(p, f))
                             for f in FitParams.FIELDS))

# -- the scaling sweep over groups of 1 and 2 ranks (tests/test_scaling.py)
scene, camcfg, cfg = presets.fit_target(size=16)
cfg = dataclasses.replace(cfg, chunk_size=512)
cam = Camera.from_config(camcfg, 16, 16)
for backend in ("core", "kernel"):
    emit("sweep", backend=backend,
         rows=scaling_sweep(scene, cam, cfg, mesh_sizes=[1, 2], iters=2,
                            backend=backend, reps=1))

emit("dryrun", **dryrun_multichip(world))
dist.destroy_process_group()
