"""Process-group bring-up, the scaling sweep and the multi-rank dry run —
the counterpart of the JAX package's ``parallel/multihost.py`` (and of the
root ``__graft_entry__.py::dryrun_multichip``).

The JAX package brings up ``jax.distributed`` on every host and runs one
SPMD program over a global mesh.  Here every rank is a process with one
device: ``initialize_multihost`` is ``torch.distributed.
init_process_group`` (NCCL for the card, gloo when the caller asks for the
CPU), the mesh is ``parallel.mesh.make_mesh``, and the sharded steps
all-reduce one flat buffer of loss and gradients.

Run as a module, it spawns one rank a card on this host and prints the
scaling sweep's rows (``--cpu``: gloo ranks on the CPU):

    python -m ray_tracer_fragment_shader_tpu_torch.parallel.multihost \
        --ranks 4 --out chiprun_out/scaling_h100.json
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..ops.rays import Camera
from ..scene.flat import FlatScene
from .mesh import make_mesh
from .shard import pad_pixels, render_image_sharded


#: how far ``scaling_sweep`` moves the sphere centres from the target's
#: (as ``chip_smoke.py``'s fit paths): the step's adjoint has live pixels
MOVE = 1.5

#: ``scaling_sweep``'s Adam rate (JAX's sweep: ``optax.adam(0.05)``)
LR = 0.05

#: ``main``'s sweep: config 3 (``full_reflective`` 1024^2 d3), the step
#: count and repeats of each timing
PRESET, SIZE, DEPTH, ITERS, REPS = "full_reflective", 1024, 3, 8, 5


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` over ``num_processes``
    ranks (this one ``process_id``) at ``coordinator_address``
    (``host:port`` or ``tcp://host:port``; None reads ``MASTER_ADDR`` and
    ``MASTER_PORT``).  ``backend``: None is NCCL, on the card (this rank's
    device ``process_id % torch.cuda.device_count()``; raises where there
    is none); ``"gloo"`` runs on the CPU.  A no-op for one process with no
    address, as JAX's; with an address, one process forms a group of
    one."""
    if not ((num_processes is not None and num_processes > 1)
            or coordinator_address is not None):
        return
    backend = "nccl" if backend is None else backend
    rank = 0 if process_id is None else process_id
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the NCCL backend; pass "
                               "backend=\"gloo\" to run the ranks on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init = "env://"
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=num_processes or 1, rank=rank)


def scaling_sweep(scene: FlatScene, camera: Camera, config: RenderConfig,
                  mesh_sizes: Optional[List[int]] = None, iters: int = 4,
                  backend: str = "kernel",
                  reps: int = 3) -> List[Dict[str, object]]:
    """Strong-scaling sweep of the sharded fwd+bwd step over growing
    groups of ranks ``[0, n)``, one row a size: ``n``, ``step_time_s``,
    ``rays_per_s``, ``efficiency`` (against the smallest group's per-rank
    rate), ``timing_method``, ``timing_spread`` and the ``loss`` of the
    last step.  Every rank of the initialized world calls it (each group
    is made by all, ``make_mesh(ranks)``); the ranks of a group run its
    steps, and every rank returns rank 0's rows.  Times are
    ``utils/timing.py::scan_diff_median`` of 1 and ``iters`` Adam steps at
    ``LR`` towards the scene's own render, each run from its parameters
    with the sphere centres moved by ``MOVE`` (JAX's sweep starts at the
    scene itself; here the adjoints run only on pixels whose cotangent is
    nonzero, so a zero loss would time no adjoint), so every group size
    reports the same loss up to reassociation.  ``backend="kernel"``
    (default) steps ``make_sharded_fit_step_kernel`` (the fit kernels on
    row bands), ``"core"`` ``make_sharded_fit_step``.  Efficiency needs
    one device a rank: ranks that share a card or the CPU check structure,
    not speed."""
    from ..diff.fit import (FitParams, make_sharded_fit_step,
                            make_sharded_fit_step_kernel)
    from ..utils.timing import scan_diff_median, step_runner
    if backend not in ("core", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    world = dist.get_world_size()
    iters = max(iters, 2)
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    rows: List[Dict[str, object]] = []
    for n in mesh_sizes:
        mesh = make_mesh(list(range(n)))
        row = None
        if mesh is not None:
            cam = camera.to(mesh.device)
            target = render_image_sharded(scene, cam, config, mesh,
                                          backend=backend)
            params = FitParams.from_scene(scene).to(mesh.device)
            with torch.no_grad():
                params.sph_center += MOVE
            start = copy.deepcopy(params.state_dict())
            opt = torch.optim.Adam(params.parameters(), lr=LR)
            if backend == "kernel":
                step = make_sharded_fit_step_kernel(scene, cam, config,
                                                    target, opt, mesh)
            else:
                step = make_sharded_fit_step(scene, cam, config,
                                             pad_pixels(target, n), opt,
                                             mesh)
            last = [None]

            def one(k):
                if k == 0:   # every run starts from the scene's parameters
                    params.load_state_dict(start)
                    opt.state.clear()
                last[0] = step(params)

            run_1, run_n = step_runner(one, iters, mesh.device)
            timing = scan_diff_median(run_1, run_n, iters, reps=reps)
            dt = timing["dt"]
            row = dict(n=n, dt=dt, rate=config.width * config.height / dt,
                       timing=timing, loss=float(last[0]))
        box = [row]
        dist.broadcast_object_list(box, src=0)
        rows.append(box[0])
    base_rate = rows[0]["rate"] / rows[0]["n"]
    return [dict(n=r["n"], step_time_s=round(r["dt"], 9),
                 rays_per_s=round(r["rate"], 1),
                 efficiency=round(r["rate"] / (base_rate * r["n"]), 4),
                 # "avg": the difference was sub-noise and the row fell
                 # back to the N-run's average
                 timing_method=r["timing"]["method"],
                 timing_spread=round(r["timing"]["spread"], 4),
                 loss=r["loss"]) for r in rows]


def dryrun_multichip(world: int) -> Dict[str, float]:
    """One step of each sharded fit step over ranks ``[0, world)`` of the
    initialized group, on tiny shapes (fit_target 16^2): the kernel band
    step (``make_sharded_fit_step_kernel`` on a ``backend="kernel"``
    target) and the core-autodiff step (``make_sharded_fit_step`` on a
    core target: the two forwards may part on decision-boundary pixels).
    Every rank of the world calls it; returns (and prints on each rank of
    the group) the two losses."""
    from ..diff.fit import (FitParams, make_sharded_fit_step,
                            make_sharded_fit_step_kernel)
    from ..scene import presets
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < world:
        raise RuntimeError(f"dryrun_multichip({world}) needs a process "
                           f"group of at least {world} ranks, have {have}")
    mesh = make_mesh(list(range(world)))
    if mesh is None:
        return {}
    scene, camcfg, config = presets.fit_target(size=16)
    config = dataclasses.replace(config, chunk_size=1024)
    camera = Camera.from_config(camcfg, config.width, config.height,
                                device=mesh.device)

    def moved():
        p = FitParams.from_scene(scene).to(mesh.device)
        with torch.no_grad():
            p.sph_center += 1.0
        return p

    target = render_image_sharded(scene, camera, config, mesh,
                                  backend="kernel")
    params = moved()
    opt = torch.optim.Adam(params.parameters(), lr=0.1)
    loss_kernel = float(make_sharded_fit_step_kernel(
        scene, camera, config, target, opt, mesh)(params))

    target = render_image_sharded(scene, camera, config, mesh)
    params = moved()
    opt = torch.optim.Adam(params.parameters(), lr=0.1)
    loss_core = float(make_sharded_fit_step(
        scene, camera, config, pad_pixels(target, world), opt,
        mesh)(params))
    print(f"dryrun_multichip({world}): sharded fit steps OK - kernel band "
          f"loss={loss_kernel:.6g}, core loss={loss_core:.6g}")
    return dict(kernel=loss_kernel, core=loss_core)


def _rank_main(rank: int, world: int, port: int, cpu: bool, out) -> None:
    """One rank of ``main``'s sweep (``torch.multiprocessing.spawn``'s
    target): the group, the sweep, rank 0's rows written to ``out``."""
    from ..scene import presets
    initialize_multihost(f"localhost:{port}", world, rank,
                         backend="gloo" if cpu else None)
    scene, camcfg, cfg = getattr(presets, PRESET)(size=SIZE, depth=DEPTH)
    device = (torch.device("cpu") if cpu
              else torch.device("cuda", torch.cuda.current_device()))
    camera = Camera.from_config(camcfg, cfg.width, cfg.height, device=device)
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    rows = scaling_sweep(scene, camera, cfg, mesh_sizes=sizes, iters=ITERS,
                         reps=REPS)
    if rank == 0:
        record = dict(preset=PRESET, size=SIZE, depth=DEPTH, iters=ITERS,
                      reps=REPS, ranks=world, rows=rows)
        for row in rows:
            print(json.dumps(row))
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(record, f, indent=1)
    dist.destroy_process_group()


def main(argv=None) -> int:
    """Spawns ``--ranks`` ranks (default: one a card) and runs
    ``scaling_sweep`` over groups of 1, 2, 4, ... of them at config 3
    (``PRESET``, ``SIZE``, ``DEPTH``); prints each row and the cards' names
    and power limits."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (the kernels' plain versions)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not a.cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run gloo ranks "
                               "on the CPU")
        from ..kernels import cuda_build
        cuda_build.load()   # one build, before the ranks load it
        smi = subprocess.run(["nvidia-smi", "--query-gpu=index,name,"
                              "power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
        print(smi.stdout.strip())
    ranks = a.ranks or (2 if a.cpu else torch.cuda.device_count())
    if not a.cpu and ranks > torch.cuda.device_count():
        raise RuntimeError(f"{ranks} ranks need {ranks} cards, have "
                           f"{torch.cuda.device_count()}")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.spawn(
        _rank_main, args=(ranks, port, a.cpu, a.out), nprocs=ranks, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
