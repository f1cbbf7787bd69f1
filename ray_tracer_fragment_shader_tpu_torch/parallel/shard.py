"""Sharded rendering and gradient reduction over a ``torch.distributed``
group — the counterpart of the JAX package's ``parallel/shard.py``.

Pixels shard across the ranks; the scene and camera are replicated.  The
forward needs no communication (pixels are independent) until the bands
are gathered; a fit step sums its loss and gradients with one
``all_reduce``.  Each rank's work is a function of ``(rank, world)`` that
issues no collective (``render_band``, ``render_tile``), so a test can run
every rank of a world in one process; the collective follows it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import CameraConfig, RenderConfig
from ..core.renderer import render_pixels
from ..kernels.render import render_image_kernel
from ..ops.rays import Camera, screen_points
from ..ops.sampling import resolve_device
from ..scene.flat import FlatScene
from .mesh import Mesh, all_reduce_sum, make_mesh, row_sharded, shard_bounds


def _pixel_index_arrays(width: int, height: int, n_shards: int,
                        device=None):
    """Flat (i, j) pixel index tensors padded to a multiple of
    ``n_shards``, and the true pixel count.  Padding pixels are clamped to
    the last real pixel: they are rendered (they trace the same scene) and
    dropped."""
    total = width * height
    pad = (-total) % n_shards
    idx = torch.arange(total + pad, dtype=torch.int64, device=device)
    idx = torch.clamp(idx, max=total - 1)
    return idx % width, idx // width, total


def pad_pixels(image: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``image``'s pixels flat [H*W, 3], padded to a multiple of
    ``n_shards`` by repeating the last pixel (the flat target of
    ``diff.fit.make_sharded_fit_step``)."""
    flat = image.reshape(-1, 3)
    pad = (-flat.shape[0]) % n_shards
    return torch.cat([flat, flat[-1:].expand(pad, 3)], 0)


def band_split(height: int, n_shards: int) -> Tuple[int, int]:
    """(padded height, rows per shard) for row-band sharding."""
    h_pad = -(-height // n_shards) * n_shards
    return h_pad, h_pad // n_shards


def band_rows(width: int, height_shard: int, rank: int, device=None):
    """Rank ``rank``'s row-band pixel indices: flat ``(ii, jj)`` tensors of
    [height_shard*width] for the global rows ``[rank*height_shard,
    (rank+1)*height_shard)``, row-major as ``screen_points``'s."""
    jj = rank * height_shard + torch.arange(height_shard, device=device)
    jj2, ii2 = torch.meshgrid(jj, torch.arange(width, device=device),
                              indexing="ij")
    return ii2.reshape(-1), jj2.reshape(-1)


def _camera(camera, config: RenderConfig, device) -> Camera:
    """``camera`` on ``device``; a ``CameraConfig`` is placed on the whole
    image (its screen's bottom edge depends on the image's height)."""
    if isinstance(camera, CameraConfig):
        return Camera.from_config(camera, config.width, config.height,
                                  device=device)
    return camera.to(device)


def band_points(camera: Camera, width: int, height_shard: int, rank: int):
    """Rank ``rank``'s row band's screen points [height_shard*width, 3];
    equal to the rows of the whole frame's ``screen_points``, bit for
    bit."""
    ij = band_rows(width, height_shard, rank, device=camera.eye.device)
    return screen_points(camera, width, height_shard, ij=ij)


def render_band(scene: FlatScene, camera, config: RenderConfig, rank: int,
                world: int, *, device=None) -> torch.Tensor:
    """Rank ``rank``'s contiguous row band of the frame ->
    [height_shard, W, 3], rendered by ``render_image_kernel`` on its
    points (rows past the image are padding, rendered and dropped by the
    caller).  No collective."""
    device = resolve_device(device)
    camera = _camera(camera, config, device)
    _, h_shard = band_split(config.height, world)
    cfg_s = dataclasses.replace(config, height=h_shard)
    return render_image_kernel(
        scene, camera, cfg_s,
        pts=band_points(camera, config.width, h_shard, rank), device=device)


def render_tile(scene: FlatScene, camera, config: RenderConfig, rank: int,
                world: int, *, device=None) -> torch.Tensor:
    """Rank ``rank``'s share of the flat pixel indices, rendered by the
    core renderer (``render_pixels(ij=)``) -> [m, 3].  No collective."""
    device = resolve_device(device)
    camera = _camera(camera, config, device)
    ii, jj, _ = _pixel_index_arrays(config.width, config.height, world,
                                    device=device)
    start, stop = shard_bounds(ii.shape[0], rank, world)
    return render_pixels(scene, camera, config.width, config.height, config,
                         ij=(ii[start:stop], jj[start:stop]), device=device)


def render_image_sharded(scene: FlatScene, camera, config: RenderConfig,
                         mesh: Optional[Mesh] = None,
                         backend: str = "core") -> torch.Tensor:
    """Full-frame render with the pixels sharded over ``mesh`` (default:
    ``make_mesh()``) -> [H,W,3] on every rank, on ``mesh.device``.

    ``backend="core"`` shards flat pixel indices through the core renderer
    (``render_tile``); ``backend="kernel"`` renders each rank's contiguous
    row band with the forward kernel (``render_band``).  The bands are
    gathered with one ``all_gather`` and the padding cut."""
    mesh = make_mesh() if mesh is None else mesh
    if backend not in ("core", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    part = render_band if backend == "kernel" else render_tile
    mine = part(scene, camera, config, mesh.rank, mesh.size,
                device=mesh.device).contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    h, w = config.height, config.width
    if backend == "kernel":
        return torch.cat(parts, 0)[:h]
    return torch.cat(parts, 0)[:h * w].reshape(h, w, 3)


def flatten_grads(value: torch.Tensor, grads: Dict[str, torch.Tensor],
                  names) -> torch.Tensor:
    """``[value, *grads[name].flatten() for name in names]``: the one
    buffer a sharded step all-reduces."""
    return torch.cat([value.detach().reshape(1).float()]
                     + [grads[n].detach().reshape(-1).float()
                        for n in names])


def unflatten_grads(flat: torch.Tensor, like: Dict[str, torch.Tensor]):
    """(value, {name: grad shaped as like[name]}) from ``flatten_grads``'s
    buffer, in ``like``'s order."""
    out, o = {}, 1
    for name, t in like.items():
        out[name] = flat[o:o + t.numel()].view(t.shape)
        o += t.numel()
    if o != flat.numel():
        raise ValueError(f"flat buffer of {flat.numel()} for {o} values")
    return flat[0], out


def sharded_value_and_grad(loss_fn: Callable, mesh: Optional[Mesh] = None
                           ) -> Callable:
    """A mesh-wide value-and-grad of the per-shard loss ``loss_fn(params,
    shard_batch) -> scalar`` (JAX: ``value_and_grad`` under ``shard_map``
    with a ``pmean``).  ``vg(params, batch) -> (value, grads)``: ``params``
    is an ``nn.Module`` replicated on every rank, ``batch`` a tensor or a
    tuple of tensors whose leading axis shards over the ranks
    (``row_sharded``); ``grads`` maps each parameter's name to its
    gradient.  The loss and the gradients are averaged over the ranks with
    ONE ``all_reduce`` of a flat buffer."""
    mesh = make_mesh() if mesh is None else mesh

    def vg(params, batch):
        local = (tuple(row_sharded(t, mesh) for t in batch)
                 if isinstance(batch, (tuple, list))
                 else row_sharded(batch, mesh))
        named = dict(params.named_parameters())
        with torch.enable_grad():
            value = loss_fn(params, local)
            got = torch.autograd.grad(value, list(named.values()),
                                      allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named.items(), got)}
        flat = all_reduce_sum(flatten_grads(value, grads, named), mesh)
        return unflatten_grads(flat / mesh.size, named)

    return vg
