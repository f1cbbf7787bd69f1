"""Camera model and primary-ray generation.

Replicates ``rayTraceScreen``'s camera setup (Hw4/MySdlApplication.cpp:
1251-1282): ``right = normalize((lookAt-eye) x up)``,
``up' = normalize(right x (lookAt-eye))``, screen anchored at the look-at
point, and rays stored as (origin, *unnormalized* direction) pairs — the
reference's ``Line(start, end)`` convention.  The triangle test's epsilon
comparisons apply to the raw parameter ``m`` (``:657-659``), so the
direction must stay unnormalized.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import CameraConfig
from ..utils.jmath import cross3, safe_normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: torch.Tensor          # [3]
    look_at: torch.Tensor      # [3]
    up: torch.Tensor           # [3]
    bottom_x: torch.Tensor     # [] offset of the screen's left edge
    bottom_y: torch.Tensor     # [] offset of the screen's bottom edge
    pixel_scale: torch.Tensor  # [] world units per pixel (reference: 1)

    @classmethod
    def from_config(cls, cfg: CameraConfig, width: int, height: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> "Camera":
        bx, by = cfg.bottom(width, height)
        f = lambda x: torch.tensor(x, dtype=dtype, device=device)
        return cls(eye=f(cfg.eye), look_at=f(cfg.look_at), up=f(cfg.up),
                   bottom_x=f(bx), bottom_y=f(by),
                   pixel_scale=f(cfg.pixel_scale))

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    def basis(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(right, up', base_screen_point) — MySdlApplication.cpp:1270-1279."""
        look = self.look_at - self.eye
        right = safe_normalize(cross3(look, self.up))
        up2 = safe_normalize(cross3(right, look))
        base = self.look_at + self.bottom_x * right + self.bottom_y * up2
        return right, up2, base


def screen_points(camera: Camera, width: int, height: int,
                  ij: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Screen point per pixel, flattened [H*W, 3] (row-major over j then i,
    j=0 the bottom scanline as in the reference's GL coordinate system).

    If ``ij`` is given as integer tensors ``(i, j)`` of shape [P], only those
    pixels are produced."""
    right, up2, base = camera.basis()
    if ij is None:
        j = torch.arange(height, dtype=base.dtype, device=base.device)
        i = torch.arange(width, dtype=base.dtype, device=base.device)
        jj, ii = torch.meshgrid(j, i, indexing="ij")
        ii = ii.reshape(-1)
        jj = jj.reshape(-1)
    else:
        ii = torch.as_tensor(ij[0], dtype=base.dtype, device=base.device)
        jj = torch.as_tensor(ij[1], dtype=base.dtype, device=base.device)
    scale = camera.pixel_scale
    return (base[None, :] + (ii * scale)[:, None] * right[None, :]
            + (jj * scale)[:, None] * up2[None, :])


def primary_rays(camera: Camera, pts: torch.Tensor,
                 jitter: Optional[torch.Tensor] = None):
    """Rays (o, v) from the eye through (possibly jittered) screen points.
    The reference jitters the *endpoint* by ``0.5*randomUnit()``
    (MySdlApplication.cpp:1296)."""
    if jitter is not None:
        pts = pts + jitter
    o = camera.eye[None, :].expand(pts.shape)
    v = pts - camera.eye
    return o, v


def sample_jitter(generator: torch.Generator, n: int, scale: float,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[n, 3] jitter vectors of length ``scale``, uniformly distributed on
    the sphere — the distribution of ``0.5*randomUnit()``
    (MySdlApplication.cpp:1148-1169) — on the generator's device.  The
    draws differ from JAX's threefry bits; pass JAX's jitter through
    ``render_image_kernel(jitter=...)`` for per-pixel parity."""
    g = torch.randn((n, 3), generator=generator, dtype=dtype,
                    device=generator.device)
    return scale * safe_normalize(g)
