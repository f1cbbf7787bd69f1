"""The program under test, ``ray_tracer_fragment_shader_tpu_torch``, as the
traffic kinds build it from a configuration file: its render and camera
configs, its scene from the seed's arrays, its fit mode.  The program is
imported here, when a kind first builds it, and by nothing of the
yardstick."""
from __future__ import annotations

import contextlib
import os
from typing import Optional

PORT = "ray_tracer_fragment_shader_tpu_torch"
#: the precisions a configuration may state, and the program's switch
PRECISIONS = ("float32", "bfloat16")


def render_config(config: dict, control: bool = False):
    """The program's ``RenderConfig`` of ``config``: its frame, depth,
    samples a pixel and precision (``bfloat16`` is ``bf16_shading``).
    ``control`` runs a float32 configuration in bfloat16, the nearest
    precision below it the program has."""
    from ray_tracer_fragment_shader_tpu_torch.config import RenderConfig
    samples = int(config.get("samples", 1))
    if samples != 1:
        raise ValueError("the reference traces one ray a pixel: a cell of "
                         "several samples needs a kind and a reference of "
                         "its own")
    precision = config.get("precision", "float32")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if control and precision != "float32":
        raise ValueError(f"the program has no precision below {precision}")
    return RenderConfig(width=config["width"], height=config["height"],
                        max_depth=config["max_depth"], samples=samples,
                        bf16_shading=control or precision == "bfloat16")


def camera_config(camera: dict, eye=None):
    from ray_tracer_fragment_shader_tpu_torch.config import CameraConfig
    return CameraConfig(eye=tuple(eye if eye is not None else camera["eye"]),
                        look_at=tuple(camera["look_at"]),
                        up=tuple(camera["up"]),
                        pixel_scale=camera["pixel_scale"])


def scene(arrays, meta, device):
    from ray_tracer_fragment_shader_tpu_torch.scene.flat import FlatScene
    return FlatScene.from_numpy(arrays, device=device, **meta)


@contextlib.contextmanager
def fit_mode(mode: Optional[str]):
    """The program's fit kernels set to ``mode`` ("twophase": K3 + K4,
    "fused": K6) for the block; None leaves its default."""
    if mode is None:
        yield
        return
    old = os.environ.get("RTFS_FIT_MODE")
    os.environ["RTFS_FIT_MODE"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RTFS_FIT_MODE", None)
        else:
            os.environ["RTFS_FIT_MODE"] = old
