"""ray_tracer_fragment_shader_tpu_torch — the ray tracer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``ray_tracer_fragment_shader_tpu`` (JAX/Pallas), which stays the
reference it is tested against.  It imports torch and numpy, never jax.
"""
from .config import CameraConfig, RenderConfig
from .core.renderer import (render_image, render_image_jit, render_pixels,
                            render_rays)
from .diff.fit import FitParams, fit, make_fit_step_kernel
from .kernels.adjoint_fused import fit_value_and_grad
from .kernels.render import render_image_kernel
from .ops.rays import Camera
from .scene import (FlatScene, Material, SceneBuilder, PRESETS,
                    concat_scenes, convert_board_coordinate)

__version__ = "0.1.0"

__all__ = [
    "CameraConfig", "RenderConfig", "Camera", "FlatScene", "Material",
    "SceneBuilder", "PRESETS", "concat_scenes", "convert_board_coordinate",
    "render_image_kernel", "FitParams", "fit", "make_fit_step_kernel",
    "fit_value_and_grad", "render_image", "render_image_jit",
    "render_pixels", "render_rays",
]
