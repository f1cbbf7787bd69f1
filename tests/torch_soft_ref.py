"""The JAX side of tests/test_torch_soft_multiview.py: the shared problem
and, run as a script (``tests/torch_jax_ref.py``), the JAX package's soft
render, ``soft_l2_loss`` and ``multiview_loss`` (soft, and hard on one
view) with their gradients.  Imports JAX and numpy, not torch; the
targets (the port's core renders) come in as an npz of inputs."""
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_jax_ref
from ray_tracer_fragment_shader_tpu.diff import multiview as JM
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams as JFitParams
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets

SIZE = 32
SIGMA = 2.0
FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient")


def problem():
    """fit_target 32^2 (JAX scene, CameraConfig, RenderConfig), two orbit
    views spanning 80 degrees, and the moved parameters as numpy: sphere
    centres + (2, -1, 1.5), radii x 1.05, the light + (6, -4, 3)."""
    js, cam, cfg = jpresets.fit_target(size=SIZE)
    views = JM.orbit_views(cam, 2, span_deg=80.0)
    p = {f: np.asarray(getattr(js, f)).copy() for f in FIELDS}
    p["sph_center"] = p["sph_center"] + np.float32([2.0, -1.0, 1.5])
    p["sph_radius"] = p["sph_radius"] * np.float32(1.05)
    p["light_pos"] = p["light_pos"] + np.float32([6.0, -4.0, 3.0])
    return js, cam, cfg, views, p


def jax_reference(path, inputs):
    """The arrays tests/test_torch_soft_multiview.py compares with, at
    ``problem()``'s parameters, saved to ``path``; ``inputs``: the npz of
    the targets ``one`` [H,W,3] and ``many`` [V,H,W,3]."""
    from ray_tracer_fragment_shader_tpu.diff.soft import render_soft
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    js, cam, cfg, views, p = problem()
    with np.load(inputs) as z:
        one, many = z["one"], z["many"]
    jp = JFitParams(**{f: jnp.asarray(p[f]) for f in FIELDS})
    jcam = Camera.from_config(cam, SIZE, SIZE)
    jcams = [Camera.from_config(v, SIZE, SIZE) for v in views]
    sigma_w = 1.5 * cam.pixel_scale

    def soft(p):
        """soft_l2_loss (diff/soft.py:103-106), its image kept"""
        img = render_soft(p.into_scene(js), jcam, cfg, sigma=SIGMA)
        return jnp.mean((img - one) ** 2), img

    losses = {"mv_soft": lambda p: JM.multiview_loss(p, js, jcams, cfg,
                                                     many, sigma_w),
              "mv_hard": lambda p: JM.multiview_loss(p, js, jcams[:1], cfg,
                                                     many[:1], None)}
    f = jax.jit(lambda p: (
        jax.value_and_grad(soft, has_aux=True)(p),
        {k: jax.value_and_grad(fn)(p) for k, fn in losses.items()}))
    ((loss, img), g), mv = f(jp)
    out = {"soft_image": np.asarray(img)}
    for name, (loss, g) in [("soft", (loss, g))] + list(mv.items()):
        out[f"{name}/loss"] = np.asarray(loss)
        for fld in FIELDS:
            out[f"{name}/grad/{fld}"] = np.asarray(getattr(g, fld))
    np.savez(path, **out)


if __name__ == "__main__":
    torch_jax_ref.configure_jax()
    jax_reference(sys.argv[1], sys.argv[2])
