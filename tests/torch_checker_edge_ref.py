"""The JAX side of tests/test_torch_checker_edge.py: the cases and, run as
a script (``tests/torch_jax_ref.py``: no fused multiply-adds in XLA's CPU
programs), the JAX core's images of every case and ``jax.value_and_grad``
of its ``l2_loss`` on every step case, in two parts that run at once:
"images" (the images, one jitted render of every size's rays a preset,
and the first step case) and "steps" (the others).

At an even frame height the middle scanline's rays pass through the
camera's look-at point, which lies on a checker square's edge: the board's
squares there are decided by the last bits of the hit point."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_jax_ref
from ray_tracer_fragment_shader_tpu.scene import Material as JMaterial
from ray_tracer_fragment_shader_tpu.scene import SceneBuilder as JBuilder
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets

#: (preset, size) of the image cases: two even sizes and an odd one each
IMAGE_CASES = tuple((name, size) for name, sizes in (
    ("fit_target", (16, 32, 15)), ("reference_demo", (32, 64, 33)),
    ("full_reflective", (32, 64, 33))) for size in sizes)
#: the tree scene's sizes (the look-at scanline against the oracle only)
TREE_SIZES = (32, 64, 33)
#: (preset, size) of the fwd+bwd step cases, one even size a preset.
#: full_reflective at 24, not 32: at 32^2 (and 22, 26, 44, 52, 64) the
#: JAX core itself leaves the f64 oracle on one pixel of the look-at row
#: by 0.87 (the port's kernel path does not), and that pixel alone parts
#: the losses by 14 %
STEP_CASES = (("fit_target", 16), ("reference_demo", 32),
              ("full_reflective", 24))
#: the steps start from the sphere centres and the lights moved by this
#: much (reference_demo's 32-unit window shows no sphere)
MOVE = 1.5
PARTS = ("images", "steps")
FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient")
#: full_reflective at config 3's depth; reference_demo at one sample
DEPTH = 3


def key(name, size):
    return f"{name}/{size}"


def jax_preset(name, size):
    """The JAX package's (scene, CameraConfig, RenderConfig) of a case."""
    if name == "reference_demo":
        s, c, f = jpresets.reference_demo()
        return s, c, dataclasses.replace(f, width=size, height=size,
                                         samples=1)
    if name == "full_reflective":
        return jpresets.full_reflective(size=size, depth=DEPTH)
    if name == "fractional_glass":
        glass = JMaterial(ambient=(0.02, 0.02, 0.02),
                          diffuse=(0.1, 0.1, 0.2), specular=(0.4, 0.4, 0.4),
                          transparency=(0.5, 0.5, 0.5), refraction=0.9)
        scene = (JBuilder().add_checkerboard()
                 .add_sphere("d5", material=glass).add_sphere("c3")
                 .add_light("b6").build())
        return (scene,) + jpresets.full_reflective(size=size, depth=DEPTH)[1:]
    return jpresets.PRESETS[name](size=size)


def moved(p):
    """A step's start: ``FitParams`` ``p`` with the centres and the lights
    moved by ``MOVE``."""
    return p.replace(sph_center=p.sph_center + MOVE,
                     light_pos=p.light_pos + MOVE)


def jax_reference(path, inputs, part):
    from ray_tracer_fragment_shader_tpu.core.renderer import render_rays
    from ray_tracer_fragment_shader_tpu.diff.fit import FitParams, l2_loss
    from ray_tracer_fragment_shader_tpu.ops.rays import (
        Camera, primary_rays, screen_points)
    out = {}
    if part == "images":
        for name in dict(IMAGE_CASES):
            sizes = [n for m, n in IMAGE_CASES if m == name]
            rays = []
            for n in sizes:
                js, jc, jf = jax_preset(name, n)
                cam = Camera.from_config(jc, n, n)
                rays.append(primary_rays(cam, screen_points(cam, n, n)))
            o, v = (jnp.concatenate(x) for x in zip(*rays))
            rgb = np.asarray(jax.jit(lambda o, v: render_rays(
                js, o, v, max_depth=jf.max_depth,
                mode=jf.resolved_mode(js.chain_exact),
                small=jf.small_number,
                attenuation_factor=jf.attenuation_factor,
                prune=jf.prune))(o, v))
            start = 0
            for n in sizes:
                out["img/" + key(name, n)] = rgb[start:start + n * n
                                                 ].reshape(n, n, 3)
                start += n * n
    with np.load(inputs) as z:
        targets = {k: jnp.asarray(z[k]) for k in z.files}
    for name, size in (STEP_CASES[:1] if part == "images" else
                       STEP_CASES[1:]):
        js, jc, jf = jax_preset(name, size)
        cam = Camera.from_config(jc, size, size)
        target = targets[key(name, size)]
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: l2_loss(p, js, cam, jf, target)))(
                moved(FitParams.from_scene(js)))
        out["loss/" + key(name, size)] = np.asarray(loss)
        for f in FIELDS:
            out[f"grad/{key(name, size)}/{f}"] = np.asarray(getattr(g, f))
    np.savez(path, **out)


if __name__ == "__main__":
    torch_jax_ref.configure_jax()
    jax_reference(*sys.argv[1:4])
