"""The JAX side of tests/test_torch_scripts.py: run as a script
(``tests/torch_jax_ref.py``), the JAX package's arrays that the port's cell
scripts are held against.  Imports JAX and numpy, not torch; the port's
depth-5 target (the kernel path's render) comes in as an npz of inputs.
The part named last on the command line (``PARTS``) is computed: the tree
image alone takes as long as the rest (eager, about 12 s), so the test
module runs the two parts in two subprocesses at once.

* the depth sweep's depth-5 chain image (config 3's scene) and depth-4 tree
  image (the fractional glass scene of scripts/depth_sweep.py:120-126)
  through the JAX core's ``render_image``, at ``SIZE``^2;
* ``jax.value_and_grad`` of the JAX core's ``l2_loss`` at the depth-5 fwd+bwd
  row's start (sphere centres + ``MOVE``) against the port's target;
* scripts/make_fit_demo.py's perturbed init (its lines 64-74, seed
  ``SEED``) and ``recovery_report`` on it.  The script itself is not
  imported: it sets a persistent compilation cache as it loads.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_jax_ref
from ray_tracer_fragment_shader_tpu.scene import Material as JMaterial
from ray_tracer_fragment_shader_tpu.scene import SceneBuilder as JBuilder
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets

#: even: the middle row's rays meet the board on a checker square's edge,
#: where the kernel path's hit point must equal the core's (o + m*v)
SIZE = 16
MOVE = 1.5
SEED = 3
FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient")
PARTS = ("tree", "rest")
REPORT_KEYS = ("center_err_max", "center_err_mean", "radius_err_max",
               "radius_rel_err_max", "light_err_max")


def tree_scene():
    """scripts/depth_sweep.py:120-126's scene."""
    glass = JMaterial(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                      specular=(0.4, 0.4, 0.4),
                      transparency=(0.5, 0.5, 0.5), refraction=0.9)
    return (JBuilder().add_checkerboard().add_sphere("d5", material=glass)
            .add_sphere("c3").add_light("b6").build())


def fit_demo_init(scene, seed):
    """scripts/make_fit_demo.py:64-74, verbatim but for the names."""
    from ray_tracer_fragment_shader_tpu.diff.fit import FitParams
    rng = np.random.RandomState(seed)
    nv = int(np.asarray(scene.sph_valid).sum())
    dc = np.zeros((scene.num_spheres, 3), np.float32)
    dc[:nv] = rng.uniform(-8, 8, (nv, 3))
    dl = rng.uniform(-10, 10, np.asarray(scene.light_pos).shape
                     ).astype(np.float32)
    return FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + jnp.asarray(dc),
        sph_radius=scene.sph_radius * jnp.asarray(
            1 + rng.uniform(-0.1, 0.1, scene.num_spheres), jnp.float32),
        light_pos=scene.light_pos + jnp.asarray(dl))


def jax_reference(path, inputs, part):
    from ray_tracer_fragment_shader_tpu.config import RenderConfig
    from ray_tracer_fragment_shader_tpu.core.renderer import render_image
    from ray_tracer_fragment_shader_tpu.diff.fit import FitParams, l2_loss
    from ray_tracer_fragment_shader_tpu.diff.multiview import (
        recovery_report)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu.scene.presets import _cam
    if part == "tree":
        np.savez(path, tree_d4=np.asarray(render_image(
            tree_scene(), _cam(SIZE),
            RenderConfig(width=SIZE, height=SIZE, max_depth=4, samples=1))))
        return
    with np.load(inputs) as z:
        target = jnp.asarray(z["target"])
    out = {}
    js, jc, jf = jpresets.full_reflective(size=SIZE, depth=5)
    out["chain_d5"] = np.asarray(render_image(js, jc, jf))
    jp = FitParams.from_scene(js)
    jp = jp.replace(sph_center=jp.sph_center + MOVE)
    cam = Camera.from_config(jc, SIZE, SIZE)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: l2_loss(p, js, cam, jf, target)))(jp)
    out["loss"] = np.asarray(loss)
    for f in FIELDS:
        out[f"grad/{f}"] = np.asarray(getattr(g, f))
    fs = jpresets.fit_target(size=SIZE)[0]
    init = fit_demo_init(fs, SEED)
    for f in FIELDS:
        out[f"init/{f}"] = np.asarray(getattr(init, f))
    report = recovery_report(init, fs)
    for k in REPORT_KEYS:
        out[f"report/{k}"] = np.asarray(report[k], np.float64)
    np.savez(path, **out)


if __name__ == "__main__":
    torch_jax_ref.configure_jax()
    jax_reference(*sys.argv[1:4])
