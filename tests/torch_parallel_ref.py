"""The JAX side of tests/test_torch_parallel.py, run as a script
(``tests/torch_jax_ref.py``) with 8 virtual CPU devices: the JAX
package's sharded core render (tests/test_parallel.py's 32^2), its
sharded core loss at 27x35 (a pixel count the 8 shards do not divide)
and the index helpers ``band_split``, ``band_rows`` and
``_pixel_index_arrays``.

Given an npz of inputs it computes instead one step of JAX's Pallas
band step (``make_sharded_fit_step_pallas``, interpret mode) over 3
devices on fit_target's camera at ``BAND_STEP_SHAPE``: 5-row bands and
2 masked padding rows, on the port's target and perturbed parameters; its optimizer keeps the
all-reduced gradients as its state, so the step returns them with the
loss.  Imports JAX and numpy, not torch."""
import dataclasses
import functools
import os
import sys

import torch_jax_ref

#: (width, height_shard, shards) of the band_rows cases
BAND_ROWS = ((24, 3, 8), (7, 5, 3))
#: (height, shards) of the band_split cases
BAND_SPLITS = ((1024, 3), (20, 8), (35, 8), (32, 8), (1, 4))
#: (width, height, shards) of the _pixel_index_arrays cases
PIXEL_INDEX = ((27, 35, 8), (24, 40, 8), (5, 3, 4))
#: the band step's frame (width, height) on fit_target's 16^2 camera, and
#: its devices.  13 rows, not 16: at an even height the middle row's rays
#: meet the floor exactly on a checker edge, where JAX's Pallas kernel
#: (interpret mode here) forms a triangle's hit point as o + |v|*m*u and
#: picks a square by its last bits (2 of 32 pixels off the f64 oracle at
#: fit_target 32^2, none at 16^2), while the port's forms it as o + m*v
#: and equals the oracle (tests/test_torch_checker_edge.py)
BAND_STEP_SHAPE, BAND_STEP_WORLD = (16, 13), 3
FIT_FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
              "mat_specular", "mat_ambient")


def main(out):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    torch_jax_ref.configure_jax()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ray_tracer_fragment_shader_tpu.core.renderer import render_image
    from ray_tracer_fragment_shader_tpu.diff.fit import (
        FitParams, make_sharded_fit_step)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu.parallel.mesh import (TILE_AXIS,
                                                              make_mesh)
    from ray_tracer_fragment_shader_tpu.parallel.shard import (
        _pixel_index_arrays, band_rows, band_split, render_image_sharded)
    from ray_tracer_fragment_shader_tpu.scene import presets

    devs = jax.devices()
    assert len(devs) >= 8, devs
    mesh = make_mesh(devs[:8])
    res = {}
    scene, camcfg, cfg = presets.three_spheres_ground(size=32)
    cfg = dataclasses.replace(cfg, chunk_size=1024)
    cam = Camera.from_config(camcfg, 32, 32)
    res["render"] = np.asarray(render_image_sharded(scene, cam, cfg, mesh))

    scene, camcfg, cfg = presets.fit_target(size=32)
    cfg = dataclasses.replace(cfg, width=27, height=35, chunk_size=1024)
    cam = Camera.from_config(camcfg, 27, 35)
    target = render_image(scene, cam, cfg)
    params = FitParams.from_scene(scene).replace(
        sph_radius=scene.sph_radius * 1.1)
    tgt_flat = jnp.reshape(target, (-1, 3))
    pad = (-tgt_flat.shape[0]) % 8
    tgt_flat = jnp.concatenate([tgt_flat, jnp.tile(tgt_flat[-1:], (pad, 1))],
                               0)
    opt = optax.sgd(0.0)
    step, (ii, jj) = make_sharded_fit_step(scene, cam, cfg, tgt_flat, opt,
                                           mesh)
    _, _, loss = step(params, opt.init(params), ii, jj, tgt_flat)
    res["core_loss"] = np.float32(loss)
    res["target_27x35"] = np.asarray(target)

    for k, (height, n) in enumerate(BAND_SPLITS):
        res[f"band_split_{k}"] = np.asarray(band_split(height, n))
    for k, (w, hs, n) in enumerate(BAND_ROWS):
        m = make_mesh(devs[:n])

        @functools.partial(shard_map, mesh=m, in_specs=(),
                           out_specs=(P(TILE_AXIS), P(TILE_AXIS)),
                           check_vma=False)
        def rows():
            return band_rows(w, hs, TILE_AXIS)
        ii, jj = rows()
        res[f"band_rows_{k}"] = np.stack([np.asarray(ii), np.asarray(jj)])
    for k, (w, h, n) in enumerate(PIXEL_INDEX):
        ii, jj, total = _pixel_index_arrays(w, h, n)
        res[f"pixel_index_{k}"] = np.stack([np.asarray(ii), np.asarray(jj)])
        res[f"pixel_total_{k}"] = np.int64(total)
    np.savez(out, **res)


def band_step(out, inputs):
    """JAX's Pallas band step on the port's ``target`` [H,W,3] from the
    port's parameters (``FIT_FIELDS``): its loss and gradients."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    torch_jax_ref.configure_jax()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from ray_tracer_fragment_shader_tpu.diff.fit import (
        FitParams, make_sharded_fit_step_pallas)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu.parallel.mesh import make_mesh
    from ray_tracer_fragment_shader_tpu.scene import presets

    with np.load(inputs) as z:
        given = {k: z[k] for k in z.files}
    scene, camcfg, cfg = presets.fit_target(size=16)
    w, h = BAND_STEP_SHAPE
    cfg = dataclasses.replace(cfg, width=w, height=h)
    cam = Camera.from_config(camcfg, w, h)
    params = FitParams.from_scene(scene).replace(
        **{f: jnp.asarray(given[f]) for f in FIT_FIELDS})
    # the "optimizer": its state is the step's all-reduced gradients
    keep = optax.GradientTransformation(
        lambda p: p,
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    mesh = make_mesh(jax.devices()[:BAND_STEP_WORLD])
    step, tgt = make_sharded_fit_step_pallas(
        scene, cam, cfg, jnp.asarray(given["target"]), keep, mesh,
        interpret=True)
    _, grads, loss = step(params, keep.init(params), tgt)
    np.savez(out, loss=np.float32(loss),
             **{f: np.asarray(getattr(grads, f)) for f in FIT_FIELDS})


if __name__ == "__main__":
    if len(sys.argv) > 2:
        band_step(sys.argv[1], sys.argv[2])
    else:
        main(sys.argv[1])
