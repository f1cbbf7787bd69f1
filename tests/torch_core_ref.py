"""The JAX side of tests/test_torch_core.py: the shared inputs (scenes,
rays, cases) and, run as a script (``tests/torch_jax_ref.py``), every
JAX-side array that module compares with.  Imports JAX and numpy, not
torch, so the subprocess starts quickly."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_jax_ref
from ray_tracer_fragment_shader_tpu.ops.rays import (
    sample_jitter as j_sample_jitter)
from ray_tracer_fragment_shader_tpu.scene import Material as JMaterial
from ray_tracer_fragment_shader_tpu.scene import SceneBuilder as JBuilder
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets

SIZE = 32
RAYS = 256
FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient")
HIT_FIELDS = ("dist", "point", "normal", "refl_dir", "trans_dir", "ambient",
              "diffuse", "specular", "transparency", "refraction")
INTERSECT_SCENES = ("three_spheres_ground", "full_reflective",
                    "reference_demo")
#: case: (preset, preset keywords, config overrides, budget)
IMAGE_CASES = {
    "chain": ("full_reflective", dict(depth=2), {}, 0.01),
    "tree": ("fractional_glass", dict(depth=1), {}, 0.01),
    "supersampled": ("three_spheres_ground", {}, dict(samples=4), 0.01),
    "adaptive": ("reference_demo", {}, dict(samples=4, adaptive=True,
                                            max_depth=2), 0.02),
}


def jax_preset(name, size=SIZE, **kw):
    """(scene, CameraConfig, RenderConfig) of the JAX package; for
    ``fractional_glass`` the tree scene of tests/test_adjoint_tree.py:25-36
    (the port's ``presets.fractional_glass``)."""
    if name == "reference_demo":
        s, c, f = jpresets.reference_demo()
        return s, c, dataclasses.replace(f, width=size, height=size, **kw)
    if name == "fractional_glass":
        glass = JMaterial(ambient=(0.02, 0.02, 0.02),
                          diffuse=(0.1, 0.1, 0.2), specular=(0.4, 0.4, 0.4),
                          transparency=(0.5, 0.5, 0.5), refraction=0.9)
        scene = (JBuilder().add_checkerboard()
                 .add_sphere("d5", material=glass).add_sphere("c3")
                 .add_light("b6").build())
        return (scene,) + jpresets.full_reflective(size=size, **kw)[1:]
    return jpresets.PRESETS[name](size=size, **kw)


def random_rays(n, seed):
    """[n,3] rays from numpy: half from the default eye toward random
    points over the board, half from random points above the board in
    random directions (secondary-ray-like); ray 0 is dead (v = 0)."""
    rng = np.random.RandomState(seed)
    eye = np.array([0.0, 100.0, 200.0], np.float32)
    tgt = np.stack([rng.uniform(-200, 200, n), rng.uniform(-20, 120, n),
                    rng.uniform(-360, 40, n)], -1)
    o = np.repeat(eye[None], n, 0)
    h = n - n // 2
    o[n // 2:] = np.stack([rng.uniform(-150, 150, h), rng.uniform(0, 80, h),
                           rng.uniform(-300, -20, h)], -1)
    v = (tgt - o).astype(np.float32)
    v[n // 2:] = rng.standard_normal((h, 3)).astype(np.float32) * 50
    v[0] = 0.0
    return o.astype(np.float32), v


def exclusions(js):
    N = js.num_triangles + js.num_spheres
    return np.random.RandomState(3).randint(-1, N, RAYS).astype(np.int32)


def checker_rays():
    """Rays straight down onto the board across its centre line: squares
    on both sides of the board's centre."""
    n = RAYS
    xs = np.linspace(-150, 150, n, dtype=np.float32)
    o = np.stack([xs, np.full(n, 50.0), np.full(n, -160.0)], -1)
    v = np.tile(np.array([[0.0, -100.0, 0.0]]), (n, 1))
    return o.astype(np.float32), v.astype(np.float32)


def tie_case():
    """Two coincident spheres and a cube with one triangle repeated right
    after itself (JAX scene), the triangle's index ``t`` (the first that
    faces the eye: the cube is convex, so the ray through its centroid
    hits it first) and two rays from the eye: to the spheres' centre and
    to the triangle's centroid."""
    js = (JBuilder().add_sphere("d5").add_sphere("d5").add_cube("b3")
          .add_light("b6").build(pad_multiple=1))
    v0, v1, v2 = (np.asarray(getattr(js, f))
                  for f in ("tri_v0", "tri_v1", "tri_v2"))
    cent = (v0 + v1 + v2) / 3.0
    n = np.cross(v1 - v0, v2 - v0)
    n *= np.sign(np.sum(n * (cent - cent.mean(0)), -1))[:, None]  # outward
    eye = np.array([[0.0, 100.0, 200.0]], np.float32)
    t = int(np.flatnonzero(np.sum(n * (eye - cent), -1) > 0)[0])
    dup = {}
    for f in ("tri_v0", "tri_v1", "tri_v2", "tri_mat", "tri_checker",
              "tri_group", "tri_valid"):
        a = np.asarray(getattr(js, f))
        dup[f] = jnp.asarray(np.concatenate([a[:t + 1], a[t:]], 0))
    o = np.repeat(eye, 2, 0)
    v = np.stack([np.asarray(js.sph_center[0]), cent[t]]) - o
    assert np.allclose(js.sph_center[0], js.sph_center[1])
    return js.replace(**dup), t, o, v.astype(np.float32)


def image_case(case):
    name, kw, over, budget = IMAGE_CASES[case]
    js, jcam, jcfg = jax_preset(name, **kw)
    return js, jcam, dataclasses.replace(jcfg, width=SIZE, height=SIZE,
                                         **over), budget


def jax_jitter(cfg, n):
    """The [S, n, 3] jitter the JAX core draws for ``cfg``: one
    ``sample_jitter`` per key of ``split(PRNGKey(seed), S)``."""
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.samples)
    return np.stack([np.asarray(j_sample_jitter(k, n, cfg.jitter_scale))
                     for k in keys])


def fit_problem():
    """full_reflective 32^2 d2 (JAX scene, Camera, config: IMAGE_CASES'
    chain case) with FitParams whose sphere centres are moved by 1.5."""
    from ray_tracer_fragment_shader_tpu.diff.fit import FitParams as JP
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera as JCamera
    js, jcc, jcfg = jpresets.full_reflective(size=SIZE, depth=2)
    jp = JP.from_scene(js)
    return (js, JCamera.from_config(jcc, SIZE, SIZE), jcfg,
            jp.replace(sph_center=jp.sph_center + 1.5))


def jax_reference(path):
    """Every JAX-side array tests/test_torch_core.py compares with, saved
    to ``path``."""
    import optax

    from ray_tracer_fragment_shader_tpu.core.renderer import render_image
    from ray_tracer_fragment_shader_tpu.diff.fit import (
        default_fit_optimizer as j_opt, l2_loss as j_l2_loss)
    from ray_tracer_fragment_shader_tpu.ops.intersect import intersect_scene
    from ray_tracer_fragment_shader_tpu.ops.shading import (
        shade_local as j_shade)

    out = {}

    def keep(prefix, hit):
        for f in ("valid", "prim_id") + HIT_FIELDS:
            out[f"{prefix}/{f}"] = np.asarray(getattr(hit, f))

    def hits_and_shade(s, o, v, e, u):
        """Prune on and off, each over the batch of (rays, exclusions):
        random without, random with, checker rays without; and the
        pruned, unexcluded hit's shading.  One compiled program a scene."""
        hits = [jax.vmap(lambda o, v, e, p=p: intersect_scene(
            s, o, v, prune=p, exclude_id=e))(o, v, e) for p in (True, False)]
        first = jax.tree_util.tree_map(lambda a: a[0], hits[0])
        return hits, j_shade(s, first, u)

    hs = jax.jit(hits_and_shade)
    co, cv = checker_rays()
    for name in INTERSECT_SCENES:
        js = jax_preset(name)[0]
        o, v = random_rays(RAYS, seed=len(name))
        u = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
        none = np.full(RAYS, -1, np.int32)
        hits, shade = hs(js, np.stack([o, o, co]), np.stack([v, v, cv]),
                         np.stack([none, exclusions(js), none]), u)
        for p, h in zip((True, False), hits):
            for k, e in enumerate((False, True)):
                keep(f"hit/{name}/{p}/{e}",
                     jax.tree_util.tree_map(lambda a: a[k], h))
        out[f"shade/{name}"] = np.asarray(shade)
        if name == "three_spheres_ground":
            keep("checker", jax.tree_util.tree_map(lambda a: a[2], hits[0]))

    js, t, o, v = tie_case()
    nt = js.num_triangles
    excl = jnp.asarray([[-1, -1], [nt, t]], jnp.int32)
    h = jax.jit(jax.vmap(
        lambda e: intersect_scene(js, o, v, exclude_id=e)))(excl)
    out["tie/prim_id"] = np.asarray(h.prim_id)
    out["tie/dist"] = np.asarray(h.dist)

    for case in IMAGE_CASES:
        if case == "chain":  # fit_problem's target below
            continue
        js, jcam, jcfg, _ = image_case(case)
        out[f"image/{case}"] = np.asarray(render_image(js, jcam, jcfg))
        if jcfg.samples > 1:
            out[f"jitter/{case}"] = jax_jitter(jcfg, SIZE * SIZE)

    # l2_loss and its gradients (the eye's too) and three optax Adam steps,
    # from one compiled value-and-grad; the target is the unmoved scene's
    # core render, IMAGE_CASES' chain case
    js, jcam, jcfg, jp = fit_problem()
    tgt = render_image(js, jcam, jcfg)
    out["fit/target"] = out["image/chain"] = np.asarray(tgt)
    vg = jax.jit(jax.value_and_grad(
        lambda p, e: j_l2_loss(p, js, jcam.replace(eye=e), jcfg, tgt),
        argnums=(0, 1)))
    loss, (g, eye_g) = vg(jp, jcam.eye)
    out["fit/loss"] = np.asarray(loss)
    out["fit/eye"] = np.asarray(eye_g)
    for f in FIELDS:
        out[f"fit/grad/{f}"] = np.asarray(getattr(g, f))
    opt = j_opt()
    state, p, losses = opt.init(jp), jp, []
    for _ in range(3):
        lo, (gp, _) = vg(p, jcam.eye)
        up, state = opt.update(gp, state, p)
        p = optax.apply_updates(p, up)
        losses.append(float(lo))
    out["fit/step_losses"] = np.asarray(losses)
    for f in FIELDS:
        out[f"fit/step/{f}"] = np.asarray(getattr(p, f))
    np.savez(path, **out)


if __name__ == "__main__":
    torch_jax_ref.configure_jax()
    jax_reference(sys.argv[1])
