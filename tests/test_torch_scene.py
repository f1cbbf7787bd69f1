"""The port's scene layer (ray_tracer_fragment_shader_tpu_torch.scene and
kernels/render.py's pack_scene) against the JAX package's: the same
builders give the same FlatScene fields and metadata, from_numpy carries a
scene across and back, and the kernels' tables are column for column the
JAX kernels' tables."""
import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu.kernels import render_pallas as jrp
from ray_tracer_fragment_shader_tpu.scene import flat as jflat
from ray_tracer_fragment_shader_tpu.scene import presets as jpresets
from ray_tracer_fragment_shader_tpu import scene as jscene
from ray_tracer_fragment_shader_tpu_torch import scene as tscene
from ray_tracer_fragment_shader_tpu_torch.kernels import render as trender
from ray_tracer_fragment_shader_tpu_torch.scene import flat as tflat
from ray_tracer_fragment_shader_tpu_torch.scene import presets as tpresets

FLOAT_ATOL = 1e-6
NAMES = ["reference_demo", "single_sphere", "three_spheres_ground",
         "full_reflective", "fit_target", "procedural_spheres", "fractional_glass"]
META = ("checker_mats", "chain_exact", "has_transmission")


def scenes(name):
    """(JAX FlatScene, port FlatScene) built the same way."""
    if name == "fractional_glass":
        from test_pallas import _fractional_scene
        return _fractional_scene(), tpresets.fractional_glass()[0]
    kw = {} if name == "reference_demo" else {"size": 32}
    return jpresets.PRESETS[name](**kw)[0], tpresets.PRESETS[name](**kw)[0]


def tensor_fields():
    return [f for f in tflat.FlatScene.__dataclass_fields__ if f not in META]


def assert_fields_equal(jax_scene, port_scene):
    for name in tensor_fields():
        a = np.asarray(getattr(jax_scene, name))
        b = getattr(port_scene, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    for name in META:
        assert getattr(port_scene, name) == getattr(jax_scene, name), name


@pytest.mark.parametrize("name", NAMES)
def test_flatscene_fields_match_jax(name):
    j, t = scenes(name)
    assert_fields_equal(j, t)
    for prop in ("num_spheres", "num_triangles", "num_groups",
                 "num_materials", "num_lights"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("name", NAMES)
def test_from_numpy_round_trips(name):
    j, t = scenes(name)
    meta = {k: getattr(j, k) for k in META}
    from_jax = tflat.FlatScene.from_numpy(
        {k: np.asarray(getattr(j, k)) for k in tensor_fields()}, **meta)
    assert_fields_equal(j, from_jax)
    back = tflat.FlatScene.from_numpy(t.to_numpy(), **meta)
    for k, v in t.tensors().items():
        assert torch.equal(getattr(back, k), v), k


def test_from_numpy_rejects_missing_fields():
    _, t = scenes("single_sphere")
    arrays = t.to_numpy()
    del arrays["light_pos"]
    with pytest.raises(KeyError, match="light_pos"):
        tflat.FlatScene.from_numpy(arrays)


@pytest.mark.parametrize("name", NAMES)
def test_pack_scene_tables_match_jax(name):
    j, t = scenes(name)
    jt = jrp.pack_scene(j)
    tt = trender.pack_scene(t)
    assert sorted(jt) == sorted(tt)
    for k in jt:
        a = np.asarray(jt[k])
        assert tt[k].dtype == torch.float32
        assert tuple(tt[k].shape) == a.shape, k
        np.testing.assert_allclose(tt[k].numpy(), a, rtol=0,
                                   atol=FLOAT_ATOL, err_msg=k)


def test_compact_scene_drops_padding():
    j, t = scenes("full_reflective")
    jc, tc = jrp.compact_scene(j), trender.compact_scene(t)
    assert tc.num_spheres == jc.num_spheres < t.num_spheres
    assert tc.num_triangles == jc.num_triangles < t.num_triangles
    assert bool(tc.sph_valid.all()) and bool(tc.tri_valid.all())


def test_concat_scenes_matches_jax():
    ja, ta = scenes("three_spheres_ground")
    jb = (jscene.SceneBuilder().add_sphere("e5").add_light("g2")
          .build())
    tb = (tscene.SceneBuilder().add_sphere("e5").add_light("g2")
          .build())
    assert_fields_equal(jflat.concat_scenes(ja, jb),
                        tflat.concat_scenes(ta, tb))
    with pytest.raises(ValueError, match="checker"):
        tflat.concat_scenes(tb, ta)


def test_to_keeps_dtypes():
    _, t = scenes("fit_target")
    d = t.to("cpu")
    assert d.sph_center.dtype == torch.float32
    assert d.sph_mat.dtype == torch.int32 and d.tri_valid.dtype == torch.bool
    assert d.checker_mats == t.checker_mats
