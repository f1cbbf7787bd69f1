"""The port's CLI (ray_tracer_fragment_shader_tpu_torch.cli): ``render``
goes through render_image_kernel (here on the CPU, with --cpu), and the
``interactive`` stdin menu builds the same scene as the JAX package's."""
import dataclasses
import io

import numpy as np
import pytest
import torch

from torch_cpu_threads import one_cpu_thread  # noqa: F401 (autouse)
from ray_tracer_fragment_shader_tpu import cli as jcli
from ray_tracer_fragment_shader_tpu.io.image import read_ppm
from ray_tracer_fragment_shader_tpu_torch import cli as tcli
from ray_tracer_fragment_shader_tpu_torch.kernels.render import (
    render_image_kernel)
from ray_tracer_fragment_shader_tpu_torch.scene import presets

# the menu session of tests/test_cli.py::test_interactive_menu_semantics
MENU_FEED = "\n".join([
    "z",          # invalid type -> menu repeats
    "d", "q9",    # invalid coordinate -> rejected
    "d", "b4",    # sphere at b4
    "y",
    "c", "b4",    # cube OVERWRITES b4 (dedupe by coordinate)
    "yes",
    "a", "b6",    # light
    "no",
]) + "\n"


def test_render_writes_render_image_kernel_output(tmp_path, capsys):
    out = tmp_path / "fr.npy"
    img = tcli.main(["render", "--preset", "full_reflective", "--size", "32",
                     "--depth", "2", "--cpu", "--out", str(out)])
    scene, cam, cfg = presets.full_reflective(size=32, depth=2)
    want = render_image_kernel(scene, cam, cfg, device="cpu")
    np.testing.assert_array_equal(np.load(out), want.numpy())
    assert torch.equal(img, want)
    text = capsys.readouterr().out
    assert "rendered 32x32 depth=2 samples=1 on cpu" in text


def test_render_png_and_adaptive_flags(tmp_path):
    out = tmp_path / "demo.ppm"
    img = tcli.main(["render", "--preset", "reference_demo", "--size", "16",
                     "--depth", "1", "--samples", "2", "--adaptive", "--cpu",
                     "--out", str(out)])
    scene, cam, cfg = presets.reference_demo()
    cfg = dataclasses.replace(cfg, width=16, height=16, max_depth=1,
                              samples=2, adaptive=True)
    assert torch.equal(img, render_image_kernel(scene, cam, cfg,
                                                device="cpu"))
    raster = read_ppm(str(out))
    assert raster.shape == (16, 16, 3) and raster.max() > 0


def test_render_watch_progressive(tmp_path, capsys):
    out = tmp_path / "w.ppm"
    tcli.main(["render", "--preset", "single_sphere", "--size", "64",
               "--cpu", "--out", str(out), "--watch"])
    assert read_ppm(str(out)).shape == (64, 64, 3)
    text = capsys.readouterr().out
    for s in (16, 32, 64):
        assert f"rendered {s}x{s}" in text


def _menu_scene(cli, monkeypatch, capsys):
    """Run ``cli``'s interactive session on MENU_FEED; return (scene,
    stdout) with the render stubbed out."""
    got = {}

    def capture(scene, cam, cfg, out_path, *rest):
        got["scene"] = scene

    monkeypatch.setattr("sys.stdin", io.StringIO(MENU_FEED))
    monkeypatch.setattr(cli, "_render_and_write", capture)
    cli.main(["interactive", "--size", "32", "--depth", "1", "--cpu",
              "--out", "x.ppm"])
    return got["scene"], capsys.readouterr().out


def test_interactive_menu_builds_the_jax_scene(monkeypatch, capsys):
    jscene, jtext = _menu_scene(jcli, monkeypatch, capsys)
    tscene, ttext = _menu_scene(tcli, monkeypatch, capsys)
    assert ttext == jtext
    assert "invalid coordinate 'q9'" in ttext
    assert "'b4': 'cube'" in ttext and "'b6': 'light'" in ttext
    for name, value in tscene.tensors().items():
        np.testing.assert_allclose(value.numpy(),
                                   np.asarray(getattr(jscene, name)),
                                   atol=1e-6, err_msg=name)
    for name in ("checker_mats", "chain_exact", "has_transmission"):
        assert getattr(tscene, name) == getattr(jscene, name)


def test_interactive_renders(tmp_path, monkeypatch, capsys):
    out = tmp_path / "scene.ppm"
    monkeypatch.setattr("sys.stdin", io.StringIO(MENU_FEED))
    img = tcli.main(["interactive", "--size", "32", "--depth", "1", "--cpu",
                     "--out", str(out)])
    assert read_ppm(str(out)).shape == (32, 32, 3)
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
    assert img.mean() > 0


@pytest.mark.parametrize("cmd", ["render", "interactive"])
def test_no_gpu_without_cpu_flag_raises(tmp_path, monkeypatch, cmd):
    """Without --cpu the CLI renders on the GPU or raises; it never moves
    to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.stdin", io.StringIO(MENU_FEED))
    with pytest.raises(RuntimeError, match="--cpu"):
        tcli.main([cmd, "--size", "16", "--out", str(tmp_path / "x.ppm")])
    assert not (tmp_path / "x.ppm").exists()


@pytest.mark.parametrize("no_prune", [False, True], ids=["prune",
                                                         "no-prune"])
@pytest.mark.parametrize("cmd", ["render", "interactive", "fit"])
def test_no_prune_reaches_the_config(tmp_path, monkeypatch, cmd, no_prune):
    """``fit --views 2 --no-prune`` renders the core's multi-view targets
    with ``RenderConfig.prune`` False, so the bounding-sphere prune mask is
    never formed (JAX cli.py:38-39, 62, 164 give the flag that meaning;
    JAX's fit parses it and ignores it).  ``render`` and ``interactive``
    run only the kernels, which never prune: they keep the default and
    refuse the flag rather than take it as a no-op."""
    from ray_tracer_fragment_shader_tpu_torch.diff import multiview
    from ray_tracer_fragment_shader_tpu_torch.ops import intersect
    got = {"masks": 0}

    class Stop(Exception):
        pass

    real_mask, real_views = intersect.group_prune_mask, multiview.render_views

    def mask(*a, **kw):
        got["masks"] += 1
        return real_mask(*a, **kw)

    def views(scene, cams, cfg, **kw):
        got["cfg"] = cfg
        got["targets"] = real_views(scene, cams, cfg, **kw)
        raise Stop

    def capture(scene, cam, cfg, *rest, **kw):
        got["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(intersect, "group_prune_mask", mask)
    monkeypatch.setattr(tcli, "_render_and_write", capture)
    monkeypatch.setattr(multiview, "render_views", views)
    monkeypatch.setattr("sys.stdin", io.StringIO(MENU_FEED))
    argv = {"render": ["render", "--preset", "full_reflective"],
            "interactive": ["interactive"],
            "fit": ["fit", "--views", "2"]}[cmd]
    argv += ["--size", "16", "--cpu", "--out", str(tmp_path / "x.ppm")]
    if cmd != "fit" and no_prune:
        with pytest.raises(SystemExit):
            tcli.main(argv + ["--no-prune"])
        assert "cfg" not in got
        return
    with pytest.raises(Stop):
        tcli.main(argv + (["--no-prune"] if no_prune else []))
    assert got["cfg"].prune is not no_prune
    if cmd == "fit":
        assert got["targets"].shape == (2, 16, 16, 3)
        assert bool(torch.isfinite(got["targets"]).all())
        assert (got["masks"] > 0) is not no_prune


def test_unknown_preset_rejected():
    with pytest.raises(SystemExit):
        tcli.main(["render", "--preset", "nope", "--cpu"])
