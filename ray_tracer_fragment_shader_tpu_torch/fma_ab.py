"""The kernels built with and without fused multiply-add in the forwards,
in one call on one card.

    python -m ray_tracer_fragment_shader_tpu_torch.fma_ab

``kernels/cuda_build.py`` builds every source with ``-fmad=false``.  This
builds the library a second time as it was built before the fit kernels'
forward joined the render kernels' (contraction on in render_chain.cu and
render_tree.cu, off in the adjoint sources) and compares the two builds:

* times: the chain kernel at config 3 1024^2 d3 and config 5 2048^2 d3,
  the tree kernel at fractional_glass 1024^2 d3, by CUDA events
  (``utils/timing.py``), builds alternated fma, no fma, no fma, fma;
* parity at 128^2 on full_reflective d3, procedural_spheres n=64 d3 and
  glass_chain d3 (sphere centres + 1.5, target the unperturbed render):
  the packed forward's fraction of pixels more than 1e-3 from its plain
  version and of packed residuals that differ, and K6
  against K3 + K4 on the same inputs (max|diff| / max|K3+K4| of the loss
  and each gradient table).

Prints the card's name and power limit first and one JSON line last.
Needs one CUDA GPU.
"""
from __future__ import annotations

import json
import subprocess

import torch

from .diff.fit import FitParams
from .kernels import adjoint_fused as AF
from .kernels import cuda_build
from .kernels import render as K
from .ops.rays import Camera, primary_rays, screen_points
from .scene import presets
from .utils.timing import time_ms

NO_FMA = dict(cuda_build.SOURCE_FLAGS)
FMA = dict(NO_FMA, **{"render_chain.cu": (), "render_tree.cu": ()})


def _use(flags) -> None:
    """Loads the library built with the per-source ``flags`` (building it
    first)."""
    cuda_build.SOURCE_FLAGS = flags
    cuda_build._lib = None
    cuda_build.load()


def _rel(got, ref) -> float:
    scale = ref.abs().max().item()
    diff = (got - ref).abs().max().item()
    return diff / scale if scale > 0 else diff


def _rays(scene, cam, cfg, dev):
    camera = Camera.from_config(cam, cfg.width, cfg.height, device=dev)
    _, v = primary_rays(camera, screen_points(camera, cfg.width, cfg.height))
    return (K.pack_scene(scene.to(dev)), v.contiguous(), camera.eye.tolist(),
            K.render_kwargs(scene, cfg))


def _parity(make, dev):
    """Packed forward against its plain version, K6 against K3 + K4."""
    scene, cam, cfg = make()
    n = cfg.width
    camera = Camera.from_config(cam, n, n, device=dev)
    target = K.render_image_kernel(scene, camera, cfg, device=dev)
    params = FitParams.from_scene(scene)
    with torch.no_grad():
        params.sph_center += 1.5
    prep = AF.prepare_fit_inputs(camera, cfg, target, device=dev)
    v, eye = prep["v"], prep["eye"]
    _, t, kw, akw = AF.kernel_inputs(params.into_scene(scene), cfg,
                                     v.shape[0], device=dev)
    img, pk = K.render_packed(t, v, eye, pack=akw["pack"], **kw)
    ref_img, ref_pk = K.render_packed_ref(t, v, eye, pack=akw["pack"], **kw)
    k6 = AF.fused_adjoint(t, v, eye, prep["target"], prep["mask"],
                          tree=False, g_scale=akw["g_scale"], **kw)
    k34 = AF.adjoint_packed(t, v, eye, img, prep["target"], prep["mask"], pk,
                            **akw)
    return dict(
        packed_mismatch_frac=((img - ref_img).abs().amax(-1) > 1e-3)
        .float().mean().item(),
        pk_differ_frac=(pk != ref_pk).float().mean().item(),
        k6_vs_k3k4=dict(zip(("loss", "dsph", "dmat", "dlight"),
                            (_rel(a, b) for a, b in zip(k6, k34)))))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("fma_ab needs a CUDA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    timed = {
        "chain config 3 1024^2 d3": _rays(
            *presets.full_reflective(size=1024, depth=3), dev),
        "chain config 5 2048^2 d3": _rays(
            *presets.procedural_spheres(n=64, size=2048, depth=3), dev),
        "tree fractional_glass 1024^2 d3": _rays(
            *presets.fractional_glass(size=1024, depth=3), dev),
    }
    times = {}
    for name, flags in (("fma", FMA), ("no_fma", NO_FMA), ("no_fma", NO_FMA),
                        ("fma", FMA)):
        _use(flags)
        for label, (t, v, eye, kw) in timed.items():
            render = K.render_tree if label.startswith("tree") else \
                K.render_chain
            ms = time_ms(lambda: render(t, v, eye, **kw), 20)
            times.setdefault(label, {}).setdefault(name, []).append(ms)
    for label, runs in times.items():
        print(f"{label}: fma {runs['fma']} ms, no fma {runs['no_fma']} ms "
              f"[{card}]")
    scenes = {
        "full_reflective d3": lambda: presets.full_reflective(size=128,
                                                              depth=3),
        "procedural_spheres n64 d3": lambda: presets.procedural_spheres(
            n=64, size=128, depth=3),
        "glass_chain d3": lambda: presets.glass_chain(size=128, depth=3),
    }
    parity = {}
    for name, flags in (("fma", FMA), ("no_fma", NO_FMA)):
        _use(flags)
        for label, make in scenes.items():
            parity.setdefault(label, {})[name] = _parity(make, dev)
            print(f"{label} {name}: {parity[label][name]}")
    print(json.dumps(dict(card=card, times_ms=times, parity=parity)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
