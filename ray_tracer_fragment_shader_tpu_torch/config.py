"""Typed configuration of the PyTorch/CUDA ray tracer (framework-free; the
same dataclasses as ``ray_tracer_fragment_shader_tpu.config``).

The reference has no config system: every knob is a compile-time constant in
``Hw4/MySdlApplication.cpp:16-52`` (window 500x500, MAX_DEPTH=5,
SUPER_SAMPLE_NUMBER=16, ATTENUATION_FACTOR=1e5, board 320/8x8, camera at
``:38-40``) plus an interactive stdin menu (``:1450-1490``).  Here those knobs
become typed dataclasses (SURVEY.md section 5, "Config / flag system").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Reference constants (Hw4/MySdlApplication.cpp:31-52, 570).
# ---------------------------------------------------------------------------
WHITE: Tuple[float, float, float] = (1.0, 1.0, 1.0)
BLACK: Tuple[float, float, float] = (0.0, 0.0, 0.0)
RED: Tuple[float, float, float] = (1.0, 0.0, 0.0)

#: Light attenuation constant A in A/(A+d^2)  (MySdlApplication.cpp:35,1171-1182).
ATTENUATION_FACTOR: float = 100000.0

#: Camera defaults (MySdlApplication.cpp:38-40).
CAMERA_POSITION: Tuple[float, float, float] = (0.0, 100.0, 200.0)
LOOK_AT_VECTOR: Tuple[float, float, float] = (0.0, 0.0, -160.0)
UP_VECTOR: Tuple[float, float, float] = (0.0, 1.0, 0.0)

#: Chess-board geometry (MySdlApplication.cpp:42-46).
BOARD_POSITION: Tuple[float, float, float] = (0.0, 0.0, -160.0)
BOARD_EDGE_SIZE: float = 320.0
BOARD_HALF_SIZE: float = BOARD_EDGE_SIZE / 2.0
NUM_SQUARES: int = 8
SQUARE_EDGE_SIZE: float = BOARD_EDGE_SIZE / NUM_SQUARES

#: Recursion depth of the bounce tree (MySdlApplication.cpp:48).
MAX_DEPTH: int = 5

#: Epsilon used throughout intersection tests (MySdlApplication.cpp:50).
SMALL_NUMBER: float = 1e-4

#: Samples per pixel for the adaptive supersampler (MySdlApplication.cpp:52).
SUPER_SAMPLE_NUMBER: int = 16

#: Default window size (MySdlApplication.cpp:570).
DEFAULT_WINDOW: int = 500


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Viewing setup mirroring ``rayTraceScreen``'s arguments.

    The reference builds the camera basis per frame from eye/lookAt/up and a
    screen rectangle anchored at the look-at point
    (``Hw4/MySdlApplication.cpp:1251-1282``): ``right = normalize(look x up)``,
    ``up' = normalize(right x look)`` and the bottom-left screen point is
    ``lookAt + bottom_x*right + bottom_y*up'`` with one world unit per pixel.
    """

    eye: Tuple[float, float, float] = CAMERA_POSITION
    look_at: Tuple[float, float, float] = LOOK_AT_VECTOR
    up: Tuple[float, float, float] = UP_VECTOR
    #: Offset (in world units) of the screen's bottom-left corner from the
    #: look-at point.  ``None`` means ``-width*pixel_scale/2`` (the
    #: reference's ``-width/2`` at pixel_scale 1, ``draw()``,
    #: MySdlApplication.cpp:1560).
    bottom_x: Optional[float] = None
    bottom_y: Optional[float] = None
    #: World units per pixel.  The reference hardcodes 1 (``screenPt +=
    #: right`` per pixel, ``:1315``), coupling field of view to resolution;
    #: this generalization decouples them (e.g. render the 512-unit window
    #: at any resolution with pixel_scale = 512/size).
    pixel_scale: float = 1.0

    def bottom(self, width: int, height: int) -> Tuple[float, float]:
        bx = (-width * self.pixel_scale / 2.0 if self.bottom_x is None
              else self.bottom_x)
        by = (-height * self.pixel_scale / 2.0 if self.bottom_y is None
              else self.bottom_y)
        return bx, by


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time knobs.

    ``mode`` selects the bounce-loop strategy:

    * ``"chain"`` — iterative single-path loop.  Exact for scenes where every
      material's transparency is all-zeros or all-ones (true for all five
      reference materials, MySdlApplication.cpp:583-588): the reference then
      traces exactly one child ray per hit (``:1238-1246``).
    * ``"tree"`` — full binary bounce tree (reflection + transmission children
      at every hit), the literal semantics of ``rayTraceRay``
      (MySdlApplication.cpp:1230-1248).  Cost grows as 2^depth; used for
      parity tests and scenes with fractional transparency.
    * ``"auto"`` — chain when the scene statically allows it, else tree.
    """

    width: int = DEFAULT_WINDOW
    height: int = DEFAULT_WINDOW
    max_depth: int = MAX_DEPTH
    #: Samples per pixel.  1 disables jitter unless ``force_jitter``.
    samples: int = 1
    #: Radius of the 3-D jitter sphere applied to the screen point; the
    #: reference jitters by ``0.5 * randomUnit()`` (MySdlApplication.cpp:1296).
    jitter_scale: float = 0.5
    force_jitter: bool = False
    seed: int = 0
    mode: str = "auto"
    #: Emulate the reference's adaptive supersampler semantics
    #: (MySdlApplication.cpp:1294-1311): samples stop counting once the
    #: weighted running average converges, and the final divisor is the
    #: loop variable at exit (the reference's /k quirk, sum of k+1 samples
    #: divided by k).  Same outputs, SPMD-friendly (all samples computed,
    #: convergence applied as a mask).
    adaptive: bool = False
    #: Replicate the reference's hierarchical bounding-sphere prune
    #: (Shape::intersection, MySdlApplication.cpp:747-758).  For well-formed
    #: scenes (all geometry inside its bounding sphere) this only rejects rays
    #: that would miss anyway.  The kernel path skips the prune (no image
    #: effect); the core renderer (core/renderer.py) applies it.
    prune: bool = True
    small_number: float = SMALL_NUMBER
    attenuation_factor: float = ATTENUATION_FACTOR
    #: Pixels per chunk of the core renderer (core/renderer.py).
    chunk_size: int = 65536
    #: Computation dtype.  The kernels compute in float32; the reference
    #: uses float64 on CPU.
    dtype: str = "float32"
    #: Split-precision shading (bfloat16 shadow sweeps and Phong blend) of
    #: the JAX package's Pallas kernels.  Kept so configs stay
    #: interchangeable; the CUDA kernel path raises NotImplementedError
    #: when it is set.
    bf16_shading: bool = False

    def resolved_mode(self, chain_exact: bool) -> str:
        if self.mode == "auto":
            return "chain" if chain_exact else "tree"
        return self.mode
