"""One JAX subprocess per test module of the port that compares with the
JAX package's XLA paths (test_torch_core.py, test_torch_soft_multiview.py,
test_torch_parallel.py): the module, run as a script, computes every
JAX-side array it compares with and saves them to an npz.

The subprocess runs with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``: XLA's
compiled CPU programs otherwise contract ``a*b + c`` into fused
multiply-adds (AVX2's FMA), where op-by-op JAX, PyTorch's CPU operations
and the port's kernels (built with ``-fmad=false``) round every
operation.  tests/conftest.py imports jax first, so the flag cannot be set
in the test process.  The script sets ``jax_disable_most_optimizations``
too: its programs compile in two thirds of the time, to the same outputs.

``start`` starts it (with an npz of inputs, when the port computes some),
and its ``result()`` collects its arrays: a module starts it as it
starts, so the module's tests that need no JAX run beside it, on the one
PyTorch CPU thread every port test module runs on
(``tests/torch_cpu_threads.py``).  ``run`` does both.  ``port_scene`` and
``port_configs`` carry the JAX package's scene and configs across to the
port.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pending:
    """A running JAX subprocess and the npz it writes."""

    def __init__(self, proc: subprocess.Popen, out):
        self.proc, self.out, self.arrays = proc, out, None

    def result(self) -> dict:
        """Waits for the subprocess; its npz as a dict of arrays."""
        if self.arrays is None:
            _, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            with np.load(self.out) as z:
                self.arrays = {k: z[k] for k in z.files}
        return self.arrays

    def cancel(self) -> None:
        """Ends the subprocess if it still runs (no test asked for it)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def start(script: str, out, inputs: dict = None, extra=()) -> Pending:
    """Starts ``python script out [inputs.npz] [extra...]`` on the CPU
    without FMA in XLA."""
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    args = [sys.executable, os.path.abspath(script), str(out)]
    if inputs is not None:
        args.append(str(out) + ".inputs.npz")
        np.savez(args[-1], **inputs)
    args += [str(a) for a in extra]
    return Pending(subprocess.Popen(args, env=env, cwd=REPO,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE, text=True), out)


def run(script: str, out, inputs: dict = None) -> dict:
    """``start(script, out, inputs).result()``."""
    return start(script, out, inputs).result()


def port_scene(js):
    """The JAX FlatScene ``js`` as the port's, leaf for leaf."""
    from ray_tracer_fragment_shader_tpu_torch.scene.flat import FlatScene
    meta = ("checker_mats", "chain_exact", "has_transmission")
    arrays = {k: np.asarray(getattr(js, k))
              for k in FlatScene.__dataclass_fields__ if k not in meta}
    return FlatScene.from_numpy(arrays, checker_mats=js.checker_mats,
                                chain_exact=js.chain_exact,
                                has_transmission=js.has_transmission)


def port_configs(*configs):
    """The JAX package's CameraConfig and RenderConfig dataclasses as the
    port's (the same fields)."""
    from ray_tracer_fragment_shader_tpu_torch import config
    return tuple(getattr(config, type(c).__name__)(**dataclasses.asdict(c))
                 for c in configs)


def configure_jax() -> None:
    """The script side: JAX on the CPU, most optimizations off."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_disable_most_optimizations", True)
