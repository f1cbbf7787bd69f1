"""What the benchmark's CPU tests share: the repository root on the path,
one PyTorch thread, and cells cut to a test's size."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

from benchmark import harness  # noqa: E402

#: past 2^31, as the checks' seeds are
SEED = 2 ** 31 + 4242


def small_cell(name: str, size: int = 16, steps_per_job: int = 5):
    """Cell ``name`` of BENCHMARK.json at ``size`` pixels a side (the same
    512-unit window), with short fit jobs, so a window of a second holds
    several."""
    cell = harness.find_cell(harness.load_spec(), name)
    cell.config = dict(cell.config, width=size, height=size,
                       camera=dict(cell.config["camera"],
                                   pixel_scale=512.0 / size))
    cell.traffic = dict(cell.traffic, steps_per_job=steps_per_job)
    return cell


def run_small(name: str, size: int = 16, seconds: float = 0.5, **kw):
    import time
    return harness.run_cell(small_cell(name, size), kw.pop("seed", SEED),
                            seconds, kw.pop("trace", False),
                            time.perf_counter(), device="cpu", **kw)
