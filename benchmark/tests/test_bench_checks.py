"""The check that decides ``correct``, on the CPU at a test's size: sound
runs pass; the control (the program's own bfloat16 shading) fails; and a
run with the timed path broken underneath fails, once for each fault the
cell can have (``faults.py``).  The harness's look for a chip is skipped:
these drive ``run_cell`` on the program's plain versions."""
import _bench_setup  # noqa: F401

import pytest

from _bench_setup import run_small

FIT = "config5_spheres64.fit_4096"
FRAME = "config5_spheres64.frame_4096"


def _failed(res):
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", [FIT, FRAME])
def test_sound_runs_are_correct(cell):
    res = run_small(cell, size=24)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", [FIT, FRAME])
def test_the_control_is_not_correct(cell):
    res = run_small(cell, size=24, control=True)
    assert not res["correct"] and _failed(res)


@pytest.mark.parametrize("cell,fault", [
    (FIT, "state_unchanged"), (FIT, "half_batch"), (FIT, "answer_altered"),
    (FRAME, "half_batch"), (FRAME, "answer_altered"),
    (FRAME, "nan_pixels")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = run_small(cell, size=24, fault=fault)
    assert not res["correct"], (fault, res["checks"])


def test_non_finite_pixels_count_as_off_and_as_failed():
    """A frame with a few NaN pixels: those pixels are off (NaN compares
    false with the limit), and each checked frame holding one is failed."""
    res = run_small(FRAME, size=24, fault="nan_pixels")
    assert res["failed"] >= 1
    assert res["checks"]["off_pixels"]["value"] >= 3 / (24 * 24)
