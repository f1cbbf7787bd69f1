"""BENCHMARK.json against the contract's form, and a new cell added by
data files alone: a configuration, a traffic mix and a metric reader that
the harness finds by their names, with no edit to its code."""
import _bench_setup  # noqa: F401

import glob
import json
import os
import re
import shutil
import time

import numpy as np

from benchmark import harness
from _bench_setup import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_has_the_contracts_form():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    spec = json.load(open(path))
    assert set(spec) == KEYS["top"]
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            extra = set(e) - KEYS[group]
            assert extra <= ({"workloads"} if group in ("end_to_end",
                                                        "per_layer")
                             else set()), (group, extra)
            assert KEYS[group] <= set(e), (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            names.add((group in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
        assert len({e["name"] for e in spec[group]}) == len(spec[group])
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    four = [w for w in cells.values() if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells.values())
    assert len(four) <= max(1, len(cells) // 4)
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert all(NAME.match(k) and k in data for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in cells.values():
        assert NAME.match(w["traffic"])
        traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                              f"{w['traffic']}.json")))
        assert "limits" in traffic
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           f"{traffic['kind']}.py"))
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    setup = [m for m in spec["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           f"{m['name']}.py")), m["name"]
        assert set(m.get("workloads", cells)) <= set(cells)
    for name in cells:
        cell = harness.find_cell(spec, name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in e2e, (name, m["name"])
    layers = {m["layer"] for m in spec["per_layer"]}
    assert all(_line(x) for x in layers)


def test_paths_hold_only_the_benchmark_and_files_are_named_by_names():
    for f in glob.glob(os.path.join(ROOT, "benchmark", "**", "*"),
                       recursive=True):
        rel = os.path.relpath(f, ROOT)
        if "__pycache__" in rel:
            continue
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", rel), rel


def _copy(tmp_path):
    """A copy of the benchmark (its tests left out) and its Python files'
    bytes, to show that adding files leaves every one of them as it was."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = {str(p.relative_to(bench)): p.read_bytes()
            for p in bench.rglob("*.py")}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    return bench, code, spec


def _find(tmp_path, bench, spec, name):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.find_cell(harness.load_spec(str(tmp_path)), name,
                             root=str(tmp_path), bench_dir=str(bench))


def _unchanged(bench, code):
    return all((bench / k).read_bytes() == v for k, v in code.items())


def test_a_new_cell_from_data_files_alone(tmp_path):
    """A configuration, a traffic mix of an existing kind and a per-layer
    metric reader added as files, and entries added to BENCHMARK.json: the
    harness code, unchanged, finds them by name and runs the cell."""
    bench, code, spec = _copy(tmp_path)
    cfg = json.load(open(bench / "configs" / "config5_spheres64.json"))
    cfg.update(name="spheres8_small", width=16, height=16, max_depth=2,
               reduced=["spheres", "width", "height", "max_depth"],
               camera=dict(cfg["camera"], pixel_scale=32.0))
    cfg["scene"] = dict(cfg["scene"], spheres=8)
    (bench / "configs" / "spheres8_small.json").write_text(json.dumps(cfg))
    traffic = json.load(open(bench / "traffic" / "fit_jobs_4096.json"))
    traffic.update(steps_per_job=4, move=2.0)
    (bench / "traffic" / "fit_jobs_short.json").write_text(
        json.dumps(traffic))
    (bench / "metrics" / "fit_steps.fit.py").write_text(
        "def read(record):\n    return record.units\n")
    spec["configs"].append(dict(name="spheres8_small", source="a test",
                                file="benchmark/configs/spheres8_small.json",
                                reduced=[], why="a test"))
    spec["workloads"].append(dict(name="spheres8_small.fit_short",
                                  config="spheres8_small",
                                  traffic="fit_jobs_short", chips=1,
                                  why="a test"))
    spec["per_layer"].append(dict(name="fit_steps.fit", unit="steps",
                                  better="higher", source="program_counter",
                                  layer="entry", moves="fit_rays_per_s",
                                  workloads=["spheres8_small.fit_short"]))
    cell = _find(tmp_path, bench, spec, "spheres8_small.fit_short")
    assert cell.config["scene"]["spheres"] == 8
    assert cell.traffic["steps_per_job"] == 4
    res = harness.run_cell(cell, 2 ** 31 + 5, 0.3, True, time.perf_counter(),
                           device="cpu")
    assert res["correct"]
    assert res["metrics"]["fit_steps.fit"]["value"] == res["attempted"]
    assert _unchanged(bench, code)


KIND = """\"\"\"Frames of one eye: an orbit that does not turn.\"\"\"
import dataclasses
import os

from benchmark import harness

_orbit = harness.kind_module(
    "orbit_frames", os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
KIND, FAULTS, CHIP_FAULTS = _orbit.KIND, _orbit.FAULTS, _orbit.CHIP_FAULTS


def run(cell, *args, **kw):
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  step_deg=0.0))
    return _orbit.run(cell, *args, **kw)
"""

SCENE = """\"\"\"The procedural scene with its spheres in a row across the
board.\"\"\"
import numpy as np

from benchmark import inputs


def arrays(scene, seed):
    a = inputs.scene_builder("procedural_spheres")(scene, seed)
    n, half = int(scene["spheres"]), float(scene["board_half"])
    a["sph_center"][:n, 0] = a["board_pos"][0] + np.linspace(
        -0.8 * half, 0.8 * half, n)
    a["sph_center"][:n, 2] = a["board_pos"][2]
    return a
"""


def test_a_new_traffic_kind_and_scene_kind_from_files_alone(tmp_path):
    """A traffic kind (``traffic/<kind>.py``) and a scene kind
    (``scenes/<kind>.py``) added as files, with a mix, a configuration and
    a metric reader that use them: the harness, unchanged, finds each by
    name, and the cell runs, traced, with its answers checked."""
    bench, code, spec = _copy(tmp_path)
    (bench / "traffic" / "still_frames.py").write_text(KIND)
    (bench / "scenes" / "sphere_row.py").write_text(SCENE)
    traffic = json.load(open(bench / "traffic" / "orbit_frames_4096.json"))
    traffic.update(kind="still_frames", warmup_frames=1)
    (bench / "traffic" / "still_frames_small.json").write_text(
        json.dumps(traffic))
    cfg = json.load(open(bench / "configs" / "config5_spheres64.json"))
    cfg.update(name="row8_small", width=16, height=16, max_depth=2,
               camera=dict(cfg["camera"], pixel_scale=32.0))
    cfg["scene"] = dict(cfg["scene"], kind="sphere_row", spheres=8)
    (bench / "configs" / "row8_small.json").write_text(json.dumps(cfg))
    (bench / "metrics" / "frames_seen.frame.py").write_text(
        "def read(record):\n    return record.units\n")
    spec["configs"].append(dict(name="row8_small", source="a test",
                                file="benchmark/configs/row8_small.json",
                                reduced=[], why="a test"))
    spec["workloads"].append(dict(name="row8_small.still", chips=1,
                                  config="row8_small",
                                  traffic="still_frames_small", why="a test"))
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + [
        "row8_small.still"]) if m["name"] == "frame_rays_per_s" else m
        for m in spec["end_to_end"]]
    spec["per_layer"].append(dict(name="frames_seen.frame", unit="frames",
                                  better="higher", source="program_counter",
                                  layer="entry", moves="frame_rays_per_s",
                                  workloads=["row8_small.still"]))
    cell = _find(tmp_path, bench, spec, "row8_small.still")
    from benchmark import inputs
    arrays = inputs.scene_arrays(cell.config["scene"], 7, str(bench))
    assert np.all(arrays["sph_center"][:8, 2] == arrays["board_pos"][2])
    res = harness.run_cell(cell, 2 ** 31 + 6, 0.3, True, time.perf_counter(),
                           device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_seen.frame"]["value"] == res["attempted"]
    bad = harness.run_cell(cell, 2 ** 31 + 6, 0.3, False,
                           time.perf_counter(), device="cpu",
                           fault="half_batch")
    assert not bad["correct"]
    assert _unchanged(bench, code)
