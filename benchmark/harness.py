"""One run of one cell: set-up from the seed, a measured window, the check
against the plain reference, one JSON line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<name>.json``: the scene, the frame, the
precision, the deployment) and a traffic mix (``traffic/<name>.json``: its
``kind`` and parameters).  Each kind of traffic is a module of its own,
``traffic/<kind>.py``, found by that name; it drives the program through a
run and judges what the window produced:

* ``run(cell, seed, seconds, trace, device, t_start, control, log)``
  makes the inputs from the seed, builds the program's step once, warms
  every shape the window uses (``setup_s``: from the process's start to
  the first timed unit, the reference's own work left out), measures for
  ``seconds`` (under ``traced`` with ``trace``) and returns the window's
  figures, a ``Record`` for the metric readers, ``judge`` and ``release``;
* ``judge()``, called once the program's state is freed, returns the
  numbers that decide ``correct`` (``checks``: each a value and its limit)
  and the count of answers that came back non-finite (``failed``);
* ``FAULTS`` names the faults of ``faults.py`` that its cells can have,
  ``CHIP_FAULTS`` those to read on the chip.

Each metric is read by ``metrics/<name>.py`` (``read(record)`` returns a
number or None) from the ``Record`` of the run.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from . import faults, opcount, stats

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracer_fragment_shader_tpu")
#: the kernels of one two-phase adjoint call (K4): the live list, the
#: adjoint and the column sums (kernels/csrc/adjoint_packed.cu)
K4_KERNELS = ("live_mark_kernel", "live_scan_kernel", "live_scatter_kernel",
              "adjoint_packed_kernel", "adjoint_reduce_kernel")
#: the chain forward (K2 in a frame, K3 in a fit step: csrc/render_chain.cu),
#: one launch a unit, so it splits a trace into units
CHAIN_KERNEL = "render_chain_kernel"
#: host spans of the profiler's and the benchmark's own, which say nothing
#: of what the host was doing for the program
PROFILER_OWN = ("Activity Buffer Request", "bench.window")


# ----------------------------------------------------------------- cells

@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    #: the directory of the traffic kinds and mixes, scenes and metrics
    bench_dir: str = BENCH_DIR


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def find_cell(spec: dict, name: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``spec``, its configuration file (under
    ``root``) and traffic file (``<bench_dir>/traffic/``) read and its
    metrics picked."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                bench_dir=bench_dir)


_MODULES: Dict[str, Any] = {}


def load_file(path: str, tag: str):
    """The module of the file ``path`` (loaded once a process)."""
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``<bench_dir>/metrics/<name>.py``'s ``read``."""
    return load_file(os.path.join(bench_dir, "metrics", f"{name}.py"),
                     f"benchmark_metric_{name}").read


def kind_module(kind: str, bench_dir: str = BENCH_DIR):
    """The traffic kind ``<bench_dir>/traffic/<kind>.py``."""
    return load_file(os.path.join(bench_dir, "traffic", f"{kind}.py"),
                     f"benchmark_traffic_{kind}")


def forbidden_modules() -> List[str]:
    """The forbidden top-level modules this process has loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------- traces

class Trace:
    """The profiler's events of a traced window: device operations and
    host operations as (name, start_ns, end_ns), and the window."""

    def __init__(self, device_ops, host_ops, window: Tuple[int, int]):
        self.window = window
        w0, w1 = window
        self.device = sorted((n, max(s, w0), min(e, w1))
                             for n, s, e in device_ops if e > w0 and s < w1)
        self.device.sort(key=lambda r: r[1])
        self.host = sorted(host_ops, key=lambda r: r[1])
        self.window_s = (w1 - w0) / 1e9
        self.busy_s = stats.union_length(
            (s, e) for _, s, e in self.device) / 1e9

    def units(self, anchor: str) -> List[List[Tuple[str, int, int]]]:
        """The device operations split into units (steps or frames), each
        from one ``anchor`` launch to the next."""
        starts = [s for n, s, _ in self.device if anchor in n]
        out: List[List[Tuple[str, int, int]]] = [[] for _ in starts]
        k = -1
        for r in self.device:
            while k + 1 < len(starts) and r[1] >= starts[k + 1]:
                k += 1
            if k >= 0:
                out[k].append(r)
        return out

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 host
        operations under which the device sat idle longest."""
        by_op: Dict[str, float] = {}
        for n, s, e in self.device:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) / 1e9
        holes = sorted(stats.gaps(((s, e) for _, s, e in self.device),
                                  *self.window),
                       key=lambda g: g[0] - g[1])[:4000]
        starts = [s for _, s, _ in self.host]
        by_host: Dict[str, float] = {}
        for g0, g1 in holes:
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "(no host operation)"
            for j in range(i, max(i - 4000, -1), -1):
                if self.host[j][2] >= mid:
                    name = self.host[j][0]
                    break
            key = name[:120]
            by_host[key] = by_host.get(key, 0.0) + (g1 - g0) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda r: -r[1])[:10]]
        return dict(device_ops=top(by_op), idle_gaps=top(by_host))


def _events(prof) -> Tuple[list, list, Optional[Tuple[int, int]]]:
    """(device ops, host ops, the window's span) of a finished
    ``torch.profiler`` session, as (name, start_ns, end_ns)."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        (dev if e.device_type() == cuda else host).append(
            (e.name(), s, s + e.duration_ns()))
    # the host's annotations, which the profiler mirrors onto the device,
    # span work and do none
    marks = {n for n, _, _ in host}
    dev = [r for r in dev if r[0] not in marks]
    win = next(((s, e) for n, s, e in host if n == "bench.window"), None)
    host = [r for r in host if r[0] not in PROFILER_OWN]
    return dev, host, win


@contextlib.contextmanager
def traced(enabled: bool, device: torch.device):
    """A ``torch.profiler`` session around the window when ``enabled``;
    yields a dict that holds the ``Trace`` once the session has ended."""
    box: Dict[str, Any] = {}
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            yield box
    dev, host, win = _events(prof)
    if win is None:
        raise RuntimeError("the profiler recorded no window span")
    box["trace"] = Trace(dev, host, win)


# ---------------------------------------------------------------- records

class Probe(NamedTuple):
    """A window unit whose work is counted: its device operations, the
    stretch of the device's time line from its first launch to the next
    unit's (or the window's end), and its work."""
    ops: List[Tuple[str, int, int]]
    span_s: float
    work: dict


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers."""
    cell: Cell
    kind: str                      # "fit" or "frame"
    chips: int
    width: int
    height: int
    setup_s: float
    window_s: float
    units: int                     # steps or frames finished in the window
    latencies_s: List[float]
    trace: Optional[Trace] = None
    #: the window units whose work is counted: index -> a function that
    #: counts it on the reference's own forward (called by traced readers)
    probes: Dict[int, Callable[[], dict]] = dataclasses.field(
        default_factory=dict)
    _probed: Optional[List[Probe]] = None

    @property
    def rays(self) -> int:
        return self.width * self.height

    def probed(self) -> List[Probe]:
        """The probe units, where the trace splits into as many units as
        the window ran (their work counted once)."""
        if self._probed is None:
            self._probed = []
            if self.trace is not None and self.probes:
                units = self.trace.units(CHAIN_KERNEL)
                if len(units) == self.units:
                    for i in sorted(self.probes):
                        if not 0 <= i < len(units) or not units[i]:
                            continue
                        end = (units[i + 1][0][1] if i + 1 < len(units)
                               else self.trace.window[1])
                        self._probed.append(Probe(
                            units[i], (end - units[i][0][1]) / 1e9,
                            self.probes[i]()))
        return self._probed


def kernel_ms(ops, *parts: str) -> float:
    return sum(e - s for n, s, e in ops if any(p in n for p in parts)) / 1e6


def roofline(record: Record, work: str, *kernels: str) -> Optional[float]:
    """The probe units' least time for their ``work`` (``opcount``'s
    bound) over the device time of their launches of ``kernels``, in %."""
    bound = spent = 0.0
    for p in record.probed():
        t = kernel_ms(p.ops, *kernels)
        if t > 0.0 and work in p.work:
            bound += opcount.bound_ms(p.work[work]["ops"],
                                      p.work[work]["bytes"])
            spent += t
    return 100.0 * bound / spent if spent > 0.0 else None


def step_mfu(record: Record) -> Optional[float]:
    """The whole unit's share of the chips' FP32 peak, over the probe
    units: their operations over their spans of the device's time line
    (launches, copies and the idle time between) times the peak, in %."""
    probed = [p for p in record.probed() if p.work.get("ops")]
    span = sum(p.span_s for p in probed)
    if span <= 0.0:
        return None
    ops = sum(p.work["ops"] for p in probed)
    return 100.0 * ops / (span * record.chips * opcount.PEAK_FP32_FLOPS)


# ------------------------------------------------------------ the device

def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_memory_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ------------------------------------------------------------------- run

def log_out(msg: str) -> None:
    """A line on standard output (before the result's) and on standard
    error."""
    print(msg, flush=True)
    log_err(msg)


def log_err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stamper(t_start: float) -> Callable[[str], None]:
    """Logs what set-up has done, with the seconds since ``t_start``."""
    return lambda what: log_err(
        f"{what} at {time.perf_counter() - t_start:.3f} s")


def collect(cell: Cell, out: dict, trace: bool, device) -> dict:
    """The result of a run: the metrics, the device, then the check (the
    program's state freed first, its peak already read)."""
    record: Record = out["record"]
    metrics = {}
    t = time.perf_counter()
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.bench_dir)(record)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    log_err(f"metrics read in {time.perf_counter() - t:.3f} s")
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
               count=cell.chips, memory_peak_bytes=int(out["memory_peak"]))
    result = dict(correct=False, attempted=int(out["units"]),
                  failed=int(out["failed"]), metrics=metrics, device=dev)
    if trace:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    record.trace = None
    out["release"]()
    free(device)
    t = time.perf_counter()
    verdict = out["judge"]()
    log_err(f"checked against the reference in "
            f"{time.perf_counter() - t:.3f} s")
    checks = verdict.pop("checks")
    result["failed"] += int(verdict.pop("failed", 0))
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    result["correct"] = bool(ok and result["failed"] == 0)
    result["forbidden"] = forbidden_modules()
    result["detail"] = verdict
    result["checks"] = checks
    return result


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, control: bool = False,
             fault: Optional[str] = None) -> dict:
    """One run of ``cell``: the result dict (the JSON line's keys, with
    ``checks`` last).  ``device`` None is the card; ``control`` runs the
    program in its own lower precision, ``fault`` plants one of
    ``faults.FAULTS`` under the timed path."""
    kind = kind_module(cell.traffic["kind"], cell.bench_dir)
    if cell.chips not in getattr(kind, "CHIPS", (1,)):
        raise ValueError(f"{cell.traffic['kind']} traffic does not run on "
                         f"{cell.chips} chips")
    if fault is not None and fault not in kind.FAULTS:
        raise ValueError(f"{cell.traffic['kind']} cells have no {fault!r}")
    device = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    with faults.planted(fault):
        out = kind.run(cell, seed, seconds, trace, device, t_start,
                       control=control, log=log_out)
    return collect(cell, out, trace, device)


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = find_cell(load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start)
    print(f"card: {_card()}", file=sys.stderr)
    found = result.pop("forbidden")
    if found:
        print(f"loaded forbidden modules: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
