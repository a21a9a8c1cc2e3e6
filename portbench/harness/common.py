"""What every cell shares: the run's context, the measured window, the
readings that the metric readers take, the judgment against the limits and
the result line."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import sys
import time

import torch

from portbench.harness import counts
from portbench.harness.trace import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "crop2seg_tpu")
TRACE_AT = 0.3        # the traced stretch starts this share into the window
CONTROLS = 3          # calibration: the seeds that also read the control and faults


@dataclasses.dataclass
class Run:
    """One run of one cell. ``program`` is the module holding the system
    under test's entry points (``harness/program.py``)."""
    cell: dict             # the cell's entry of BENCHMARK.json
    cfg: dict
    mix: dict
    limits: dict
    metrics: list          # the cell's metric entries of BENCHMARK.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    out_dir: str
    program: object
    marks: list = dataclasses.field(default_factory=list)
    unit_ends: list = dataclasses.field(default_factory=list)   # host clock, the window's units

    def mark(self, stage: str) -> None:
        """Notes the seconds since the process started at the end of a
        set-up stage (printed on standard error)."""
        self.marks.append((stage, time.time() - self.t_start))

    @property
    def dtype(self) -> torch.dtype:
        return counts.DTYPES[self.cfg["dtype"]]


@dataclasses.dataclass
class Readings:
    """What the metric readers (``metrics/<name>.py``) read. ``work``
    counts patches (tile cells) or samples (training cells)."""
    cfg: dict
    mix: dict
    dtype: torch.dtype
    setup_s: float
    window_s: float
    units: int
    work: int
    peak_bytes: int
    flops_per_work: float | None  # forward a patch, or forward + backward a sample (traced runs)
    ltae_shape: dict            # one launch of the L-TAE's kernels
    trace: dict | None = None   # the traced stretch's summary (trace.py)
    traced_work: int = 0


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def make_run(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             program=None) -> Run:
    """The cell ``name`` of BENCHMARK.json with its configuration, mix,
    limits and metric entries; LookupError if BENCHMARK.json has no such
    cell."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise LookupError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    out_dir = os.path.join(ROOT, ".portbench_out", f"{name}-{seed}")
    return Run(cell=cell, cfg=load_json(ROOT, conf["file"]),
               mix=load_json(BENCH, "traffic", f"{cell['traffic']}.json"),
               limits=load_json(BENCH, "limits", f"{name}.json"),
               metrics=layer if trace else e2e, seed=seed, seconds=seconds, trace=trace,
               device=torch.device(device), t_start=t_start, out_dir=out_dir, program=program)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def window(run: Run, unit, traced_units: int):
    """Runs ``unit(i) -> work`` for i = 0, 1, ... until ``run.seconds``
    have passed on the host's clock, then synchronizes: the window is from
    its start to that synchronize, and holds all the work issued in it.
    With ``run.trace`` the profiler covers ``traced_units`` whole units
    starting TRACE_AT into the window. Returns (units, work, seconds,
    tracer or None, traced work)."""
    tracer = Tracer(traced_units) if run.trace else None
    traced_work = 0
    sync(run.device)
    t0 = time.perf_counter()
    run.unit_ends = [t0]
    i = work = 0
    while True:
        if tracer is not None and not tracer.done and time.perf_counter() - t0 >= TRACE_AT * run.seconds:
            with tracer:
                for _ in range(tracer.units):
                    w = unit(i)
                    i, work, traced_work = i + 1, work + w, traced_work + w
                    run.unit_ends.append(time.perf_counter())
        else:
            work += unit(i)
            i += 1
            run.unit_ends.append(time.perf_counter())
        if time.perf_counter() - t0 >= run.seconds and (tracer is None or tracer.done):
            break
    sync(run.device)
    return i, work, time.perf_counter() - t0, tracer, traced_work


def read_metrics(run: Run, readings: Readings) -> dict:
    """Each of the cell's metrics from its reader ``metrics/<name>.py``;
    a reader that finds nothing to read returns None and the metric is
    left out."""
    out = {}
    for m in run.metrics:
        path = os.path.join(BENCH, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every compared number finite and at most its
    limit; ``checks`` holds each number beside its limit."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def loaded_forbidden() -> list:
    """Top-level names of the loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(run: Run, peak: int, trace: dict | None) -> dict:
    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def short_name(name: str, width: int = 160) -> str:
    """A kernel's or op's name without its argument list, namespaces and
    lambda scaffolding, cut to ``width`` letters."""
    name = re.sub(r"^void ", "", name)
    for noise in ("at::native::", "(anonymous namespace)::", "at::", "c10::", "std::",
                  "(TensorIteratorBase&)"):
        name = name.replace(noise, "")
    name = re.sub(r"::\{lambda\([^)]*\)#\d+\}(::operator\(\)\(\) const)?", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:width]


def breakdown(trace: dict) -> dict:
    """The ten device ops that took most time and the ten longest idle
    stretches by what the host was doing, in seconds as measured."""
    return {"device_ops": [[short_name(name), s] for name, s, _ in trace["device_ops"][:10]],
            "idle_gaps": [[short_name(name), s] for name, s in trace["idle_gaps"][:10]]}


def write_summary(run: Run, trace: dict) -> None:
    """The traced stretch's summary, under the run's own output directory."""
    os.makedirs(run.out_dir, exist_ok=True)
    with open(os.path.join(run.out_dir, "profile_summary.json"), "w") as f:
        json.dump(trace, f, indent=1)
