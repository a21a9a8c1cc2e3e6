"""Profiling / model-characteristics utilities (port of
crop2seg_tpu/utils/profiling.py onto CUDA events and torch.profiler).

The reference's opt-in profiling helpers (reference
src/learning/utils.py:535-608):
- ``count_params``: the model's parameter count (buffers such as
  BatchNorm's running statistics are not parameters).
- ``model_characteristics``: parameters, FLOPs and bytes accessed of one
  forward on the reference's fixed 1 x 30 x 10 x 128 x 128 probe: FLOPs
  from ``torch.utils.flop_counter`` (2 per multiply-add of the matmuls and
  convolutions), bytes as the sum over the forward's operators of their
  tensor inputs and outputs (the measure XLA's cost analysis reports).
- ``inference_time``: warmed repeated latency; on the card each call is
  timed by CUDA events around it, on the CPU by the host clock.
- ``trace``: a torch.profiler context (CPU and, where present, CUDA
  activity), its chrome trace written under ``logdir`` on exit.
- ``StepMeter``: a steps/s and samples/s meter for the train loop.

The program's own spans and counters, at the stages of its work (the tile,
the train step, the L-TAE wrappers, the aggregator, the disk stream):
- ``span(name)``: a context manager that records only while recording is on,
  that is while a torch profiler runs (on the thread that checks, which
  autograd's backward thread inherits) or while a ``collect()`` scope is
  open. Otherwise it costs one check. While the profiler runs it also opens
  ``record_function(name)``, so the span sits in the profiler's trace beside
  the device kernels its stage launched, on the same clock.
- ``count(name, n)``: a counter, under the same condition.
- ``span_table()``: what was recorded while recording was on, by name: a
  span's calls, host seconds (``time.perf_counter``) and self seconds (its
  time less that of its child spans on its own thread), and each counter.
  ``reset_spans()`` clears it. ``collect()`` yields a table of the same
  form that holds only what its scope saw. Nothing is written out.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.autograd import profiler as autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from crop2seg_tpu_torch.device import resolve_device


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class _BytesCounter(TorchDispatchMode):
    """Sums the bytes of every operator's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def model_characteristics(model: torch.nn.Module, batch_shape=(1, 30, 128, 128, 10),
                          device=None) -> Dict[str, float]:
    """Params, FLOPs and bytes accessed of one eval forward on the reference
    probe shape (learning/utils.py:544: sample 1x30x10x128x128), on
    ``device`` (the CUDA card unless "cpu" is asked for)."""
    dev = resolve_device(device)
    b, t = batch_shape[:2]
    model = model.to(dev).eval()
    x = torch.zeros(batch_shape, device=dev)
    dates = torch.arange(t, dtype=torch.float32, device=dev)[None].expand(b, t)
    mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
    with torch.inference_mode():
        flops = FlopCounterMode(display=False)
        with flops:
            model(x, dates, mask)
        counter = _BytesCounter()
        with counter:
            model(x, dates, mask)
    return {"n_params": count_params(model),
            "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.bytes)}


def inference_time(fn: Callable, args, repetitions: int = 100,
                   warmup: int = 5) -> Dict[str, float]:
    """Mean/std latency in ms (reference learning/utils.py:569-608). Where a
    CUDA card is initialized, each call is timed by CUDA events recorded
    around it on the current stream; elsewhere by the host clock."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(repetitions):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1000)
    times = np.asarray(times)
    return {"mean_ms": float(times.mean()), "std_ms": float(times.std()),
            "p50_ms": float(np.percentile(times, 50)),
            "p99_ms": float(np.percentile(times, 99))}


@contextlib.contextmanager
def trace(logdir: str = "torch_trace"):
    """torch.profiler over the block (CUDA activity too where a card is
    present); writes ``logdir/trace.json`` (chrome://tracing, Perfetto) and
    yields the profiler (``key_averages()`` for a table)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepMeter:
    """Streaming steps/sec + samples/sec meter for the train loop. Where a
    CUDA card is in use, ``rates`` first waits for the queued device work,
    so the rate counts finished steps, not launched ones."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.samples = 0

    def update(self, batch_size: int):
        self.steps += 1
        self.samples += batch_size

    def rates(self) -> Dict[str, float]:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"steps_per_sec": self.steps / dt,
                "samples_per_sec": self.samples / dt}


def _new_table() -> dict:
    return {"spans": {}, "counters": {}}


_profiler_enabled = torch.autograd._profiler_enabled
_table = _new_table()
_scopes: list = []          # the tables of the open collect() scopes
_lock = threading.Lock()    # guards _table and _scopes' tables
_threads = threading.local()  # each thread's stack of open spans
_OFF = contextlib.nullcontext()  # the span while recording is off


class _Span:
    __slots__ = ("name", "_frame", "_rf")

    def __init__(self, name: str, profiling: bool):
        self.name = name
        self._rf = autograd_profiler.record_function(name) if profiling else None

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        self._frame = [time.perf_counter(), 0.0]    # start, children's seconds
        _threads.__dict__.setdefault("stack", []).append(self._frame)
        return self

    def __exit__(self, *exc):
        start, children = self._frame
        seconds = time.perf_counter() - start
        stack = _threads.stack
        stack.pop()
        if stack:
            stack[-1][1] += seconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
        with _lock:
            for table in (_table, *_scopes):
                entry = table["spans"].setdefault(
                    self.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0})
                entry["calls"] += 1
                entry["host_s"] += seconds
                entry["self_s"] += seconds - children
        return False


def span(name: str):
    """``with span(name):`` records the block's host seconds under ``name``
    while recording is on (module docstring); otherwise it returns a
    context that does nothing, after one check. A span's self seconds leave
    out its children on the same thread only: a span on another thread
    (autograd's backward, a decoder) is a child of none."""
    profiling = _profiler_enabled()
    if profiling or _scopes:
        return _Span(name, profiling)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording is on."""
    if _scopes or _profiler_enabled():
        with _lock:
            for table in (_table, *_scopes):
                table["counters"][name] = table["counters"].get(name, 0) + n


def span_table() -> dict:
    """{"spans": {name: {"calls", "host_s", "self_s"}}, "counters": {name:
    n}}: what the spans and counters recorded since the last
    ``reset_spans()``, while recording was on."""
    with _lock:
        return {"spans": {k: dict(v) for k, v in _table["spans"].items()},
                "counters": dict(_table["counters"])}


def reset_spans() -> None:
    with _lock:
        _table["spans"].clear()
        _table["counters"].clear()


@contextlib.contextmanager
def collect():
    """Turns recording on for the block, with or without a profiler, and
    yields a table of ``span_table()``'s form that holds what the spans and
    counters of every thread recorded while the block ran (read it after
    the block). Scopes nest; each holds its own."""
    scope = _new_table()
    with _lock:
        _scopes.append(scope)
    try:
        yield scope
    finally:
        with _lock:
            _scopes[:] = [s for s in _scopes if s is not scope]
