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
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch
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
