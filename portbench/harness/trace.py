"""The traced stretch of a ``--trace 1`` run: torch.profiler with CPU and
CUDA activity over a few whole units (tiles or steps) inside the window,
reduced after the window to a small summary (no chrome trace is kept):

- ``window_s``: the traced stretch, from the first traced unit's start to
  the synchronize after the last (the ``portbench.traced`` range);
- ``busy_s``: the union of the device's operations (kernels, copies, sets)
  inside it;
- ``device_ops``: device seconds and launches by operation name;
- ``host_ops``: device seconds under each host op (``aten::convolution``
  and the like: the kernels it and its children launched);
- ``idle_gaps``: the device's idle seconds named by the host op that
  overlapped each gap most (the innermost on a tie).
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN = "portbench.traced"


def _is_device(e) -> bool:
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return False
    if getattr(e, "is_user_annotation", False):
        return False
    return "annotation" not in str(getattr(e, "activity_type", "")).lower()


class Tracer:
    """Profiles the units run inside ``with tracer:``; ``units`` is how many
    a run traces."""

    def __init__(self, units: int):
        self.units, self.done = units, False
        self._prof = self._span = None

    def __enter__(self):
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = record_function(SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        self.done = True
        return False

    def summary(self) -> dict:
        events = self._prof.events()
        spans = [e for e in events if e.name == SPAN and not _is_device(e)]
        if not spans:
            raise RuntimeError("the profile holds no traced range")
        s0, s1 = spans[0].time_range.start, spans[0].time_range.end
        dev = [e for e in events if _is_device(e)
               and e.time_range.end > s0 and e.time_range.start < s1]
        ops = collections.defaultdict(lambda: [0.0, 0])
        for e in dev:
            ops[e.name][0] += (e.time_range.end - e.time_range.start) / 1e6
            ops[e.name][1] += 1
        iv = sorted((max(e.time_range.start, s0), min(e.time_range.end, s1)) for e in dev)
        busy, gaps, cur0, cur1 = 0.0, [], s0, s0
        for a, b in iv:
            if a > cur1:
                busy += cur1 - cur0
                gaps.append((cur1, a))
                cur0 = a
            cur1 = max(cur1, b)
        busy += cur1 - cur0
        if s1 > cur1:
            gaps.append((cur1, s1))
        host_ops = collections.defaultdict(float)
        for avg in self._prof.key_averages():
            if avg.device_type == torch.autograd.DeviceType.CPU and avg.device_time_total > 0:
                host_ops[avg.key] += avg.device_time_total / 1e6
        return {"window_s": (s1 - s0) / 1e6, "busy_s": busy / 1e6,
                "device_ops": sorted(([k, v[0], v[1]] for k, v in ops.items()),
                                     key=lambda r: -r[1]),
                "host_ops": dict(host_ops),
                "idle_gaps": _name_gaps(gaps, events, s0, s1)}


NAMED_GAPS = 500   # the longest gaps named one by one; the rest summed


def _name_gaps(gaps, events, s0, s1) -> list:
    """[name, idle seconds] by the host op that overlapped each gap most;
    past the NAMED_GAPS longest gaps, the rest as one entry."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.name != SPAN and e.time_range.end > s0 and e.time_range.start < s1]
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    by_name = collections.defaultdict(float)
    if len(gaps) > NAMED_GAPS:
        rest = gaps[NAMED_GAPS:]
        by_name[f"(gaps under {(rest[0][1] - rest[0][0]):.1f} us)"] = sum(
            b - a for a, b in rest) / 1e6
        gaps = gaps[:NAMED_GAPS]
    starts = np.array([e.time_range.start for e in cpu], dtype=np.float64)
    ends = np.array([e.time_range.end for e in cpu], dtype=np.float64)
    names = [e.name for e in cpu]
    for a, b in gaps:
        name = "(no host op)"
        if len(cpu):
            overlap = np.minimum(ends, b) - np.maximum(starts, a)
            best = overlap.max()
            if best > 0:
                tied = np.flatnonzero(overlap >= best)
                name = names[tied[np.argmin(ends[tied] - starts[tied])]]
        by_name[name] += (b - a) / 1e6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda r: -r[1])
