"""Time the stage-dump kernel (crop2seg_tpu_torch/csrc/ltae_stages.cu) on one
card, so that two checkouts can be compared in turns within one call.

    PYTHONPATH=<checkout> python3 scripts/bench_ltae_stages_torch.py [--iters 50]

crop2seg_tpu_torch is imported from PYTHONPATH when it is set (this
checkout's otherwise), and its kernel is built there. The inputs are those
of scripts/debug_ltae_stages_torch.py (B=1, T=61, N=256, C=64, D=256, G=16,
fp32, pads from t=55). Prints the card (nvidia-smi name and power limit),
the SM clock and power draw before and after, and one JSON line: the
wrapper's ms per call (CUDA events around --iters back-to-back calls after
2 warm-up calls) and the kernel's device ms per call (torch.profiler over
the same number of calls; the call is host-bound at this size).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.ops import ltae_stages as ls  # noqa: E402

B, T, N, C, D, G, LENGTH = 1, 61, 256, 64, 256, 16, 55


def inputs(dev):
    """x, pe, mask, win, bin, u, cs drawn from default_rng(0) in the order
    of scripts/debug_ltae_stages.py::run."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, N, C))
    pe = rng.standard_normal((B, T, D))
    mask = np.zeros((B, 1, T))
    mask[:, :, LENGTH:] = 1.0
    win = rng.standard_normal((C, D)) * 0.1
    bin_ = rng.standard_normal((D,)) * 0.1
    u = rng.standard_normal((D, G)) * 0.1
    cs = rng.standard_normal((1, G)) * 0.1
    return [torch.tensor(a.astype(np.float32), device=dev)
            for a in (x, pe, mask, win, bin_, u, cs)]


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(smi("name,power.limit"))
    dev = torch.device("cuda")
    xs = inputs(dev)

    def call():
        ls.ltae_stages(*xs, n_head=G)
    print(f"clocks.sm, power.draw before: {smi('clocks.sm,power.draw')}")
    for _ in range(2):
        call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.iters):
        call()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            call()
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA" and "ltae_stages_kernel" in e.key
                    ) / 1e3 / args.iters
    print(f"clocks.sm, power.draw after: {smi('clocks.sm,power.draw')}")
    print(json.dumps({"package": os.path.dirname(os.path.dirname(ls.__file__)),
                      "ms": ms, "device_ms": device_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
