"""Time the fused eval L-TAE kernel (crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu)
at a main-path shape on one card, so that two checkouts can be compared in
turns within one call.

    PYTHONPATH=<checkout> python3 scripts/bench_ltae_fused_torch.py
        [--width timeunet|utae] [--nq 1] [--iters 20]

crop2seg_tpu_torch is imported from PYTHONPATH when it is set (this
checkout's otherwise), and its kernel is built there. Inputs and parameters
are drawn from a seeded generator at B=10, T=61 with every other sample
padded to 55: TimeUNet's width (N=128*128, C=d_out=64, the deferred tail
affine, no attention) or U-TAE's (N=16*16, C=d_out=128, attention out); G=16,
D=256, nq queries per head. Prints the card (nvidia-smi name and power
limit), then per dtype the SM clock and power draw before and after its
timing, and one JSON line with the wrapper's ms per call: the mean over
--iters back-to-back calls after 3 warm-up calls (CUDA events around the
loop) and the median of the same calls, each between its own pair of CUDA
events; and, from torch.profiler over another --iters calls, the kernel's
own device time per launch (``kernel_ms``) and all device time per call
(``device_ms``: the folds' small products too). Where the kernel takes less
time than the host needs to issue a call (U-TAE's shape since the wide
kernel), the events time the host and only the profiler times the kernel.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.ops import ltae_fused as lf  # noqa: E402

WIDTHS = {"timeunet": dict(n=128 * 128, c=64, d_out=64, tail=True, attn=False),
          "utae": dict(n=16 * 16, c=128, d_out=128, tail=False, attn=True)}
B, T, LENGTH, D, G, D_K = 10, 61, 55, 256, 16, 4


def inputs(width: dict, nq: int, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    c, d_out = width["c"], width["d_out"]

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)
    params = {"in_scale": 1 + r(c, scale=0.1), "in_bias": r(c, scale=0.1),
              "win": r(c, D, scale=c ** -0.5), "bin": r(D, scale=0.1),
              "wk": r(D, G * D_K, scale=0.5), "bk": r(G * D_K, scale=0.1),
              "q": r(G, nq, D_K), "wm_folded": r(D, d_out, scale=D ** -0.5),
              "bm_folded": r(d_out, scale=0.1), "out_scale": 1 + r(d_out, scale=0.1),
              "out_bias": r(d_out, scale=0.1)}
    pad = torch.zeros(B, T, dtype=torch.bool, device=dev)
    pad[::2, LENGTH:] = True
    valid = (~pad).float()[:, :, None]
    tail = ((1 + r(B, T, c, scale=0.2)) * valid, r(B, T, c, scale=0.1) * valid)
    return r(B, T, width["n"], c), r(B, T, D), pad, params, (
        tail if width["tail"] else None)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def device_ms(launch, iters: int):
    """(kernel, all) device ms per call over ``iters`` calls, by
    torch.profiler: the ltae_fused kernel's own time, and every kernel's."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernel = sum(e.self_device_time_total for e in events if "ltae_fused" in e.key)
    return kernel / 1e3 / iters, sum(e.self_device_time_total for e in events) / 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", choices=tuple(WIDTHS), default="timeunet")
    ap.add_argument("--nq", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(smi("name,power.limit"))
    dev = torch.device("cuda")
    width = WIDTHS[args.width]
    x, pe, pad, params, tail = inputs(width, args.nq, dev)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)

        def launch():
            lf.ltae_fused_forward(xd, pe, pad, params, n_head=G, d_k=D_K,
                                  need_attn=width["attn"], tail_affine=tail)
        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        print(f"clocks.sm, power.draw before {str(dtype)[6:]}: {smi('clocks.sm,power.draw')}")
        events = [torch.cuda.Event(enable_timing=True) for _ in range(args.iters + 1)]
        for i in range(args.iters):
            events[i].record()
            launch()
        events[-1].record()
        torch.cuda.synchronize()
        print(f"clocks.sm, power.draw after {str(dtype)[6:]}: {smi('clocks.sm,power.draw')}")
        per_launch = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        kernel_ms, all_ms = device_ms(launch, args.iters)
        print(json.dumps({"package": os.path.dirname(os.path.dirname(lf.__file__)),
                          "width": args.width, "nq": args.nq, "dtype": str(dtype)[6:],
                          "ms": events[0].elapsed_time(events[-1]) / args.iters,
                          "median_ms": statistics.median(per_launch),
                          "kernel_ms": kernel_ms, "device_ms": all_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
