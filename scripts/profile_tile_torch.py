"""Where the time of one whole tile goes in crop2seg_tpu_torch, on one card.

    python3 scripts/profile_tile_torch.py [--model timeunet|utae|wtae|timeunet_v2|...]
                                          [--dtype bf16|fp32] [--trace out.json]

Runs TimeUNet_v1 (default) or any other model of the factory (U-TAE, W-TAE,
TimeUNet_v2, the baselines; U-Net naive with max_temp 61) at the factory
defaults (seeded random
weights) through make_tile_predictor on one synthetic (61, 1098, 1098, 10)
tile, length 55, batch 10: one warm-up tile, then one tile under
torch.profiler. Prints the
card (nvidia-smi name and power limit), the tile's wall time, the device's
busy share (summed kernel time over wall time), and the kernels that take
the most device time, grouped by name.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.inference.tile import make_tile_predictor  # noqa: E402
from crop2seg_tpu_torch.models.factory import MODELS, get_model  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=MODELS, default="timeunet")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = get_model({"model": args.model, "max_temp": 61},
                      generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(2)
    tile = torch.randn(61, 1098, 1098, 10, generator=gen, device=dev)
    tile[55:] = 0.0
    dates = np.arange(61, dtype=np.float32) * 5 + 3
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    predict = make_tile_predictor(model, batch_size=10, dtype=dtype)
    predict(tile, dates, 55)                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        predict(tile, dates, 55)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"{args.model} tile {args.dtype}: wall {wall:.4f} s ({100 / wall:.2f} patches/s), "
          f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e4 / wall:.1f} % of wall, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(f"{e.self_device_time_total / 1e3:10.3f} "
              f"{100 * e.self_device_time_total / max(busy_us, 1):5.1f}% "
              f"{e.count:6d}  {e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
