"""Where the time of one training step goes in crop2seg_tpu_torch, on one card.

    python3 scripts/profile_train_torch.py [--model timeunet|utae|wtae|timeunet_v2|...]
                                           [--dtype fp32|bf16] [--untailed]
                                           [--remat] [--batch 4] [--steps 3]
                                           [--trace out.json]

Runs make_train_step on TimeUNet_v1, U-TAE, W-TAE or another model of the
factory (TimeUNet_v2, the baselines; U-Net naive with max_temp 61) at the factory defaults
(seeded random weights, 15 classes, class 14 weighted 0, Adam lr 1e-3, dropout live;
fp32, or bf16 under autocast with ``--dtype bf16``). TimeUNet defers in_conv's
GroupNorm + ReLU into the ltae_pool_tail kernels, or with ``--untailed``
applies it in PyTorch before the untailed pair; U-TAE trains on plain ops,
with ``--remat`` under activation checkpointing (``remat_policy="conv_out"``;
the JAX bench's U-TAE train cell is ``--model utae --dtype bf16 --batch 16
--remat``); W-TAE trains on plain ops too, with ``--remat`` checkpointing
in_conv, the reduction pyramid and the down blocks (``conv_out``; the JAX
bench's W-TAE cell is ``--model wtae --dtype bf16 --batch 16 --remat``);
TimeUNet with ``--remat`` checkpoints its down and up blocks and out_conv.
One synthetic batch (T=61, 128x128x10, lengths 61/55/43/27 repeated): two
warm-up steps, then ``--steps`` steps under torch.profiler. Prints the card
(nvidia-smi name and power limit), the wall time per step, the device's busy share (summed kernel
time over wall time), the peak memory the profiled steps allocate above what
the warm-up left (weights, Adam state, the batch), and the kernels that take
the most device time, grouped by name.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.learning.trainer import StepConfig, make_train_step  # noqa: E402
from crop2seg_tpu_torch.models.factory import MODELS, get_model  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=MODELS, default="timeunet")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    ap.add_argument("--untailed", action="store_true",
                    help="TimeUNet: do not defer in_conv's GroupNorm + ReLU into the kernels")
    ap.add_argument("--remat", action="store_true",
                    help="activation checkpointing (U-TAE, W-TAE: remat_policy "
                         "conv_out; TimeUNet: its down and up blocks and out_conv)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
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
    b, t = args.batch, 61
    gen = torch.Generator(device=dev).manual_seed(4)
    lengths = torch.tensor([(61, 55, 43, 27)[i % 4] for i in range(b)], device=dev)
    pad = torch.arange(t, device=dev)[None] >= lengths[:, None]
    x = torch.randn(b, t, 128, 128, 10, generator=gen, device=dev)
    x[pad] = 0.0
    batch = {"x": x, "pad_mask": pad,
             "dates": (torch.arange(t, dtype=torch.float32, device=dev) * 5 + 3
                       )[None].expand(b, t).contiguous(),
             "y": torch.randint(0, 15, (b, 128, 128), generator=gen, device=dev)}
    model = get_model({"model": args.model, "remat": args.remat, "max_temp": t},
                      generator=torch.Generator().manual_seed(0))
    if args.model == "timeunet":
        model.defer_tail = False if args.untailed else None
    step = make_train_step(model, StepConfig(num_classes=15,
                                             class_weights=(1.0,) * 14 + (0.0,)),
                           dtype=torch.bfloat16 if args.dtype == "bf16" else None)
    drop = torch.Generator(device=dev).manual_seed(7)
    for _ in range(2):                                         # warm-up
        step(batch, drop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # weights, Adam state, the batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(args.steps):
            step(batch, drop)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) / args.steps
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events) / args.steps
    route = (("untailed" if args.untailed else "tail") + (", remat" if args.remat else "")
             if args.model == "timeunet" else
             ("remat conv_out" if args.remat else "no remat"))
    print(f"{args.model} train step B={b} {args.dtype} {route}: wall {wall * 1e3:.3f} ms per "
          f"step, device busy {busy_us / 1e3:.3f} ms = {busy_us / 1e4 / wall:.1f} "
          f"% of wall; peak memory above the weights, Adam state and batch "
          f"{peak:.2f} GiB")
    print(f"{'ms/step':>10} {'share':>6} {'calls':>6}  kernel")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(f"{e.self_device_time_total / 1e3 / args.steps:10.3f} "
              f"{100 * e.self_device_time_total / args.steps / max(busy_us, 1):5.1f}% "
              f"{e.count // args.steps:6d}  {e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
