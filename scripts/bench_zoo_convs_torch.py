"""Time the baselines' per-frame convolutions on one CUDA card, by memory
layout, dtype and cuDNN autotuning.

    python3 scripts/bench_zoo_convs_torch.py [--batch 10] [--iters 3] [--widths | --grad]

For each conv of ConvLSTM's and ConvGRU's cells (3x3, zero padding, the
factory's hidden widths 160 and 180 over 10 input bands), U-Net naive's
in_conv (610 -> 244) and a 64 -> 64 reference (with ``--widths``: instead,
ConvGRU's out_conv 190 -> 180 beside the widths around it, fp32 only), at
128^2 and ``--batch`` frames: the ms of one ``F.conv2d`` on the channels-last view that the port's
``nn/layers.py::Conv2d`` passes (NHWC) and on a contiguous NCHW copy, in
fp32 (TF32 off) and bf16, with ``torch.backends.cudnn.benchmark`` off (the
train CLI's setting) and on (``--widths``: also with cuDNN off, PyTorch's own
convolution, ``no_cudnn_ms``). ``--grad``: ConvGRU's two convs and
ConvLSTM's in fp32 at the train step's batch (4), the forward and the
backward (``torch.ops.aten.convolution_backward``, input, weight and bias
gradients) with cuDNN on and off. CUDA events around ``--iters`` calls
after one warm-up; prints one JSON line a case and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

CONVS = (("convlstm gates", 170, 640), ("convgru in_conv", 190, 360),
         ("convgru out_conv", 190, 180), ("unet_naive in_conv", 610, 244),
         ("reference", 64, 64))
# ConvGRU's out_conv and its neighbours: which widths take the slow path
WIDTHS = (("convgru out_conv", 190, 180), ("C_out 176", 190, 176), ("C_out 184", 190, 184),
          ("C_out 192", 190, 192), ("C_out 90", 190, 90), ("C_in 192", 192, 180),
          ("C_in 184", 184, 180), ("ConvLSTM hidden 180", 190, 720), ("C_out 224", 190, 224),
          ("C_out 256", 190, 256), ("C_out 288", 190, 288), ("C_out 320", 190, 320),
          ("C_in 64", 64, 180), ("C_in 128", 128, 180))


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grad_cases(batch: int, iters: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, c_in, c_out in CONVS[:3]:
        x = torch.randn(batch, c_in, 128, 128, device="cuda", generator=gen)
        w = torch.randn(c_out, c_in, 3, 3, device="cuda", generator=gen) * 0.01
        b = torch.zeros(c_out, device="cuda")
        gy = torch.randn(batch, c_out, 128, 128, device="cuda", generator=gen)
        res = {"conv": name, "c_in": c_in, "c_out": c_out, "batch": batch}
        for tag, on in (("cudnn", True), ("no_cudnn", False)):
            with torch.backends.cudnn.flags(enabled=on, allow_tf32=False):
                res[f"{tag}_fwd_ms"] = time_ms(lambda: F.conv2d(x, w, b, padding=1), iters)
                res[f"{tag}_bwd_ms"] = time_ms(lambda: torch.ops.aten.convolution_backward(
                    gy, x, w, [c_out], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                    [True, True, True]), iters)
        print(json.dumps(res), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=10)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--widths", action="store_true")
    parser.add_argument("--grad", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.grad:
        grad_cases(args.batch, args.iters)
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, c_in, c_out in WIDTHS if args.widths else CONVS:
        x = torch.randn(args.batch, 128, 128, c_in, device="cuda", generator=gen)
        w = torch.randn(c_out, c_in, 3, 3, device="cuda", generator=gen) * 0.01
        b = torch.zeros(c_out, device="cuda")
        flops = 2.0 * args.batch * 128 * 128 * c_out * c_in * 9
        for dtype in (torch.float32,) if args.widths else (torch.float32, torch.bfloat16):
            xd, wd, bd = x.to(dtype), w.to(dtype), b.to(dtype)
            nhwc = xd.permute(0, 3, 1, 2)                    # channels-last strides
            nchw = nhwc.contiguous()
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                res = {"conv": name, "c_in": c_in, "c_out": c_out,
                       "dtype": str(dtype)[6:], "cudnn_benchmark": bench}
                for layout, inp in (("nhwc", nhwc), ("nchw", nchw)):
                    ms = time_ms(lambda: F.conv2d(inp, wd, bd, padding=1), args.iters)
                    res[f"{layout}_ms"] = ms
                    res[f"{layout}_tflops"] = flops / ms / 1e9
                if args.widths and not bench:
                    with torch.backends.cudnn.flags(enabled=False):   # PyTorch's own conv
                        res["no_cudnn_ms"] = time_ms(
                            lambda: F.conv2d(nchw, wd, bd, padding=1), args.iters)
                print(json.dumps(res), flush=True)
    torch.backends.cudnn.benchmark = False


if __name__ == "__main__":
    main()
