"""Time the training pair of L-TAE pooling kernels (crop2seg_tpu_torch/csrc/
ltae_pool.cu, forward and backward) at the TimeUNet train step's shape on
one card, so that two checkouts can be compared in turns within one call.

    PYTHONPATH=<checkout> python3 scripts/bench_ltae_pool_torch.py [--iters 10]

crop2seg_tpu_torch is imported from PYTHONPATH when it is set (this
checkout's otherwise), and its kernels are built there. Inputs and parameters
are drawn from a seeded generator at B=4, T=61 (samples 1-3 padded to 55,
the tail affine zeroed there), N=128*128, C=64, D=256, G=16, drop_p 0.1.
Prints the card (nvidia-smi name and power limit), then one JSON line per
variant (untailed or tail mode, x fp32 or bf16) with the forward's and the
backward's ms per call (CUDA events, mean over --iters calls after 2 warm-up
calls). The backward is timed through torch.autograd.grad, so it includes
the wrapper's few small products around the kernel.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.ops import ltae_pool as lp  # noqa: E402

B, T, LENGTH, N, C, D, G, DROP_P = 4, 61, 55, 128 * 128, 64, 256, 16, 0.1


def inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)
    params = (r(C, D, scale=C ** -0.5), r(D, scale=0.1), r(D, G, scale=0.2),
              r(1, G, scale=0.1))
    pad = torch.zeros(B, T, dtype=torch.bool, device=dev)
    pad[1:, LENGTH:] = True
    valid = (~pad).float()[:, :, None]
    ts = ((1 + r(B, T, C, scale=0.2)) * valid, r(B, T, C, scale=0.1) * valid)
    return r(B, T, N, C), ts, r(B, T, D), pad, params, r(B, N, D)


def timed(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    x, ts, pe, pad, params, go = inputs(dev)
    for tail in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            leaves = [a.detach().clone().requires_grad_(True)
                      for a in (x.to(dtype), *(ts if tail else ()), pe, *params)]

            def forward():
                if tail:
                    z, tsc, tsh, pe_, *p = leaves
                    return lp.ltae_pool_tail(z, tsc, tsh, pe_, pad, *p, 99,
                                             n_head=G, drop_p=DROP_P)
                x_, pe_, *p = leaves
                return lp.ltae_pool(x_, pe_, pad, *p, 99, n_head=G, drop_p=DROP_P)

            def fwd_only():
                with torch.no_grad():
                    forward()
            fwd_ms = timed(fwd_only, args.iters)
            o = forward()
            god = go.to(o.dtype)
            bwd_ms = timed(lambda: torch.autograd.grad(o, leaves, god, retain_graph=True),
                           args.iters)
            print(json.dumps({"package": os.path.dirname(os.path.dirname(lp.__file__)),
                              "variant": lp.variant(tail, dtype, "bwd").replace("_bwd", ""),
                              "fwd_ms": fwd_ms, "bwd_ms": bwd_ms}), flush=True)
            del o, god, leaves
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
