"""Time the temporal aggregator's kernel pair (crop2seg_tpu_torch/csrc/
temporal_aggregate.cu) at U-TAE's three skip shapes on one card, beside the
bound set by its bytes, the plain loop it replaces and the same sum by one
library call.

    python3 scripts/bench_aggregate_torch.py [--iters 20] [--dtype bf16|fp32]
        [--no-plain] [--no-library]

Shapes: T = 61, C = 64, K = 16 heads, the skips at 128^2, 64^2 and 32^2, at
B = 16 (the training cell's batch, lengths spread over 27-61) and B = 10
(a tile's batch, half of the patches at 27 dates and half at 61); the
weights (B, T, K, H, W) as the resample writes them. Inputs come from a
seeded generator on the card.

Prints the card (nvidia-smi name and power limit) and its SM clock and power
draw before and after, then one JSON line a shape: each kernel's device ms
a call (CUDA events around --iters back-to-back launches after 2 warm-up
launches, so the mean; and the median of per-launch events), its bytes (x
and the weights read at the live dates, dout read once, out, dx and dw
written once) and its share of the bound at 3.35 TB/s; unless --no-plain,
the plain loop's forward and forward-plus-backward ms
(``ops/aggregate.py::weighted_sum_reference``, the same inputs); unless
--no-library, those of ``weighted_sum_library`` (one ``torch.einsum`` over T
on the masked weights, cuBLAS's batched products and autograd's backward)
beside the pair's forward plus backward.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.ops import aggregate as ag  # noqa: E402

T, C, K = 61, 64, 16
SIDES = (128, 64, 32)
PEAK_BYTES_PER_S = 3.35e12


def lengths(b: int) -> list:
    """Each sample's dates: 27-61 spread over a batch of 16; 27 and 61 in
    turn over a tile's batch of 10."""
    if b == 16:
        return [27 + round(i * (T - 27) / (b - 1)) for i in range(b)]
    return [27 if i % 2 else T for i in range(b)]


def inputs(dev, b: int, side: int, dtype):
    gen = torch.Generator(device=dev).manual_seed(side * 100 + b)
    x = torch.randn(b, T, side, side, C, generator=gen, device=dev).to(dtype)
    w = torch.rand(b, T, K, side, side, generator=gen, device=dev).to(dtype)
    pad = torch.arange(T, device=dev)[None] >= torch.tensor(lengths(b), device=dev)[:, None]
    dout = torch.randn(b, side, side, C, generator=gen, device=dev).to(dtype)
    return x, w, pad, dout


def timed(fn, iters: int):
    """(mean, median) ms a call of fn."""
    for _ in range(2):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    for i in range(iters):
        events[i].record()
        fn()
    events[-1].record()
    torch.cuda.synchronize()
    per_call = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return events[0].elapsed_time(events[-1]) / iters, statistics.median(per_call)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def pair_bytes(x, w, pad) -> tuple:
    """(forward, backward) bytes: x and w read at the live dates, dout read
    and out written once, dx and dw written at every date."""
    b, t, h, wd, c = x.shape
    live = int((~pad).sum())
    xb, wb = h * wd * c * x.element_size(), w.shape[2] * h * wd * w.element_size()
    out = b * xb
    return (live * (xb + wb) + out, live * (xb + wb) + out + b * t * (xb + wb))


def weighted_sum_library(x, w, pad):
    """``ops/aggregate.py::weighted_sum`` without ``den`` by one library call:
    the padded dates' weights zeroed, then ``torch.einsum`` contracts T
    (einsum permutes x and the weights so that (B, H, W, K) are batch
    dimensions, and cuBLAS accumulates each (1 x T) by (T x C/K) product in
    fp32 and rounds it once to x's dtype). Differentiable by autograd."""
    b, t, h, wd, c = x.shape
    k = w.shape[2]
    w = w * (~pad).to(w.dtype)[:, :, None, None, None]
    out = torch.einsum("btkhw,bthwkc->bhwkc", w, x.reshape(b, t, h, wd, k, c // k))
    return out.reshape(b, h, wd, c)


def measure(dev, b: int, side: int, dtype, iters: int, plain: bool = True,
            library: bool = True) -> dict:
    """One shape's row: the pair's kernels timed by direct launches, their
    bytes and bound, and the plain loop's and the library's forward and
    forward-plus-backward ms where asked."""
    fwd_entry, bwd_entry = ag._kernels()
    x, w, pad, dout = inputs(dev, b, side, dtype)
    pad8 = pad.to(torch.uint8)
    out, dx, dw = torch.empty_like(dout), torch.empty_like(x), torch.empty_like(w)
    route = ag.kernel_route(C, K, dtype)
    fwd_ms, fwd_med = timed(lambda: ag._launch(
        fwd_entry, "fwd", x, w, pad8, None, (out,), route), iters)
    bwd_ms, bwd_med = timed(lambda: ag._launch(
        bwd_entry, "bwd", x, w, pad8, None, (dout, dx, dw), route), iters)
    fb, bb = pair_bytes(x, w, pad)
    row = {"b": b, "side": side, "t": T, "c": C, "k": K, "dtype": str(dtype)[6:],
           "route": route, "fwd_ms": fwd_ms, "fwd_median_ms": fwd_med,
           "bwd_ms": bwd_ms, "bwd_median_ms": bwd_med,
           "fwd_bytes": fb, "bwd_bytes": bb,
           "fwd_bound_ms": 1e3 * fb / PEAK_BYTES_PER_S,
           "bwd_bound_ms": 1e3 * bb / PEAK_BYTES_PER_S,
           "fwd_bound_share": 1e3 * fb / PEAK_BYTES_PER_S / fwd_ms,
           "bwd_bound_share": 1e3 * bb / PEAK_BYTES_PER_S / bwd_ms}
    xl = x.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    for name, fn, n, wanted in (("library", weighted_sum_library, 5, library),
                                ("plain", ag.weighted_sum_reference, 3, plain)):
        if not wanted:
            continue

        def forward():
            with torch.no_grad():
                fn(x, w, pad)

        def both():
            torch.autograd.grad(fn(xl, wl, pad), [xl, wl], dout)
        row[f"{name}_fwd_ms"] = timed(forward, n)[0]
        row[f"{name}_fwd_bwd_ms"] = timed(both, n)[0]
    row["pair_fwd_bwd_ms"] = fwd_ms + bwd_ms
    del x, w, xl, wl, pad, pad8, dout, out, dx, dw
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--no-plain", action="store_true")
    ap.add_argument("--no-library", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    dev = torch.device("cuda")
    print(smi("name,power.limit"))
    print(f"clocks.sm, power.draw before: {smi('clocks.sm,power.draw')}")
    for b in (16, 10):
        for side in SIDES:
            print(json.dumps(measure(dev, b, side, dtype, args.iters, not args.no_plain,
                                     not args.no_library)), flush=True)
    print(f"clocks.sm, power.draw after: {smi('clocks.sm,power.draw')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
