"""Drive crop2seg_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, one CUDA card

1. Builds the fused L-TAE kernel (csrc/ltae_fused_fwd.cu) from the sources.
2. Holds the kernel against its plain PyTorch version on the card at full
   width (T=61, N=128*128, C=64, D=256, G=16, d_out=64, with pads), in fp32
   and bf16, with the tail affine and the attention output each on and off,
   then times both at the main-path shape (B=10) beside the kernel's bound.
3. Runs TimeUNet_v1 at the factory defaults (15 classes, weights drawn from a
   seeded torch.Generator) through make_tile_predictor on one synthetic
   standardized tile (61, 1098, 1098, 10), length 55, batch 10, in bf16 (the
   main path, launch counts read around it) and in fp32; checks shapes,
   finiteness, sum-to-1, exactly 10 kernel launches per tile, two patches
   against the same model with the plain L-TAE forced, and pad invariance.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line of
kernels, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises, and the exit code is then non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from crop2seg_tpu_torch.inference.tile import make_tile_predictor
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.ops import _build
from crop2seg_tpu_torch.ops import ltae_fused as lf
from crop2seg_tpu_torch.ops.patchify import patchify_inference_tile

# H100 SXM data-sheet peaks (dense): device memory and per-type math rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

T, HW, C, D, G, D_OUT, D_K = 61, 128 * 128, 64, 256, 16, 64, 4
MAIN_B, LENGTH = 10, 55
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}   # out, vs plain fp32
ATTN_TOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ltae_flops(b: int, tail: bool) -> float:
    """Operations the fused forward needs (one query), counted per row:
    tail affine, in-GroupNorm, scores, softmax, C-space pooling, the
    projection + PE term, the MLP and the out-GroupNorm."""
    per_row = ((3 * T * C if tail else 0) + 6 * T * C + 2 * T * C * G
               + 4 * G * T + 2 * G * T * C + 2 * C * D + 2 * T * D + D
               + 2 * D * D_OUT + 2 * D_OUT + 8 * D_OUT)
    return float(b * HW * per_row)


def ltae_bytes(b: int, dtype: torch.dtype, tail: bool, need_attn: bool) -> float:
    """Each input read once, each output written once."""
    es = torch.tensor([], dtype=dtype).element_size()
    n = b * T * HW * C * es + b * HW * D_OUT * es        # x in, out
    n += b * T * D * 4 + b * G * T * 4                   # pe, pes
    n += (C * D + D + C * G + D * D_OUT + 3 * D_OUT) * 4  # folded weights
    if tail:
        n += 2 * b * T * C * 4
    if need_attn:
        n += b * HW * G * T * 4
    return float(n)


def bound(b: int, dtype: torch.dtype, tail: bool, need_attn: bool):
    t_bytes = ltae_bytes(b, dtype, tail, need_attn) / HBM_BYTES_PER_S * 1e3
    t_ops = ltae_flops(b, tail) / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ltae_inputs(model, b: int, gen: torch.Generator, dev):
    """Full-width kernel inputs: the seeded model's L-TAE parameters (with
    non-trivial BN statistics), its PE of real day offsets, pads, and a
    deferred tail affine zeroed at the pads."""
    te = model.temporal_encoder
    sd = {k: v.clone() for k, v in te.state_dict().items()}
    sd["mlp.2.running_mean"] = 0.3 * torch.randn(D_OUT, generator=gen, device=dev)
    sd["mlp.2.running_var"] = 0.5 + torch.rand(D_OUT, generator=gen, device=dev)
    params = lf.params_from_ltae_variables(sd)
    dates = (torch.arange(T, dtype=torch.float32) * 5 + 3).to(dev)
    with torch.inference_mode():
        pe = te.pe(dates[None].expand(b, T)).contiguous()
    lengths = torch.tensor([LENGTH, T] * b)[:b].to(dev)
    pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
    x = torch.randn(b, T, HW, C, generator=gen, device=dev)
    valid = (~pad).float()[:, :, None]
    sc = (1 + 0.2 * torch.randn(b, T, C, generator=gen, device=dev)) * valid
    sh = 0.1 * torch.randn(b, T, C, generator=gen, device=dev) * valid
    return x, pe, pad, params, (sc, sh)


def phase_kernel(model, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    x, pe, pad, params, tail = ltae_inputs(model, 2, gen, dev)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        for use_tail in (False, True):
            for need_attn in (False, True):
                ta = tail if use_tail else None
                got, attn = lf.ltae_fused_forward(
                    xd, pe, pad, params, n_head=G, d_k=D_K,
                    need_attn=need_attn, tail_affine=ta)
                want, want_attn = lf.ltae_fused_forward_reference(
                    xd.float(), pe, pad, params, n_head=G, d_k=D_K,
                    need_attn=need_attn, tail_affine=ta)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                name = f"{str(dtype)[6:]} tail={use_tail} attn={need_attn}"
                check(torch.isfinite(got.float()).all().item(), f"{name}: non-finite")
                line = f"kernel vs plain {name}: max_abs_err {err:.3e} (tol {TOL[dtype]:g})"
                if need_attn:
                    aerr = (attn - want_attn).abs().max().item()
                    line += f", attn {aerr:.3e} (tol {ATTN_TOL:g})"
                    check(aerr <= ATTN_TOL, f"{name}: attn error {aerr}")
                print(line, flush=True)
                check(err <= TOL[dtype], f"{name}: out error {err}")
                errs[(dtype, use_tail, need_attn)] = err
    del x, pe, pad, tail
    torch.cuda.empty_cache()

    timings = {}
    x, pe, pad, params, tail = ltae_inputs(model, MAIN_B, gen, dev)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        ms = cuda_ms(lambda: lf.ltae_fused_forward(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=False,
            tail_affine=tail), iters=10)
        plain_ms = cuda_ms(lambda: lf.ltae_fused_forward_reference(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=False,
            tail_affine=tail), iters=3, warmup=1)
        b_ms, b_by = bound(MAIN_B, dtype, True, False)
        timings[dtype] = (ms, plain_ms, b_ms, b_by)
        print(f"ltae_fused_fwd {str(dtype)[6:]} B={MAIN_B} T={T} N={HW} C={C}: "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}), {ltae_flops(MAIN_B, True) / ms / 1e9:.1f} TFLOP/s, "
              f"{ltae_bytes(MAIN_B, dtype, True, False) / ms / 1e6:.1f} GB/s",
              flush=True)
        del xd
        torch.cuda.empty_cache()
    return errs, timings


def phase_main_path(model, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    tile = torch.randn(T, 1098, 1098, 10, generator=gen, device=dev)
    tile[LENGTH:] = 0.0
    dates = np.arange(T, dtype=np.float32) * 5 + 3

    def run(predict, t):
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = predict(t, dates, LENGTH)
        return res, time.perf_counter() - start

    predict_bf16 = make_tile_predictor(model, batch_size=MAIN_B, dtype=torch.bfloat16)
    run(predict_bf16, tile)                                 # warm-up
    lf.ltae_fused_forward.launches = 0
    res, secs = run(predict_bf16, tile)                     # the main path
    launches = lf.ltae_fused_forward.launches
    print(f"tile bf16: {secs:.3f} s, {100 / secs:.2f} patches/s, "
          f"ltae_fused_fwd launches {launches}", flush=True)
    check(launches == 10, f"bf16 tile launched the kernel {launches} times, not 10")

    predict_fp32 = make_tile_predictor(model, batch_size=MAIN_B)
    run(predict_fp32, tile)                                 # warm-up
    lf.ltae_fused_forward.launches = 0
    res32, secs32 = run(predict_fp32, tile)
    print(f"tile fp32: {secs32:.3f} s, {100 / secs32:.2f} patches/s, "
          f"ltae_fused_fwd launches {lf.ltae_fused_forward.launches}", flush=True)
    check(lf.ltae_fused_forward.launches == 10, "fp32 tile did not launch 10 times")

    for name, r in (("bf16", res), ("fp32", res32)):
        p, cls = r["proba"], r["classes"]
        check(p.shape == (1098, 1098, 15) and cls.shape == (1098, 1098)
              and cls.dtype == np.uint8, f"{name}: shapes {p.shape} {cls.shape}")
        check(bool(np.isfinite(p).all()), f"{name}: non-finite proba")
        s_err = float(np.abs(p.sum(-1) - 1).max())
        check(s_err < 1e-4, f"{name}: proba sums off by {s_err}")
        check(bool((cls == p.argmax(-1)).all()), f"{name}: classes != argmax")
    agree = float((res["classes"] == res32["classes"]).mean())
    print(f"bf16 vs fp32 tile: max |dproba| "
          f"{np.abs(res['proba'] - res32['proba']).max():.3e}, class agreement "
          f"{agree:.4f}", flush=True)

    # two patches of the fp32 tile against the plain L-TAE forced (fp32)
    idx = [0, 11]                          # patch 11: rows/cols 128-255
    with torch.inference_mode():
        xb = patchify_inference_tile(tile)[idx]
        mask = torch.arange(T, device=dev)[None].expand(2, T) >= LENGTH
        logits = model(xb, torch.as_tensor(dates, device=dev)[None].expand(2, T),
                       mask, fused=False)
        plain = torch.softmax(logits.float(), -1).cpu().numpy()
    served = np.stack([res32["proba"][:128, :128], res32["proba"][128:256, 128:256]])
    p_err = float(np.abs(served - plain).max())
    print(f"fp32 tile vs plain L-TAE on patches {idx}: max |dproba| {p_err:.3e} "
          f"(tol 1e-3)", flush=True)
    check(p_err <= 1e-3, f"tile differs from the plain L-TAE path by {p_err}")

    noisy = tile.clone()
    noisy[LENGTH:] = 10 * torch.randn(noisy[LENGTH:].shape, generator=gen, device=dev)
    res_noisy, _ = run(predict_bf16, noisy)
    inv_err = float(np.abs(res_noisy["proba"] - res["proba"]).max())
    print(f"pad invariance (garbage in frames {LENGTH}..{T - 1}): max |dproba| "
          f"{inv_err:.3e} (tol 1e-6)", flush=True)
    check(inv_err <= 1e-6, f"pad frames leak into the output: {inv_err}")
    return launches, 100 / secs, 100 / secs32


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    start = time.perf_counter()
    lib = _build.build("ltae_fused_fwd")
    print(f"built {lib.name} in {time.perf_counter() - start:.1f} s", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip(), flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    model = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    errs, timings = phase_kernel(model, dev)
    launches, pps_bf16, pps_fp32 = phase_main_path(model, dev)

    ms, plain_ms, b_ms, b_by = timings[torch.bfloat16]
    ms32, plain32, b32, b_by32 = timings[torch.float32]
    kernel = {
        "name": "ltae_fused_fwd", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu",
        "replaces": "crop2seg_tpu/ops/ltae_pallas.py:421",
        "launches": launches,
        "max_abs_err": max(v for k, v in errs.items() if k[0] == torch.bfloat16),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "dtype": "bfloat16", "shape": [MAIN_B, T, HW, C],
        "max_abs_err_fp32": max(v for k, v in errs.items() if k[0] == torch.float32),
        "ms_fp32": ms32, "plain_ms_fp32": plain32, "bound_ms_fp32": b32,
        "bound_by_fp32": b_by32,
        "tile_patches_per_s": pps_bf16, "tile_patches_per_s_fp32": pps_fp32,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
