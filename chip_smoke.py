"""Drive crop2seg_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, one CUDA card

1. Builds the kernel sources (csrc/ltae_fused_fwd.cu, csrc/ltae_pool.cu,
   csrc/ltae_stages.cu), one nvcc process each, started together, and prints
   ptxas's registers and spills per kernel instantiation.
2. Holds the fused eval L-TAE kernel against its plain PyTorch version on the
   card at full width (T=61, N=128*128, C=64, D=256, G=16, d_out=64, with
   pads), in fp32 and bf16, with the tail affine and the attention output
   each on and off, then times both at the serving shape (B=10) beside the
   kernel's bound.
3. Holds the training pooling kernels (ltae_pool forward and backward) in
   each of their four variants (untailed or with the deferred in_conv tail,
   x in fp32 or bf16) against their plain version under autograd at full
   width (B=2, one sample padded to 55): o and all gradients (dx or dz, dpe,
   dW_f, db_f, du, dcs, and dtsc, dtsh in tail mode), at drop_p 0 and 0.1
   with the same seed; then times each variant and its plain version at the
   train step's B=4, and checks that two backward calls give the same
   gradients bit for bit (the backward adds its blocks' sums in a fixed
   order).
4. Serving path: TimeUNet_v1 at the factory defaults (15 classes, weights
   drawn from a seeded torch.Generator) through make_tile_predictor on one
   synthetic standardized tile (61, 1098, 1098, 10), length 55, batch 10, in
   bf16 (launch counts read around it) and in fp32; checks shapes,
   finiteness, sum-to-1, exactly 10 kernel launches per tile, two patches
   against the same model with the plain L-TAE forced, and pad invariance.
5. Training path: make_train_step (B=4, T=61, 128x128x10, lengths
   61/55/43/27, class 14 weighted 0, Adam lr 1e-3, dropout live) on one
   synthetic batch from the same weights, 5 steps in fp32 and 5 in bf16
   (autocast) through the deferred in_conv tail (the JAX train CLI's
   --use_pallas_train [--bf16]), then 5 of each dtype with the tail not
   deferred (the untailed pair); checks finite losses that fall, one forward
   and one backward launch per step of exactly the variant the route and
   dtype select, changed BatchNorm statistics, one fused eval kernel launch
   per make_eval_step call, and at B=2 every parameter's gradient against
   the same model on the plain tail route (dropout on, same generator seed).
   Prints the warm step times and peak memory.
6. The fused eval L-TAE kernel at U-TAE's bottleneck (T=61, N=16*16, C=128,
   D=256, G=16, d_out=128) against its plain version (B=2, one sample
   padded to 55, fp32 and bf16, attention on and off), then both timed at
   the serving batch (B=10, attention on) beside the bound.
7. The stage-dump path: scripts/debug_ltae_stages_torch.py's run (the stage
   kernel and its plain version on that script's seeded inputs, B=1, T=61,
   N=256, C=64), one launch, each stage within tolerance and finite; then
   both timed beside the bound.
8. U-TAE serving (the JAX package's default model, factory defaults,
   seeded weights): the entry forward at (1, 30, 128, 128, 10), length 27
   (one kernel launch, finite logits), then one tile through
   make_tile_predictor in bf16 and fp32 with the checks of phase 4.
9. The fused eval L-TAE kernel with three queries per head (nq = 3), at
   U-TAE's bottleneck width (N=16*16, C=d_out=128) and TimeUNet's (N=128*128,
   C=d_out=64), against its plain version (B=2, fp32 and bf16, tail affine
   and attention each on and off; tolerances at TOL_Q), both timed at B=10;
   then that mode's
   path, the LTAE(num_queries=3) module in eval at U-TAE's width: exactly
   one launch, agreeing with the module's plain ops.
10. U-TAE training at the factory defaults: make_train_step, 5 steps at B=4
   in fp32 without remat and 5 at B=16 in bf16 with remat="conv_out" (the
   JAX bench's core train cell), each with a finite, falling loss, changed
   BatchNorm statistics and no launch of any kernel (the JAX U-TAE trains
   on plain ops too); then one B=2 step's gradients with remat ("conv_out"
   and "full") against those without, within the measured spread.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line of
kernels, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises, and the exit code is then non-zero.
"""
from __future__ import annotations

import collections
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from crop2seg_tpu_torch.inference.tile import make_tile_predictor
from crop2seg_tpu_torch.learning.losses import cross_entropy
from crop2seg_tpu_torch.learning.trainer import (
    StepConfig, make_eval_step, make_train_step)
from crop2seg_tpu_torch.models.factory import get_model, init_weights
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_lengths
from crop2seg_tpu_torch.ops import _build
from crop2seg_tpu_torch.ops import ltae_fused as lf
from crop2seg_tpu_torch.ops import ltae_pool as lp
from crop2seg_tpu_torch.ops import ltae_stages as ls
from crop2seg_tpu_torch.ops.patchify import patchify_inference_tile

# H100 SXM data-sheet peaks (dense): device memory and per-type math rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

T, HW, C, D, G, D_OUT, D_K = 61, 128 * 128, 64, 256, 16, 64, 4
MAIN_B, LENGTH = 10, 55
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}   # out, vs plain fp32
ATTN_TOL = 1e-4
UTAE_HW, UTAE_C = 16 * 16, 128     # U-TAE's L-TAE: the 16^2 bottleneck, C = d_out
NQ = 3                             # queries per head in phase 9
# phase 9 (nq = 3) vs the plain version at U-TAE's width: out in fp32; out in
# bf16 against the fp32 plain version on the same bf16-rounded input, per
# value as a share of max(1, |value|) (the out GroupNorm pools nq * d_out / G
# values, so outputs reach ~5, where storing in bf16 alone rounds by up to
# 2**-8 of the value); attention (fp32 either way). At TimeUNet's width fp32
# out and attention keep phase 2's TOL and ATTN_TOL: there the nq = 1 mode
# itself differs from its plain version by ~6e-4 and ~8e-6 (the out
# GroupNorm's groups of d_out / G = 4 channels amplify the order of fp32 sums)
TOL_Q = {torch.float32: 5e-4, torch.bfloat16: 1e-2}
ATTN_TOL_Q = 1e-5
# the LTAE(num_queries=3) module's fused path against its plain ops: the
# whole-module tolerance (the folds change the order of the fp32 sums)
MODULE_TOL_Q = 1e-3
UTAE_TRAIN_RUNS = (("fp32 B=4", None, 4, False), ("bf16 B=16 remat conv_out",
                                                  torch.bfloat16, 16, True))
# the stage kernel vs its plain version: fp32 sums in another order, as a
# share of each stage's largest |value|; the attention absolutely
STAGE_TOL, ATTN_TOL_STAGES = 1e-4, 1e-5
TRAIN_B, TRAIN_LENGTHS, N_CLASSES = 4, (61, 55, 43, 27), 15
# ltae_pool kernels vs plain, as max |err| / max |plain|: fp32 sums of up to
# B*N*T = 2M terms (the weight, PE and bias gradients) taken in another
# order: the grid-wide ones per block's range of rows, then across blocks
POOL_TOL = 1e-3
# the bf16 variants against the fp32 plain version on the same bf16-rounded
# input and a bf16-exact upstream gradient: o and dx are stored in bf16, one
# rounding of 2**-9 of each value, everything else is computed as in fp32
POOL_TOL_BF16 = 1e-2
# (tail, dtype) of the four ltae_pool variants, in the report's order
VARIANTS = [(tail, dtype) for tail in (False, True)
            for dtype in (torch.float32, torch.bfloat16)]
# whole-model gradients, kernel vs plain ltae_pool, as |diff| / |plain| per
# parameter (2-norms). The train-mode U-Net backward (BatchNorm over batch
# statistics, ReLU masks) amplifies a 1e-5 change of its input to about 1e-2
# in every gradient, so the yardstick is measured in the same run: the plain
# path again with the L-TAE output scaled by (1 + GRAD_EPS * noise), GRAD_EPS
# above the kernel's own forward error in o (about 7e-6 of its largest
# value). Kernel vs plain must stay within GRAD_FACTOR times that spread
# (the parameter's own, or the median over parameters if larger). Gradients
# that are zero in exact arithmetic (biases feeding a train-mode BatchNorm,
# the key bias under the softmax) are rounding noise on both paths: below
# GRAD_ZERO of the model's largest gradient, on both.
GRAD_EPS, GRAD_FACTOR, GRAD_ZERO = 1e-5, 4.0, 1e-5


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


def ltae_flops(b: int, tail: bool, n: int = HW, c: int = C,
               d_out: int = D_OUT, nq: int = 1) -> float:
    """Operations the fused forward needs, counted per row: tail affine and
    in-GroupNorm once; per query the scores, softmax, C-space pooling, the
    projection + PE term and the MLP; the out-GroupNorm over all queries."""
    per_query = (2 * T * c * G + 4 * G * T + 2 * G * T * c + 2 * c * D + 2 * T * D
                 + D + 2 * D * d_out + 2 * d_out + 8 * d_out)
    per_row = (3 * T * c if tail else 0) + 6 * T * c + nq * per_query
    return float(b * n * per_row)


def ltae_bytes(b: int, dtype: torch.dtype, tail: bool, need_attn: bool,
               n: int = HW, c: int = C, d_out: int = D_OUT, nq: int = 1) -> float:
    """Each input read once, each output written once."""
    es = torch.tensor([], dtype=dtype).element_size()
    nb = b * T * n * c * es + b * n * nq * d_out * es    # x in, out
    nb += b * T * D * 4 + b * G * nq * T * 4             # pe, pes
    nb += (c * D + D + c * G * nq + D * d_out + 3 * d_out) * 4  # folded weights
    if tail:
        nb += 2 * b * T * c * 4
    if need_attn:
        nb += b * n * G * nq * T * 4
    return float(nb)


def bound(b: int, dtype: torch.dtype, tail: bool, need_attn: bool, **shape):
    """The kernel's bound at ``shape`` (n, c, d_out, nq; TimeUNet's and one
    query by default)."""
    t_bytes = ltae_bytes(b, dtype, tail, need_attn, **shape) / HBM_BYTES_PER_S * 1e3
    t_ops = ltae_flops(b, tail, **shape) / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ltae_inputs(model, b: int, gen: torch.Generator, dev, n: int = HW, nq: int = 1):
    """Full-width kernel inputs: the seeded model's L-TAE parameters (with
    non-trivial BN statistics; with nq > 1 queries drawn as the factory
    draws them), its PE of real day offsets, pads, and a deferred tail affine
    zeroed at the pads; n pixel rows of its width."""
    te = model.temporal_encoder
    c, d_out = te.in_norm.num_channels, te.out_norm.num_channels
    sd = {k: v.clone() for k, v in te.state_dict().items()}
    sd["mlp.2.running_mean"] = 0.3 * torch.randn(d_out, generator=gen, device=dev)
    sd["mlp.2.running_var"] = 0.5 + torch.rand(d_out, generator=gen, device=dev)
    if nq > 1:
        sd["attention_head.Q"] = (2.0 / D_K) ** 0.5 * torch.randn(
            G, nq, D_K, generator=gen, device=dev)
    params = lf.params_from_ltae_variables(sd)
    dates = (torch.arange(T, dtype=torch.float32) * 5 + 3).to(dev)
    with torch.inference_mode():
        pe = te.pe(dates[None].expand(b, T)).contiguous()
    lengths = torch.tensor([LENGTH, T] * b)[:b].to(dev)
    pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
    x = torch.randn(b, T, n, c, generator=gen, device=dev)
    valid = (~pad).float()[:, :, None]
    sc = (1 + 0.2 * torch.randn(b, T, c, generator=gen, device=dev)) * valid
    sh = 0.1 * torch.randn(b, T, c, generator=gen, device=dev) * valid
    return x, pe, pad, params, (sc, sh)


def check_kernel(name: str, xd, pe, pad, params, need_attn: bool, tail=None,
                 tol=TOL, attn_tol: float = ATTN_TOL, per_value: bool = False) -> float:
    """Kernel 1 against its plain version (fp32, on the same input rounded
    to xd's dtype): out within tol[dtype] (with ``per_value``, bf16 out
    within tol * max(1, |value|) per value), attention within attn_tol,
    finite. Returns the largest |err| of out."""
    got, attn = lf.ltae_fused_forward(xd, pe, pad, params, n_head=G, d_k=D_K,
                                      need_attn=need_attn, tail_affine=tail)
    want, want_attn = lf.ltae_fused_forward_reference(
        xd.float(), pe, pad, params, n_head=G, d_k=D_K, need_attn=need_attn,
        tail_affine=tail)
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.isfinite(got.float()).all().item(),
          f"{name}: shape or non-finite")
    diff = (got.float() - want).abs()
    err = diff.max().item()
    held = err
    line = f"kernel vs plain {name}: max_abs_err {err:.3e} (tol {tol[xd.dtype]:g}"
    if per_value and xd.dtype == torch.bfloat16:
        held = (diff / want.abs().clamp_min(1.0)).max().item()
        line += f" of max(1, |value|): {held:.3e}"
    line += ")"
    if need_attn:
        check(attn.shape == want_attn.shape, f"{name}: attn shape {attn.shape}")
        aerr = (attn - want_attn).abs().max().item()
        line += f", attn {aerr:.3e} (tol {attn_tol:g})"
        check(aerr <= attn_tol, f"{name}: attn error {aerr}")
    print(line, flush=True)
    check(held <= tol[xd.dtype], f"{name}: out error {held}")
    return err


def phase_kernel(model, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    x, pe, pad, params, tail = ltae_inputs(model, 2, gen, dev)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        for use_tail in (False, True):
            for need_attn in (False, True):
                errs[(dtype, use_tail, need_attn)] = check_kernel(
                    f"{str(dtype)[6:]} tail={use_tail} attn={need_attn}", xd, pe,
                    pad, params, need_attn, tail if use_tail else None)
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


def pool_flops(b: int, backward: bool, tail: bool = False) -> float:
    """Operations of the ltae_pool kernels, counted per row. Forward: input
    GroupNorm, scores, softmax, C-space pooling, the projection + PE term,
    and in tail mode the affine and ReLU (3 per element). Backward: the
    forward recomputed up to the softmax, Z and q, p1, the softmax jacobian,
    pooling, dxhat, the GroupNorm backward and the four sums A, F, E, Dsum;
    in tail mode also the affine and ReLU again, the mask, dz and the two
    sums dtsc, dtsh (3 + 5 per element)."""
    tc, tcg, tg = T * C, T * C * G, T * G
    if backward:
        per_row = 14 * tc + 12 * tcg + 9 * tg + 4 * C * D + 4 * T * D
        per_row += 8 * tc if tail else 0
    else:
        per_row = 6 * tc + 4 * tcg + 4 * tg + 2 * C * D + 2 * T * D
        per_row += 3 * tc if tail else 0
    return float(b * HW * per_row)


def pool_bytes(b: int, backward: bool, tail: bool = False,
               dtype: torch.dtype = torch.float32) -> float:
    """Each input read once, each output written once: x (z), o or go and dx
    in x's dtype, the rest fp32."""
    es = torch.tensor([], dtype=dtype).element_size()
    n = b * T * HW * C * es + b * HW * D * es      # x; o (fwd) or go (bwd)
    n += (b * T * D + b * G * T + C * D + C * G) * 4  # bpe, pes, W_f, Ws
    if tail:
        n += 2 * b * T * C * 4                     # tsc, tsh
    if backward:
        n += b * T * HW * C * es                   # dx
        n += (C * G + C * D + b * T * G + b * T * D) * 4  # the four sums
        n += 2 * b * T * C * 4 if tail else 0      # dtsc, dtsh
    return float(n)


def pool_bound(b: int, backward: bool, tail: bool = False,
               dtype: torch.dtype = torch.float32):
    t_bytes = pool_bytes(b, backward, tail, dtype) / HBM_BYTES_PER_S * 1e3
    t_ops = pool_flops(b, backward, tail) / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pool_inputs(model, b: int, gen: torch.Generator, dev):
    """Full-width ltae_pool inputs: the seeded model's folded L-TAE
    parameters, its PE of real day offsets, sample 1 padded to LENGTH, and a
    deferred tail affine (tsc, tsh) zeroed at the pads."""
    te = model.temporal_encoder
    with torch.no_grad():
        params = [p.detach().clone() for p in te.pool_params()]
        pe = te.pe((torch.arange(T, dtype=torch.float32, device=dev) * 5 + 3
                    )[None].expand(b, T)).contiguous()
    pad = torch.zeros(b, T, dtype=torch.bool, device=dev)
    pad[1:, LENGTH:] = True
    x = torch.randn(b, T, HW, C, generator=gen, device=dev)
    valid = (~pad).float()[:, :, None]
    ts = ((1 + 0.2 * torch.randn(b, T, C, generator=gen, device=dev)) * valid,
          0.1 * torch.randn(b, T, C, generator=gen, device=dev) * valid)
    return x, ts, pe, pad, params


def pool_leaves(tail: bool, x, ts, pe, params):
    """Fresh leaves of one call: x (or z), in tail mode tsc and tsh, pe, the
    four folded parameters."""
    return [a.detach().clone().requires_grad_(True)
            for a in (x, *(ts if tail else ()), pe, *params)]


def pool_apply(tail: bool, plain: bool, leaves, pad, seed: int, drop_p: float):
    """The wrapper (the kernel pair on the card) or the plain version."""
    if tail:
        z, tsc, tsh, pe, *params = leaves
        fn = lp.ltae_pool_tail_reference if plain else lp.ltae_pool_tail
        return fn(z, tsc, tsh, pe, pad, *params, seed, n_head=G, drop_p=drop_p)
    x, pe, *params = leaves
    fn = lp.ltae_pool_reference if plain else lp.ltae_pool
    return fn(x, pe, pad, *params, seed, n_head=G, drop_p=drop_p)


def phase_pool_kernel(model, dev):
    """Kernels 2 and 3, each variant against the plain version under
    autograd, then each timed."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x, ts, pe, pad, params = pool_inputs(model, 2, gen, dev)
    # the upstream gradient, exact in bf16 so that the bf16 variants see it
    proj = torch.randn(2, HW, D, generator=gen, device=dev).bfloat16().float()
    errs = {}
    for tail, dtype in VARIANTS:
        names = (("o", "dx") + (("dtsc", "dtsh") if tail else ())
                 + ("dpe", "dwin_f", "dbin_f", "du", "dcs"))
        tol = POOL_TOL if dtype == torch.float32 else POOL_TOL_BF16
        fwd_name, bwd_name = (lp.variant(tail, dtype, d) for d in ("fwd", "bwd"))
        errs[fwd_name] = errs[bwd_name] = 0.0
        xd = x.to(dtype)
        outs = {}
        for drop_p in (0.0, 0.1):
            res = []
            for plain, xin in ((False, xd), (True, xd.float())):
                leaves = pool_leaves(tail, xin, ts, pe, params)
                o = pool_apply(tail, plain, leaves, pad, 1234, drop_p)
                grads = torch.autograd.grad((o.float() * proj).sum(), leaves)
                res.append([o.detach().float()] + [g_.detach().float() for g_ in grads])
                del o, grads, leaves
            torch.cuda.synchronize()
            got, want = res
            outs[drop_p] = got[0]
            for name, g_, w_ in zip(names, got, want):
                key = fwd_name if name == "o" else bwd_name
                check(g_.shape == w_.shape and bool(torch.isfinite(g_).all()),
                      f"{key} {name} drop_p={drop_p}: shape or non-finite")
                err = (g_ - w_).abs().max().item()
                # dcs = sum ds is zero in exact arithmetic (sum_t ds = 0: the
                # softmax ignores a constant shift), so both sides are rounding
                # noise: hold it against du, the same ds summed with weights h
                scale = want[names.index("du" if name == "dcs" else name)]
                rel = err / max(scale.abs().max().item(), 1e-30)
                print(f"{key} vs plain drop_p={drop_p} {name}: max_abs_err "
                      f"{err:.3e}, relative {rel:.3e} (tol {tol:g})", flush=True)
                check(rel <= tol, f"{key} {name} drop_p={drop_p}: {rel}")
                errs[key] = max(errs[key], err)
            del res, got, want
        moved = (outs[0.1] - outs[0.0]).abs().max().item()
        check(moved > 1e-3, f"{fwd_name}: drop_p=0.1 left o unchanged ({moved})")
        del xd, outs
        torch.cuda.empty_cache()
    del x, ts, pe, pad, proj
    torch.cuda.empty_cache()

    x, ts, pe, pad, params = pool_inputs(model, TRAIN_B, gen, dev)
    go = torch.randn(TRAIN_B, HW, D, generator=gen, device=dev)
    timings = {}
    for tail, dtype in VARIANTS:
        xd = x.to(dtype)
        per = {}
        for plain, iters in ((False, 10), (True, 3)):
            leaves = pool_leaves(tail, xd, ts, pe, params)

            def fwd():
                with torch.no_grad():
                    pool_apply(tail, plain, leaves, pad, 99, 0.1)
            fwd_ms = cuda_ms(fwd, iters=iters, warmup=1)
            o = pool_apply(tail, plain, leaves, pad, 99, 0.1)
            god = go.to(o.dtype)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, god, retain_graph=True),
                             iters=iters, warmup=1)
            per[plain] = (fwd_ms, bwd_ms)
            if not plain:   # the backward's sums are added in a fixed order
                again = [torch.autograd.grad(o, leaves, god, retain_graph=True)
                         for _ in range(2)]
                check(all(torch.equal(p, q) for p, q in zip(*again)),
                      f"{lp.variant(tail, dtype, 'bwd')}: two calls gave other gradients")
                del again
            del o, god, leaves
            torch.cuda.empty_cache()
        for i, direction in enumerate(("fwd", "bwd")):
            bwd = direction == "bwd"
            name = lp.variant(tail, dtype, direction)
            ms, plain_ms = per[False][i], per[True][i]
            timings[name] = (ms, plain_ms)
            b_ms, b_by = pool_bound(TRAIN_B, bwd, tail, dtype)
            flops, nbytes = pool_flops(TRAIN_B, bwd, tail), pool_bytes(TRAIN_B, bwd, tail, dtype)
            print(f"{name} B={TRAIN_B} T={T} N={HW} C={C}: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; bytes "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms, operations "
                  f"{flops / PEAK_FLOP_PER_S[dtype] * 1e3:.3f} ms, "
                  f"{flops / (TRAIN_B * HW) / 1e6:.3f} MFLOP per row), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s",
                  flush=True)
        del xd
        torch.cuda.empty_cache()
    del x, ts, pe, pad, go
    torch.cuda.empty_cache()
    return errs, timings


def train_batch(b: int, gen: torch.Generator, dev):
    lengths = torch.tensor([TRAIN_LENGTHS[i % len(TRAIN_LENGTHS)] for i in range(b)],
                           device=dev)
    pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
    x = torch.randn(b, T, 128, 128, 10, generator=gen, device=dev)
    x[pad] = 0.0
    dates = (torch.arange(T, dtype=torch.float32, device=dev) * 5 + 3)[None].expand(b, T)
    y = torch.randint(0, N_CLASSES, (b, 128, 128), generator=gen, device=dev)
    return {"x": x, "dates": dates.contiguous(), "pad_mask": pad, "y": y}


def train_run(label: str, fresh, batch, cfg, dev, *, dtype=None,
              defer_tail=None, steps: int = 5):
    """``steps`` steps of make_train_step from the weights ``fresh`` on
    ``batch``, each path with the pair's launch counts set to 0 just before
    it and read just after: every step must launch the forward and the
    backward of exactly the variant its route and dtype select, once each.
    Returns the model, the counts, the losses, the warm step ms (steps 2 on:
    mean, median) and the peak memory in GiB."""
    model = get_model({"model": "timeunet"}, device=dev)
    model.load_state_dict(fresh)
    model.defer_tail = defer_tail
    step = make_train_step(model, cfg, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    tail = defer_tail is not False
    want = {lp.variant(tail, dtype or torch.float32, d): 1 for d in ("fwd", "bwd")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    lp.ltae_pool.launches.clear()                      # this path's counts
    for i in range(steps):
        before = collections.Counter(lp.ltae_pool.launches)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        aux = step(batch, gen)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(aux["loss"]))
        per_step = dict(lp.ltae_pool.launches - before)
        print(f"train {label} step {i + 1}: loss {losses[-1]:.6f}, {step_ms[-1]:.3f} ms, "
              f"ltae_pool launches {per_step}, cm sum {int(aux['cm'].sum())}", flush=True)
        check(per_step == want, f"{label} step {i + 1} launched {per_step}, not {want}")
        check(np.isfinite(losses[-1]), f"{label} step {i + 1}: loss {losses[-1]}")
    launches = dict(lp.ltae_pool.launches)
    check(losses[-1] < losses[0], f"{label}: loss did not fall over {steps} steps: {losses}")
    # the median as well: one late warm-up step can move the mean by a third
    warm_ms, warm_median = float(np.mean(step_ms[1:])), float(np.median(step_ms[1:]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train step B={TRAIN_B} {label}, warm (steps 2-{steps}): mean {warm_ms:.3f} ms, "
          f"median {warm_median:.3f} ms, {TRAIN_B / warm_median * 1e3:.2f} samples/s at "
          f"the median; peak memory {peak:.2f} GiB", flush=True)
    return model, launches, losses, (warm_ms, warm_median), peak


def phase_train(dev):
    """The training path: 5 steps through make_train_step on the deferred
    tail route in fp32 and in bf16, and 5 of each dtype on the untailed
    route, then the eval step, then one step's gradients against the plain
    tail route."""
    cfg = StepConfig(num_classes=N_CLASSES,
                     class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    model = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    batch = train_batch(TRAIN_B, torch.Generator(device=dev).manual_seed(4), dev)
    bn_before = [fresh["temporal_encoder.mlp.2.running_mean"],
                 fresh["up_blocks.0.up.1.running_var"]]

    launches, runs = {}, {}
    for label, dtype, defer_tail, steps in (
            ("tail fp32", None, None, 5), ("tail bf16", torch.bfloat16, None, 5),
            ("untailed fp32", None, False, 5),
            ("untailed bf16", torch.bfloat16, False, 5)):
        model, counts, losses, warm_ms, peak = train_run(
            label, fresh, batch, cfg, dev, dtype=dtype, defer_tail=defer_tail,
            steps=steps)
        launches.update(counts)
        runs[label] = {"losses": losses, "warm_ms": warm_ms[0],
                       "warm_median_ms": warm_ms[1], "peak_gib": peak}
        if label == "tail fp32":
            bn_after = [model.temporal_encoder.mlp[2].running_mean,
                        model.up_blocks[0].up[1].running_var]
            check(all(not torch.equal(a, b) for a, b in zip(bn_before, bn_after)),
                  "BatchNorm running statistics did not change")
            served = model
        else:
            del model
        torch.cuda.empty_cache()
    model = served

    lf.ltae_fused_forward.launches = 0                 # the eval step's path
    aux = make_eval_step(model, cfg)(batch)
    torch.cuda.synchronize()
    eval_launches = lf.ltae_fused_forward.launches
    print(f"eval step: loss {float(aux['loss']):.6f}, ltae_fused_fwd launches "
          f"{eval_launches}", flush=True)
    check(eval_launches == 1, f"eval step launched the eval kernel {eval_launches} times")
    del aux, model, served
    torch.cuda.empty_cache()

    # one step's gradients at B=2: the tail kernel pair vs the plain tail
    # route (ltae_pool_tail_reference), and the plain tail route with its
    # L-TAE output perturbed, as the yardstick
    small = {k: v[:2] for k, v in batch.items()}
    grads = {}
    for name, fused, eps in (("kernel", True, 0.0), ("plain", False, 0.0),
                             ("perturbed", False, GRAD_EPS)):
        m = get_model({"model": "timeunet"}, device=dev)
        m.load_state_dict(fresh)
        m.defer_tail = True
        m.train()
        if eps:
            noise = torch.Generator(device=dev).manual_seed(12)
            m.temporal_encoder.register_forward_hook(
                lambda mod, args, out: (out[0] * (1 + eps * torch.randn(
                    out[0].shape, generator=noise, device=dev)), out[1]))
        g2 = torch.Generator(device=dev).manual_seed(11)
        logits = m(small["x"], small["dates"], small["pad_mask"], fused=fused,
                   generator=g2)
        cross_entropy(logits, small["y"], weight=torch.tensor(
            cfg.class_weights, device=dev)).backward()
        grads[name] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        del m, logits
        torch.cuda.empty_cache()

    check_grads_within_spread("kernel", grads["kernel"], grads["plain"],
                              grads["perturbed"])
    return launches, runs


def check_grads_within_spread(label: str, got: dict, plain: dict, perturbed: dict):
    """One step's gradients ``got`` against ``plain``, as |diff| / |plain|
    per parameter, within GRAD_FACTOR times the spread that perturbing the
    L-TAE output by GRAD_EPS causes (``perturbed``; the parameter's own, or
    the median over parameters if larger); gradients that are zero up to
    rounding on the plain side stay below GRAD_ZERO of the largest."""
    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    top = max(g_.abs().max().item() for g_ in plain.values())
    zero = [k for k, g_ in plain.items() if g_.abs().max().item() <= GRAD_ZERO * top]
    for k in zero:
        z = got[k].abs().max().item()
        check(z <= GRAD_ZERO * top, f"{label}: gradient of {k}: {z} where the plain one is 0")
    live = [k for k in plain if k not in zero]
    kp = {k: rel(got[k], plain[k]) for k in live}
    pe_ = {k: rel(perturbed[k], plain[k]) for k in live}
    floor = float(np.median(list(pe_.values())))
    ratio = {k: kp[k] / (GRAD_FACTOR * max(pe_[k], floor)) for k in live}
    worst = max(ratio, key=ratio.get)
    print(f"B=2 gradients, |diff|/|plain| over {len(live)} parameters (and "
          f"{len(zero)} zero up to rounding, within {GRAD_ZERO:g} of the "
          f"largest on both paths): {label} vs plain median "
          f"{np.median(list(kp.values())):.3e} max {max(kp.values()):.3e}; plain "
          f"vs plain with the L-TAE output perturbed by {GRAD_EPS:g}: median "
          f"{floor:.3e} max {max(pe_.values()):.3e}; worst ratio to the limit "
          f"{ratio[worst]:.3f} ({worst})", flush=True)
    check(ratio[worst] <= 1.0, f"gradient of {worst}: {label} vs plain {kp[worst]:.3e}"
          f" beyond {GRAD_FACTOR:g}x the perturbation spread")
    return ratio[worst]


def phase_main_path(model, dev, label: str = ""):
    """One tile through make_tile_predictor in bf16 and fp32 with its checks;
    ``label`` prefixes the printed lines. Returns the bf16 tile's kernel
    launches and patches/s in bf16 and fp32."""
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
    print(f"{label}tile bf16: {secs:.3f} s, {100 / secs:.2f} patches/s, "
          f"ltae_fused_fwd launches {launches}", flush=True)
    check(launches == 10, f"{label}bf16 tile launched the kernel {launches} times, not 10")

    predict_fp32 = make_tile_predictor(model, batch_size=MAIN_B)
    run(predict_fp32, tile)                                 # warm-up
    lf.ltae_fused_forward.launches = 0
    res32, secs32 = run(predict_fp32, tile)
    print(f"{label}tile fp32: {secs32:.3f} s, {100 / secs32:.2f} patches/s, "
          f"ltae_fused_fwd launches {lf.ltae_fused_forward.launches}", flush=True)
    check(lf.ltae_fused_forward.launches == 10, f"{label}fp32 tile did not launch 10 times")

    for name, r in (("bf16", res), ("fp32", res32)):
        p, cls = r["proba"], r["classes"]
        check(p.shape == (1098, 1098, 15) and cls.shape == (1098, 1098)
              and cls.dtype == np.uint8, f"{name}: shapes {p.shape} {cls.shape}")
        check(bool(np.isfinite(p).all()), f"{name}: non-finite proba")
        s_err = float(np.abs(p.sum(-1) - 1).max())
        check(s_err < 1e-4, f"{name}: proba sums off by {s_err}")
        check(bool((cls == p.argmax(-1)).all()), f"{name}: classes != argmax")
    agree = float((res["classes"] == res32["classes"]).mean())
    print(f"{label}bf16 vs fp32 tile: max |dproba| "
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
    print(f"{label}fp32 tile vs plain L-TAE on patches {idx}: max |dproba| {p_err:.3e} "
          f"(tol 1e-3)", flush=True)
    check(p_err <= 1e-3, f"{label}tile differs from the plain L-TAE path by {p_err}")

    noisy = tile.clone()
    noisy[LENGTH:] = 10 * torch.randn(noisy[LENGTH:].shape, generator=gen, device=dev)
    res_noisy, _ = run(predict_bf16, noisy)
    inv_err = float(np.abs(res_noisy["proba"] - res["proba"]).max())
    print(f"{label}pad invariance (garbage in frames {LENGTH}..{T - 1}): max |dproba| "
          f"{inv_err:.3e} (tol 1e-6)", flush=True)
    check(inv_err <= 1e-6, f"{label}pad frames leak into the output: {inv_err}")
    return launches, 100 / secs, 100 / secs32


def phase_kernel_utae(model, dev):
    """Kernel 1 at U-TAE's bottleneck: against its plain version at B=2 (fp32
    and bf16, attention on and off), then both timed at B=10 with the
    attention out, as U-TAE serves it."""
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = dict(n=UTAE_HW, c=UTAE_C, d_out=UTAE_C)
    x, pe, pad, params, _ = ltae_inputs(model, 2, gen, dev, n=UTAE_HW)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        for need_attn in (False, True):
            errs[(dtype, need_attn)] = check_kernel(
                f"C={UTAE_C} {str(dtype)[6:]} attn={need_attn}", xd, pe, pad, params,
                need_attn)

    timings = {}
    x, pe, pad, params, _ = ltae_inputs(model, MAIN_B, gen, dev, n=UTAE_HW)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        ms = cuda_ms(lambda: lf.ltae_fused_forward(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=True), iters=50)
        plain_ms = cuda_ms(lambda: lf.ltae_fused_forward_reference(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=True), iters=10)
        b_ms, b_by = bound(MAIN_B, dtype, False, True, **shape)
        timings[dtype] = (ms, plain_ms, b_ms, b_by)
        flops, nbytes = ltae_flops(MAIN_B, False, **shape), ltae_bytes(
            MAIN_B, dtype, False, True, **shape)
        print(f"ltae_fused_fwd {str(dtype)[6:]} B={MAIN_B} T={T} N={UTAE_HW} "
              f"C={UTAE_C} d_out={UTAE_C} attn: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{flops / (MAIN_B * UTAE_HW) / 1e6:.3f} MFLOP per row), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s",
              flush=True)
    return errs, timings


def stage_flops(b: int, t: int, n: int, c: int, d: int, g: int) -> float:
    """Operations of the stage kernel, counted per row: the GroupNorm (sums,
    squares, normalize), h = xn W_in + b_in + pe, the scores, the softmax
    and the weighted sum."""
    per_row = 6 * t * c + 2 * t * c * d + 2 * t * d + 2 * t * d * g + 4 * g * t + 2 * t * d
    return float(b * n * per_row)


def stage_bytes(b: int, t: int, n: int, c: int, d: int, g: int) -> float:
    """x, pe, mask and the weights read once; h0, scores, attn and o written
    once; all fp32."""
    return float(4 * (b * t * n * c + b * t * d + b * t + c * d + d + d * g + g
                      + 2 * b * n * d + 2 * b * n * g * t))


def phase_stages(dev):
    """Kernel 4: the stage-dump path, scripts/debug_ltae_stages_torch.py's
    run, with the launch count read around it; each stage against the plain
    version; then both timed."""
    spec = importlib.util.spec_from_file_location(
        "debug_ltae_stages_torch",
        Path(__file__).resolve().parent / "scripts" / "debug_ltae_stages_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ls.ltae_stages.launches = 0                        # this path's count
    res = script.run(dev)
    launches = ls.ltae_stages.launches
    print(f"stage-dump path: ltae_stages launches {launches}", flush=True)
    check(launches == 1, f"the stage-dump path launched its kernel {launches} times")
    worst = 0.0
    for name, err, scale, finite in res:
        tol = ATTN_TOL_STAGES if name == "attn" else STAGE_TOL * scale
        print(f"ltae_stages vs plain {name}: max_abs_err {err:.3e} (tol {tol:.3e}), "
              f"finite={finite}", flush=True)
        check(finite and err <= tol, f"ltae_stages {name}: error {err} or non-finite")
        worst = max(worst, err)
    args = [torch.tensor(a, device=dev) for a in script.script_inputs()]
    b, t, n, c = args[0].shape
    d, g = args[3].shape[1], script.N_HEAD
    work = (b, t, n, c, d, g)
    ms = cuda_ms(lambda: ls.ltae_stages(*args, n_head=g), iters=50)
    plain_ms = cuda_ms(lambda: ls.ltae_stages_reference(*args, n_head=g), iters=20)
    t_bytes = stage_bytes(*work) / HBM_BYTES_PER_S * 1e3
    t_ops = stage_flops(*work) / PEAK_FLOP_PER_S[torch.float32] * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"ltae_stages B={b} T={t} N={n} C={c}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms, "
          f"operations {t_ops:.4f} ms), "
          f"{stage_flops(*work) / ms / 1e9:.1f} TFLOP/s", flush=True)
    return {"launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "shape": [b, t, n, c]}


def phase_utae(model, dev):
    """U-TAE serving: the entry forward at BASELINE config #1's shape, then
    the tile of phase 4 with its checks."""
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(1, 30, 128, 128, 10, generator=gen, device=dev)
    dates = (torch.arange(30, dtype=torch.float32, device=dev) * 5 + 3)[None]
    pad = pad_mask_from_lengths(torch.tensor([27], device=dev), 30)
    with torch.inference_mode():
        model(x, dates, pad)                                # warm-up
        torch.cuda.synchronize()
        lf.ltae_fused_forward.launches = 0
        start = time.perf_counter()
        logits = model(x, dates, pad)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
    entry = lf.ltae_fused_forward.launches
    print(f"utae entry forward (1, 30, 128, 128, 10), length 27: logits "
          f"{tuple(logits.shape)}, {secs * 1e3:.3f} ms, ltae_fused_fwd launches "
          f"{entry}", flush=True)
    check(tuple(logits.shape) == (1, 128, 128, N_CLASSES), f"entry logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "entry forward: non-finite logits")
    check(entry == 1, f"entry forward launched the kernel {entry} times, not 1")
    del x, logits
    launches, pps_bf16, pps_fp32 = phase_main_path(model, dev, label="utae ")
    return entry, launches, pps_bf16, pps_fp32


def phase_kernel_queries(models: dict, dev):
    """Kernel 1 with NQ queries per head at U-TAE's and TimeUNet's widths:
    against its plain version at B=2 (fp32 and bf16, tail affine and
    attention each on and off), then both timed at B=10 (U-TAE's width with
    the attention out, TimeUNet's with the tail affine and without it). Then
    the mode's path, LTAE(num_queries=NQ) in eval at U-TAE's width and B=10:
    one launch, agreeing with the module's plain ops. Returns the errors,
    the timings and that path's launch count."""
    gen = torch.Generator(device=dev).manual_seed(9)
    widths = {"utae": dict(n=UTAE_HW, c=UTAE_C, d_out=UTAE_C),
              "timeunet": dict(n=HW, c=C, d_out=D_OUT)}
    tols = {"utae": (TOL_Q, ATTN_TOL_Q),
            "timeunet": ({torch.float32: TOL[torch.float32],
                          torch.bfloat16: TOL_Q[torch.bfloat16]}, ATTN_TOL)}
    errs, timings = {}, {}
    for width, shape in widths.items():
        model = models[width]
        tol, attn_tol = tols[width]
        x, pe, pad, params, tail = ltae_inputs(model, 2, gen, dev, n=shape["n"], nq=NQ)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for use_tail in (False, True):
                for need_attn in (False, True):
                    errs[(width, dtype, use_tail, need_attn)] = check_kernel(
                        f"nq={NQ} C={shape['c']} {str(dtype)[6:]} tail={use_tail} "
                        f"attn={need_attn}", xd, pe, pad, params, need_attn,
                        tail if use_tail else None, tol=tol, attn_tol=attn_tol,
                        per_value=True)
        del x, pe, pad, tail, xd
        torch.cuda.empty_cache()

        x, pe, pad, params, tail = ltae_inputs(model, MAIN_B, gen, dev, n=shape["n"], nq=NQ)
        need_attn, ts = (True, None) if width == "utae" else (False, tail)
        iters, plain_iters = (50, 10) if width == "utae" else (10, 3)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            ms = cuda_ms(lambda: lf.ltae_fused_forward(
                xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=need_attn,
                tail_affine=ts), iters=iters)
            plain_ms = cuda_ms(lambda: lf.ltae_fused_forward_reference(
                xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=need_attn,
                tail_affine=ts), iters=plain_iters, warmup=1)
            b_ms, b_by = bound(MAIN_B, dtype, ts is not None, need_attn, nq=NQ, **shape)
            timings[(width, dtype)] = (ms, plain_ms, b_ms, b_by)
            flops = ltae_flops(MAIN_B, ts is not None, nq=NQ, **shape)
            nbytes = ltae_bytes(MAIN_B, dtype, ts is not None, need_attn, nq=NQ, **shape)
            print(f"ltae_fused_fwd nq={NQ} {str(dtype)[6:]} B={MAIN_B} T={T} "
                  f"N={shape['n']} C={shape['c']} d_out={shape['d_out']} "
                  f"tail={ts is not None} attn={need_attn}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{flops / (MAIN_B * shape['n']) / 1e6:.3f} MFLOP per row), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s",
                  flush=True)
            del xd
            torch.cuda.empty_cache()
        del x, pe, pad, tail
        torch.cuda.empty_cache()

    # the mode's path: the LTAE module with NQ queries, eval, on the card
    te = LTAE(in_channels=UTAE_C, n_head=G, d_k=D_K, mlp=(D, UTAE_C), d_model=D,
              num_queries=NQ)
    te = init_weights(te, torch.Generator().manual_seed(10)).to(dev).eval()
    x = torch.randn(MAIN_B, T, 16, 16, UTAE_C, generator=gen, device=dev)
    pad = pad_mask_from_lengths(torch.tensor([LENGTH, T] * (MAIN_B // 2), device=dev), T)
    x[pad] = 0.0
    dates = (torch.arange(T, dtype=torch.float32, device=dev) * 5 + 3)[None].expand(MAIN_B, T)
    with torch.inference_mode():
        lf.ltae_fused_forward.launches = 0             # this path's count
        out, attn = te(x, dates, pad)
        torch.cuda.synchronize()
        launches = lf.ltae_fused_forward.launches
        ref, ref_attn = te(x, dates, pad, fused=False)
    check(tuple(out.shape) == (MAIN_B, NQ, 16, 16, UTAE_C) and tuple(attn.shape) == (
        MAIN_B, 16, 16, G, NQ, T), f"LTAE nq={NQ}: shapes {out.shape} {attn.shape}")
    check(bool(torch.isfinite(out).all()), f"LTAE nq={NQ}: non-finite output")
    err = (out - ref).abs().max().item()
    aerr = (attn - ref_attn).abs().max().item()
    print(f"LTAE(num_queries={NQ}) eval, ({MAIN_B}, {T}, 16, 16, {UTAE_C}): "
          f"ltae_fused_fwd launches {launches}; fused vs plain ops out {err:.3e} "
          f"(tol {MODULE_TOL_Q:g}), attn {aerr:.3e} (tol {ATTN_TOL_Q:g})", flush=True)
    check(launches == 1, f"LTAE nq={NQ} launched the kernel {launches} times, not 1")
    check(err <= MODULE_TOL_Q and aerr <= ATTN_TOL_Q,
          f"LTAE nq={NQ}: fused vs plain out {err}, attn {aerr}")
    return errs, timings, launches


def phase_utae_train(dev):
    """U-TAE training at the factory defaults: UTAE_TRAIN_RUNS through
    make_train_step (5 steps each, warm step ms over steps 2-5, peak
    memory), then one B=2 step's gradients with remat against those
    without, held to the spread that perturbing the L-TAE output causes."""
    cfg = StepConfig(num_classes=N_CLASSES,
                     class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    model = get_model({"model": "utae"}, generator=torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    stats = ("temporal_encoder.mlp.2.running_mean", "up_blocks.0.up.1.running_var",
             "out_conv.conv.conv.1.running_mean")
    runs = {}
    for label, dtype, b, remat in UTAE_TRAIN_RUNS:
        model = get_model({"model": "utae", "remat": remat}, device=dev)
        model.load_state_dict(fresh)
        batch = train_batch(b, torch.Generator(device=dev).manual_seed(4), dev)
        step = make_train_step(model, cfg, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lp.ltae_pool.launches.clear()                  # this path's counts
        lf.ltae_fused_forward.launches = 0
        losses, step_ms = [], []
        for i in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            aux = step(batch, gen)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(aux["loss"]))
            print(f"utae train {label} step {i + 1}: loss {losses[-1]:.6f}, "
                  f"{step_ms[-1]:.3f} ms", flush=True)
            check(np.isfinite(losses[-1]), f"utae {label} step {i + 1}: loss {losses[-1]}")
        launched = dict(lp.ltae_pool.launches)
        launched["ltae_fused_fwd"] = lf.ltae_fused_forward.launches
        check(not any(launched.values()),
              f"utae {label}: the training path launched a kernel: {launched}")
        check(losses[-1] < losses[0], f"utae {label}: loss did not fall: {losses}")
        moved = [not torch.equal(model.state_dict()[k], fresh[k].to(dev)) for k in stats]
        check(all(moved), f"utae {label}: BatchNorm statistics unchanged: {stats}")
        warm_ms = float(np.mean(step_ms[1:]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"utae train step {label}, warm (steps 2-5): {warm_ms:.3f} ms, "
              f"{b / warm_ms * 1e3:.2f} samples/s; peak memory {peak:.2f} GiB; "
              f"kernel launches {launched}", flush=True)
        runs[label] = {"losses": losses, "warm_ms": warm_ms, "peak_gib": peak,
                       "batch": b}
        del model, step, batch, aux
        torch.cuda.empty_cache()

    small = train_batch(2, torch.Generator(device=dev).manual_seed(4), dev)
    grads = {}
    for name, remat, policy, eps in (("no remat", False, "conv_out", 0.0),
                                     ("remat conv_out", True, "conv_out", 0.0),
                                     ("remat full", True, "full", 0.0),
                                     ("perturbed", False, "conv_out", GRAD_EPS)):
        m = get_model({"model": "utae", "remat": remat, "remat_policy": policy}, device=dev)
        m.load_state_dict(fresh)
        m.train()
        if eps:
            noise = torch.Generator(device=dev).manual_seed(12)
            m.temporal_encoder.register_forward_hook(
                lambda mod, args, out: (out[0] * (1 + eps * torch.randn(
                    out[0].shape, generator=noise, device=dev)), out[1]))
        logits = m(small["x"], small["dates"], small["pad_mask"],
                   generator=torch.Generator(device=dev).manual_seed(11))
        cross_entropy(logits, small["y"], weight=torch.tensor(
            cfg.class_weights, device=dev)).backward()
        grads[name] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        del m, logits
        torch.cuda.empty_cache()
    worst = {label: check_grads_within_spread(label, grads[label], grads["no remat"],
                                              grads["perturbed"])
             for label in ("remat conv_out", "remat full")}
    return runs, worst


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
    libs = _build.build_all(["ltae_fused_fwd", "ltae_pool", "ltae_stages"])
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "smem")):
                print("  ptxas:", line.strip(), flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    model = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    errs, timings = phase_kernel(model, dev)
    pool_errs, pool_t = phase_pool_kernel(model, dev)
    launches, pps_bf16, pps_fp32 = phase_main_path(model, dev)
    del model
    torch.cuda.empty_cache()
    pool_launches, runs = phase_train(dev)
    utae = get_model({"model": "utae"}, generator=torch.Generator().manual_seed(0))
    utae_errs, utae_t = phase_kernel_utae(utae, dev)
    stages = phase_stages(dev)
    entry_launches, utae_launches, utae_pps, utae_pps32 = phase_utae(utae, dev)
    timeunet = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    q_errs, q_t, q_launches = phase_kernel_queries({"utae": utae, "timeunet": timeunet}, dev)
    del utae, timeunet
    torch.cuda.empty_cache()
    utae_runs, remat_worst = phase_utae_train(dev)

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
    pool = []
    for tail, dtype in VARIANTS:
        for direction in ("fwd", "bwd"):
            name = lp.variant(tail, dtype, direction)
            b_ms, b_by = pool_bound(TRAIN_B, direction == "bwd", tail, dtype)
            pool.append({
                "name": name, "route": "cuda",
                "source": "crop2seg_tpu_torch/csrc/ltae_pool.cu",
                "replaces": "crop2seg_tpu/ops/ltae_pallas_train.py:"
                            + ("457" if direction == "fwd" else "536"),
                "launches": pool_launches.get(name, 0),
                "max_abs_err": pool_errs[name],
                "ms": pool_t[name][0], "plain_ms": pool_t[name][1],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "dtype": str(dtype)[6:], "shape": [TRAIN_B, T, HW, C],
            })
            if tail and direction == "fwd":
                run = runs[f"tail {'fp32' if dtype == torch.float32 else 'bf16'}"]
                pool[-1].update(train_losses=run["losses"],
                                train_step_ms=run["warm_ms"],
                                train_step_median_ms=run["warm_median_ms"],
                                train_peak_gib=run["peak_gib"])
    ms, plain_ms, b_ms, b_by = utae_t[torch.bfloat16]
    ms32, plain32, b32, b_by32 = utae_t[torch.float32]
    kernel_utae = {
        "name": "ltae_fused_fwd_utae", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu",
        "replaces": "crop2seg_tpu/ops/ltae_pallas.py:421",
        "launches": utae_launches,
        "max_abs_err": max(v for k, v in utae_errs.items() if k[0] == torch.bfloat16),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "dtype": "bfloat16", "shape": [MAIN_B, T, UTAE_HW, UTAE_C], "d_out": UTAE_C,
        "attn": True, "launches_entry_forward": entry_launches,
        "max_abs_err_fp32": max(v for k, v in utae_errs.items() if k[0] == torch.float32),
        "ms_fp32": ms32, "plain_ms_fp32": plain32, "bound_ms_fp32": b32,
        "bound_by_fp32": b_by32,
        "tile_patches_per_s": utae_pps, "tile_patches_per_s_fp32": utae_pps32,
    }
    kernel_stages = {
        "name": "ltae_stages", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_stages.cu",
        "replaces": "scripts/debug_ltae_stages.py:91", "library_ms": None,
        "dtype": "float32", **stages,
    }
    ms, plain_ms, b_ms, b_by = q_t[("utae", torch.bfloat16)]
    kernel_q = {
        "name": f"ltae_fused_fwd_nq{NQ}", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu",
        "replaces": "crop2seg_tpu/ops/ltae_pallas.py:421",
        "launches": q_launches,
        "max_abs_err": max(v for k, v in q_errs.items() if k[1] == torch.bfloat16),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "dtype": "bfloat16", "shape": [MAIN_B, T, UTAE_HW, UTAE_C], "d_out": UTAE_C,
        "num_queries": NQ, "attn": True,
        "max_abs_err_fp32": max(v for k, v in q_errs.items() if k[1] == torch.float32),
    }
    for (width, dtype), (ms, plain_ms, b_ms, b_by) in q_t.items():
        if (width, dtype) != ("utae", torch.bfloat16):
            kernel_q[f"{width}_{str(dtype)[6:]}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    print("utae_train " + json.dumps({"runs": utae_runs,
                                      "remat_grad_worst_ratio": remat_worst}),
          flush=True)
    print(json.dumps({"kernels": [kernel, kernel_utae] + pool + [kernel_stages, kernel_q]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
