"""Drive crop2seg_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, one CUDA card

1. Builds the kernel sources (csrc/ltae_fused_fwd.cu, csrc/ltae_pool.cu,
   csrc/ltae_stages.cu), one nvcc process each, started together with the
   native loader's g++ (native/loader.cpp), and prints
   ptxas's registers and spills per kernel instantiation (and on their own
   lines the wide, queries and general kernels').
2. Holds the fused eval L-TAE kernel (at C <= 64 with one query its
   row-group kernel, ltae_fused_group_kernel) against its plain PyTorch
   version on the card at full width (T=61, N=128*128, C=64, D=256, G=16,
   d_out=64, with pads), in fp32 and bf16, with the tail affine and the
   attention output each on and off, then times both at the serving shape
   (B=10) beside the kernel's bound.
3. Holds the training pooling kernels (ltae_pool forward and backward) in
   each of their four variants (untailed or with the deferred in_conv tail,
   x in fp32 or bf16) against their plain version under autograd at full
   width (B=2, one sample padded to 55): o and all gradients (dx or dz, dpe,
   dW_f, db_f, du, dcs, and dtsc, dtsh in tail mode), at drop_p 0 and 0.1
   with the same seed; then times each variant and its plain version at the
   train step's B=4 (the forward kernel's mean and median ms per launch),
   and checks that two backward calls give the same gradients bit for bit
   (the backward adds its blocks' sums in a fixed order). The forward is
   ltae_pool_fwd_group_kernel<Tin, Tail>; its four instantiations' ptxas
   registers and spills are printed after the build and go into the
   kernels line.
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
   D=256, G=16, d_out=128: the wide row-group kernel,
   ltae_fused_wide_kernel) against its plain version (B=2, one sample
   padded to 55, fp32 and bf16, attention on and off; then B=1, the entry
   forward's shape, and B=2 at N=258, which ends in a partial group), then
   both timed at the serving batch (B=10, attention on) beside the bound:
   the wrapper's call by CUDA events (``ms``, as every kernel), and the
   kernel's own device time by torch.profiler (``device_ms``), since at
   this shape the host takes longer to issue a call than the kernel runs.
7. The stage-dump path: scripts/debug_ltae_stages_torch.py's run (the stage
   kernel and its plain version on that script's seeded inputs, B=1, T=61,
   N=256, C=64), one launch, each stage within tolerance and finite; then
   both timed beside the bound, the kernel also by its device time
   (torch.profiler), since the wrapper's call is host-bound at this size.
8. U-TAE serving (the JAX package's default model, factory defaults,
   seeded weights): the entry forward at (1, 30, 128, 128, 10), length 27
   (one kernel launch, finite logits), then one tile through
   make_tile_predictor in bf16 and fp32 with the checks of phase 4.
9. The fused eval L-TAE kernel with three queries per head (nq = 3: the
   queries row-group kernel, ltae_fused_queries_kernel), at U-TAE's
   bottleneck width (N=16*16, C=d_out=128) and TimeUNet's (N=128*128,
   C=d_out=64), against its plain version (B=2, fp32 and bf16, tail affine
   and attention each on and off; tolerances at TOL_Q), both timed at B=10
   (the wrapper's call by CUDA events, the kernel by torch.profiler) beside
   the bound; then that mode's path, the LTAE(num_queries=3) module in eval
   at U-TAE's width: exactly one launch of the queries kernel, agreeing with
   the module's plain ops.
10. U-TAE training at the factory defaults (run after phase 11):
   make_train_step, 5 steps at B=4
   in fp32 without remat and 5 at B=16 in bf16 with remat="conv_out" (the
   JAX bench's core train cell), each with a finite, falling loss, changed
   BatchNorm statistics and no launch of any kernel (the JAX U-TAE trains
   on plain ops too); then one B=2 step's gradients with remat ("conv_out"
   and "full") against those without, within the measured spread.
11. The general kernels, which take every shape past the fast kernels'
   limits (T > 64 above all): timed at T=128, B=4, TimeUNet's width (the
   eval kernel with the tail affine, the training pair in tail mode with
   drop_p 0.1, the forward also by its kernel's device time; fp32 and bf16)
   beside their plain versions and bounds. Then
   the routes on the card, each path's counts set to 0 just before it and
   read just after: the LTAE module in eval on the kernel route at T=70 and
   T=128 (one query at C=64 with the tail, C=128 with the attention, three
   queries; fp32 and bf16): one general launch each, held against the plain
   version with TOL and ATTN_TOL (TOL_Q and ATTN_TOL_Q with three queries);
   the training pair at T=70 and 128 (tail bf16 and untailed fp32, drop_p
   0.1) against its plain version under autograd with POOL_TOL /
   POOL_TOL_BF16, one general forward and backward each; a TimeUNet train
   step at T=70, B=2 (4 steps, finite falling loss, exactly one general
   forward and one general backward a step); the U-TAE entry forward at
   T=70 (one general launch); a TimeUNet tile of a year of 5-day revisits
   (73, 1098, 1098, 10) through make_tile_predictor at batch 10 in bf16 and
   fp32, timed (patches/s): exactly 10 general launches each, proba finite
   and summing to 1, then the general kernel at the tile's shape (B=10,
   T=73, the tail) against its plain version with TOL; two general backwards on the same inputs (tail mode,
   T=128, fp32 and bf16): every gradient bit for bit the same; TimeUNet
   with pad_value=1.5 (in_conv's tail not deferred) in eval and in a
   train-mode forward: one launch of the eval kernel or of the untailed
   training forward, logits within 1e-3 of the plain L-TAE's.
12. The train CLI (python -m crop2seg_tpu_torch.train, its main called in
   this process) on a synthetic dataset of 16 patches at 128^2, T 27-61, in
   a temporary directory, each run's kernel counts set to 0 just before it
   and read just after: (a) TimeUNet_v1 at the factory defaults, --bf16
   --use_pallas_train, batch 4, 2 epochs, T buckets [32,48,61]: exactly one
   tail bf16 forward and backward of the training pair per train batch and
   one eval-kernel launch (group route) per val and test batch, finite
   metrics, the JAX CLI's output files; epoch seconds and steps/s printed;
   (b) a resume of (a) to 3 epochs: it starts after (a)'s best epoch (the
   checkpoint model.ckpt holds, as the JAX CLI resumes) with Adam's step
   count restored; (f) (a) again with --device_cache: x reaches the steps
   in bf16 and epoch 2 gathers its batches on the card, one launch of the
   same tail bf16 pair per step; (c) --test of (a)'s folder: test loss within 1e-5
   relative and mIoU within 1e-4 of (a)'s own test; (d) U-TAE in fp32 with
   --add_boundary_loss --device_cache, 1 epoch: no launch of the training
   pair, one wide eval-kernel launch per val and test batch, finite
   boundary metrics; (e) one TimeUNet step at B=4 with remat against
   without: gradients within the perturbation spread (as in phase 5), both
   peak memories printed. The CLI's batches come from the native C++ loader
   (native/loader.cpp, built with g++ at first use): every BatchLoader a
   run builds must still hold its native plan after the run (a file the
   loader rejects drops a loader to the Python path) and batches must have
   been decoded natively; the train BatchLoader's ms a batch is printed
   beside the Python collate path's.
13. Serving from disk (webapp/pipeline.py::generate_prediction, the port's
   webapp engine): (a) one synthetic 100-patch inference cell written to a
   temporary directory as the port's DatasetCreator saves one (float32
   .npy patches (61, 10, 128, 128), ~4 GB, and a metadata.json with dates
   and affines; uint16 where the disk is short), cut from a seeded tile
   (61, 10, 1098, 1098) of reflectance-like values by
   DatasetCreator.patchify_inference, beside a model directory (conf.json:
   TimeUNet_v1 at the factory defaults; NORM_S2_patch.json; Fold_1/model.ckpt
   of seeded weights); (b) generate_prediction cold with a parcel raster,
   then the warm stream (stream_tile_inference on the same dataset; the
   post-processing is not repeated), each run's counts set to 0 just
   before it: proba (1098, 1098, 15) finite and summing to 1 within 1e-5,
   classes uint8 and the argmax, exactly 10 launches of the eval kernel's
   group route and no other L-TAE kernel; for generate_prediction every
   cache file written and homogenized 0 outside the parcels; (c)
   make_tile_predictor in fp32 on the same inputs (the padded tile
   standardized as the decoder does it, rounded to bf16; patch 0 the
   decoder's bit for bit): proba within 1e-5, classes equal wherever the
   top-2 margin is >= 1e-4; (d) the stream's patches/s cold and warm, its
   timeline, and the post-processing seconds (raster, polygonize, vectors)
   on their own.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line of
kernels, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises, and the exit code is then non-zero.
"""
from __future__ import annotations

import collections
import concurrent.futures
import copy
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from crop2seg_tpu_torch import native
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
    return cuda_ms_median(fn, iters, warmup)[0]


def cuda_ms_median(fn, iters: int, warmup: int = 2):
    """(mean, median) ms per call: CUDA events around the loop and around
    each call."""
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    for i in range(iters):
        events[i].record()
        fn()
    events[-1].record()
    torch.cuda.synchronize()
    per_call = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return events[0].elapsed_time(events[-1]) / iters, per_call[iters // 2]


def kernel_device_ms(fn, iters: int, name: str) -> float:
    """Device ms per call of the kernels whose name holds ``name``, by
    torch.profiler over ``iters`` calls after a warm-up: the kernel's own
    time, without the host's time to issue a call, which CUDA events
    around back-to-back calls measure once it exceeds the kernel's."""
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and name in e.key]
    check(bool(events), f"the profiler saw no kernel named like {name}")
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def ptxas_report(log: str) -> dict:
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = [0, 0, 0]
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            out[name][1] = int(words[words.index("spill") - 2])
            out[name][2] = int(words[words.index("loads") - 3])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[name][0] = int(words[words.index("registers") - 1])
    return {k: tuple(v) for k, v in out.items()}


def pool_fwd_kernel_name(tail: bool, dtype: torch.dtype) -> str:
    tin = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
    return f"ltae_pool_fwd_group_kernel<{tin}, {'true' if tail else 'false'}>"


def pool_fwd_mangled(tail: bool, dtype: torch.dtype) -> str:
    tin = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    return f"ltae_pool_fwd_group_kernelI{tin}Lb{int(tail)}E"


def ltae_flops(b: int, tail: bool, n: int = HW, c: int = C,
               d_out: int = D_OUT, nq: int = 1, t: int = T) -> float:
    """Operations the fused forward needs, counted per row: tail affine and
    in-GroupNorm once; per query the scores, softmax, C-space pooling, the
    projection + PE term and the MLP; the out-GroupNorm over all queries."""
    per_query = (2 * t * c * G + 4 * G * t + 2 * G * t * c + 2 * c * D + 2 * t * D
                 + D + 2 * D * d_out + 2 * d_out + 8 * d_out)
    per_row = (3 * t * c if tail else 0) + 6 * t * c + nq * per_query
    return float(b * n * per_row)


def ltae_bytes(b: int, dtype: torch.dtype, tail: bool, need_attn: bool,
               n: int = HW, c: int = C, d_out: int = D_OUT, nq: int = 1,
               t: int = T) -> float:
    """Each input read once, each output written once."""
    es = torch.tensor([], dtype=dtype).element_size()
    nb = b * t * n * c * es + b * n * nq * d_out * es    # x in, out
    nb += b * t * D * 4 + b * G * nq * t * 4             # pe, pes
    nb += (c * D + D + c * G * nq + D * d_out + 3 * d_out) * 4  # folded weights
    if tail:
        nb += 2 * b * t * c * 4
    if need_attn:
        nb += b * n * G * nq * t * 4
    return float(nb)


def bound(b: int, dtype: torch.dtype, tail: bool, need_attn: bool, **shape):
    """The kernel's bound at ``shape`` (n, c, d_out, nq, t; TimeUNet's, one
    query and T = 61 by default)."""
    t_bytes = ltae_bytes(b, dtype, tail, need_attn, **shape) / HBM_BYTES_PER_S * 1e3
    t_ops = ltae_flops(b, tail, **shape) / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ltae_inputs(model, b: int, gen: torch.Generator, dev, n: int = HW, nq: int = 1,
                t: int = T):
    """Full-width kernel inputs: the seeded model's L-TAE parameters (with
    non-trivial BN statistics; with nq > 1 queries drawn as the factory
    draws them), its PE of real day offsets over t dates, every other
    sample padded from t - 6 (LENGTH at T = 61), and a deferred tail affine
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
    dates = (torch.arange(t, dtype=torch.float32) * 5 + 3).to(dev)
    with torch.inference_mode():
        pe = te.pe(dates[None].expand(b, t)).contiguous()
    lengths = torch.tensor([t - (T - LENGTH), t] * b)[:b].to(dev)
    pad = torch.arange(t, device=dev)[None] >= lengths[:, None]
    x = torch.randn(b, t, n, c, generator=gen, device=dev)
    valid = (~pad).float()[:, :, None]
    sc = (1 + 0.2 * torch.randn(b, t, c, generator=gen, device=dev)) * valid
    sh = 0.1 * torch.randn(b, t, c, generator=gen, device=dev) * valid
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


def pool_flops(b: int, backward: bool, tail: bool = False, t: int = T) -> float:
    """Operations of the ltae_pool kernels, counted per row. Forward: input
    GroupNorm, scores, softmax, C-space pooling, the projection + PE term,
    and in tail mode the affine and ReLU (3 per element). Backward: the
    forward recomputed up to the softmax, Z and q, p1, the softmax jacobian,
    pooling, dxhat, the GroupNorm backward and the four sums A, F, E, Dsum;
    in tail mode also the affine and ReLU again, the mask, dz and the two
    sums dtsc, dtsh (3 + 5 per element)."""
    tc, tcg, tg = t * C, t * C * G, t * G
    if backward:
        per_row = 14 * tc + 12 * tcg + 9 * tg + 4 * C * D + 4 * t * D
        per_row += 8 * tc if tail else 0
    else:
        per_row = 6 * tc + 4 * tcg + 4 * tg + 2 * C * D + 2 * t * D
        per_row += 3 * tc if tail else 0
    return float(b * HW * per_row)


def pool_bytes(b: int, backward: bool, tail: bool = False,
               dtype: torch.dtype = torch.float32, t: int = T) -> float:
    """Each input read once, each output written once: x (z), o or go and dx
    in x's dtype, the rest fp32 (the general pair's saved statistics, 4 per
    row and head, are not counted: the fast pair has none)."""
    es = torch.tensor([], dtype=dtype).element_size()
    n = b * t * HW * C * es + b * HW * D * es      # x; o (fwd) or go (bwd)
    n += (b * t * D + b * G * t + C * D + C * G) * 4  # bpe, pes, W_f, Ws
    if tail:
        n += 2 * b * t * C * 4                     # tsc, tsh
    if backward:
        n += b * t * HW * C * es                   # dx
        n += (C * G + C * D + b * t * G + b * t * D) * 4  # the four sums
        n += 2 * b * t * C * 4 if tail else 0      # dtsc, dtsh
    return float(n)


def pool_bound(b: int, backward: bool, tail: bool = False,
               dtype: torch.dtype = torch.float32, t: int = T):
    t_bytes = pool_bytes(b, backward, tail, dtype, t) / HBM_BYTES_PER_S * 1e3
    t_ops = pool_flops(b, backward, tail, t) / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pool_inputs(model, b: int, gen: torch.Generator, dev, t: int = T):
    """Full-width ltae_pool inputs: the seeded model's folded L-TAE
    parameters, its PE of real day offsets over t dates, samples 1.. padded
    from t - 6 (LENGTH at T = 61), and a deferred tail affine (tsc, tsh)
    zeroed at the pads."""
    te = model.temporal_encoder
    with torch.no_grad():
        params = [p.detach().clone() for p in te.pool_params()]
        pe = te.pe((torch.arange(t, dtype=torch.float32, device=dev) * 5 + 3
                    )[None].expand(b, t)).contiguous()
    pad = torch.zeros(b, t, dtype=torch.bool, device=dev)
    pad[1:, t - (T - LENGTH):] = True
    x = torch.randn(b, t, HW, C, generator=gen, device=dev)
    valid = (~pad).float()[:, :, None]
    ts = ((1 + 0.2 * torch.randn(b, t, C, generator=gen, device=dev)) * valid,
          0.1 * torch.randn(b, t, C, generator=gen, device=dev) * valid)
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
            fwd_ms, fwd_median = cuda_ms_median(fwd, iters=iters, warmup=1)
            o = pool_apply(tail, plain, leaves, pad, 99, 0.1)
            god = go.to(o.dtype)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, god, retain_graph=True),
                             iters=iters, warmup=1)
            per[plain] = (fwd_ms, bwd_ms, fwd_median)
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
            median = None if bwd else per[False][2]
            timings[name] = (ms, plain_ms, median)
            b_ms, b_by = pool_bound(TRAIN_B, bwd, tail, dtype)
            flops, nbytes = pool_flops(TRAIN_B, bwd, tail), pool_bytes(TRAIN_B, bwd, tail, dtype)
            med = "" if bwd else f" (median {median:.3f})"
            print(f"{name} B={TRAIN_B} T={T} N={HW} C={C}: kernel {ms:.3f} ms{med}, "
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


def train_batch(b: int, gen: torch.Generator, dev, t: int = T):
    lengths = torch.tensor([TRAIN_LENGTHS[i % len(TRAIN_LENGTHS)] for i in range(b)],
                           device=dev)
    pad = torch.arange(t, device=dev)[None] >= lengths[:, None]
    x = torch.randn(b, t, 128, 128, 10, generator=gen, device=dev)
    x[pad] = 0.0
    dates = (torch.arange(t, dtype=torch.float32, device=dev) * 5 + 3)[None].expand(b, t)
    y = torch.randint(0, N_CLASSES, (b, 128, 128), generator=gen, device=dev)
    return {"x": x, "dates": dates.contiguous(), "pad_mask": pad, "y": y}


def train_run(label: str, fresh, batch, cfg, dev, *, dtype=None,
              defer_tail=None, steps: int = 5, general: bool = False):
    """``steps`` steps of make_train_step from the weights ``fresh`` on
    ``batch``, each path with the pair's launch counts set to 0 just before
    it and read just after: every step must launch the forward and the
    backward of exactly the variant its route and dtype select (``general``:
    the general pair's, past the fast pair's T <= 64), once each.
    Returns the model, the counts, the losses, the warm step ms (steps 2 on:
    mean, median) and the peak memory in GiB."""
    model = get_model({"model": "timeunet"}, device=dev)
    model.load_state_dict(fresh)
    model.defer_tail = defer_tail
    step = make_train_step(model, cfg, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    tail = defer_tail is not False
    want = {lp.variant(tail, dtype or torch.float32, d, general): 1 for d in ("fwd", "bwd")}
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
    b = batch["x"].shape[0]
    print(f"train step B={b} {label}, warm (steps 2-{steps}): mean {warm_ms:.3f} ms, "
          f"median {warm_median:.3f} ms, {b / warm_median * 1e3:.2f} samples/s at "
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
    """Kernel 1 at U-TAE's bottleneck (the wide row-group kernel): against
    its plain version at B=2 (fp32 and bf16, attention on and off), at B=1
    (the entry forward's shape: most blocks get one or two rows) and at B=2
    with N=258 (a partial last group), then both timed at B=10 with the
    attention out, as U-TAE serves it."""
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = dict(n=UTAE_HW, c=UTAE_C, d_out=UTAE_C)
    errs = {}
    for b, n in ((2, UTAE_HW), (1, UTAE_HW), (2, UTAE_HW + 2)):
        x, pe, pad, params, _ = ltae_inputs(model, b, gen, dev, n=n)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for need_attn in (False, True):
                errs[(dtype, need_attn, b, n)] = check_kernel(
                    f"C={UTAE_C} B={b} N={n} {str(dtype)[6:]} attn={need_attn}", xd,
                    pe, pad, params, need_attn)

    timings = {}
    x, pe, pad, params, _ = ltae_inputs(model, MAIN_B, gen, dev, n=UTAE_HW)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)

        def launch():
            return lf.ltae_fused_forward(xd, pe, pad, params, n_head=G, d_k=D_K,
                                         need_attn=True)
        ms = cuda_ms(launch, iters=50)
        device_ms = kernel_device_ms(launch, 50, "ltae_fused_wide_kernel")
        plain_ms = cuda_ms(lambda: lf.ltae_fused_forward_reference(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=True), iters=10)
        b_ms, b_by = bound(MAIN_B, dtype, False, True, **shape)
        timings[dtype] = (ms, plain_ms, b_ms, b_by, device_ms)
        flops, nbytes = ltae_flops(MAIN_B, False, **shape), ltae_bytes(
            MAIN_B, dtype, False, True, **shape)
        print(f"ltae_fused_fwd {str(dtype)[6:]} B={MAIN_B} T={T} N={UTAE_HW} "
              f"C={UTAE_C} d_out={UTAE_C} attn: kernel {ms:.3f} ms (the wrapper's "
              f"call, CUDA events; device time {device_ms:.3f} ms, profiler), plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{flops / (MAIN_B * UTAE_HW) / 1e6:.3f} MFLOP per row), "
              f"{flops / device_ms / 1e9:.1f} TFLOP/s, "
              f"{nbytes / device_ms / 1e6:.1f} GB/s in device time",
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
    version; then both timed: the wrapper's call by CUDA events, the
    kernel's device time by torch.profiler (the call is host-bound at this
    size)."""
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
    device_ms = kernel_device_ms(lambda: ls.ltae_stages(*args, n_head=g), 50,
                                 "ltae_stages_kernel")
    plain_ms = cuda_ms(lambda: ls.ltae_stages_reference(*args, n_head=g), iters=20)
    t_bytes = stage_bytes(*work) / HBM_BYTES_PER_S * 1e3
    t_ops = stage_flops(*work) / PEAK_FLOP_PER_S[torch.float32] * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"ltae_stages B={b} T={t} N={n} C={c}: kernel {ms:.4f} ms (the wrapper's "
          f"call, CUDA events; device time {device_ms:.4f} ms, profiler), plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms, "
          f"operations {t_ops:.4f} ms), "
          f"{stage_flops(*work) / device_ms / 1e9:.1f} TFLOP/s in device time", flush=True)
    return {"launches": launches, "max_abs_err": worst, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "shape": [b, t, n, c]}


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
    """Kernel 1 with NQ queries per head (the queries row-group kernel) at
    U-TAE's and TimeUNet's widths: against its plain version at B=2 (fp32
    and bf16, tail affine and attention each on and off; every call on the
    "queries" route), then both timed at B=10 (U-TAE's width with the
    attention out, TimeUNet's with the tail affine and without it), the
    kernel by CUDA events around the wrapper's call and by torch.profiler.
    Then the mode's path, LTAE(num_queries=NQ) in eval at U-TAE's width and
    B=10: one launch of the queries kernel, agreeing with the module's plain
    ops. Returns the errors, the timings and that path's launch count."""
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
        check(lf.kernel_route(T, shape["c"], D, G, shape["d_out"], NQ) == "queries",
              f"nq={NQ} at C={shape['c']} does not take the queries kernel")
        lf.ltae_fused_forward.route_launches.clear()
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for use_tail in (False, True):
                for need_attn in (False, True):
                    errs[(width, dtype, use_tail, need_attn)] = check_kernel(
                        f"nq={NQ} C={shape['c']} {str(dtype)[6:]} tail={use_tail} "
                        f"attn={need_attn}", xd, pe, pad, params, need_attn,
                        tail if use_tail else None, tol=tol, attn_tol=attn_tol,
                        per_value=True)
        check(dict(lf.ltae_fused_forward.route_launches) == {"queries": 8},
              f"nq={NQ} checks launched {dict(lf.ltae_fused_forward.route_launches)}")
        del x, pe, pad, tail, xd
        torch.cuda.empty_cache()

        x, pe, pad, params, tail = ltae_inputs(model, MAIN_B, gen, dev, n=shape["n"], nq=NQ)
        need_attn, ts = (True, None) if width == "utae" else (False, tail)
        iters, plain_iters = (50, 10) if width == "utae" else (10, 3)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)

            def launch():
                return lf.ltae_fused_forward(xd, pe, pad, params, n_head=G, d_k=D_K,
                                             need_attn=need_attn, tail_affine=ts)
            ms = cuda_ms(launch, iters=iters)
            device_ms = kernel_device_ms(launch, iters, "ltae_fused_queries_kernel")
            plain_ms = cuda_ms(lambda: lf.ltae_fused_forward_reference(
                xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=need_attn,
                tail_affine=ts), iters=plain_iters, warmup=1)
            b_ms, b_by = bound(MAIN_B, dtype, ts is not None, need_attn, nq=NQ, **shape)
            timings[(width, dtype)] = (ms, plain_ms, b_ms, b_by, device_ms)
            flops = ltae_flops(MAIN_B, ts is not None, nq=NQ, **shape)
            nbytes = ltae_bytes(MAIN_B, dtype, ts is not None, need_attn, nq=NQ, **shape)
            print(f"ltae_fused_fwd nq={NQ} {str(dtype)[6:]} B={MAIN_B} T={T} "
                  f"N={shape['n']} C={shape['c']} d_out={shape['d_out']} "
                  f"tail={ts is not None} attn={need_attn}: kernel {ms:.3f} ms (the "
                  f"wrapper's call, CUDA events; device time {device_ms:.3f} ms, "
                  f"profiler), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{flops / (MAIN_B * shape['n']) / 1e6:.3f} MFLOP per row), "
                  f"{flops / device_ms / 1e9:.1f} TFLOP/s, "
                  f"{nbytes / device_ms / 1e6:.1f} GB/s in device time", flush=True)
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
        lf.ltae_fused_forward.route_launches.clear()
        out, attn = te(x, dates, pad)
        torch.cuda.synchronize()
        launches = lf.ltae_fused_forward.launches
        routes = dict(lf.ltae_fused_forward.route_launches)
        ref, ref_attn = te(x, dates, pad, fused=False)
    check(tuple(out.shape) == (MAIN_B, NQ, 16, 16, UTAE_C) and tuple(attn.shape) == (
        MAIN_B, 16, 16, G, NQ, T), f"LTAE nq={NQ}: shapes {out.shape} {attn.shape}")
    check(bool(torch.isfinite(out).all()), f"LTAE nq={NQ}: non-finite output")
    err = (out - ref).abs().max().item()
    aerr = (attn - ref_attn).abs().max().item()
    print(f"LTAE(num_queries={NQ}) eval, ({MAIN_B}, {T}, 16, 16, {UTAE_C}): "
          f"ltae_fused_fwd launches {launches}; fused vs plain ops out {err:.3e} "
          f"(tol {MODULE_TOL_Q:g}), attn {aerr:.3e} (tol {ATTN_TOL_Q:g})", flush=True)
    check(launches == 1 and routes == {"queries": 1},
          f"LTAE nq={NQ} launched {routes}, not the queries kernel once")
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


def general_eval_case(label: str, te, dtype, t: int, n_side: int, gen, dev,
                      tail: bool, need_attn: bool, tol, attn_tol, per_value=False):
    """The LTAE module ``te`` in eval on the kernel route at T = t (B = 2,
    n_side^2 pixels, the second sample padded from t - 6): the general
    kernel's count set to 0 just before and read just after (one launch),
    out and attention held against the plain version on the module's own
    folded parameters (``ltae_fused_forward_reference``) within tol[dtype]
    (per value of max(1, |value|) in bf16 with ``per_value``) and attn_tol.
    Returns the largest |err| of out."""
    b, c, nq = 2, te.in_norm.num_channels, te.num_queries
    x = torch.randn(b, t, n_side, n_side, c, generator=gen, device=dev)
    pad = pad_mask_from_lengths(torch.tensor([t, t - 6], device=dev), t)
    x[pad] = 0.0
    xd = x.to(dtype)
    dates = (torch.arange(t, dtype=torch.float32, device=dev) * 5 + 3)[None].expand(b, t)
    valid = (~pad).float()[:, :, None]
    ts = ((1 + 0.2 * torch.randn(b, t, c, generator=gen, device=dev)) * valid,
          0.1 * torch.randn(b, t, c, generator=gen, device=dev) * valid) if tail else None
    with torch.inference_mode():
        lf.ltae_fused_forward.route_launches.clear()   # this path's count
        out, attn = te(xd, dates, pad, need_attn=need_attn, tail_affine=ts)
        torch.cuda.synchronize()
        routes = dict(lf.ltae_fused_forward.route_launches)
        params = lf.params_from_ltae_variables(te.state_dict())
        want, want_attn = lf.ltae_fused_forward_reference(
            xd.float().reshape(b, t, -1, c), te.pe(dates), pad, params, n_head=G,
            d_k=D_K, need_attn=need_attn, tail_affine=ts)
    check(routes == {"general": 1}, f"{label}: launched {routes}, not the general kernel once")
    got = (out.permute(0, 2, 3, 1, 4) if nq > 1 else out).reshape(want.shape).float()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    diff = (got - want).abs()
    err = diff.max().item()
    held = (diff / want.abs().clamp_min(1.0)).max().item() if (
        per_value and dtype == torch.bfloat16) else err
    line = f"{label}: general launches {routes['general']}, out {err:.3e} (tol {tol[dtype]:g}"
    line += f" of max(1, |value|): {held:.3e})" if per_value and dtype == torch.bfloat16 else ")"
    if need_attn:
        got_attn = attn.reshape(want_attn.shape)
        aerr = (got_attn - want_attn).abs().max().item()
        line += f", attn {aerr:.3e} (tol {attn_tol:g})"
        check(aerr <= attn_tol, f"{label}: attn error {aerr}")
    print(line, flush=True)
    check(held <= tol[dtype], f"{label}: out error {held}")
    return err


def pool_case(label: str, model, tail: bool, dtype, t: int, gen, dev, drop_p: float):
    """The training pair at T = t against its plain version under autograd
    as phase 3 holds the fast pair (B = 2, TimeUNet's width, drop_p): one
    general forward and one general backward launch, o and every gradient
    within POOL_TOL (fp32) or POOL_TOL_BF16. Returns the largest relative
    errors of the forward and of the backward."""
    x, ts, pe, pad, params = pool_inputs(model, 2, gen, dev, t=t)
    proj = torch.randn(2, HW, D, generator=gen, device=dev).bfloat16().float()
    names = (("o", "dx") + (("dtsc", "dtsh") if tail else ())
             + ("dpe", "dwin_f", "dbin_f", "du", "dcs"))
    tol = POOL_TOL if dtype == torch.float32 else POOL_TOL_BF16
    res, launched = [], None
    for plain, xin in ((False, x.to(dtype)), (True, x.to(dtype).float())):
        leaves = pool_leaves(tail, xin, ts, pe, params)
        lp.ltae_pool.launches.clear()                  # this path's counts
        o = pool_apply(tail, plain, leaves, pad, 1234, drop_p)
        grads = torch.autograd.grad((o.float() * proj).sum(), leaves)
        torch.cuda.synchronize()
        if not plain:
            launched = dict(lp.ltae_pool.launches)
        res.append([o.detach().float()] + [g_.detach().float() for g_ in grads])
        del o, grads, leaves
    want_launch = {lp.variant(tail, dtype, d, general=True): 1 for d in ("fwd", "bwd")}
    check(launched == want_launch, f"{label}: launched {launched}, not {want_launch}")
    got, want = res
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, g_, w_ in zip(names, got, want):
        check(g_.shape == w_.shape and bool(torch.isfinite(g_).all()),
              f"{label} {name}: shape or non-finite")
        scale = want[names.index("du" if name == "dcs" else name)]
        rel = (g_ - w_).abs().max().item() / max(scale.abs().max().item(), 1e-30)
        check(rel <= tol, f"{label} {name}: {rel}")
        key = "fwd" if name == "o" else "bwd"
        worst[key] = max(worst[key], rel)
    print(f"{label}: launches {launched}; o {worst['fwd']:.3e}, worst gradient "
          f"{worst['bwd']:.3e} relative (tol {tol:g})", flush=True)
    return worst


T_YEAR = 73   # a year of Sentinel-2 dates at the 5-day revisit: past the fast kernels' 64


def phase_tile_year(model, dev):
    """One (73, 1098, 1098, 10) tile, every date valid, through
    make_tile_predictor at batch 10 in bf16 and fp32 (a warm-up run, then the
    timed one, the general kernel's counts set to 0 just before it): exactly
    10 launches of the general kernel, proba finite and summing to 1. Then
    the general kernel at the tile's shape (B = 10, T = 73, TimeUNet's
    width, the tail affine, no attention; every other sample padded from
    T - 6) against its plain version on the same inputs, within TOL, its
    count set to 0 just before (one launch). Returns ({dtype: (patches/s,
    launches)}, {dtype: max |err| of out})."""
    gen = torch.Generator(device=dev).manual_seed(16)
    tile = torch.randn(T_YEAR, 1098, 1098, 10, generator=gen, device=dev)
    dates = np.arange(T_YEAR, dtype=np.float32) * 5 + 3
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        predict = make_tile_predictor(model, batch_size=MAIN_B, dtype=dtype)
        predict(tile, dates, T_YEAR)                            # warm-up
        torch.cuda.synchronize()
        lf.ltae_fused_forward.route_launches.clear()            # this path's count
        start = time.perf_counter()
        res = predict(tile, dates, T_YEAR)
        secs = time.perf_counter() - start
        routes = dict(lf.ltae_fused_forward.route_launches)
        p = res["proba"]
        s_err = float(np.abs(p.sum(-1) - 1).max())
        print(f"tile T={T_YEAR} {str(dtype)[6:]}: {secs:.3f} s, {100 / secs:.2f} patches/s, "
              f"launches {routes}, proba sums off by {s_err:.2e}", flush=True)
        check(routes == {"general": 10}, f"T={T_YEAR} tile launched {routes}, not the general "
              f"kernel 10 times")
        check(p.shape == (1098, 1098, N_CLASSES) and bool(np.isfinite(p).all()),
              f"T={T_YEAR} {dtype} tile: proba shape or non-finite")
        check(s_err < 1e-4, f"T={T_YEAR} {dtype} tile: proba sums off by {s_err}")
        out[dtype] = (100 / secs, routes["general"])
    del tile
    torch.cuda.empty_cache()

    errs = {}
    x, pe, pad, params, tail = ltae_inputs(model, MAIN_B, gen, dev, t=T_YEAR)
    for dtype in (torch.bfloat16, torch.float32):
        lf.ltae_fused_forward.route_launches.clear()            # this check's count
        errs[dtype] = check_kernel(
            f"ltae_fused_general_kernel {str(dtype)[6:]} B={MAIN_B} T={T_YEAR} N={HW} "
            f"C={C} (the tile's shape)", x.to(dtype), pe, pad, params, False, tail)
        routes = dict(lf.ltae_fused_forward.route_launches)
        check(routes == {"general": 1}, f"T={T_YEAR} check launched {routes}, not the "
              f"general kernel once")
    del x, pe, pad, tail
    torch.cuda.empty_cache()
    return out, errs


def general_bwd_reproducible(model, gen, dev):
    """Two general backwards (tail mode, drop_p 0.1, T = 128, B = 2) on the
    same inputs give the same dx, dtsc, dtsh and the gradients formed from
    the reduced sums (dpe, dW_f, db_f, du, dcs) bit for bit, per dtype:
    the blocks' partial sums are added in a fixed order."""
    x, ts, pe, pad, params = pool_inputs(model, 2, gen, dev, t=T_GENERAL)
    go = torch.randn(2, HW, D, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        leaves = pool_leaves(True, x.to(dtype), ts, pe, params)
        o = pool_apply(True, False, leaves, pad, 21, 0.1)
        god = go.to(o.dtype)
        first = torch.autograd.grad(o, leaves, god, retain_graph=True)
        again = torch.autograd.grad(o, leaves, god)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"ltae_pool_tail_bwd{'_bf16' if dtype == torch.bfloat16 else ''}_general "
              f"T={T_GENERAL}: two backwards bit-identical in dx, dtsc, dtsh, dpe, dW_f, "
              f"db_f, du, dcs: {same}", flush=True)
        check(same, f"the general backward ({dtype}) is not reproducible")
        del leaves, o, first, again
    torch.cuda.empty_cache()
    return True


def phase_routing(models: dict, dev):
    """Shapes past the fast kernels' limits on the kernel route (the default
    on the card) take the general kernels, as the JAX package runs its
    Pallas kernels there: the LTAE in eval at T = 70 and 128 (one query at
    TimeUNet's C = 64 with the tail, at U-TAE's C = 128 with the attention,
    and three queries), the training pair at T = 70 and 128 (tail bf16 and
    untailed fp32, drop_p 0.1), a TimeUNet train step at T = 70, B = 2 and
    the U-TAE entry forward at T = 70; then TimeUNet with pad_value=1.5
    keeps in_conv's tail. Returns the general kernels' launches per path
    and kernel, their errors, and the TimeUNet pad_value errors."""
    gen = torch.Generator(device=dev).manual_seed(13)
    launches = collections.Counter()
    errs = collections.defaultdict(float)
    cases = (("C=64 tail", dict(in_channels=C, mlp=(D, D_OUT)), HW, True, False, 1),
             ("C=128 attn", dict(in_channels=UTAE_C, mlp=(D, UTAE_C)), UTAE_HW, False,
              True, 1),
             (f"nq={NQ} C=128 attn", dict(in_channels=UTAE_C, mlp=(D, UTAE_C),
                                          num_queries=NQ), UTAE_HW, False, True, NQ))
    for name, kw, n, tail, need_attn, nq in cases:
        te = LTAE(n_head=G, d_k=D_K, d_model=D, **kw)
        te = init_weights(te, torch.Generator().manual_seed(14)).to(dev).eval()
        tol, attn_tol = (TOL, ATTN_TOL) if nq == 1 else (
            {torch.float32: TOL_Q[torch.float32], torch.bfloat16: TOL_Q[torch.bfloat16]},
            ATTN_TOL_Q)
        for t in (70, 128):
            for dtype in (torch.float32, torch.bfloat16):
                err = general_eval_case(
                    f"LTAE {name} T={t} {str(dtype)[6:]} eval", te, dtype, t,
                    int(n ** 0.5), gen, dev, tail, need_attn, tol, attn_tol,
                    per_value=nq > 1)
                launches["ltae_fused_fwd_general"] += 1
                errs[("eval", dtype)] = max(errs[("eval", dtype)], err)
        del te
        torch.cuda.empty_cache()

    timeunet = models["timeunet"]
    for t in (70, 128):
        for tail, dtype in ((True, torch.bfloat16), (False, torch.float32)):
            worst = pool_case(f"ltae_pool tail={tail} {str(dtype)[6:]} T={t} drop_p=0.1",
                              timeunet, tail, dtype, t, gen, dev, 0.1)
            for d in ("fwd", "bwd"):
                launches[lp.variant(tail, dtype, d, general=True)] += 1
                errs[(d, dtype)] = max(errs[(d, dtype)], worst[d])
            torch.cuda.empty_cache()

    # a TimeUNet train step at T = 70: the tail route's general pair
    cfg = StepConfig(num_classes=N_CLASSES,
                     class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    fresh = {k: v.clone() for k, v in get_model(
        {"model": "timeunet"}, generator=torch.Generator().manual_seed(0)).state_dict().items()}
    batch = train_batch(2, torch.Generator(device=dev).manual_seed(4), dev, t=70)
    model, counts, losses, warm_ms, peak = train_run(
        "T=70 tail fp32", fresh, batch, cfg, dev, steps=4, general=True)
    launches.update(counts)
    del model, batch
    torch.cuda.empty_cache()

    # the U-TAE entry forward at T = 70: its L-TAE at C = 128 on the general kernel
    utae = models["utae"]
    x = torch.randn(1, 70, 128, 128, 10, generator=gen, device=dev)
    dates = (torch.arange(70, dtype=torch.float32, device=dev) * 5 + 3)[None]
    pad = pad_mask_from_lengths(torch.tensor([64], device=dev), 70)
    with torch.inference_mode():
        lf.ltae_fused_forward.route_launches.clear()   # this path's count
        logits = utae(x, dates, pad)
        torch.cuda.synchronize()
        routes = dict(lf.ltae_fused_forward.route_launches)
    print(f"utae entry forward (1, 70, 128, 128, 10), length 64: logits "
          f"{tuple(logits.shape)}, launches {routes}", flush=True)
    check(tuple(logits.shape) == (1, 128, 128, N_CLASSES)
          and bool(torch.isfinite(logits).all()), "utae T=70 entry forward: logits")
    check(routes == {"general": 1}, f"utae T=70 entry forward launched {routes}")
    launches["ltae_fused_fwd_general"] += 1
    del x, logits
    torch.cuda.empty_cache()

    # a year of 5-day revisits: the TimeUNet tile at T = 73, ten general launches
    year, year_errs = phase_tile_year(timeunet, dev)
    launches["ltae_fused_fwd_general"] += sum(n for _, n in year.values())
    for dtype, err in year_errs.items():
        errs[("eval", dtype)] = max(errs[("eval", dtype)], err)
    reproducible = general_bwd_reproducible(timeunet, gen, dev)

    model = get_model({"model": "timeunet", "pad_value": 1.5}, device=dev,
                      generator=torch.Generator().manual_seed(0))
    model.temporal_encoder.attn_dropout, model.temporal_encoder.mlp[1].p = 0.0, 0.0
    x = torch.randn(2, T, 128, 128, 10, generator=gen, device=dev)
    pad = pad_mask_from_lengths(torch.tensor([LENGTH, T], device=dev), T)
    dates = (torch.arange(T, dtype=torch.float32, device=dev) * 5 + 3)[None].expand(2, -1)
    pad_errs = {}
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            lf.ltae_fused_forward.launches = 0         # this path's counts
            lp.ltae_pool.launches.clear()
            got = model(x, dates, pad)
            torch.cuda.synchronize()
            n = {"ltae_fused_fwd": lf.ltae_fused_forward.launches, **lp.ltae_pool.launches}
            want = model(x, dates, pad, fused=False)
        pad_errs[train] = (got - want).abs().max().item()
        label = "train-mode forward" if train else "eval"
        expect = lp.variant(False, torch.float32, "fwd") if train else "ltae_fused_fwd"
        print(f"TimeUNet pad_value=1.5 {label}: kernel launches {n}, kernel route vs "
              f"plain L-TAE logits {pad_errs[train]:.3e} (tol 1e-3)", flush=True)
        check({k: v for k, v in n.items() if v} == {expect: 1},
              f"TimeUNet pad_value=1.5 {label}: launches {n}, expected one {expect}")
        check(pad_errs[train] <= 1e-3, f"TimeUNet pad_value=1.5 {label}: {pad_errs[train]}")
    return dict(launches), dict(errs), {"losses": losses, "warm_ms": warm_ms[0],
                                        "peak_gib": peak}, pad_errs, {
        "tile_t73_patches_per_s": year[torch.bfloat16][0],
        "tile_t73_patches_per_s_fp32": year[torch.float32][0],
        "bwd_general_reproducible": reproducible}


T_GENERAL = 128   # the general kernels' timing shape: T past the fast kernels' 64


def phase_general_timing(models: dict, dev):
    """The general kernels timed at T = 128, TimeUNet's width (N = 128*128,
    C = 64, D = 256), B = 4, beside their plain versions and bounds: the
    eval kernel with the tail affine and no attention (bf16 and fp32), the
    training pair in tail mode with drop_p 0.1 (fp32 and bf16; the forward
    also by its kernel's device time, torch.profiler). Returns {name:
    {dtype: (ms, plain_ms, bound_ms, bound_by, device_ms or None)}}."""
    gen = torch.Generator(device=dev).manual_seed(15)
    model, t, b = models["timeunet"], T_GENERAL, TRAIN_B
    out = collections.defaultdict(dict)
    x, pe, pad, params, tail = ltae_inputs(model, b, gen, dev, t=t)
    check(lf.kernel_route(t, C, D, G, D_OUT, 1) == "general", "T=128 is not general")
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        ms = cuda_ms(lambda: lf.ltae_fused_forward(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=False,
            tail_affine=tail), iters=5)
        plain_ms = cuda_ms(lambda: lf.ltae_fused_forward_reference(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=False,
            tail_affine=tail), iters=2, warmup=1)
        b_ms, b_by = bound(b, dtype, True, False, t=t)
        out["ltae_fused_fwd_general"][dtype] = (ms, plain_ms, b_ms, b_by, None)
        print(f"ltae_fused_general_kernel {str(dtype)[6:]} B={b} T={t} N={HW} C={C}: "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; bytes {ltae_bytes(b, dtype, True, False, t=t) / HBM_BYTES_PER_S * 1e3:.4f}"
              f" ms, operations {ltae_flops(b, True, t=t) / PEAK_FLOP_PER_S[dtype] * 1e3:.4f}"
              f" ms)", flush=True)
        del xd
        torch.cuda.empty_cache()
    del x, pe, pad, params, tail
    torch.cuda.empty_cache()

    x, ts, pe, pad, params = pool_inputs(model, b, gen, dev, t=t)
    go = torch.randn(b, HW, D, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        per = {}
        for plain, iters in ((False, 5), (True, 2)):
            leaves = pool_leaves(True, xd, ts, pe, params)

            def fwd():
                with torch.no_grad():
                    pool_apply(True, plain, leaves, pad, 99, 0.1)
            fwd_ms = cuda_ms(fwd, iters=iters, warmup=1)
            # the forward kernel's own device time (torch.profiler)
            fwd_device = None if plain else kernel_device_ms(
                fwd, iters, "ltae_pool_fwd_general_kernel")
            o = pool_apply(True, plain, leaves, pad, 99, 0.1)
            god = go.to(o.dtype)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, god, retain_graph=True),
                             iters=iters, warmup=1)
            per[plain] = (fwd_ms, bwd_ms, fwd_device)
            del o, god, leaves
            torch.cuda.empty_cache()
        for i, direction in enumerate(("fwd", "bwd")):
            bwd = direction == "bwd"
            b_ms, b_by = pool_bound(b, bwd, True, dtype, t)
            name = f"ltae_pool_tail_{direction}_general"
            device = None if bwd else per[False][2]
            out[name][dtype] = (per[False][i], per[True][i], b_ms, b_by, device)
            dev_text = "" if bwd else f" (device time {device:.3f} ms, profiler)"
            print(f"{lp.variant(True, dtype, direction, general=True)} B={b} T={t} N={HW} "
                  f"C={C}: kernel {per[False][i]:.3f} ms{dev_text}, plain "
                  f"{per[True][i]:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{pool_flops(b, bwd, True, t) / (b * HW) / 1e6:.3f} MFLOP per row)",
                  flush=True)
        del xd
        torch.cuda.empty_cache()
    del x, ts, pe, pad, params, go
    torch.cuda.empty_cache()
    return out


CLI_PATCHES = 16        # phase 12's synthetic dataset: 128^2, T 27-61
CLI_FILES = ("conf.json", "Fold_1/trainlog.json", "Fold_1/all_test_metrics.json",
             "Fold_1/all_conf_mat.pkl", "all_overall.json", "all_per_class.json")


def cli_run(label: str, argv: list, want_pool: dict, want_eval: dict):
    """``python -m crop2seg_tpu_torch.train`` in this process (its ``main``
    on ``argv``), each kernel count set to 0 just before and read just
    after: the training pair's launches by variant must be ``want_pool``
    (None: the caller checks them) and the eval kernel's by route
    ``want_eval``, exactly. Returns the run,
    the counts and the seconds it took."""
    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.data import BatchLoader

    cfg = cli.parse_config(argv + ["--device", "cuda", "--display_step", "1000"])
    # the CLI's own loaders: each one it builds, and each batch decoded natively
    loaders, native_batches = [], []
    init, native_batch = BatchLoader.__init__, BatchLoader._native_batch

    def watch_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        loaders.append(self)

    def watch_native(self, *args, **kwargs):
        native_batches.append(1)
        return native_batch(self, *args, **kwargs)

    BatchLoader.__init__, BatchLoader._native_batch = watch_init, watch_native
    lp.ltae_pool.launches.clear()                      # this path's counts
    lf.ltae_fused_forward.launches = 0
    lf.ltae_fused_forward.route_launches.clear()
    start = time.perf_counter()
    try:
        run = cli.main(cfg)
        torch.cuda.synchronize()
    finally:
        BatchLoader.__init__, BatchLoader._native_batch = init, native_batch
    seconds = time.perf_counter() - start
    pool = dict(lp.ltae_pool.launches)
    routes = dict(lf.ltae_fused_forward.route_launches)
    print(f"train cli {label}: {seconds:.1f} s, training pair launches {pool}, "
          f"eval kernel launches by route {routes}; {len(loaders)} BatchLoaders, "
          f"{len(native_batches)} batches decoded natively; "
          f"test {json.dumps(run.test_metrics)}", flush=True)
    # a file the native loader rejects drops its BatchLoader to the Python
    # path for the rest of the run (the plan is then None)
    check(loaders and all(ld._plan is not None for ld in loaders) and native_batches,
          f"train cli {label}: the CLI's BatchLoaders left the native path "
          f"({[ld._plan is not None for ld in loaders]}, {len(native_batches)} "
          f"native batches)")
    check(want_pool is None or pool == want_pool,
          f"train cli {label}: training pair launched {pool}, not {want_pool}")
    check(routes == want_eval, f"train cli {label}: eval kernel launched {routes}, "
                               f"not {want_eval}")
    check(all(np.isfinite(v) for v in run.test_metrics.values()),
          f"train cli {label}: test metrics {run.test_metrics}")
    for epoch, m in run.trainlog.items():
        check(all(np.isfinite(v) for v in m.values()),
              f"train cli {label}: epoch {epoch} metrics {m}")
    return run, pool, routes, seconds


def train_loader_timing(cli, data: str, bs: int) -> dict:
    """The train CLI's training BatchLoader on phase 12's dataset: it must
    hold a native plan (the native C++ loader decodes its batches); one
    epoch's batches timed natively and on the Python collate path, ms a
    batch (the host's clock, x only, no upload)."""
    from crop2seg_tpu_torch.data import BatchLoader

    cfg = cli.parse_config(["--dataset", "synthetic", "--dataset_folder", data])
    dt_train = cli.build_datasets(cfg)[0]
    ms = {}
    for name, native in (("native", True), ("python", False)):
        loader = BatchLoader(dt_train, bs, t_buckets=(32, 48, 61), native=native)
        if native:
            check(loader._plan is not None, "train cli: the train BatchLoader holds no "
                                            "native plan")
        list(loader)                                          # warm the page cache
        start = time.perf_counter()
        n = sum(1 for _ in loader)
        ms[name] = (time.perf_counter() - start) * 1e3 / n
    print(f"train cli loader: the train BatchLoader holds a native plan; B={bs}, 128^2, "
          f"T 27-61, {n} batches: native {ms['native']:.2f} ms a batch, Python collate "
          f"{ms['python']:.2f} ms a batch", flush=True)
    return {"native_ms_per_batch": ms["native"], "python_ms_per_batch": ms["python"]}


def phase_train_cli(dev):
    """Phase 12: the train CLI end to end on the card, on a synthetic
    dataset of CLI_PATCHES patches at 128^2, T 27-61, written to a temporary
    directory: (a) TimeUNet_v1 at the factory defaults, bf16, 2 epochs
    (train, val, best-k checkpoints, reload, test, fold aggregation); (b) a
    resume of (a) to epoch 3 with Adam's step count restored (from the
    best epoch, which model.ckpt holds, as the JAX CLI resumes); (c) --test
    of (a)'s folder, which must repeat (a)'s test; (f) (a) again with the
    device cache (x cast to bf16 before the step: the same kernel variant
    must run as for (a)'s fp32 x under autocast); (d) U-TAE fp32 with the
    boundary loss and the device cache, 1 epoch; (e) one TimeUNet step at
    B=4 with remat against without, gradients within the perturbation
    spread, both peak memories printed."""
    import os
    import tempfile

    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.data import make_synthetic_dataset
    from crop2seg_tpu_torch.learning import checkpoint as ckpt

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        start = time.perf_counter()
        make_synthetic_dataset(data, n_patches=CLI_PATCHES)
        sizes = [len(d) for d in cli.build_datasets(cli.parse_config(
            ["--dataset", "synthetic", "--dataset_folder", data]))]
        bs = 4
        n_train, n_val, n_test = sizes[0] // bs, -(-sizes[1] // bs), -(-sizes[2] // bs)
        print(f"train cli: synthetic dataset of {CLI_PATCHES} patches (train/val/test "
              f"{sizes}) written in {time.perf_counter() - start:.1f} s; batches a "
              f"train epoch {n_train}, val {n_val}, test {n_test}", flush=True)
        out["loader"] = train_loader_timing(cli, data, bs)
        common = ["--dataset", "synthetic", "--dataset_folder", data,
                  "--batch_size", str(bs), "--t_buckets", "[32,48,61]"]
        a_dir, b_dir, c_dir = (os.path.join(tmp, n) for n in ("a", "b", "c"))
        tail16 = {lp.variant(True, torch.bfloat16, d): 0 for d in ("fwd", "bwd")}

        def pool_want(steps):
            return {k: steps for k in tail16} if steps else {}
        timeunet = ["--model", "timeunet", "--bf16", "--use_pallas_train"] + common
        run_a, pool_a, eval_a, sec_a = cli_run(
            "(a) timeunet bf16, 2 epochs", timeunet + ["--epochs", "2", "--res_dir", a_dir],
            pool_want(2 * n_train), {"group": 2 * n_val + n_test})
        missing = [f for f in CLI_FILES if not os.path.exists(os.path.join(a_dir, f))]
        check(not missing, f"train cli (a) wrote no {missing}")
        check(os.path.exists(os.path.join(a_dir, "Fold_1", "model.ckpt")),
              "train cli (a): no model.ckpt")
        epochs = {e: {"seconds": m["train_epoch_time"],
                      "steps_per_s": n_train / m["train_epoch_time"]}
                  for e, m in run_a.trainlog.items()}
        for e, v in epochs.items():
            print(f"train cli (a) epoch {e}: {n_train} train steps (B={bs}, bf16) in "
                  f"{v['seconds']:.3f} s, {v['steps_per_s']:.3f} steps/s", flush=True)

        # a resume continues after the best epoch, the one model.ckpt holds
        best = ckpt.load_state(os.path.join(a_dir, "Fold_1"))["meta"]["epoch"]
        run_b, pool_b, eval_b, sec_b = cli_run(
            f"(b) resume to epoch 3 from (a)'s best, epoch {best}",
            timeunet + ["--epochs", "3", "--weight_folder", a_dir, "--res_dir", b_dir],
            pool_want((3 - best) * n_train), {"group": (3 - best) * n_val + n_test})
        check(run_b.start_epoch == best + 1, f"train cli (b) resumed at epoch "
                                             f"{run_b.start_epoch}, not {best + 1}")
        check(run_b.restored_adam_step == best * n_train and run_b.adam_step == 3 * n_train,
              f"train cli (b): Adam step {run_b.restored_adam_step} restored, "
              f"{run_b.adam_step} at the end, not {best * n_train} and {3 * n_train}")

        run_c, pool_c, eval_c, sec_c = cli_run(
            "(c) --test of (a)", timeunet + ["--test", "--weight_folder", a_dir,
                                             "--res_dir", c_dir],
            {}, {"group": n_test})
        ta, tc = run_a.test_metrics, run_c.test_metrics
        loss_rel = abs(tc["test_loss"] - ta["test_loss"]) / abs(ta["test_loss"])
        miou_diff = abs(tc["test_IoU"] - ta["test_IoU"])
        print(f"train cli (c) vs (a): test loss {tc['test_loss']!r} / {ta['test_loss']!r} "
              f"(relative {loss_rel:.3e}), mIoU {tc['test_IoU']!r} / {ta['test_IoU']!r}",
              flush=True)
        check(loss_rel <= 1e-5 and miou_diff <= 1e-4,
              f"train cli (c): --test gave loss {tc['test_loss']}, mIoU {tc['test_IoU']}; "
              f"the run's own test {ta['test_loss']}, {ta['test_IoU']}")

        # (f) (a) again with the device cache: x reaches the steps in bf16, cast
        # before the upload; epoch 2 gathers its batches on the card (as
        # many as the T buckets' stacks fill), and every step must launch
        # the same tail bf16 variant as (a)'s fp32 x under autocast
        run_f, pool_f, eval_f, sec_f = cli_run(
            "(f) timeunet bf16, device cache, 2 epochs",
            timeunet + ["--epochs", "2", "--device_cache", "--res_dir",
                        os.path.join(tmp, "f")],
            None, {"group": 2 * n_val + n_test})
        check(n_train < run_f.adam_step <= 2 * n_train and pool_f == pool_want(
            run_f.adam_step), f"train cli (f): {run_f.adam_step} steps launched {pool_f}")

        run_d, pool_d, eval_d, sec_d = cli_run(
            "(d) utae fp32 boundary loss, device cache",
            ["--model", "utae", "--add_boundary_loss", "--device_cache", "--epochs", "1",
             "--res_dir", os.path.join(tmp, "d")] + common,
            {}, {"wide": n_val + n_test})
        bnd = {k: v for k, v in {**run_d.trainlog[1], **run_d.test_metrics}.items()
               if k.endswith("_b")}
        check(len(bnd) == 6 and all(np.isfinite(v) for v in bnd.values()),
              f"train cli (d): boundary metrics {bnd}")
        print(f"train cli (d) boundary metrics {json.dumps(bnd)}; epoch 1 "
              f"{run_d.trainlog[1]['train_epoch_time']:.3f} s", flush=True)
        epochs_f = {e: {"seconds": m["train_epoch_time"]} for e, m in run_f.trainlog.items()}
        print(f"train cli (f) epochs {json.dumps(epochs_f)}, {run_f.adam_step} steps",
              flush=True)
        out.update(epochs=epochs, epochs_device_cache=epochs_f,
                   seconds={"a": sec_a, "b": sec_b, "c": sec_c, "d": sec_d, "f": sec_f},
                   test_a=ta, test_c=tc, boundary=bnd, batches=[n_train, n_val, n_test],
                   resumed_from_epoch=best)
        pools = [pool_a, pool_b, pool_c, pool_d, pool_f]
        evals = [eval_a, eval_b, eval_c, eval_d, eval_f]
        out["launches"] = {k: sum(p.get(k, 0) for p in pools) for k in tail16}
        out["launches"].update({f"eval_{r}": sum(e.get(r, 0) for e in evals)
                                for r in ("group", "wide")})

    # (e) remat on TimeUNet: one B=4 step's gradients with and without, and
    # without remat with the L-TAE output perturbed, as the yardstick
    cfg = StepConfig(num_classes=N_CLASSES, class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    fresh = get_model({"model": "timeunet"},
                      generator=torch.Generator().manual_seed(0)).state_dict()
    batch = train_batch(TRAIN_B, torch.Generator(device=dev).manual_seed(4), dev)
    grads, peaks = {}, {}
    for name, remat, eps in (("no remat", False, 0.0), ("remat", True, 0.0),
                             ("perturbed", False, GRAD_EPS)):
        m = get_model({"model": "timeunet", "remat": remat}, device=dev)
        m.load_state_dict(fresh)
        m.train()
        if eps:
            noise = torch.Generator(device=dev).manual_seed(12)
            m.temporal_encoder.register_forward_hook(
                lambda mod, args, o: (o[0] * (1 + eps * torch.randn(
                    o[0].shape, generator=noise, device=dev)), o[1]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits = m(batch["x"], batch["dates"], batch["pad_mask"],
                   generator=torch.Generator(device=dev).manual_seed(11))
        cross_entropy(logits, batch["y"], weight=torch.tensor(
            cfg.class_weights, device=dev)).backward()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        grads[name] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        del m, logits
        torch.cuda.empty_cache()
    print(f"train cli (e) TimeUNet B={TRAIN_B} fp32 step: peak memory above the "
          f"weights {peaks['no remat']:.2f} GiB without remat, {peaks['remat']:.2f} "
          f"GiB with", flush=True)
    out["remat_grad_worst_ratio"] = check_grads_within_spread(
        "remat", grads["remat"], grads["no remat"], grads["perturbed"])
    out["remat_peak_gib"] = {"no_remat": peaks["no remat"], "remat": peaks["remat"]}
    return out


CELL_FIELD = 64          # phase 13's tile: 64^2 fields of one spectral profile
CELL_DATES = [int(f"2019{m:02d}{d:02d}") for m in range(1, 13) for d in (1, 7, 13, 19, 25)
              ][:T] + [20191231] * max(0, T - 60)


def write_serving_cell(root: str) -> dict:
    """Phase 13 (a): one synthetic 100-patch inference cell on disk, as the
    port's DatasetCreator saves one (float32 .npy patches (T, 10, 128, 128)
    and a metadata.json with dates and affines), cut from a seeded
    (T, 10, 1098, 1098) tile of reflectance-like uint16 values (fields of
    CELL_FIELD^2 px with a profile each, plus noise) by
    DatasetCreator.patchify_inference; the model directory beside it
    (conf.json: TimeUNet_v1 at the factory defaults, NORM_S2_patch.json in
    the S2TSCzCrop release format, Fold_1/model.ckpt of seeded weights).
    Where the temporary disk cannot take the float32 patches, they are
    saved as uint16 (the reference's format, which the loader reads)."""
    import os
    import shutil

    from crop2seg_tpu_torch.gis.dataset_creator import DatasetCreator, patch_affines
    from crop2seg_tpu_torch.gis.raster import Affine
    from crop2seg_tpu_torch.learning import checkpoint as ckpt

    times = {}
    start = time.perf_counter()
    rng = np.random.default_rng(13)
    n_f = -(-1098 // CELL_FIELD)
    fields = rng.integers(300, 5000, (T, 10, n_f, n_f), dtype=np.uint16)
    tile = np.repeat(np.repeat(fields, CELL_FIELD, 2), CELL_FIELD, 3)[:, :, :1098, :1098]
    tile = tile + rng.integers(0, 400, tile.shape, dtype=np.uint16)
    times["generate_s"] = time.perf_counter() - start
    start = time.perf_counter()
    patches = DatasetCreator.patchify_inference(tile)         # (100, T, 10, 128, 128)
    times["patchify_s"] = time.perf_counter() - start
    cell = os.path.join(root, "cell")
    need = patches.size * 4
    fmt = "float32" if shutil.disk_usage(root).free > 1.2 * need else "uint16"
    affine = Affine(10.0, 0.0, 499980.0, 0.0, -10.0, 5600040.0)
    start = time.perf_counter()
    dc = DatasetCreator(cell, for_inference=True)
    affines = patch_affines(affine, 10)
    if fmt == "float32":
        dc._save(patches, None, np.ones(100, bool), "T33UVR", 0, CELL_DATES, 32633,
                 affines, None, None)
    else:
        for i in range(100):
            np.save(os.path.join(cell, "DATA_S2", f"S2_{i}.npy"), patches[i])
        with open(os.path.join(cell, "metadata.json"), "w") as f:
            json.dump([{"ID_PATCH": i, "ID_WITHIN_TILE": i, "TILE": "T33UVR",
                        "Status": "OK", "time-series_length": T, "crs": 32633,
                        "Fold": i % 5 + 1, "set": "",
                        "dates-S2": {str(j): d for j, d in enumerate(CELL_DATES)},
                        "affine": list(affines[i])} for i in range(100)], f)
    times["write_s"] = time.perf_counter() - start
    size = sum(os.path.getsize(os.path.join(cell, "DATA_S2", f))
               for f in os.listdir(os.path.join(cell, "DATA_S2")))
    print(f"serving cell: tile {tile.shape} uint16 generated in {times['generate_s']:.1f} s, "
          f"patchified in {times['patchify_s']:.1f} s, 100 {fmt} patches written "
          f"({size / 2 ** 30:.2f} GiB) in {times['write_s']:.1f} s", flush=True)

    model_dir = os.path.join(root, "model")
    os.makedirs(os.path.join(model_dir, "Fold_1"))
    conf = {"model": "timeunet", "num_classes": 15, "input_dim": 10, "dtype": "bfloat16"}
    with open(os.path.join(model_dir, "conf.json"), "w") as f:
        json.dump(conf, f)
    norm_rng = np.random.default_rng(14)
    norm = {"train": {"mean": norm_rng.uniform(1500, 3000, 10).tolist(),
                      "std": norm_rng.uniform(600, 1400, 10).tolist()}}
    with open(os.path.join(model_dir, "NORM_S2_patch.json"), "w") as f:
        json.dump(norm, f)
    model = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    ckpt.save_state(os.path.join(model_dir, "Fold_1"), model, None, 0, 0.0)
    parcels = np.repeat(np.repeat(np.arange(n_f * n_f).reshape(n_f, n_f) + 1,
                                  CELL_FIELD, 0), CELL_FIELD, 1)[:1098, :1098]
    parcels[np.repeat(np.repeat(rng.random((n_f, n_f)) < 0.3, CELL_FIELD, 0),
                      CELL_FIELD, 1)[:1098, :1098]] = 0          # background
    return {"cell": cell, "model_dir": model_dir, "model": model, "tile": tile,
            "format": fmt, "parcels": parcels, "times": times, "bytes": size}


def phase_serving_from_disk(dev, train_cli: dict):
    """Phase 13: a 100-patch cell from disk to the crop map and its GIS
    outputs through webapp/pipeline.py::generate_prediction (TimeUNet_v1 at
    full width, T = 61, batch 10), cold; then the warm stream alone
    (stream_tile_inference on the same dataset and weights: the GIS
    post-processing of the same classes is not repeated), each run's
    counts set to 0 just before it; then the in-memory tile predictor on
    the same inputs."""
    import os
    import tempfile

    from crop2seg_tpu_torch.data import S2TSCZCropDataset, load_norm_values
    from crop2seg_tpu_torch.webapp.pipeline import generate_prediction, stream_tile_inference

    out = {"train_cli_loader": train_cli["loader"]}
    with tempfile.TemporaryDirectory() as tmp:
        cell = write_serving_cell(tmp)
        out.update(format=cell["format"], cell_bytes=cell["bytes"], **cell["times"])
        # the dataset generate_prediction builds for the prediction year 2019
        norm = load_norm_values(os.path.join(cell["model_dir"], "NORM_S2_patch.json"))
        ds = S2TSCZCropDataset(cell["cell"], norm=True, norm_values=norm, set_type="train",
                               for_inference=True, reference_date="2018-09-01")
        runs = {}
        cache = os.path.join(tmp, "cache")
        for label in ("cold", "warm"):
            lf.ltae_fused_forward.launches = 0               # this path's counts
            lf.ltae_fused_forward.route_launches.clear()
            lp.ltae_pool.launches.clear()
            ls.ltae_stages.launches = 0
            tl = {}
            torch.cuda.synchronize()
            start = time.perf_counter()
            if label == "cold":
                res = generate_prediction(cell["cell"], cell["model_dir"], 2019, cache,
                                          lpis_parcels=cell["parcels"], batch_size=MAIN_B,
                                          timeline=tl)
            else:
                proba, classes = stream_tile_inference(cell["model"], ds, MAIN_B, timeline=tl)
                res = {"proba": proba, "classes": classes}
            seconds = time.perf_counter() - start
            routes = dict(lf.ltae_fused_forward.route_launches)
            others = dict(lp.ltae_pool.launches)
            stages = ls.ltae_stages.launches
            runs[label] = {"seconds": seconds, "stream_s": tl["total"],
                           "patches_per_s": 100 / tl["total"],
                           "launches": lf.ltae_fused_forward.launches, "routes": routes,
                           "timeline": tl}
            what = (f"stream_tile_inference {seconds:.2f} s" if label == "warm" else
                    f"generate_prediction {seconds:.2f} s; setup {tl['setup']:.2f} s")
            print(f"serving {label}: {what}; stream {tl['total']:.3f} s = "
                  f"{100 / tl['total']:.2f} patches/s; ltae_fused_fwd launches {routes}; "
                  f"timeline {json.dumps(tl)}", flush=True)
            check(routes == {"group": 10} and lf.ltae_fused_forward.launches == 10,
                  f"serving {label}: the eval kernel launched {routes}, not 10 group")
            check(not others and stages == 0, f"serving {label}: other L-TAE kernels "
                                              f"launched: {others}, stages {stages}")
            p, cls = res["proba"], res["classes"]
            check(p.shape == (1098, 1098, 15) and p.dtype == np.float32,
                  f"serving {label}: proba {p.shape} {p.dtype}")
            check(bool(np.isfinite(p).all()), f"serving {label}: non-finite proba")
            s_err = float(np.abs(p.sum(-1) - 1).max())
            check(s_err <= 1e-5, f"serving {label}: proba sums off by {s_err}")
            check(cls.dtype == np.uint8 and cls.shape == (1098, 1098)
                  and bool((cls == p.argmax(-1)).all()), f"serving {label}: classes")
            runs[label]["result"] = res
        cold = runs["cold"]
        cold.update(postprocess_s=cold["timeline"]["postprocess"],
                    setup_s=cold["timeline"]["setup"],
                    segments=int(cold["result"]["segments"].max()),
                    polygons=len(cold["result"]["polygons"]))
        print(f"serving cold: post-processing {cold['postprocess_s']:.2f} s "
              f"({cold['segments']} segments, {cold['polygons']} polygons)", flush=True)
        pred = os.path.join(cache, "prediction")
        files = ["classes.npy", "homogenized.npy", "prediction.shp", "prediction.shx",
                 "prediction.dbf", "prediction.geojson"]
        missing = [f for f in files if not os.path.exists(os.path.join(pred, f))]
        if not any(os.path.exists(os.path.join(pred, f))
                   for f in ("prediction.tif", "prediction.npz")):
            missing.append("prediction.tif / .npz")
        check(not missing, f"serving: no {missing} in the cache")
        check(bool((cold["result"]["homogenized"][cell["parcels"] == 0] == 0).all()),
              "serving: homogenized is not 0 outside the parcels")

        # (c) the in-memory path on the same inputs: the padded 1280^2 tile,
        # standardized as the decoder does it ((x - mean) * (1 / std) in
        # fp32, rounded to bf16), through make_tile_predictor in fp32, cropped
        plan = ds.native_batch_plan()
        mean = torch.tensor(plan["mean"], device=dev).view(1, 10, 1, 1)
        inv = torch.tensor(np.float32(1) / plan["std"].astype(np.float32),
                           device=dev).view(1, 10, 1, 1)
        # the values are < 2**15: the int16 view holds them exactly
        x = torch.from_numpy(cell["tile"].view(np.int16)).to(dev).float()[:, plan["reorder"]]
        x = torch.nn.functional.pad(x, (0, 1280 - 1098, 0, 1280 - 1098))
        x = ((x - mean) * inv).to(torch.bfloat16)
        # patch 0 as the decoder gives it, bit for bit
        dec, _, _ = native.load_batch([ds.light_item(0)["path"]], T, 128, 128,
                                      reorder=plan["reorder"], mean=plan["mean"],
                                      std=plan["std"], layout="nchw", out_dtype="bf16")
        same = torch.equal(dec[0].to(dev).view(torch.int16),
                           x[:, :, :128, :128].contiguous().view(torch.int16))
        check(same, "serving: the in-memory standardization is not the decoder's")
        x = x.float().permute(0, 2, 3, 1).contiguous()               # (T, 1280, 1280, C)
        dates = ds.light_item(0)["dates"]
        predict = make_tile_predictor(cell["model"], batch_size=MAIN_B)
        lf.ltae_fused_forward.launches = 0
        mem = predict(x, dates, T)
        check(lf.ltae_fused_forward.launches == 10, "serving: the in-memory tile did not "
                                                    "launch 10 times")
        del x
        torch.cuda.empty_cache()
        warm = runs["warm"]["result"]
        p_err = float(np.abs(warm["proba"] - mem["proba"]).max())
        top2 = np.sort(mem["proba"], -1)[..., -2:]
        sure = top2[..., 1] - top2[..., 0] >= 1e-4
        cls_diff = int((warm["classes"] != mem["classes"])[sure].sum())
        cold_err = float(np.abs(runs["cold"]["result"]["proba"] - warm["proba"]).max())
        print(f"serving vs make_tile_predictor (fp32, same bf16 inputs): max |dproba| "
              f"{p_err:.3e} (tol 1e-5), classes differing where the top-2 margin >= 1e-4: "
              f"{cls_diff} of {int(sure.sum())}; cold vs warm max |dproba| {cold_err:.3e}",
              flush=True)
        check(p_err <= 1e-5, f"serving differs from make_tile_predictor by {p_err}")
        check(cls_diff == 0, f"serving: {cls_diff} classes differ from make_tile_predictor")
        check(cold_err <= 1e-5, f"serving: the warm stream differs from the cold run by "
                                f"{cold_err}")
        for r in runs.values():
            del r["result"]
        out.update(runs=runs, vs_tile_predictor_max_abs_err=p_err,
                   cold_vs_warm_max_abs_err=cold_err)
    return out


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
    # the native loader (g++) builds beside the kernels (nvcc)
    loader_build = concurrent.futures.ThreadPoolExecutor(1).submit(native.build)
    libs = _build.build_all(["ltae_fused_fwd", "ltae_pool", "ltae_stages"])
    loader_lib = loader_build.result()
    print(f"built {', '.join(p.name for p in libs.values())}, {loader_lib.name} in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "smem")):
                print("  ptxas:", line.strip(), flush=True)
    pool_ptxas = ptxas_report(libs["ltae_pool"].with_suffix(".log").read_text())
    fwd_ptxas = {}
    for tail, dtype in VARIANTS:
        found = [v for k, v in pool_ptxas.items() if pool_fwd_mangled(tail, dtype) in k]
        check(len(found) == 1, f"ptxas reported no {pool_fwd_kernel_name(tail, dtype)}")
        fwd_ptxas[(tail, dtype)] = found[0]
        print(f"ptxas {pool_fwd_kernel_name(tail, dtype)}: {found[0][0]} registers, "
              f"{found[0][1]} bytes spill stores, {found[0][2]} bytes spill loads", flush=True)

    fused_ptxas = ptxas_report(libs["ltae_fused_fwd"].with_suffix(".log").read_text())
    # {(kernel, dtype[, R]): (registers, spill stores, spill loads)} of the
    # wide row-group kernel, the queries kernel (R rows a group: 4 at C <= 64,
    # 2 above) and the general kernels
    ptx = {}
    tins = ((torch.float32, "f"), (torch.bfloat16, "13__nv_bfloat16"))
    for dtype, tin in tins:
        for key, lib, mangled in (
                (("wide", dtype), fused_ptxas, f"ltae_fused_wide_kernelI{tin}E"),
                (("queries", dtype, 4), fused_ptxas, f"ltae_fused_queries_kernelI{tin}Li4E"),
                (("queries", dtype, 2), fused_ptxas, f"ltae_fused_queries_kernelI{tin}Li2E"),
                # the general kernels' instantiations with the workspace
                # in shared memory (Smem = true), those the timing runs
                (("general", dtype), fused_ptxas, f"ltae_fused_general_kernelI{tin}Lb1E"),
                (("pool_fwd_general", dtype), pool_ptxas,
                 f"ltae_pool_fwd_general_kernelI{tin}Lb1ELb1E"),
                (("pool_bwd_general", dtype), pool_ptxas,
                 f"ltae_pool_bwd_general_kernelI{tin}Lb1ELb1E")):
            found = [v for k, v in lib.items() if mangled in k]
            check(len(found) == 1, f"ptxas reported no {mangled}")
            ptx[key] = found[0]
            print(f"ptxas {key[0]}<{str(dtype)[6:]}{', ' + str(key[2]) if len(key) > 2 else ''}"
                  f"{', tail' if 'pool' in key[0] else ''}>: {found[0][0]} registers, "
                  f"{found[0][1]} bytes spill stores, {found[0][2]} bytes spill loads",
                  flush=True)
    wide_ptxas = {dtype: ptx[("wide", dtype)] for dtype, _ in tins}

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
    models = {"utae": utae, "timeunet": timeunet}
    q_errs, q_t, q_launches = phase_kernel_queries(models, dev)
    gen_t = phase_general_timing(models, dev)
    torch.cuda.empty_cache()
    gen_launches, gen_errs, gen_train, pad_value_errs, year = phase_routing(models, dev)
    del utae, timeunet, models
    torch.cuda.empty_cache()
    utae_runs, remat_worst = phase_utae_train(dev)
    torch.cuda.empty_cache()
    cli_out = phase_train_cli(dev)
    torch.cuda.empty_cache()
    serving = phase_serving_from_disk(dev, cli_out)

    ms, plain_ms, b_ms, b_by = timings[torch.bfloat16]
    ms32, plain32, b32, b_by32 = timings[torch.float32]
    kernel = {
        "name": "ltae_fused_fwd", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu",
        "replaces": "crop2seg_tpu/ops/ltae_pallas.py:421",
        "kernel": "ltae_fused_group_kernel<Tin>",
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
            tin = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
            pool.append({
                "name": name, "route": "cuda",
                "source": "crop2seg_tpu_torch/csrc/ltae_pool.cu",
                "replaces": "crop2seg_tpu/ops/ltae_pallas_train.py:"
                            + ("457" if direction == "fwd" else "536"),
                "kernel": (pool_fwd_kernel_name(tail, dtype) if direction == "fwd" else
                           f"ltae_pool_bwd_kernel<{tin}, {str(tail).lower()}>"
                           " + ltae_pool_bwd_reduce"),
                "launches": pool_launches.get(name, 0),
                "max_abs_err": pool_errs[name],
                "ms": pool_t[name][0], "plain_ms": pool_t[name][1],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "dtype": str(dtype)[6:], "shape": [TRAIN_B, T, HW, C],
            })
            if direction == "fwd":
                regs, spill_st, spill_ld = fwd_ptxas[(tail, dtype)]
                pool[-1].update(median_ms=pool_t[name][2], registers=regs,
                                spill_store_bytes=spill_st, spill_load_bytes=spill_ld)
            if tail and direction == "fwd":
                run = runs[f"tail {'fp32' if dtype == torch.float32 else 'bf16'}"]
                pool[-1].update(train_losses=run["losses"],
                                train_step_ms=run["warm_ms"],
                                train_step_median_ms=run["warm_median_ms"],
                                train_peak_gib=run["peak_gib"])
    ms, plain_ms, b_ms, b_by, device_ms = utae_t[torch.bfloat16]
    ms32, plain32, b32, b_by32, device32 = utae_t[torch.float32]
    kernel_utae = {
        "name": "ltae_fused_fwd_utae", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu",
        "replaces": "crop2seg_tpu/ops/ltae_pallas.py:421",
        "kernel": "ltae_fused_wide_kernel<Tin>",
        "registers": wide_ptxas[torch.bfloat16][0],
        "spill_store_bytes": wide_ptxas[torch.bfloat16][1],
        "registers_fp32": wide_ptxas[torch.float32][0],
        "spill_store_bytes_fp32": wide_ptxas[torch.float32][1],
        "launches": utae_launches,
        "max_abs_err": max(v for k, v in utae_errs.items() if k[0] == torch.bfloat16),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "dtype": "bfloat16", "shape": [MAIN_B, T, UTAE_HW, UTAE_C], "d_out": UTAE_C,
        "attn": True, "launches_entry_forward": entry_launches,
        "max_abs_err_fp32": max(v for k, v in utae_errs.items() if k[0] == torch.float32),
        "ms_fp32": ms32, "plain_ms_fp32": plain32, "bound_ms_fp32": b32,
        "bound_by_fp32": b_by32, "device_ms": device_ms, "device_ms_fp32": device32,
        "tile_patches_per_s": utae_pps, "tile_patches_per_s_fp32": utae_pps32,
    }
    kernel_stages = {
        "name": "ltae_stages", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_stages.cu",
        "replaces": "scripts/debug_ltae_stages.py:91", "library_ms": None,
        "dtype": "float32", **stages,
    }
    ms, plain_ms, b_ms, b_by, device_ms = q_t[("utae", torch.bfloat16)]
    kernel_q = {
        "name": f"ltae_fused_fwd_nq{NQ}", "route": "cuda",
        "source": "crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu",
        "replaces": "crop2seg_tpu/ops/ltae_pallas.py:421",
        "kernel": "ltae_fused_queries_kernel<Tin, R>",
        "registers": ptx[("queries", torch.bfloat16, 2)][0],
        "spill_store_bytes": ptx[("queries", torch.bfloat16, 2)][1],
        "launches": q_launches,
        "max_abs_err": max(v for k, v in q_errs.items() if k[1] == torch.bfloat16),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "device_ms": device_ms,
        "dtype": "bfloat16", "shape": [MAIN_B, T, UTAE_HW, UTAE_C], "d_out": UTAE_C,
        "num_queries": NQ, "attn": True,
        "max_abs_err_fp32": max(v for k, v in q_errs.items() if k[1] == torch.float32),
    }
    for (width, dtype), (ms, plain_ms, b_ms, b_by, device_ms) in q_t.items():
        if (width, dtype) != ("utae", torch.bfloat16):
            regs = ptx[("queries", dtype, 2 if width == "utae" else 4)]
            kernel_q[f"{width}_{str(dtype)[6:]}"] = {
                "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "registers": regs[0], "spill_store_bytes": regs[1]}
    general = []
    for name, key, replaces, errs_key in (
            ("ltae_fused_fwd_general", "general", "crop2seg_tpu/ops/ltae_pallas.py:421",
             "eval"),
            ("ltae_pool_tail_fwd_general", "pool_fwd_general",
             "crop2seg_tpu/ops/ltae_pallas_train.py:457", "fwd"),
            ("ltae_pool_tail_bwd_general", "pool_bwd_general",
             "crop2seg_tpu/ops/ltae_pallas_train.py:536", "bwd")):
        (ms, plain_ms, b_ms, b_by, dev_ms), (ms32, plain32, b32, b_by32, dev32) = (
            gen_t[name][torch.bfloat16], gen_t[name][torch.float32])
        if errs_key == "eval":
            n_launch = gen_launches.get(name, 0)
            by_variant = None
        else:
            by_variant = {k: v for k, v in gen_launches.items()
                          if k.startswith("ltae_pool") and f"_{errs_key}" in k}
            n_launch = sum(by_variant.values())
        general.append({
            "name": name, "route": "cuda",
            "source": ("crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu" if key == "general"
                       else "crop2seg_tpu_torch/csrc/ltae_pool.cu"),
            "replaces": replaces,
            "kernel": {"general": "ltae_fused_general_kernel<Tin>",
                       "pool_fwd_general": "ltae_pool_fwd_general_kernel<Tin, Tail>",
                       "pool_bwd_general": "ltae_pool_bwd_general_kernel<Tin, Tail>"
                                           " + ltae_pool_bwd_reduce"}[key],
            "launches": n_launch, "launches_by_variant": by_variant,
            "max_abs_err": gen_errs.get((errs_key, torch.bfloat16), 0.0),
            "max_abs_err_fp32": gen_errs.get((errs_key, torch.float32), 0.0),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "dtype": "bfloat16",
            "shape": [TRAIN_B, T_GENERAL, HW, C],
            "ms_fp32": ms32, "plain_ms_fp32": plain32, "bound_ms_fp32": b32,
            "bound_by_fp32": b_by32,
            "registers": ptx[(key, torch.bfloat16)][0],
            "spill_store_bytes": ptx[(key, torch.bfloat16)][1],
            "registers_fp32": ptx[(key, torch.float32)][0],
            "spill_store_bytes_fp32": ptx[(key, torch.float32)][1],
        })
        if dev_ms is not None:
            general[-1].update(device_ms=dev_ms, device_ms_fp32=dev32)
    general[0].update(tile_t73_patches_per_s=year["tile_t73_patches_per_s"],
                      tile_t73_patches_per_s_fp32=year["tile_t73_patches_per_s_fp32"])
    general[2].update(reproducible=year["bwd_general_reproducible"],
                      train_step_t70_ms=gen_train["warm_ms"])
    print("utae_train " + json.dumps({"runs": utae_runs,
                                      "remat_grad_worst_ratio": remat_worst}),
          flush=True)
    print("routing " + json.dumps({"general_launches": gen_launches,
                                   "timeunet_t70_train": gen_train,
                                   "timeunet_pad_value_err": {
                                       "eval": pad_value_errs[False],
                                       "train_forward": pad_value_errs[True]}}), flush=True)
    kernel["launches_train_cli"] = cli_out["launches"]["eval_group"]
    kernel_utae["launches_train_cli"] = cli_out["launches"]["eval_wide"]
    for entry in pool:
        entry["launches_train_cli"] = cli_out["launches"].get(entry["name"], 0)
    print("train_cli " + json.dumps(cli_out), flush=True)
    kernel["launches_serving_from_disk"] = {
        k: r["launches"] for k, r in serving["runs"].items()}
    kernel["disk_to_map_patches_per_s"] = {
        k: r["patches_per_s"] for k, r in serving["runs"].items()}
    print("serving_from_disk " + json.dumps(serving), flush=True)
    print(f"chip_smoke.py ran {time.perf_counter() - start:.1f} s, the build included",
          flush=True)
    print(json.dumps({"kernels": [kernel, kernel_utae] + pool + [kernel_stages, kernel_q]
                      + general}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
