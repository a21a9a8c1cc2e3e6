"""Drive crop2seg_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, one CUDA card

1. Builds the kernel sources (csrc/ltae_fused_fwd.cu, csrc/ltae_pool.cu,
   csrc/ltae_stages.cu, csrc/temporal_aggregate.cu: the skip aggregator's
   pair, which the models below that aggregate skips launch and
   tests/test_torch_aggregate_kernel.py holds against its plain version),
   one nvcc process each, started together with the
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
   make_tile_predictor in bf16 and fp32 with the checks of phase 4; the
   bf16 tile launches the skip aggregator's forward (counter
   ``aggregate.kernel``) exactly 30 times, three skips a batch of ten.
   Then the aggregator's pair (csrc/temporal_aggregate.cu) at U-TAE's three
   skips (128^2, 64^2, 32^2, T=61, C=64, K=16, the attention resampled
   from 16^2) at B=16 (lengths 27-61) and B=10, bf16 and fp32, forward and
   backward against the loop of per-date ops: out and dx bit for bit, dw
   within 1e-6 of its products' magnitudes and in bf16 one rounding
   besides; then the pair, the loop and one torch.einsum timed at B=16,
   128^2 beside the bytes bound (``temporal_aggregate_fwd`` / ``_bwd`` on
   the kernels line, ``library_ms`` the einsum's).
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
   BatchNorm statistics, no launch of any L-TAE kernel (the JAX U-TAE
   trains its L-TAE on plain ops too) and 15 launches each way of the
   aggregator's pair (three skips a step); then one B=2 step's gradients with remat ("conv_out"
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
14. The conv variants and W-TAE (phase_variants), each path's counts set
   to 0 just before it: (a) W-TAE at the factory defaults (seeded weights)
   through phase 4's tile in bf16 and fp32 with its checks and no L-TAE
   kernel launch (W-TAE's attention-only L-TAE has no kernel, in the JAX
   package either); (b) W-TAE training as phase 10: 5 steps at B=4 fp32 and
   5 at B=16 bf16 with remat conv_out, B=2 remat gradients within the
   perturbation spread; (c) U-TAE with MBConv blocks (16 classes): an eval
   forward at B=10, one launch of kernel 1's wide route, within 1e-3 of
   fused=False, and one B=4 fp32 train step with remat; (d) TimeUNet with
   depthwise-separable convs + SE and with instance norm: in_conv keeps its
   tail, so an eval forward at B=10 launches kernel 1's group route once,
   untailed, within 1e-3 of fused=False, and a B=4 train step in fp32 and
   in bf16 the untailed pool pair once each way; then kernel 1 untailed
   timed at TimeUNet's width; (e) the train CLI on phase 12's dataset:
   W-TAE with --add_boundary_loss, 2 epochs, a resume to 3 and --test
   (no kernel launch; finite boundary metrics; --test repeats the run's
   test), and U-TAE --use_mbconv --remat, 1 epoch (one wide launch per val
   and test batch).
15. TimeUNet_v2 and the rest of get_model's zoo (phase_zoo), each path's
   counts set to 0 just before it and read just after; none launches an
   L-TAE kernel (the JAX package computes them on XLA ops): (a) TimeUNet_v2
   at the factory defaults (seeded weights) through phase 4's tile in bf16
   and fp32 (shapes, finite, sums to 1, pad invariance within 1e-6 in fp32,
   two patches rerun with a quarter of the classical attention's chunk rows
   within 1e-5), patches/s beside the classical attention's bound; (b)
   TimeUNet_v2 training: 5 steps at B=4 in fp32 and in bf16 (finite,
   falling loss, BatchNorm statistics changed, warm step ms, peak memory),
   then one step's gradients with the chunks checkpointed against not
   (B=1, dropout on, the same seed) within the perturbation spread; (c)
   UNet3D, ConvLSTM, ConvGRU, uconvlstm and U-Net naive (max_temp 61) at
   the factory defaults: the tile in bf16 and fp32 (pad invariance for
   uconvlstm, the one whose JAX model has it), one B=4 fp32 train step;
   (d) the train CLI on phase 12's dataset: --model timeunet_v2 for an
   epoch and --test of its result, --model convlstm for an epoch; a
   ``zoo`` JSON line, and the kernels line gains
   ``launches_timeunet_v2_and_zoo`` (0).
16. PASTIS training, preprocessing on the card, the L-TAE streamed over T
   and the modules no entry point reaches (phase_pastis), each path's counts
   set to 0 just before it and read just after: (a) the train CLI on a
   synthetic PASTIS folder (10 patches at 128^2, T 38-61, 20 classes, two a
   fold), bf16, one epoch: U-TAE on fold 1 (one wide eval launch per val and
   test batch), --test of it (repeats its test loss), TimeUNet_v1 on fold 1
   with --use_pallas_train (the tail bf16 pair once a step, one group
   launch per val and test batch), with --seq_chunk 8 alone (each training
   step streams the L-TAE over T, no pair launch, as the JAX CLI routes it)
   and with both flags (the pair, nothing streamed), U-TAE over all five
   folds (every fold's
   files, the overall files, the confusion matrices over all ten patches);
   (b) preprocess_batch at B=4, T=61, 128^2 on the card against the CPU for
   the same draws (exact but the standardized values, 1e-6); (c)
   TimeUNet's full-width L-TAE through _chunked (seq_chunk 8 and 16)
   against the plain train path, o, output and every gradient, fp32 and
   bf16, beside the kernel pair: warm ms and peak memory; (d) UNetEx,
   MLPMixer and TemporalAggregator3D at their defaults on 128^2 inputs
   against the CPU, one UNetEx train step. A ``pastis`` JSON line; the
   kernels line gains ``launches_pastis`` and ``launches_chunked_and_m10b``
   (0).

17. Data-parallel training and patch-parallel serving (phase_data_parallel,
   parallel/mesh.py), each path's counts set to 0 just before it and read
   just after: (a) where two or more cards are visible, an NCCL group over
   them running three TimeUNet bf16 steps on the kernel pair at B = 4
   (loss and statistics held: each card's bf16 convs round at its own
   batch size) and two fp32 steps held as (b) holds them (on one card it
   prints that this path was not run: NCCL refuses two ranks on one
   device); (b) TimeUNet fp32 (the tail fp32 pair once a step in
   each rank) and (c) U-TAE with remat, over two gloo ranks on cuda:0, B =
   2 each of the global batch of 4, dropout 0, against one process on the
   global batch: the loss (1e-5 relative), cm and cm_top2 (exact but
   pixels within a tie of the one process's logits), BatchNorm's running
   statistics (1e-5), the ranks' gradients equal and within the spread of
   the gradient check above, the ranks' step ms and a gloo all-reduce's;
   (d) TimeUNet's tile through make_tile_predictor on one card (batch 10)
   and with the mesh [cuda:0, cuda:0] (patch_parallel_infer, batch 20: 10 a
   device), bf16 and fp32: probabilities within 1e-4 / 1e-5, classes equal
   where decided, 10 eval kernel launches each, patches/s of each; (e) the CLI with --num_devices
   2: refused on one card (trains an epoch on two or more), and on the CPU
   over two gloo processes, whose test loss one process's --test repeats
   within 1e-5; (f) graft_entry's entry forward (one wide launch) and
   dryrun_multichip(1). A ``data_parallel`` JSON line; the kernels line
   gains ``launches_data_parallel``.
18. The 2-D data x space training mesh (phase_space_parallel,
   parallel/mesh.py), each path's counts set to 0 just before it and read
   just after: on a (2, 2) mesh (rank d * 2 + s: samples 2d, 2d + 1 of
   phase 17's global batch of 4, rows 64s to 64s + 63 of each frame), (a)
   NCCL a card a rank where four cards are visible (else it prints that
   this path was not run), (b) TimeUNet fp32 on the tail pair, (c) U-TAE
   fp32 with remat and (d) TimeUNet bf16 (the loss and statistics held)
   over four gloo ranks on cuda:0, each held against phase 17's
   one-process step as phase 17 holds its group (the logits reassembled
   from the ranks' rows), each rank launching its pair once a step; a
   rank's step ms beside one process's and the median ms of a halo
   exchange at in_conv's width; (e) graft_entry.dryrun_multichip(2) with
   its two 2-D blocks, on two cards or, where one is visible, over gloo
   processes on the CPU. A ``space_parallel`` JSON line; the kernels line
   gains ``launches_space_parallel``.
19. The rest of the zoo on the 2-D mesh (phase_space_zoo): on the (2, 2)
   mesh, (a) NCCL a card a rank where four cards are visible (else it
   prints that this path was not run), (b) four gloo ranks on cuda:0:
   TimeUNet_v2, UNet3D, ConvLSTM, BConvLSTM, ConvGRU, uconvlstm and U-Net
   naive at the factory's widths (T = 61), U-TAE with its boundary head and
   the boundary loss, TimeUNet on the tail pair with test_region
   "boundary", fp32 and dropout 0, each held against one process's step on
   phase 17's global batch as phase 17 holds its group (the boundary
   head's loss and matrix too; the gradients within GRAD_FACTOR times the
   spread that perturbing the case's named module causes), one step a
   case (TimeUNet two, launching its pair once a step in each rank); the
   one-process steps run first and are freed before the ranks start; a
   rank's step ms beside one process's and the median ms of a halo
   exchange at each model's widest conv. A ``space_zoo`` JSON line; the
   kernels line gains ``launches_space_zoo``.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line of
kernels, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises, and the exit code is then non-zero.
"""
from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
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
from crop2seg_tpu_torch.nn import aggregator
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_lengths
from crop2seg_tpu_torch.ops import _build
from crop2seg_tpu_torch.ops import aggregate as ag
from crop2seg_tpu_torch.ops import ltae_fused as lf
from crop2seg_tpu_torch.ops import ltae_pool as lp
from crop2seg_tpu_torch.ops import ltae_stages as ls
from crop2seg_tpu_torch.ops.patchify import patchify_inference_tile
from crop2seg_tpu_torch.utils.profiling import collect

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
            m.temporal_encoder.register_forward_hook(perturb_hook(eps, dev))
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


def check_grads_within_spread(label: str, got: dict, plain: dict, perturbed: dict,
                              batch: int = 2, what: str = "the L-TAE output"):
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
    print(f"B={batch} gradients, |diff|/|plain| over {len(live)} parameters (and "
          f"{len(zero)} zero up to rounding, within {GRAD_ZERO:g} of the "
          f"largest on both paths): {label} vs plain median "
          f"{np.median(list(kp.values())):.3e} max {max(kp.values()):.3e}; plain "
          f"vs plain with {what} perturbed by {GRAD_EPS:g}: median "
          f"{floor:.3e} max {max(pe_.values()):.3e}; worst ratio to the limit "
          f"{ratio[worst]:.3f} ({worst})", flush=True)
    check(ratio[worst] <= 1.0, f"gradient of {worst}: {label} vs plain {kp[worst]:.3e}"
          f" beyond {GRAD_FACTOR:g}x the perturbation spread")
    return ratio[worst]


def phase_main_path(model, dev, label: str = "", kernel_launches: int = 10,
                    aggregate_launches: int | None = 0):
    """One tile through make_tile_predictor in bf16 and fp32 with its checks;
    ``label`` prefixes the printed lines. Each tile must launch the eval
    kernel ``kernel_launches`` times and the training pair never; with
    kernel launches two patches are held against the plain L-TAE forced.
    The bf16 tile runs inside a ``collect()`` scope, whose counter
    ``aggregate.kernel`` (the skip aggregator's forward launches) must read
    ``aggregate_launches`` where that is given. Returns the bf16 tile's
    kernel launches, patches/s in bf16 and fp32, the bf16 / fp32 class
    agreement and the bf16 tile's aggregator launches."""
    gen = torch.Generator(device=dev).manual_seed(2)
    tile = torch.randn(T, 1098, 1098, 10, generator=gen, device=dev)
    tile[LENGTH:] = 0.0
    dates = np.arange(T, dtype=np.float32) * 5 + 3

    def run(predict, t):
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = predict(t, dates, LENGTH)
        return res, time.perf_counter() - start

    def counted(predict, name):
        run(predict, tile)                                  # warm-up
        lf.ltae_fused_forward.launches = 0                  # this path's counts
        lp.ltae_pool.launches.clear()
        with collect() as table:
            res, secs = run(predict, tile)
        launches = lf.ltae_fused_forward.launches
        agg = table["counters"].get("aggregate.kernel", 0)
        print(f"{label}tile {name}: {secs:.3f} s, {100 / secs:.2f} patches/s, "
              f"ltae_fused_fwd launches {launches}, aggregate launches {agg}", flush=True)
        check(launches == kernel_launches and not lp.ltae_pool.launches,
              f"{label}{name} tile launched the eval kernel {launches} times, not "
              f"{kernel_launches}, and the training pair {dict(lp.ltae_pool.launches)}")
        check(aggregate_launches is None or agg == aggregate_launches,
              f"{label}{name} tile launched the aggregator's forward {agg} times, not "
              f"{aggregate_launches}")
        return res, secs, launches, agg

    predict_bf16 = make_tile_predictor(model, batch_size=MAIN_B, dtype=torch.bfloat16)
    res, secs, launches, agg = counted(predict_bf16, "bf16")     # the main path
    res32, secs32, _, _ = counted(make_tile_predictor(model, batch_size=MAIN_B), "fp32")

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

    if kernel_launches:
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
        print(f"{label}fp32 tile vs plain L-TAE on patches {idx}: max |dproba| "
              f"{p_err:.3e} (tol 1e-3)", flush=True)
        check(p_err <= 1e-3, f"{label}tile differs from the plain L-TAE path by {p_err}")

    noisy = tile.clone()
    noisy[LENGTH:] = 10 * torch.randn(noisy[LENGTH:].shape, generator=gen, device=dev)
    res_noisy, _ = run(predict_bf16, noisy)
    inv_err = float(np.abs(res_noisy["proba"] - res["proba"]).max())
    print(f"{label}pad invariance (garbage in frames {LENGTH}..{T - 1}): max |dproba| "
          f"{inv_err:.3e} (tol 1e-6)", flush=True)
    check(inv_err <= 1e-6, f"{label}pad frames leak into the output: {inv_err}")
    return launches, 100 / secs, 100 / secs32, agree, agg


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
    # three skips a forward, ten batches of ten patches a tile
    launches, pps_bf16, pps_fp32, _, agg = phase_main_path(
        model, dev, label="utae ", aggregate_launches=3 * 100 // MAIN_B)
    return entry, launches, pps_bf16, pps_fp32, agg


def agg_script():
    """scripts/bench_aggregate_torch.py as a module: U-TAE's skip shapes,
    their lengths, the pair's bytes and the same sum by one library call."""
    spec = importlib.util.spec_from_file_location(
        "bench_aggregate_torch",
        Path(__file__).resolve().parent / "scripts" / "bench_aggregate_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def agg_inputs(script, b: int, side: int, dtype, gen, dev):
    """A U-TAE skip as the aggregator hands it to the pair: x (B, T, side,
    side, C), the L-TAE's softmaxed attention on its 16^2 grid resampled to
    the skip (``nn/aggregator.py::_resample_attn``) as (B, T, K, side,
    side), the pad mask of the script's lengths, and an upstream gradient."""
    t, c, k = script.T, script.C, script.K
    x = torch.randn(b, t, side, side, c, generator=gen, device=dev).to(dtype)
    logits = torch.randn(b, 16, 16, k, t, generator=gen, device=dev)
    a = torch.softmax(logits, -1).to(dtype).permute(0, 4, 3, 1, 2)
    w = aggregator._resample_attn(a.reshape(b * t, k, 16, 16), side, side)
    pad = pad_mask_from_lengths(torch.tensor(script.lengths(b), device=dev), t)
    dout = torch.randn(b, side, side, c, generator=gen, device=dev).to(dtype)
    return x, w.reshape(b, t, k, side, side), pad, dout


def phase_aggregate(dev):
    """The skip aggregator's kernel pair (csrc/temporal_aggregate.cu) at the
    shapes U-TAE's cells give it: the three skips (128^2, 64^2, 32^2, T=61,
    C=64 in K=16 heads) at B=16 (lengths 27-61) and B=10 (27 and 61 in
    turn), bf16 and fp32, forward and backward against the loop of per-date
    ops (``ops/aggregate.py::weighted_sum_reference``): out and dx bit for
    bit, dw within 1e-6 of its products' magnitudes (the loop's dw of |x| and
    |dout|) and in bf16 one rounding (2^-7 of the value) besides. Then the
    pair, the loop and the same sum by one library call
    (``weighted_sum_library``: torch.einsum) timed at the training cell's
    level-0 skip (B=16, 128^2, bf16). Returns the largest errors and the
    timings."""
    script = agg_script()
    gen = torch.Generator(device=dev).manual_seed(26)
    worst = {"out": 0.0, "dx": 0.0, "dw": 0.0, "dw_ratio": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for b in (16, 10):
            for side in script.SIDES:
                x, w, pad, dout = agg_inputs(script, b, side, dtype, gen, dev)
                got = []
                for fn, xi, di in ((ag.weighted_sum, x, dout),
                                   (ag.weighted_sum_reference, x, dout),
                                   (ag.weighted_sum_reference, x.float().abs(),
                                    dout.float().abs())):
                    xl = xi.detach().requires_grad_(True)
                    wl = w.detach().to(xi.dtype).requires_grad_(True)
                    out = fn(xl, wl, pad)
                    got.append((out.detach(),) + torch.autograd.grad(out, [xl, wl], di))
                    del out, xl, wl
                (out_k, dx_k, dw_k), (out_r, dx_r, dw_r), (_, _, mag) = got
                del got
                dw_k, dw_r = dw_k.float(), dw_r.float()
                bound = mag * 1e-6 + 1e-12
                if dtype == torch.bfloat16:
                    bound = bound + dw_r.abs() * 2.0 ** -7
                err = {"out": (out_k.float() - out_r.float()).abs().max().item(),
                       "dx": (dx_k.float() - dx_r.float()).abs().max().item(),
                       "dw": (dw_k - dw_r).abs().max().item(),
                       "dw_ratio": ((dw_k - dw_r).abs() / bound).max().item()}
                label = f"aggregate pair {str(dtype)[6:]} B={b} {side}^2"
                print(f"{label} vs the loop: out max |err| {err['out']:.3e}, dx "
                      f"{err['dx']:.3e}, dw {err['dw']:.3e} (worst ratio to its bound "
                      f"{err['dw_ratio']:.3f}); padded dates' dx zero "
                      f"{bool((dx_k[pad] == 0).all())}", flush=True)
                check(torch.equal(out_k, out_r), f"{label}: out differs from the loop's")
                check(torch.equal(dx_k, dx_r), f"{label}: dx differs from the loop's")
                check(bool((dx_k[pad] == 0).all()), f"{label}: dx nonzero at padded dates")
                check(err["dw_ratio"] <= 1.0, f"{label}: dw beyond its bound")
                worst = {k: max(v, err[k]) for k, v in worst.items()}
                del x, w, pad, dout, out_k, dx_k, dw_k, out_r, dx_r, dw_r, mag, bound
                torch.cuda.empty_cache()

    b, side, dtype = 16, script.SIDES[0], torch.bfloat16
    x, w, pad, dout = agg_inputs(script, b, side, dtype, gen, dev)
    fb, bb = script.pair_bytes(x, w, pad)
    timings = {}
    for name, fn, iters in (("pair", ag.weighted_sum, 20),
                            ("library", script.weighted_sum_library, 5),
                            ("plain", ag.weighted_sum_reference, 3)):
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)

        def forward():
            with torch.no_grad():
                fn(x, w, pad)
        fwd_ms = cuda_ms(forward, iters=iters)
        out = fn(xl, wl, pad)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, [xl, wl], dout, retain_graph=True),
                         iters=iters)
        timings[name] = (fwd_ms, bwd_ms)
        print(f"aggregate {name} B={b} T={script.T} {side}^2 C={script.C} K={script.K} "
              f"bf16: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms", flush=True)
        del xl, wl, out
        torch.cuda.empty_cache()
    bound = (1e3 * fb / HBM_BYTES_PER_S, 1e3 * bb / HBM_BYTES_PER_S)
    print(f"aggregate pair bound (bytes at {HBM_BYTES_PER_S / 1e12:g} TB/s): forward "
          f"{bound[0]:.3f} ms, backward {bound[1]:.3f} ms", flush=True)
    del x, w, pad, dout
    torch.cuda.empty_cache()
    return {"worst": worst, "timings": timings, "bound_ms": bound,
            "shape": [b, script.T, side, side, script.C], "k": script.K}


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


def perturb_hook(eps: float, dev):
    """A forward hook that scales a module's output (the first of a tuple)
    by (1 + eps * noise): the yardstick of the gradient checks."""
    noise = torch.Generator(device=dev).manual_seed(12)

    def hook(mod, args, out):
        first = out[0] if isinstance(out, tuple) else out
        first = first * (1 + eps * torch.randn(first.shape, generator=noise, device=dev))
        return (first,) + tuple(out[1:]) if isinstance(out, tuple) else first
    return hook


def plain_train_runs(dev, name: str, fresh: dict, stats: tuple, runs_cfg, cfg,
                     aggregate_per_step: int | None = None) -> dict:
    """``runs_cfg`` (label, dtype, B, remat) through make_train_step from the
    weights ``fresh``, 5 steps each: a finite, falling loss, the BatchNorm
    statistics ``stats`` changed and no launch of any L-TAE kernel; warm
    step ms over steps 2-5 by CUDA events and peak memory. The steps run in
    a ``collect()`` scope: the skip aggregator's forward launches (counter
    ``aggregate.kernel``) and backward launches (span ``aggregate.bwd``)
    must each read 5 * ``aggregate_per_step`` where that is given."""
    runs = {}
    for label, dtype, b, remat in runs_cfg:
        model = get_model({"model": name, "remat": remat}, device=dev)
        model.load_state_dict(fresh)
        batch = train_batch(b, torch.Generator(device=dev).manual_seed(4), dev)
        step = make_train_step(model, cfg, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lp.ltae_pool.launches.clear()                  # this path's counts
        lf.ltae_fused_forward.launches = 0
        losses, step_ms = [], []
        with collect() as table:
            for i in range(5):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                aux = step(batch, gen)
                end.record()
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(end))
                losses.append(float(aux["loss"]))
                print(f"{name} train {label} step {i + 1}: loss {losses[-1]:.6f}, "
                      f"{step_ms[-1]:.3f} ms", flush=True)
                check(np.isfinite(losses[-1]),
                      f"{name} {label} step {i + 1}: loss {losses[-1]}")
        agg = (table["counters"].get("aggregate.kernel", 0),
               table["spans"].get("aggregate.bwd", {}).get("calls", 0))
        print(f"{name} train {label}: aggregate launches over 5 steps, forward {agg[0]}, "
              f"backward {agg[1]}", flush=True)
        if aggregate_per_step is not None:
            check(agg == (5 * aggregate_per_step,) * 2, f"{name} {label}: the aggregator "
                  f"launched {agg}, not {5 * aggregate_per_step} each way")
        launched = dict(lp.ltae_pool.launches)
        launched["ltae_fused_fwd"] = lf.ltae_fused_forward.launches
        check(not any(launched.values()),
              f"{name} {label}: the training path launched a kernel: {launched}")
        check(losses[-1] < losses[0], f"{name} {label}: loss did not fall: {losses}")
        moved = [not torch.equal(model.state_dict()[k], fresh[k].to(dev)) for k in stats]
        check(all(moved), f"{name} {label}: BatchNorm statistics unchanged: {stats}")
        warm_ms = float(np.mean(step_ms[1:]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name} train step {label}, warm (steps 2-5): {warm_ms:.3f} ms, "
              f"{b / warm_ms * 1e3:.2f} samples/s; peak memory {peak:.2f} GiB; "
              f"kernel launches {launched}", flush=True)
        runs[label] = {"losses": losses, "warm_ms": warm_ms, "peak_gib": peak,
                       "batch": b, "aggregate_launches": list(agg)}
        del model, step, batch, aux
        torch.cuda.empty_cache()
    return runs


def phase_plain_train(dev, name: str, stats: tuple, runs_cfg=UTAE_TRAIN_RUNS,
                      aggregate_per_step: int | None = None):
    """Training of a model whose L-TAE trains on plain ops (U-TAE, whose
    L-TAE trains with the attention out, and W-TAE, whose L-TAE has no
    kernel) at the factory defaults: ``runs_cfg`` through make_train_step (5
    steps each, warm step ms over steps 2-5 by CUDA events, peak memory),
    each with a finite, falling loss, the BatchNorm statistics ``stats``
    changed, no launch of any L-TAE kernel and ``aggregate_per_step`` launches
    each way of the aggregator's pair a step (``plain_train_runs``); then one
    B=2 step's gradients with remat against those without, held to the
    spread that perturbing the temporal encoder's output causes."""
    cfg = StepConfig(num_classes=N_CLASSES,
                     class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    model = get_model({"model": name}, generator=torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    runs = plain_train_runs(dev, name, fresh, stats, runs_cfg, cfg, aggregate_per_step)

    small = train_batch(2, torch.Generator(device=dev).manual_seed(4), dev)
    grads = {}
    for label, remat, policy, eps in (("no remat", False, "conv_out", 0.0),
                                      ("remat conv_out", True, "conv_out", 0.0),
                                      ("remat full", True, "full", 0.0),
                                      ("perturbed", False, "conv_out", GRAD_EPS)):
        m = get_model({"model": name, "remat": remat, "remat_policy": policy}, device=dev)
        m.load_state_dict(fresh)
        m.train()
        if eps:
            m.temporal_encoder.register_forward_hook(perturb_hook(eps, dev))
        logits = m(small["x"], small["dates"], small["pad_mask"],
                   generator=torch.Generator(device=dev).manual_seed(11))
        cross_entropy(logits, small["y"], weight=torch.tensor(
            cfg.class_weights, device=dev)).backward()
        grads[label] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        del m, logits
        torch.cuda.empty_cache()
    worst = {label: check_grads_within_spread(f"{name} {label}", grads[label],
                                              grads["no remat"], grads["perturbed"])
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


def cli_run(label: str, argv: list, want_pool: dict, want_eval: dict,
            native: bool = True, all_folds: bool = False):
    """``python -m crop2seg_tpu_torch.train`` in this process (its ``main``
    on ``argv``; with ``all_folds`` on each fold of its ``fold_sequence``, as
    the command does), each kernel count set to 0 just before and read just
    after: the training pair's launches by variant must be ``want_pool``
    (None: the caller checks them) and the eval kernel's by route
    ``want_eval``, exactly; with ``native`` every BatchLoader the CLI builds
    decodes natively (a dataset without a native plan, PASTIS, collates in
    Python). Returns the (last fold's) run, the counts and the seconds it
    took."""
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
        for fold in cli.fold_sequence(cfg) if all_folds else [cfg.fold]:
            cfg.fold = fold
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
    check(not native or (loaders and all(ld._plan is not None for ld in loaders)
                         and native_batches),
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


def phase_train_cli(dev, data: str):
    """Phase 12: the train CLI end to end on the card, on a synthetic
    dataset of CLI_PATCHES patches at 128^2, T 27-61, written to ``data``
    (phase 14 trains on it too): (a) TimeUNet_v1 at the factory defaults, bf16, 2 epochs
    (train, val, best-k checkpoints, reload, test, fold aggregation); (b) a
    resume of (a) to epoch 3 with Adam's step count restored (from the
    best epoch, which model.ckpt holds, as the JAX CLI resumes); (c) --test
    of (a)'s folder, which must repeat (a)'s test; (f) (a) again with the
    device cache (x cast to bf16 before the step: the same kernel variant
    must run as for (a)'s fp32 x under autocast); (d) U-TAE fp32 with the
    boundary loss and the device cache, 1 epoch; (e) one TimeUNet step at
    B=4 with remat against without, gradients within the perturbation
    spread, both peak memories printed."""
    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.data import make_synthetic_dataset
    from crop2seg_tpu_torch.learning import checkpoint as ckpt

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
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
            m.temporal_encoder.register_forward_hook(perturb_hook(eps, dev))
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


DWS = "depthwise_separable"
# phase 14 (d): TimeUNet variants whose in_conv cannot defer its tail
TIMEUNET_VARIANTS = (("dws+se", {"conv_type": DWS, "add_squeeze": True}),
                     ("instance", {"encoder_norm": "instance"}))
# phase 14 (c), (e): U-TAE with MBConv blocks. Their GroupNorm heads need
# widths divisible by 4 (out_conv (32, 15) fails, in the JAX package too),
# so 16 classes, the 16th the ignored one
MB_CLASSES = 16
MB_CFG = {"model": "utae", "use_mbconv": True, "out_conv": [32, MB_CLASSES]}
MB_STEP = StepConfig(num_classes=MB_CLASSES,
                     class_weights=(1.0,) * (MB_CLASSES - 1) + (0.0,))
VARIANT_TOL = 1e-3           # kernel route vs plain L-TAE, whole model, fp32


def zero_counts() -> None:
    """Every kernel count set to 0: the start of a path."""
    lf.ltae_fused_forward.launches = 0
    lf.ltae_fused_forward.route_launches.clear()
    lf.ltae_fused_forward.tail_launches = 0
    lp.ltae_pool.launches.clear()


def kernel_counts() -> dict:
    """The counts since ``zero_counts``: eval launches by route (and those
    with a deferred tail), the training pair's by variant."""
    out = {f"eval_{k}": v for k, v in lf.ltae_fused_forward.route_launches.items()}
    if lf.ltae_fused_forward.tail_launches:
        out["eval_tailed"] = lf.ltae_fused_forward.tail_launches
    out.update(lp.ltae_pool.launches)
    return out


def timed_forward(model, batch, **kw):
    """One warm forward of ``model`` in inference mode on ``batch``, its
    kernel counts and its ms by CUDA events."""
    with torch.inference_mode():
        model(batch["x"], batch["dates"], batch["pad_mask"], **kw)         # warm-up
        torch.cuda.synchronize()
        zero_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = model(batch["x"], batch["dates"], batch["pad_mask"], **kw)
        end.record()
        torch.cuda.synchronize()
    return out, kernel_counts(), start.elapsed_time(end)


def one_train_step(label: str, model, batch, cfg, dtype, want: dict) -> dict:
    """One make_train_step step, its counts set to 0 just before it: the
    launches must be ``want``, the loss finite. Returns loss, ms, peak
    GiB and the launches."""
    step = make_train_step(model, cfg, dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    aux = step(batch, torch.Generator(device=batch["x"].device).manual_seed(7))
    end.record()
    torch.cuda.synchronize()
    got = kernel_counts()
    res = {"loss": float(aux["loss"]), "ms": start.elapsed_time(end),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": got}
    print(f"{label}: loss {res['loss']:.6f}, {res['ms']:.3f} ms (first step), peak "
          f"{res['peak_gib']:.2f} GiB, kernel launches {got}", flush=True)
    check(np.isfinite(res["loss"]), f"{label}: loss {res['loss']}")
    check(got == want, f"{label}: launched {got}, not {want}")
    return res


def phase_variants(dev, data: str, tmp: str) -> dict:
    """Phase 14: the conv variants and W-TAE. (a) W-TAE at the factory
    defaults (seeded weights) through phase 4's tile in bf16 and fp32: no
    L-TAE kernel launch (its attention-only L-TAE has none, as in the JAX
    package), proba finite and summing to 1, pad invariance; patches/s and
    the bf16 / fp32 class agreement. (b) W-TAE training as phase 10 trains
    U-TAE: 5 steps at B=4 fp32 and 5 at B=16 bf16 with remat conv_out, then
    B=2 remat gradients against none. (c) U-TAE with MBConv blocks: an eval
    forward at B=10 on kernel 1's wide route against fused=False, and one
    B=4 fp32 train step (remat conv_out: without it the MBConv in_conv's
    activations at 4 * 61 frames of 128^2 x 256 would not fit). (d)
    TimeUNet with depthwise-separable convs + SE, and with instance norm:
    in_conv keeps its tail, so an eval forward at B=10 launches kernel 1's
    group route untailed, within VARIANT_TOL of fused=False, and a B=4 train
    step the untailed pool pair in fp32 and bf16; then kernel 1 untailed
    timed at TimeUNet's width. (e) The train CLI on phase 12's dataset:
    W-TAE with the boundary loss, 2-step epochs, train -> resume -> test;
    U-TAE with MBConv, one epoch."""
    out = {}
    # (a) the W-TAE tile
    wtae = get_model({"model": "wtae"}, generator=torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    _, pps, pps32, agree, _ = phase_main_path(wtae, dev, label="wtae ", kernel_launches=0,
                                              aggregate_launches=None)
    out["tile"] = {"patches_per_s": pps, "patches_per_s_fp32": pps32,
                   "class_agreement": agree,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"wtae tile: peak memory {out['tile']['peak_gib']:.2f} GiB", flush=True)
    del wtae
    torch.cuda.empty_cache()

    # (b) W-TAE training
    out["train"], out["remat_grad_worst_ratio"] = phase_plain_train(
        dev, "wtae", ("up_blocks.0.up.1.running_var", "up_blocks.1.skip_conv.1.running_mean",
                      "out_conv.conv.conv.1.running_mean"))
    torch.cuda.empty_cache()

    # (c) U-TAE with MBConv blocks
    fresh = get_model(MB_CFG, generator=torch.Generator().manual_seed(0)).state_dict()
    model = get_model(MB_CFG, device=dev)
    model.load_state_dict(fresh)
    batch = train_batch(MAIN_B, torch.Generator(device=dev).manual_seed(4), dev)
    torch.cuda.reset_peak_memory_stats()
    got, counts, ms = timed_forward(model, batch)
    with torch.inference_mode():
        want = model(batch["x"], batch["dates"], batch["pad_mask"], fused=False)
    err = (got.float() - want.float()).abs().max().item()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"utae mbconv eval B={MAIN_B} fp32: {ms:.3f} ms, kernel launches {counts}, "
          f"vs fused=False max |dlogit| {err:.3e} (tol {VARIANT_TOL:g}), peak {peak:.2f} GiB",
          flush=True)
    check(counts == {"eval_wide": 1}, f"utae mbconv eval launched {counts}")
    check(err <= VARIANT_TOL and bool(torch.isfinite(got).all()),
          f"utae mbconv: kernel route vs plain {err}")
    del model, got, want, batch
    torch.cuda.empty_cache()
    model = get_model({**MB_CFG, "remat": True}, device=dev)
    model.load_state_dict(fresh)
    step = one_train_step("utae mbconv train B=4 fp32 remat conv_out", model,
                          train_batch(TRAIN_B, torch.Generator(device=dev).manual_seed(4),
                                      dev), MB_STEP, None, {})
    out["utae_mbconv"] = {"eval_ms": ms, "eval_err": err, "eval_peak_gib": peak,
                          "train_step": step, "launches": counts}
    del model, fresh
    torch.cuda.empty_cache()

    # (d) TimeUNet variants: kernel 1 and the pool pair untailed
    cfg = StepConfig(num_classes=N_CLASSES, class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    eval_batch = train_batch(MAIN_B, torch.Generator(device=dev).manual_seed(4), dev)
    batch = train_batch(TRAIN_B, torch.Generator(device=dev).manual_seed(4), dev)
    out["timeunet"] = {}
    for label, kw in TIMEUNET_VARIANTS:
        fresh = get_model({"model": "timeunet", **kw},
                          generator=torch.Generator().manual_seed(0)).state_dict()
        model = get_model({"model": "timeunet", **kw}, device=dev)
        model.load_state_dict(fresh)
        check(not model._tail_deferrable, f"timeunet {label} would defer its tail")
        got, counts, ms = timed_forward(model, eval_batch)
        with torch.inference_mode():
            want = model(eval_batch["x"], eval_batch["dates"], eval_batch["pad_mask"],
                         fused=False)
        err = (got - want).abs().max().item()
        print(f"timeunet {label} eval B={MAIN_B} fp32: {ms:.3f} ms, kernel launches "
              f"{counts}, vs fused=False max |dlogit| {err:.3e} (tol {VARIANT_TOL:g})",
              flush=True)
        check(counts == {"eval_group": 1}, f"timeunet {label} eval launched {counts}")
        check(err <= VARIANT_TOL, f"timeunet {label}: kernel route vs plain {err}")
        res = {"eval_ms": ms, "eval_err": err, "launches": counts}
        del got, want
        for dtype in (None, torch.bfloat16):
            name = "bf16" if dtype else "fp32"
            model.load_state_dict(fresh)
            want_pool = {lp.variant(False, dtype or torch.float32, d): 1
                         for d in ("fwd", "bwd")}
            res[f"train_{name}"] = one_train_step(
                f"timeunet {label} train B={TRAIN_B} {name}", model, batch, cfg, dtype,
                want_pool)
        out["timeunet"][label] = res
        del model
        torch.cuda.empty_cache()
    del eval_batch, batch

    # kernel 1 untailed at TimeUNet's width (the variants' route), B=10
    timeunet = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    x, pe, pad, params, _ = ltae_inputs(timeunet, MAIN_B,
                                        torch.Generator(device=dev).manual_seed(1), dev)
    out["untailed_timing"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        ms = cuda_ms(lambda: lf.ltae_fused_forward(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=False), iters=10)
        plain_ms = cuda_ms(lambda: lf.ltae_fused_forward_reference(
            xd, pe, pad, params, n_head=G, d_k=D_K, need_attn=False), iters=3, warmup=1)
        b_ms, b_by = bound(MAIN_B, dtype, False, False)
        out["untailed_timing"][str(dtype)[6:]] = {"ms": ms, "plain_ms": plain_ms,
                                                 "bound_ms": b_ms, "bound_by": b_by}
        print(f"ltae_fused_fwd untailed {str(dtype)[6:]} B={MAIN_B} T={T} N={HW} C={C}: "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})",
              flush=True)
        del xd
    del x, pe, pad, params, timeunet
    torch.cuda.empty_cache()

    # (e) the train CLI on phase 12's dataset
    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.learning import checkpoint as ckpt

    bs = 4
    sizes = [len(d) for d in cli.build_datasets(cli.parse_config(
        ["--dataset", "synthetic", "--dataset_folder", data]))]
    n_train, n_val, n_test = sizes[0] // bs, -(-sizes[1] // bs), -(-sizes[2] // bs)
    common = ["--dataset", "synthetic", "--dataset_folder", data,
              "--batch_size", str(bs), "--t_buckets", "[32,48,61]"]
    wtae_argv = ["--model", "wtae", "--add_boundary_loss"] + common
    dirs = {k: os.path.join(tmp, f"variants_{k}") for k in ("w1", "w2", "w3", "mb")}
    run1, _, _, sec1 = cli_run("(14e) wtae boundary loss, 2 epochs",
                               wtae_argv + ["--epochs", "2", "--res_dir", dirs["w1"]], {}, {})
    best = ckpt.load_state(os.path.join(dirs["w1"], "Fold_1"))["meta"]["epoch"]
    run2, _, _, sec2 = cli_run(
        f"(14e) wtae resume to epoch 3 from the best, epoch {best}",
        wtae_argv + ["--epochs", "3", "--weight_folder", dirs["w1"], "--res_dir", dirs["w2"]],
        {}, {})
    check(run2.start_epoch == best + 1 and run2.restored_adam_step == best * n_train
          and run2.adam_step == 3 * n_train,
          f"wtae resume: epoch {run2.start_epoch}, Adam steps {run2.restored_adam_step} "
          f"-> {run2.adam_step}")
    run3, _, _, sec3 = cli_run(
        "(14e) wtae --test", wtae_argv + ["--test", "--weight_folder", dirs["w1"],
                                          "--res_dir", dirs["w3"]], {}, {})
    t1, t3 = run1.test_metrics, run3.test_metrics
    loss_rel = abs(t3["test_loss"] - t1["test_loss"]) / abs(t1["test_loss"])
    bnd = {k: v for k, v in {**run1.trainlog[1], **t3}.items() if k.endswith("_b")}
    print(f"train cli (14e) wtae: --test vs the run's own test, loss relative "
          f"{loss_rel:.3e}; boundary metrics {json.dumps(bnd)}", flush=True)
    check(loss_rel <= 1e-5, f"wtae --test loss {t3['test_loss']} vs {t1['test_loss']}")
    check(len(bnd) == 6 and all(np.isfinite(v) for v in bnd.values()),
          f"wtae boundary metrics {bnd}")
    run_mb, _, eval_mb, sec_mb = cli_run(
        "(14e) utae mbconv fp32 remat, 1 epoch",
        ["--model", "utae", "--use_mbconv", "--remat", "--out_conv", f"[32,{MB_CLASSES}]",
         "--num_classes", str(MB_CLASSES), "--epochs", "1", "--res_dir", dirs["mb"]]
        + common, {}, {"wide": n_val + n_test})
    out["cli"] = {"seconds": {"wtae": sec1, "wtae_resume": sec2, "wtae_test": sec3,
                              "utae_mbconv": sec_mb},
                  "wtae_epoch_s": {e: m["train_epoch_time"] for e, m in run1.trainlog.items()},
                  "wtae_test": t1, "utae_mbconv_test": run_mb.test_metrics,
                  "eval_wide_launches": eval_mb.get("wide", 0),
                  "batches": [n_train, n_val, n_test]}
    return out


# phase 15: TimeUNet_v2 (its full-resolution classical TAE2d in chunks of
# pixel rows) and the rest of get_model's zoo, none of which reaches an
# L-TAE kernel (the JAX package computes them on XLA ops)
ZOO = (("unet3d", {}), ("convlstm", {}), ("convgru", {}), ("uconvlstm", {}),
       ("unet_naive", {"max_temp": T}))
# the zoo models whose output does not depend on the pad frames, in JAX and
# in the port (tests/test_torch_zoo.py::PAD_INVARIANT): the recurrent
# encoders scan the pad frames, 3-D convs and the T folding mix them in
ZOO_PAD_INVARIANT = ("uconvlstm",)
CHUNK_TOL = 1e-5          # a quarter of the chunk rows against the tile, fp32
ZOO_STEP = StepConfig(num_classes=N_CLASSES,
                      class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))


def classical_flops(rows: int, t: int = T, d: int = D, h: int = G, dk: int = D_K) -> float:
    """Operations of the classical attention (crop2seg_tpu/nn/tae2d.py:44-88)
    on ``rows`` pixel rows: the q, k and v projections (the values n_head *
    d wide), the scores, attention x values and fc_out, 2 per multiply-add
    (the softmax, dropout and LayerNorm are not counted)."""
    per_row = 2 * t * d * (2 * h * dk + h * d) + 2 * h * t * t * (dk + d) + 2 * t * h * d * d
    return float(rows) * per_row


def zoo_tile(model, dev, label: str, pad_invariant: bool, chunked: bool = False) -> dict:
    """Phase 4's tile (T = 61, 1098^2, length 55) through make_tile_predictor
    at batch 10, bf16 then fp32, each path's kernel counts set to 0 just
    before it and read just after: no kernel launch, proba finite, summing
    to 1, classes its argmax. ``pad_invariant``: the fp32 tile again with
    garbage in the pad frames, within 1e-6. ``chunked`` (TimeUNet_v2): two
    patches rerun in fp32 with a quarter of the classical attention's chunk
    rows, within CHUNK_TOL of the tile. Returns patches/s, peak memory and
    the launches."""
    gen = torch.Generator(device=dev).manual_seed(2)
    tile = torch.randn(T, 1098, 1098, 10, generator=gen, device=dev)
    tile[LENGTH:] = 0.0
    dates = np.arange(T, dtype=np.float32) * 5 + 3
    res, launches = {}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        predict = make_tile_predictor(model, batch_size=MAIN_B, dtype=dtype)
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16,
                                                    enabled=dtype is not None):
            xb = torch.stack([tile[:, i:i + 128, j:j + 128]         # warm-up: 4 patches
                              for i in (0, 128) for j in (0, 128)])
            model(xb, torch.as_tensor(dates, device=dev)[None].expand(4, T),
                  torch.arange(T, device=dev)[None].expand(4, T) >= LENGTH)
        del xb
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        start = time.perf_counter()
        r = predict(tile, dates, LENGTH)
        secs = time.perf_counter() - start
        launches[name] = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        p, cls = r["proba"], r["classes"]
        s_err = float(np.abs(p.sum(-1) - 1).max())
        print(f"{label} tile {name}: {secs:.3f} s, {100 / secs:.2f} patches/s, peak "
              f"{peak:.2f} GiB, kernel launches {launches[name]}, proba sums off by "
              f"{s_err:.2e}", flush=True)
        check(not launches[name], f"{label} {name} tile launched {launches[name]}")
        check(p.shape == (1098, 1098, N_CLASSES) and cls.shape == (1098, 1098)
              and cls.dtype == np.uint8, f"{label} {name}: shapes {p.shape} {cls.shape}")
        check(bool(np.isfinite(p).all()), f"{label} {name}: non-finite proba")
        check(s_err < 1e-4, f"{label} {name}: proba sums off by {s_err}")
        check(bool((cls == p.argmax(-1)).all()), f"{label} {name}: classes != argmax")
        res[name] = {"r": r, "patches_per_s": 100 / secs, "seconds": secs, "peak_gib": peak}
    out = {k: {m: v for m, v in r.items() if m != "r"} for k, r in res.items()}
    out["launches"] = launches
    out["class_agreement"] = float((res["bf16"]["r"]["classes"]
                                    == res["fp32"]["r"]["classes"]).mean())
    if chunked:
        te = model.temporal_encoder_full_resolution
        st = te.attention_heads[0]
        rows = classical_chunk_rows(te, T, torch.float32)
        idx = [0, 11]                          # patch 11: rows/cols 128-255
        te.chunk_rows = quarter = max(1, rows // 4)
        try:
            with torch.inference_mode():
                xb = patchify_inference_tile(tile)[idx]
                logits = model(xb, torch.as_tensor(dates, device=dev)[None].expand(2, T),
                               torch.arange(T, device=dev)[None].expand(2, T) >= LENGTH)
                again = torch.softmax(logits.float(), -1).cpu().numpy()
        finally:
            te.chunk_rows = None
        served = np.stack([res["fp32"]["r"]["proba"][:128, :128],
                           res["fp32"]["r"]["proba"][128:256, 128:256]])
        c_err = float(np.abs(served - again).max())
        print(f"{label} fp32 patches {idx} with {quarter} chunk rows "
              f"(the tile's {rows}, fc_v {tuple(st.fc_v.weight.shape)}): max |dproba| "
              f"{c_err:.3e} (tol {CHUNK_TOL:g})", flush=True)
        check(c_err <= CHUNK_TOL, f"{label}: a quarter of the chunk rows moved proba by {c_err}")
        out["chunk_rows"], out["quarter_chunk_err"] = rows, c_err
    if pad_invariant:
        noisy = tile.clone()
        noisy[LENGTH:] = 10 * torch.randn(noisy[LENGTH:].shape, generator=gen, device=dev)
        zero_counts()
        r = make_tile_predictor(model, batch_size=MAIN_B)(noisy, dates, LENGTH)
        check(not kernel_counts(), f"{label} pad-invariance tile launched {kernel_counts()}")
        inv = float(np.abs(r["proba"] - res["fp32"]["r"]["proba"]).max())
        print(f"{label} pad invariance fp32 (garbage in frames {LENGTH}..{T - 1}): max "
              f"|dproba| {inv:.3e} (tol 1e-6)", flush=True)
        check(inv <= 1e-6, f"{label}: pad frames leak into the output: {inv}")
        out["pad_invariance_err"] = inv
    return out


def classical_chunk_rows(te, t: int, dtype) -> int:
    """The chunk rows a classical TAE2d takes at T steps in ``dtype``."""
    from crop2seg_tpu_torch.nn.tae2d import chunk_rows

    st = te.attention_heads[0]
    return chunk_rows(t, st.fc_q.in_features, te.n_head, st.d_hidden, dtype.itemsize)


def timeunet_v2_train(dev) -> dict:
    """TimeUNet_v2 training at the factory defaults: 5 steps at B=4 in fp32
    and 5 in bf16 (``plain_train_runs``: finite, falling loss, BatchNorm
    statistics changed, no kernel launch, warm step ms and peak memory);
    then one step's gradients with the classical chunks checkpointed against
    the same chunks not checkpointed (dropout on, the same generator seed),
    within GRAD_FACTOR times the spread that perturbing the full-resolution
    TAE2d's output by GRAD_EPS causes. That check runs at B=1 (a sample
    padded from 55): without checkpoints the chunks keep ~2.6 MB of fp32
    activations a pixel row, ~43 GB at B=1 and ~85 GB at B=2."""
    fresh = get_model({"model": "timeunet_v2"},
                      generator=torch.Generator().manual_seed(0)).state_dict()
    stats = ("temporal_encoder_full_resolution.mlp.1.running_mean",
             "temporal_encoder_low_resolution.mlp.1.running_var",
             "up_blocks.0.up.1.running_var", "out_conv.conv.conv.1.running_mean")
    runs = plain_train_runs(dev, "timeunet_v2", fresh, stats,
                            (("fp32 B=4", None, TRAIN_B, False),
                             ("bf16 B=4", torch.bfloat16, TRAIN_B, False)), ZOO_STEP)

    small = {k: v[1:2] for k, v in
             train_batch(2, torch.Generator(device=dev).manual_seed(4), dev).items()}
    grads, peaks = {}, {}
    for label, ckpt, eps in (("not checkpointed", False, 0.0), ("checkpointed", True, 0.0),
                             ("perturbed", False, GRAD_EPS)):
        m = get_model({"model": "timeunet_v2"}, device=dev)
        m.load_state_dict(fresh)
        m.train()
        m.temporal_encoder_full_resolution.checkpoint_chunks = ckpt
        if eps:
            m.temporal_encoder_full_resolution.register_forward_hook(perturb_hook(eps, dev))
        torch.cuda.reset_peak_memory_stats()
        logits = m(small["x"], small["dates"], small["pad_mask"],
                   generator=torch.Generator(device=dev).manual_seed(11))
        cross_entropy(logits, small["y"], weight=torch.tensor(
            ZOO_STEP.class_weights, device=dev)).backward()
        peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        grads[label] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        print(f"timeunet_v2 B=1 step {label}: peak memory {peaks[label]:.2f} GiB", flush=True)
        del m, logits
        torch.cuda.empty_cache()
    worst = check_grads_within_spread("timeunet_v2 checkpointed chunks", grads["checkpointed"],
                                      grads["not checkpointed"], grads["perturbed"], batch=1,
                                      what="the full-resolution TAE2d's output")
    identical = all(torch.equal(grads["checkpointed"][k], grads["not checkpointed"][k])
                    for k in grads["checkpointed"])
    print(f"timeunet_v2 checkpointed vs not: gradients bit for bit {identical}", flush=True)
    return {"runs": runs, "ckpt_grad_worst_ratio": worst, "ckpt_grads_identical": identical,
            "b1_peak_gib": peaks}


def phase_zoo(dev, data: str, tmp: str) -> dict:
    """Phase 15: TimeUNet_v2 and the rest of get_model's zoo, none of which
    launches an L-TAE kernel. (a) TimeUNet_v2 at the factory defaults
    (seeded weights) through phase 4's tile in bf16 and fp32 (``zoo_tile``:
    pad invariance in fp32, two patches with a quarter of the chunk rows),
    patches/s beside the classical attention's bound. (b) TimeUNet_v2
    training (``timeunet_v2_train``). (c) UNet3D, ConvLSTM, ConvGRU,
    uconvlstm and U-Net naive (max_temp 61) at the factory defaults: the
    tile in bf16 and fp32 (pad invariance where the JAX model has it), one
    B=4 fp32 train step. (d) The train CLI on phase 12's dataset:
    ``--model timeunet_v2`` for an epoch, then ``--test`` of its result
    (which repeats the run's own test), and ``--model convlstm`` for an
    epoch."""
    out = {}
    tv2 = get_model({"model": "timeunet_v2"}, generator=torch.Generator().manual_seed(0))
    out["timeunet_v2_tile"] = zoo_tile(tv2, dev, "timeunet_v2", True, chunked=True)
    for name in ("bf16", "fp32"):
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        b_s = classical_flops(100 * HW) / PEAK_FLOP_PER_S[dtype]
        pps = out["timeunet_v2_tile"][name]["patches_per_s"]
        out["timeunet_v2_tile"][name].update(attention_bound_s=b_s,
                                             attention_bound_patches_per_s=100 / b_s)
        print(f"timeunet_v2 tile {name}: {pps:.2f} patches/s; the classical attention "
              f"alone needs >= {b_s:.3f} s a tile ({classical_flops(100 * HW) / 1e12:.1f} "
              f"TFLOP), <= {100 / b_s:.2f} patches/s", flush=True)
    del tv2
    torch.cuda.empty_cache()
    out["timeunet_v2_train"] = timeunet_v2_train(dev)
    torch.cuda.empty_cache()

    batch = train_batch(TRAIN_B, torch.Generator(device=dev).manual_seed(4), dev)
    out["zoo"] = {}
    for name, extra in ZOO:
        cfg = {"model": name, **extra}
        fresh = get_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
        model = get_model(cfg, device=dev)
        model.load_state_dict(fresh)
        res = zoo_tile(model, dev, name, name in ZOO_PAD_INVARIANT)
        res["train_step"] = one_train_step(f"{name} train B={TRAIN_B} fp32", model, batch,
                                           ZOO_STEP, None, {})
        out["zoo"][name] = res
        del model, fresh
        torch.cuda.empty_cache()
    del batch

    bs = 4
    common = ["--dataset", "synthetic", "--dataset_folder", data, "--batch_size", str(bs),
              "--t_buckets", "[32,48,61]", "--epochs", "1"]
    dirs = {k: os.path.join(tmp, f"zoo_{k}") for k in ("v2", "v2_test", "lstm")}
    run, _, _, sec = cli_run("(15d) timeunet_v2, 1 epoch",
                             ["--model", "timeunet_v2", "--res_dir", dirs["v2"]] + common,
                             {}, {})
    run_t, _, _, sec_t = cli_run("(15d) timeunet_v2 --test",
                                 ["--model", "timeunet_v2", "--test", "--weight_folder",
                                  dirs["v2"], "--res_dir", dirs["v2_test"]] + common, {}, {})
    t1, t2 = run.test_metrics, run_t.test_metrics
    loss_rel = abs(t2["test_loss"] - t1["test_loss"]) / abs(t1["test_loss"])
    print(f"train cli (15d) timeunet_v2: --test vs the run's own test, loss relative "
          f"{loss_rel:.3e}", flush=True)
    check(loss_rel <= 1e-5, f"timeunet_v2 --test loss {t2['test_loss']} vs {t1['test_loss']}")
    run_l, _, _, sec_l = cli_run("(15d) convlstm, 1 epoch",
                                 ["--model", "convlstm", "--res_dir", dirs["lstm"]] + common,
                                 {}, {})
    out["cli"] = {"seconds": {"timeunet_v2": sec, "timeunet_v2_test": sec_t,
                              "convlstm": sec_l},
                  "timeunet_v2_test": t1, "convlstm_test": run_l.test_metrics,
                  "test_loss_rel": loss_rel}
    return out


# phase 16: PASTIS five-fold training and seq_chunk on the card, preprocess_batch
# on the card, TimeUNet's L-TAE streamed over T, and the modules no entry point
# reaches (UNetEx, MLPMixer, TemporalAggregator3D)
PASTIS_PATCHES, PASTIS_T, PASTIS_CLASSES = 10, (38, 61), 20
# preprocess_batch on the card against the CPU for the same draws: the
# standardized values as a share of max(1, |value|) (the same IEEE fp32
# operations on both; the tolerance allows one rounding apart)
PREP_TOL = 1e-6
PREP_DROPOUT = 0.2
SEQ_CHUNKS = (8, 16)
# _chunked against the plain train path in fp32, ||diff|| / ||plain|| of o
# (the pooled output before the MLP tail), the L-TAE output and every
# gradient: fp32 sums in another order (online softmax, chunked sums over T)
CHUNK_TOL = 1e-3
# the modules no entry point reaches, card vs CPU on the same weights, fp32
# with TF32 off, max |diff| / max(1, max |CPU|): whole models (ROADMAP.md)
M10B_TOL = 1e-3
M10B_MIXER_ROWS = 1024   # the MLP-Mixer's CPU reference: its first rows (rows are independent)
SIDE = 128               # the patches' edge


def pastis_cli(dev, tmp: str) -> dict:
    """(16a) The train CLI on a synthetic PASTIS folder (PASTIS_PATCHES
    patches at 128^2, T 38-61, 20 classes, two patches a fold), bf16, one
    epoch: U-TAE on fold 1 (train, validate, test: one wide eval launch per
    val and test batch, no pair launch), ``--test`` of its fold, which must
    repeat its test loss; TimeUNet_v1 on fold 1 with ``--use_pallas_train``
    (the tail bf16 pair once a step, one group launch per val and test
    batch); with ``--seq_chunk 8`` and without ``--use_pallas_train``, as the
    JAX CLI routes it: each training step streams the L-TAE over T
    (``_chunked``), no pair launch, the eval kernel in val and test; with
    both flags the pair's launches and no ``_chunked``; then U-TAE over all
    five folds (no --fold): every fold's
    files, the overall files, the confusion matrices aggregated over the ten
    patches' pixels."""
    from crop2seg_tpu_torch.data import make_synthetic_pastis
    from crop2seg_tpu_torch.learning.checkpoint import aggregate_fold_cms

    data = os.path.join(tmp, "pastis")
    start = time.perf_counter()
    make_synthetic_pastis(data, n_patches=PASTIS_PATCHES, t_range=PASTIS_T, hw=SIDE,
                          n_classes=PASTIS_CLASSES)
    print(f"pastis: synthetic folder of {PASTIS_PATCHES} patches ({SIDE}^2, T "
          f"{PASTIS_T[0]}-{PASTIS_T[1]}, {PASTIS_CLASSES} classes) written in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    bs = 2
    n_train, n_val, n_test = 6 // bs, 2 // bs, 2 // bs        # a fold: 3 / 1 / 1 folds
    common = ["--dataset", "pastis", "--dataset_folder", data, "--batch_size", str(bs),
              "--epochs", "1", "--num_classes", str(PASTIS_CLASSES),
              "--out_conv", f"[32, {PASTIS_CLASSES}]", "--bf16"]
    dirs = {k: os.path.join(tmp, f"pastis_{k}")
            for k in ("utae", "utae_test", "timeunet", "timeunet_chunk", "timeunet_chunk_pair",
                      "five")}
    tail16 = {lp.variant(True, torch.bfloat16, d): n_train for d in ("fwd", "bwd")}
    fold1 = ["--fold", "1"]
    runs, launches = {}, []

    def run(name, argv, pool, evals, all_folds=False):
        r, p, e, sec = cli_run(f"(16a) {name}", argv + common, pool, evals, native=False,
                               all_folds=all_folds)
        launches.append({**p, **{f"eval_{k}": v for k, v in e.items()}})
        runs[name] = {"seconds": sec, "test": r.test_metrics,
                      "epoch_s": [m["train_epoch_time"] for m in r.trainlog.values()]}
        return r

    r_u = run("utae fold 1", ["--model", "utae", "--res_dir", dirs["utae"]] + fold1,
              {}, {"wide": n_val + n_test})
    missing = [f for f in CLI_FILES if not os.path.exists(os.path.join(dirs["utae"], f))]
    check(not missing, f"pastis utae fold 1 wrote no {missing}")
    r_ut = run("utae fold 1 --test", ["--model", "utae", "--test", "--weight_folder",
                                      dirs["utae"], "--res_dir", dirs["utae_test"]] + fold1,
               {}, {"wide": n_test})
    loss_rel = (abs(r_ut.test_metrics["test_loss"] - r_u.test_metrics["test_loss"])
                / abs(r_u.test_metrics["test_loss"]))
    print(f"train cli (16a) utae --test vs the run's own test: loss relative "
          f"{loss_rel:.3e}", flush=True)
    check(loss_rel <= 1e-5, f"pastis --test loss {r_ut.test_metrics['test_loss']} vs "
                            f"{r_u.test_metrics['test_loss']}")
    pair = ["--model", "timeunet", "--use_pallas_train"]
    run("timeunet fold 1 --use_pallas_train", pair + ["--res_dir", dirs["timeunet"]] + fold1,
        tail16, {"group": n_val + n_test})
    # --seq_chunk on the card, as in the JAX CLI: without --use_pallas_train
    # the training steps stream the L-TAE over T (no pair launch), the val
    # and test steps run the eval kernel; with it the pair trains and
    # nothing is streamed
    for name, argv, want_pool, want_chunked, res in (
            ("timeunet fold 1 --seq_chunk 8", ["--model", "timeunet"], {}, n_train,
             "timeunet_chunk"),
            ("timeunet fold 1 --seq_chunk 8 --use_pallas_train", pair, tail16, 0,
             "timeunet_chunk_pair")):
        chunked_calls = []
        chunked = LTAE._chunked
        LTAE._chunked = lambda self, *a, **k: chunked_calls.append(self.training) or chunked(
            self, *a, **k)
        try:
            run(name, argv + ["--seq_chunk", "8", "--res_dir", dirs[res]] + fold1,
                want_pool, {"group": n_val + n_test})
        finally:
            LTAE._chunked = chunked
        print(f"train cli (16a) {name}: the L-TAE streamed over T {len(chunked_calls)} "
              f"times (training {sum(chunked_calls)})", flush=True)
        check(len(chunked_calls) == want_chunked and all(chunked_calls),
              f"pastis {name}: the L-TAE was streamed over T {len(chunked_calls)} times "
              f"(training {sum(chunked_calls)}), not {want_chunked} training steps")
    run("utae five folds", ["--model", "utae", "--res_dir", dirs["five"]],
        {}, {"wide": 5 * (n_val + n_test)}, all_folds=True)
    for f in range(1, 6):
        missing = [n for n in ("trainlog.json", "all_test_metrics.json", "all_conf_mat.pkl",
                               "model.ckpt")
                   if not os.path.exists(os.path.join(dirs["five"], f"Fold_{f}", n))]
        check(not missing, f"pastis five folds: Fold_{f} has no {missing}")
        with open(os.path.join(dirs["five"], f"Fold_{f}", "all_test_metrics.json")) as fh:
            loss = json.load(fh)["test_loss"]
        check(np.isfinite(loss), f"pastis five folds: Fold_{f} test loss {loss}")
    cm_pixels = int(aggregate_fold_cms(dirs["five"]).sum())
    with open(os.path.join(dirs["five"], "all_overall.json")) as fh:
        overall = json.load(fh)
    print(f"train cli (16a) utae five folds: {cm_pixels} test pixels aggregated, overall "
          f"{json.dumps(overall)}", flush=True)
    check(cm_pixels == PASTIS_PATCHES * HW, f"pastis five folds aggregated {cm_pixels} "
                                            f"pixels, not {PASTIS_PATCHES * HW}")
    check(np.isfinite(overall["micro_IoU"]) and np.isfinite(overall["Accuracy"]),
          f"pastis five folds overall {overall}")
    total = collections.Counter()
    for c in launches:
        total.update(c)
    return {"runs": runs, "test_loss_rel": loss_rel, "overall": overall,
            "launches": dict(total)}


def pastis_preprocess(dev) -> dict:
    """(16b) preprocess_batch on the card at B=4, T=61, 128^2, 10 channels
    (reorder, NDVI, standardization, flips and rotations, temporal dropout
    0.2), the draws from a generator on the card, against the CPU for the
    same draws: reorder, augmentation, y and the pad mask exactly, the
    standardized values within PREP_TOL; its warm ms."""
    from crop2seg_tpu_torch.ops import preprocess as pp

    gen = torch.Generator(device=dev).manual_seed(16)
    b = TRAIN_B
    lengths = torch.tensor(TRAIN_LENGTHS, device=dev)
    pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
    x = torch.rand(b, T, SIDE, SIDE, 10, generator=gen, device=dev) * 4000
    y = torch.randint(0, PASTIS_CLASSES, (b, SIDE, SIDE), generator=gen, device=dev)
    mean = torch.rand(10, generator=gen, device=dev) * 1900 + 100
    std = torch.rand(10, generator=gen, device=dev) * 490 + 10
    flip, rot = pp.draw_geometry(b, gen)
    drop = pp.draw_temporal_dropout((b, T), PREP_DROPOUT, gen)
    kw = dict(reorder=True, ndvi=True, augment=True, temporal_dropout=PREP_DROPOUT)
    cpu = {k: v.cpu() for k, v in dict(x=x, y=y, pad=pad, mean=mean, std=std, flip=flip,
                                       rot=rot, drop=drop).items()}

    def on(t):
        return pp.preprocess_batch(t["x"], t["mean"], t["std"], y=t["y"], pad_mask=t["pad"],
                                   flip=t["flip"], rot=t["rot"], drop=t["drop"], **kw)
    dev_t = dict(x=x, y=y, pad=pad, mean=mean, std=std, flip=flip, rot=rot, drop=drop)
    got, want = on(dev_t), on(cpu)
    ms = cuda_ms(lambda: on(dev_t), 5)
    check(torch.equal(pp.reorder_channels(x).cpu(), pp.reorder_channels(cpu["x"])),
          "preprocess: reorder differs on the card")
    ax, ay = pp.augment_geometric(x, y, flip, rot)
    cx, cy = pp.augment_geometric(cpu["x"], cpu["y"], cpu["flip"], cpu["rot"])
    check(torch.equal(ax.cpu(), cx) and torch.equal(ay.cpu(), cy),
          "preprocess: flips / rotations differ on the card")
    check(torch.equal(got["y"].cpu(), want["y"]), "preprocess: y differs on the card")
    check(torch.equal(got["pad_mask"].cpu(), want["pad_mask"]),
          "preprocess: the pad mask differs on the card")
    err = ((got["x"].cpu() - want["x"]).abs() / want["x"].abs().clamp_min(1.0)).max().item()
    dropped = int((want["pad_mask"] & ~cpu["pad"]).sum())
    print(f"preprocess (16b) B={b} T={T} {SIDE}^2x10 on the card: {ms:.3f} ms warm; flips "
          f"{flip.tolist()}, rotations {rot.tolist()}, {dropped} frames dropped; x vs the "
          f"CPU max |diff| / max(1, |x|) {err:.3e} (limit {PREP_TOL:g}); reorder, "
          f"augmentation, y and pad mask exact", flush=True)
    check(err <= PREP_TOL and torch.isfinite(got["x"]).all().item(),
          f"preprocess: x on the card differs by {err} from the CPU")
    return {"ms": ms, "x_err": err, "frames_dropped": dropped}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def chunk_check(label: str, got: dict, ref: dict, yard: dict | None = None) -> float:
    """||got - ref|| / ||ref|| for every tensor of ``ref`` (o, the output,
    x's and every parameter's gradient): within CHUNK_TOL, or, with
    ``yard``, within GRAD_FACTOR times yard's own distance from ``ref`` (the
    tensor's, or the median over tensors if larger), and never tighter than
    CHUNK_TOL. A gradient zero up to
    rounding in ``ref`` (below GRAD_ZERO of the largest) must stay so.
    Returns the worst ratio to its limit."""
    grads = [k for k in ref if k.startswith("grad ")]
    top = max(ref[k].abs().max().item() for k in grads)
    zero = [k for k in grads if ref[k].abs().max().item() <= GRAD_ZERO * top]
    for k in zero:
        check(got[k].abs().max().item() <= GRAD_ZERO * top,
              f"{label}: {k} where the plain one is 0 up to rounding")
    live = [k for k in ref if k not in zero]
    err = {k: _rel(got[k], ref[k]) for k in live}
    if yard is None:
        limit = {k: CHUNK_TOL for k in live}
    else:
        dist = {k: _rel(yard[k], ref[k]) for k in live}
        floor = float(np.median(list(dist.values())))
        limit = {k: max(GRAD_FACTOR * max(dist[k], floor), CHUNK_TOL) for k in live}
    ratio = {k: err[k] / limit[k] for k in live}
    worst = max(ratio, key=ratio.get)
    print(f"{label}: ||diff|| / ||plain|| o {err['o']:.3e}, out {err['out']:.3e}, "
          f"gradients median {np.median([err[k] for k in live if k in grads]):.3e} max "
          f"{max(err[k] for k in live if k in grads):.3e} ({len(zero)} zero up to "
          f"rounding); worst ratio to its limit {ratio[worst]:.3f} ({worst}, limit "
          f"{limit[worst]:.3e})", flush=True)
    check(ratio[worst] <= 1.0, f"{label}: {worst} differs by {err[worst]:.3e}, beyond "
                               f"{limit[worst]:.3e}")
    return ratio[worst]


def chunked_ltae(dev) -> dict:
    """(16c) TimeUNet's L-TAE at full width (B=4, T=61, N=128^2, C=64,
    D=256, G=16, seeded weights, dropout 0, training mode) through
    ``_chunked`` (fused=False, seq_chunk 8 and 16) against the plain train
    path (the embed and attention ops with the attention out), o (the pooled
    output before the MLP tail), the output and every gradient of one
    backward from a fixed random cotangent: in fp32 within CHUNK_TOL; in
    bf16 autocast within GRAD_FACTOR times the plain path's own bf16-to-fp32
    distance. Each path runs twice, the second warm: its ms (forward and
    backward, CUDA events) and its peak memory above the inputs; the kernel
    pair (``use_pallas_train`` with seq_chunk set: the pair takes
    precedence, as in the JAX gate) beside them. The chunked runs
    (``use_pallas_train`` off) launch no kernel."""
    te = get_model({"model": "timeunet"}, device=dev,
                   generator=torch.Generator().manual_seed(0)).temporal_encoder
    te.train()
    te.attn_dropout = 0.0
    te.mlp[1].p = 0.0
    gen = torch.Generator(device=dev).manual_seed(5)
    b = TRAIN_B
    pad = torch.arange(T, device=dev)[None] >= torch.tensor(TRAIN_LENGTHS, device=dev)[:, None]
    x = torch.randn(b, T, SIDE, SIDE, C, generator=gen, device=dev)
    x[pad] = 0.0
    x.requires_grad_(True)
    dates = (torch.arange(T, dtype=torch.float32, device=dev) * 5 + 3)[None].expand(b, T)
    dates = dates.contiguous()
    cot = torch.randn(b, SIDE, SIDE, D_OUT, generator=gen, device=dev)
    captured = {}
    tail = te._mlp_tail

    def capture(o, generator=None):
        captured["o"] = o.detach().float()
        return tail(o, generator)
    te._mlp_tail = capture

    def path(dtype, fused: bool, seq_chunk, need_attn: bool) -> dict:
        # the JAX gate: _chunked without use_pallas_train, the pair with it
        te.seq_chunk, te.use_pallas_train = seq_chunk, fused
        for _ in range(2):                      # the second call is the warm one
            te.zero_grad(set_to_none=True)
            x.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            zero_counts()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            with torch.autocast("cuda", torch.bfloat16, enabled=dtype == torch.bfloat16):
                out, _ = te(x, dates, pad, need_attn=need_attn, fused=fused)
            (out.float() * cot).sum().backward()
            end.record()
            torch.cuda.synchronize()
        res = {"o": captured["o"].reshape(b, SIDE, SIDE, -1), "out": out.detach().float(),
               "grad x": x.grad.detach().clone()}
        res.update({f"grad {k}": p.grad.detach().clone() for k, p in te.named_parameters()})
        meta = {"ms": start.elapsed_time(end),
                "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                "launches": kernel_counts()}
        return res, meta

    out, ratios = {}, {}
    plain32 = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        plain, meta = path(dtype, False, None, True)
        out[f"plain {name}"] = meta
        check(meta["launches"] == {}, f"plain L-TAE launched {meta['launches']}")
        for tc in SEQ_CHUNKS:
            got, meta = path(dtype, False, tc, False)
            out[f"seq_chunk {tc} {name}"] = meta
            check(meta["launches"] == {}, f"_chunked launched {meta['launches']}")
            ratios[f"{tc} {name}"] = chunk_check(
                f"_chunked seq_chunk {tc} {name} vs plain {name}", got, plain,
                None if dtype == torch.float32 else plain32)
            del got
        _, meta = path(dtype, True, SEQ_CHUNKS[0], False)
        out[f"pair {name}"] = meta
        check(sum(meta["launches"].values()) == 2,
              f"the kernel pair with seq_chunk set launched {meta['launches']}")
        if dtype == torch.float32:
            plain32 = plain
        del plain
        torch.cuda.empty_cache()
        for k in ("plain", "seq_chunk 8", "seq_chunk 16", "pair"):
            m = out[f"{k} {name}"]
            print(f"L-TAE (16c) B={b} T={T} {SIDE}^2 C={C} D={D} {name} {k}: forward + "
                  f"backward {m['ms']:.3f} ms warm, peak {m['peak_gib']:.2f} GiB above the "
                  f"inputs, launches {m['launches']}", flush=True)
    te._mlp_tail = tail
    del plain32
    torch.cuda.empty_cache()
    return {"paths": out, "worst_ratio": ratios}


def m10b_modules(dev) -> dict:
    """(16d) UNetEx (its defaults: base 64, 4 stages, GELU; 10 input
    channels), MLPMixer (its defaults: 4 layers, token MLP 64, channel MLP
    256, over TimeUNet's T = 61 tokens of C = 64) and TemporalAggregator3D
    (att_group, 16 heads' masks at 64^2 upsampled to the 128^2 skip of C =
    64, with pads) on 128^2 inputs at B = 2: a forward on the card against
    the same weights on the CPU (M10B_TOL; the MLP-Mixer's rows are
    independent, so its first M10B_MIXER_ROWS rows are run on the CPU), its
    warm ms; then one UNetEx train step (20 classes, B = 2) with finite
    gradients. No kernel launches."""
    from crop2seg_tpu_torch.models import MLPMixer, UNetEx
    from crop2seg_tpu_torch.nn.blocks3d import TemporalAggregator3D

    torch.manual_seed(16)
    g = torch.Generator().manual_seed(17)
    b = 2
    attn = torch.softmax(torch.randn(b, SIDE // 2, SIDE // 2, G, T, generator=g), -1)
    pad = torch.arange(T)[None] >= torch.tensor([T, 40])[:, None]
    cases = {
        "unet_ex": (UNetEx(in_channels=10), (torch.randn(b, SIDE, SIDE, 10, generator=g),),
                    None),
        "mlp_mixer": (MLPMixer(num_tokens=T, hidden_dim=C),
                      (torch.randn(b * HW, T, C, generator=g),), M10B_MIXER_ROWS),
        "temporal_aggregator3d": (TemporalAggregator3D("att_group"),
                                  (torch.randn(b, T, SIDE, SIDE, C, generator=g), attn, pad),
                                  None),
    }
    out = {}
    zero_counts()
    for name, (model, args, rows) in cases.items():
        model.eval()
        with torch.no_grad():
            for m in model.modules():      # non-trivial BatchNorm statistics
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.normal_(0, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
        dev_model = copy.deepcopy(model).to(dev)
        dev_args = tuple(a.to(dev) for a in args)
        with torch.inference_mode():
            got = dev_model(*dev_args)
            ms = cuda_ms(lambda: dev_model(*dev_args), 3)
            cpu_args = args if rows is None else (args[0][:rows],) + args[1:]
            want = model(*cpu_args)
        got, want = (got[0], want[0]) if isinstance(want, tuple) else (got, want)
        got = got.cpu() if rows is None else got[:rows].cpu()
        err = ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item()
        print(f"{name} (16d) B={b} {SIDE}^2 on the card: {ms:.3f} ms a forward warm, vs the "
              f"CPU max |diff| / max(1, max |CPU|) {err:.3e} (limit {M10B_TOL:g}), output "
              f"{tuple(got.shape)}", flush=True)
        check(err <= M10B_TOL and torch.isfinite(got).all().item(),
              f"{name}: the card's forward differs from the CPU's by {err}")
        out[name] = {"ms": ms, "err": err}
        del dev_model, dev_args
    model = UNetEx(in_channels=10, num_classes=PASTIS_CLASSES).to(dev).train()
    xb = torch.randn(b, SIDE, SIDE, 10, device=dev)
    yb = torch.randint(0, PASTIS_CLASSES, (b, SIDE, SIDE), device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(2):                          # the second step is the warm one
        model.zero_grad(set_to_none=True)
        start.record()
        loss = torch.nn.functional.cross_entropy(model(xb).permute(0, 3, 1, 2), yb)
        loss.backward()
        end.record()
        torch.cuda.synchronize()
    finite = all(torch.isfinite(p.grad).all().item() for p in model.parameters())
    print(f"unet_ex (16d) train step B={b} {SIDE}^2 {PASTIS_CLASSES} classes: loss "
          f"{loss.item():.6f}, {start.elapsed_time(end):.3f} ms warm, gradients finite "
          f"{finite}", flush=True)
    check(np.isfinite(loss.item()) and finite, "unet_ex train step: non-finite loss or grads")
    out["unet_ex_train"] = {"loss": loss.item(), "ms": start.elapsed_time(end)}
    launched = kernel_counts()
    check(launched == {}, f"the M10b modules launched {launched}")
    return out


def phase_pastis(dev, tmp: str) -> dict:
    """Phase 16: (a) PASTIS training through the CLI (``pastis_cli``), (b)
    preprocess_batch on the card (``pastis_preprocess``), (c) TimeUNet's
    L-TAE streamed over T (``chunked_ltae``), (d) UNetEx, MLPMixer and
    TemporalAggregator3D (``m10b_modules``); each part's seconds."""
    out, seconds = {}, {}
    for key, fn in (("cli", lambda: pastis_cli(dev, tmp)),
                    ("preprocess", lambda: pastis_preprocess(dev)),
                    ("chunked", lambda: chunked_ltae(dev)),
                    ("m10b", lambda: m10b_modules(dev))):
        start = time.perf_counter()
        out[key] = fn()
        torch.cuda.empty_cache()
        seconds[key] = time.perf_counter() - start
        print(f"phase 16 ({key}): {seconds[key]:.1f} s", flush=True)
    out["seconds"] = seconds
    return out


# phase 17: data-parallel training and patch-parallel serving (parallel/mesh.py),
# the CLI's --num_devices and graft_entry
DP_SEED = 17               # the global batch's and the weights' seed
DP_B = 4                   # the global batch, as phase 4's steps
# the group's step against the one-process step on the global batch: the
# loss relative, the BatchNorm running statistics as a share of max(1, |x|),
# and the tie: a prediction may differ only where the one-process logits' top
# two (or, for the top-2 matrix, second and third) are closer than it. fp32
# sums in another order move the logits by ~1e-6. In bf16 each card's convs
# round at its own batch size (cuDNN takes other algorithms at B = 1 than at
# B = 4): on four cards 447 of 65536 argmaxes moved by more than 0.03 of a
# logit while the loss agreed to 1.7e-6 (PERF.md §6), so the bf16 case
# holds no prediction (tie None) and the fp32 case holds them
DP_TOL = {torch.float32: dict(loss=1e-5, stats=1e-5, tie=1e-4),
          torch.bfloat16: dict(loss=1e-3, stats=1e-3, tie=None)}
# the 2-rank tile against the 1-device tile: probabilities
DP_TILE_TOL = dict(rtol=1e-4, atol=1e-5)
DP_CASES = {
    # name: (model config, autocast dtype, steps, launches by variant a rank a step)
    "timeunet fp32": ({"model": "timeunet"}, None, 2,
                      {lp.variant(True, torch.float32, d): 1 for d in ("fwd", "bwd")}),
    "utae remat fp32": ({"model": "utae", "remat": True}, None, 2, {}),
}
# (a): three bf16 steps on the pair, and the fp32 steps that hold the
# predictions and the gradients
DP_NCCL_CASES = {
    "timeunet bf16": ({"model": "timeunet"}, torch.bfloat16, 3,
                      {lp.variant(True, torch.bfloat16, d): 1 for d in ("fwd", "bwd")}),
    "timeunet fp32": DP_CASES["timeunet fp32"],
}


def dp_model(cfg: dict, dev):
    """The phase's model: factory defaults, seeded weights, dropout 0 (the
    ranks draw their own masks, so only dropout 0 compares with one
    process)."""
    model = get_model(cfg, device=dev, generator=torch.Generator().manual_seed(DP_SEED))
    model.temporal_encoder.attn_dropout = 0.0
    model.temporal_encoder.mlp[1].p = 0.0
    return model


def dp_step_record(model, step, batch, gen, steps: int) -> dict:
    """``steps`` steps of ``step`` on ``batch``: the first step's loss,
    confusion matrices, logits, gradients (before Adam) and running
    statistics on the host (with a boundary head also its logits, loss_b
    and cm_b), every step's loss, the last step's ms (CUDA events) and the
    pair's launches a step."""
    logits = {}
    hook = model.register_forward_hook(lambda m, a, out: logits.__setitem__("v", out))
    rec = {"losses": [], "launches": []}
    for i in range(steps):
        lp.ltae_pool.launches.clear()                  # this step's counts
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        aux = step(batch, gen)
        end.record()
        torch.cuda.synchronize()
        rec["losses"].append(float(aux["loss"]))
        rec["launches"].append(dict(lp.ltae_pool.launches))
        if i == 0:
            out = logits["v"] if isinstance(logits["v"], tuple) else (logits["v"],)
            if len(out) > 1:
                rec.update(logits_b=out[1].detach().float().cpu(), cm_b=aux["cm_b"].cpu(),
                           loss_b=float(aux["loss_b"]))
            rec.update(
                cm=aux["cm"].cpu(), cm_top2=aux["cm_top2"].cpu(),
                logits=out[0].detach().float().cpu(),
                grads={k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                stats={k: v.detach().cpu() for k, v in model.state_dict().items()
                       if "running_" in k})
    rec["ms"] = start.elapsed_time(end)
    hook.remove()
    return rec


def dp_rank(rank: int, world: int, store_dir: str, backend: str, cases: list) -> dict:
    """One rank of phase 17 (a)-(c): ``cases`` (name, model config, dtype,
    steps) over the group, each rank its shard of the global batch of DP_B
    on cuda:rank (NCCL) or, with gloo, on cuda:0; and the ms of a gloo or
    NCCL all-reduce of the last model's gradient size."""
    from crop2seg_tpu_torch.parallel import (
        data_parallel_step, init_group, rank_seed, replicate, shard_batch)

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    group = init_group(rank, world, store_dir, dev, backend=backend)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = StepConfig(num_classes=N_CLASSES, class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    out = {}
    for name, model_cfg, dtype, steps in cases:
        model = replicate(dp_model(model_cfg, dev), group)
        batch = train_batch(DP_B, torch.Generator(device=dev).manual_seed(DP_SEED), dev)
        step = data_parallel_step(model, cfg, device=dev, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(rank_seed(DP_SEED, rank))
        out[name] = dp_step_record(model, step, shard_batch(batch, group), gen, steps)
        del model, step, batch
        torch.cuda.empty_cache()
    flat = torch.ones(sum(p.numel() for p in dp_model(cases[-1][1], dev).parameters()),
                      device=dev)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(flat, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["all_reduce"] = {"floats": flat.numel(), "ms_median": float(np.median(times[1:]))}
    return out


def dp_predictions_beyond_tie(got: torch.Tensor, ref: torch.Tensor, y, tie: float) -> tuple:
    """The group's logits ``got`` against the one-process ``ref``: the
    pixels whose argmax, and whose top-2 prediction, differ where the
    reference's deciding gap exceeds ``tie``, and the pixels within a tie."""
    from crop2seg_tpu_torch.learning.metrics import top2_prediction

    top3 = ref.topk(3, dim=-1).values
    tie1 = (top3[..., 0] - top3[..., 1]) <= tie
    tie2 = tie1 | ((top3[..., 1] - top3[..., 2]) <= tie)
    bad1 = (got.argmax(-1) != ref.argmax(-1)) & ~tie1
    bad2 = (top2_prediction(got, y) != top2_prediction(ref, y)) & ~tie2
    return int(bad1.sum()), int(bad2.sum()), int(tie2.sum())


def dp_check(label: str, ranks: list, ref: dict, perturbed: dict, y, want_launches,
             dtype=None, logits=None, what: str = "the L-TAE output") -> dict:
    """(b)/(c)/(a): every rank's loss, confusion matrices and running
    statistics against the one-process step ``ref`` (the matrices exact
    unless a pixel is within a tie, ``dp_predictions_beyond_tie``), the
    ranks' gradients equal and within the perturbation spread of ``ref``'s
    (``perturbed``: one process with the L-TAE output scaled by 1 + GRAD_EPS
    * noise; ``what`` names the perturbed output), and each rank's pair
    launches a step; DP_TOL of ``dtype`` (bf16: the loss and statistics
    only). ``logits``: the group's logits of the global batch (default: the
    ranks' concatenated along B). Every number is printed before any
    check."""
    from crop2seg_tpu_torch.learning.metrics import confusion_matrix

    tol = DP_TOL[dtype or torch.float32]
    held = tol["tie"] is not None
    loss_rel = max(abs(r["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
                   for r in ranks)
    stats_err = max(((r["stats"][k] - v).abs().max() / v.abs().max().clamp_min(1.0)).item()
                    for r in ranks for k, v in ref["stats"].items()) if ref["stats"] else 0.0
    if logits is None:
        logits = torch.cat([r["logits"] for r in ranks])
    cm_equal = all(torch.equal(r["cm"], ref["cm"]) and torch.equal(r["cm_top2"], ref["cm_top2"])
                   for r in ranks)
    differ = int((logits.argmax(-1) != ref["logits"].argmax(-1)).sum())
    bad1, bad2, ties = dp_predictions_beyond_tie(logits, ref["logits"], y, tol["tie"] or 0.0)
    launches = [r["launches"] for r in ranks]
    print(f"data parallel {label}: {len(ranks)} ranks, loss {ranks[0]['losses'][0]!r} vs one "
          f"process {ref['losses'][0]!r} (relative {loss_rel:.3e}), losses a step "
          f"{ranks[0]['losses']} vs {ref['losses']}; cm and cm_top2 "
          f"{'equal' if cm_equal else 'differ'}: {differ} argmax pixels differ, {bad1} argmax "
          f"and {bad2} top-2 beyond a tie of {tol['tie']} ({ties} within it); running "
          f"statistics within {stats_err:.3e}; step ms per rank "
          f"{[round(r['ms'], 3) for r in ranks]} (one process, B={DP_B}: {ref['ms']:.3f}); "
          f"pair launches a step per rank {launches}", flush=True)
    worst = None
    if held:
        worst = check_grads_within_spread(f"dp {label}", ranks[0]["grads"], ref["grads"],
                                          perturbed, batch=DP_B, what=what)
    else:
        print(f"data parallel {label}: predictions and gradients not held in bf16 (each "
              "card's convs round at its own batch size; the fp32 case holds them)", flush=True)
    # the group's matrices are its logits', summed over the ranks, and its
    # gradients the same on every rank
    n_cls = ref["cm"].shape[0]
    check(torch.equal(ranks[0]["cm"], confusion_matrix(logits.argmax(-1), y, n_cls)),
          f"{label}: the group's cm is not its ranks' predictions'")
    for r in ranks[1:]:
        for k, g in ranks[0]["grads"].items():
            check(torch.equal(r["grads"][k], g), f"{label}: ranks disagree on the gradient of {k}")
    check(not held or (bad1 == 0 and bad2 == 0),
          f"{label}: {bad1} argmax and {bad2} top-2 predictions differ from one process's "
          f"beyond a tie of {tol['tie']}")
    check(loss_rel <= tol["loss"], f"{label}: loss relative {loss_rel:.3e}")
    check(stats_err <= tol["stats"], f"{label}: running statistics differ by {stats_err:.3e}")
    for r in ranks:
        check(all(np.isfinite(r["losses"])), f"{label}: losses {r['losses']}")
        check(all(n == want_launches for n in r["launches"]),
              f"{label}: a rank launched {r['launches']}, not {want_launches} a step")
    return {"loss": ranks[0]["losses"][0], "loss_ref": ref["losses"][0], "loss_rel": loss_rel,
            "stats_err": stats_err, "grad_worst_ratio": worst, "ties": ties,
            "argmax_differ": differ,
            "rank_step_ms": [r["ms"] for r in ranks], "one_process_step_ms": ref["ms"],
            "launches_per_rank": [sum(sum(n.values()) for n in r["launches"]) for r in ranks],
            "launches_by_variant": dict(sum((collections.Counter(n) for r in ranks
                                             for n in r["launches"]), collections.Counter()))}


DP_REFS = {}


def dp_reference(name: str, model_cfg: dict, dtype, steps: int, dev) -> tuple:
    """One process on the global batch: the step the group must repeat, and
    the same first step with the L-TAE output perturbed (the yardstick);
    kept by ``name`` for phase 18, which holds its mesh to the same steps."""
    if name in DP_REFS:
        return DP_REFS[name]
    cfg = StepConfig(num_classes=N_CLASSES, class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    out = []
    for eps in (0.0, GRAD_EPS):
        model = dp_model(model_cfg, dev)
        if eps:
            model.temporal_encoder.register_forward_hook(perturb_hook(eps, dev))
        batch = train_batch(DP_B, torch.Generator(device=dev).manual_seed(DP_SEED), dev)
        step = make_train_step(model, cfg, dtype=dtype)
        out.append(dp_step_record(model, step, batch, torch.Generator(device=dev).manual_seed(
            DP_SEED), steps if not eps else 1))
        del model, step
        torch.cuda.empty_cache()
    DP_REFS[name] = out[0], out[1]["grads"], batch["y"].cpu()
    return DP_REFS[name]


def dp_tiles(dev) -> dict:
    """(d) TimeUNet's tile through make_tile_predictor on one card (batches
    of 10) and with the mesh [cuda:0, cuda:0] (patch_parallel_infer: batches
    of 20, 10 a device, so that each device runs the one card's batch shape:
    at another batch size the card's bf16 convolutions may take other
    algorithms, ~1e-3 apart), bf16 and fp32: probabilities within
    DP_TILE_TOL, classes equal where the 1-device run's top two
    probabilities differ by more than 1e-5, the eval kernel 10 times each;
    patches/s of each."""
    from crop2seg_tpu_torch.parallel import make_mesh

    model = get_model({"model": "timeunet"}, device=dev,
                      generator=torch.Generator().manual_seed(DP_SEED))
    gen = torch.Generator(device=dev).manual_seed(2)
    tile = torch.randn(T, 1098, 1098, 10, generator=gen, device=dev)
    tile[LENGTH:] = 0.0
    dates = np.arange(T, dtype=np.float32) * 5 + 3
    mesh = make_mesh([dev, dev])
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        res = {}
        for label, kw, want in (("1 device", {"batch_size": MAIN_B}, 10),
                                ("mesh", {"batch_size": 2 * MAIN_B, "mesh": mesh}, 10)):
            predict = make_tile_predictor(model, dtype=dtype, **kw)
            predict(tile, dates, LENGTH)                      # warm-up
            lf.ltae_fused_forward.route_launches.clear()     # this path's counts
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[label] = predict(tile, dates, LENGTH)
            secs = time.perf_counter() - t0
            routes = dict(lf.ltae_fused_forward.route_launches)
            res[label]["pps"], res[label]["launches"] = 100 / secs, routes
            check(routes == {"group": want}, f"tile {name} {label}: eval kernel {routes}, "
                                             f"not {want} group launches")
        one, sh = res["1 device"], res["mesh"]
        p_err = float(np.abs(sh["proba"] - one["proba"]).max())
        np.testing.assert_allclose(sh["proba"], one["proba"], **DP_TILE_TOL)
        top2 = np.sort(one["proba"], axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 1e-5
        differ = int(((sh["classes"] != one["classes"]) & decided).sum())
        print(f"patch parallel tile {name}: mesh [cuda:0, cuda:0] {sh['pps']:.2f} patches/s "
              f"vs 1 device {one['pps']:.2f}; max |dproba| {p_err:.3e}; classes differ at "
              f"{differ} decided pixels ({int((~decided).sum())} within 1e-5); launches "
              f"{sh['launches']} vs {one['launches']}", flush=True)
        check(differ == 0, f"tile {name}: the mesh's classes differ at {differ} pixels")
        out[name] = {"mesh_pps": sh["pps"], "one_device_pps": one["pps"], "max_dproba": p_err,
                     "launches_mesh": sh["launches"]["group"],
                     "launches_one_device": one["launches"]["group"]}
    del model, tile
    torch.cuda.empty_cache()
    return out


def dp_cli(dev, data: str, tmp: str) -> dict:
    """(e) The train CLI with --num_devices 2: on one card it must refuse
    (fewer cards than ranks), on two or more it trains an epoch on phase
    12's dataset; with --device cpu it trains an epoch of a small TimeUNet
    on a small synthetic set over two gloo processes, and one process's
    --test of its folder repeats its test loss within 1e-5."""
    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.data import make_synthetic_dataset

    out = {}
    cards = torch.cuda.device_count()
    argv = ["--dataset", "synthetic", "--dataset_folder", data, "--model", "timeunet",
            "--bf16", "--use_pallas_train", "--batch_size", "4", "--epochs", "1",
            "--num_devices", "2", "--res_dir", os.path.join(tmp, "dp_card")]
    if cards < 2:
        try:
            cli.main(cli.parse_config(argv))
        except SystemExit as e:
            out["one_card_refusal"] = str(e)
        check("cuda devices are visible" in out.get("one_card_refusal", ""),
              f"--num_devices 2 on one card: {out.get('one_card_refusal')!r}, not the "
              "visible-card refusal")
        print(f"train cli (17e) --num_devices 2 on {cards} card: refused: "
              f"{out['one_card_refusal']}", flush=True)
    else:
        start = time.perf_counter()
        run = cli.main(cli.parse_config(argv))
        out["cards_epoch_s"] = time.perf_counter() - start
        check(all(np.isfinite(v) for v in run.test_metrics.values()),
              f"--num_devices 2 on the cards: {run.test_metrics}")
        print(f"train cli (17e) --num_devices 2 on the cards: {out['cards_epoch_s']:.1f} s, "
              f"test {json.dumps(run.test_metrics)}", flush=True)
    small = os.path.join(tmp, "dp_small")
    make_synthetic_dataset(small, n_patches=10, t_range=(5, 12), hw=16)
    common = ["--device", "cpu", "--dataset", "synthetic", "--dataset_folder", small,
              "--model", "timeunet", "--encoder_widths", "[8,8]", "--decoder_widths", "[8,8]",
              "--out_conv", "[8,15]", "--n_head", "2", "--d_model", "16",
              "--batch_size", "2", "--t_buckets", "[8,12]", "--display_step", "1000"]
    res = os.path.join(tmp, "dp_cpu")
    start = time.perf_counter()
    run = cli.main(cli.parse_config(common + ["--epochs", "1", "--num_devices", "2",
                                              "--res_dir", res]))
    out["cpu_seconds"] = time.perf_counter() - start
    missing = [f for f in CLI_FILES if not os.path.exists(os.path.join(res, f))]
    check(not missing, f"--device cpu --num_devices 2 wrote no {missing}")
    tested = cli.main(cli.parse_config(common + ["--test", "--weight_folder", res,
                                                 "--res_dir", os.path.join(tmp, "dp_cpu_test")]))
    a, b = run.test_metrics["test_loss"], tested.test_metrics["test_loss"]
    out["cpu_test_loss_rel"] = abs(a - b) / abs(a)
    print(f"train cli (17e) --device cpu --num_devices 2: {out['cpu_seconds']:.1f} s, test "
          f"loss {a!r}; one process's --test {b!r} (relative {out['cpu_test_loss_rel']:.3e})",
          flush=True)
    check(out["cpu_test_loss_rel"] <= 1e-5, f"--test of the 2-rank run: loss {b} vs {a}")
    return out


def dp_nccl(dev, world: int) -> tuple:
    """(a) DP_NCCL_CASES over an NCCL group of ``world`` cards, one rank a
    card, each against one process on the global batch (``dp_check``);
    returns the checks and the NCCL all-reduce's ms."""
    from crop2seg_tpu_torch.parallel import run_workers

    ranks = run_workers(dp_rank, world, "nccl",
                        [(n, c, d, s) for n, (c, d, s, _) in DP_NCCL_CASES.items()])
    checks = {}
    for name, (model_cfg, dtype, steps, want) in DP_NCCL_CASES.items():
        ref, perturbed, y = dp_reference(name, model_cfg, dtype, steps, dev)
        checks[name] = dp_check(f"(17a) nccl {name}", [r[name] for r in ranks], ref, perturbed,
                                y, want, dtype)
    return checks, ranks[0]["all_reduce"]


def phase_data_parallel(dev, data: str, tmp: str) -> dict:
    """Phase 17: (a) an NCCL group over every card (where there are two or
    more), (b) TimeUNet and (c) U-TAE with remat over two gloo ranks on
    cuda:0, each against one process on the global batch (``dp_check``),
    (d) the patch-parallel tile (``dp_tiles``), (e) the CLI's --num_devices
    (``dp_cli``), (f) graft_entry's ``entry`` and ``dryrun_multichip(1)``;
    each part's seconds."""
    from crop2seg_tpu_torch import graft_entry
    from crop2seg_tpu_torch.parallel import run_workers

    out, seconds = {"checks": {}}, {}
    start = time.perf_counter()
    cards = torch.cuda.device_count()
    world = max(n for n in (1, 2, 4) if n <= cards and DP_B % n == 0)
    if world >= 2:
        checks, out["nccl_all_reduce"] = dp_nccl(dev, world)
        out["checks"].update({"nccl " + k: v for k, v in checks.items()})
    else:
        print(f"data parallel (17a): the NCCL path across cards was not run: {cards} card "
              "is visible, and NCCL refuses two ranks on one device", flush=True)
    seconds["a"] = time.perf_counter() - start
    start = time.perf_counter()
    cases = [(n, c, d, s) for n, (c, d, s, _) in DP_CASES.items()]
    ranks = run_workers(dp_rank, 2, "gloo", cases)
    for name, (model_cfg, dtype, steps, want) in DP_CASES.items():
        ref, perturbed, y = dp_reference(name, model_cfg, dtype, steps, dev)
        out["checks"][name] = dp_check(f"(17{'b' if 'timeunet' in name else 'c'}) gloo {name}",
                                       [r[name] for r in ranks], ref, perturbed, y, want, dtype)
    out["gloo_all_reduce"] = ranks[0]["all_reduce"]
    print(f"data parallel: gloo all-reduce of {out['gloo_all_reduce']['floats']} floats on "
          f"cuda:0, median {out['gloo_all_reduce']['ms_median']:.3f} ms", flush=True)
    seconds["bc"] = time.perf_counter() - start
    start = time.perf_counter()
    out["tiles"] = dp_tiles(dev)
    seconds["d"] = time.perf_counter() - start
    start = time.perf_counter()
    out["cli"] = dp_cli(dev, data, tmp)
    seconds["e"] = time.perf_counter() - start
    start = time.perf_counter()
    fn, args = graft_entry.entry()
    lf.ltae_fused_forward.route_launches.clear()        # this path's counts
    logits = fn(*args)
    torch.cuda.synchronize()
    out["entry_launches"] = dict(lf.ltae_fused_forward.route_launches)
    check(tuple(logits.shape) == (1, 128, 128, 15) and torch.isfinite(logits).all().item()
          and out["entry_launches"] == {"wide": 1},
          f"graft_entry.entry: {tuple(logits.shape)}, launches {out['entry_launches']}")
    out["dryrun"] = graft_entry.dryrun_multichip(1)
    seconds["f"] = time.perf_counter() - start
    out["seconds"] = seconds
    print(f"phase 17: seconds {json.dumps(seconds)}", flush=True)
    return out


# phase 18: the 2-D data x space training mesh (parallel/mesh.py) on phase
# 17's global batch, each case against phase 17's one-process step
SP_MESH = (2, 2)           # (data, space): 2 samples and 64 of the 128 rows a rank
SP_CASES = {
    # name: (model config, autocast dtype, steps, launches by variant a rank a
    # step, the name of phase 17's reference)
    "timeunet fp32": ({"model": "timeunet"}, None, 2,
                      {lp.variant(True, torch.float32, d): 1 for d in ("fwd", "bwd")},
                      "timeunet fp32"),
    "utae remat conv_out fp32": ({"model": "utae", "remat": True}, None, 2, {},
                                 "utae remat fp32"),
    "timeunet bf16": ({"model": "timeunet"}, torch.bfloat16, 2,
                      {lp.variant(True, torch.bfloat16, d): 1 for d in ("fwd", "bwd")},
                      "timeunet bf16"),
}
SP_HALO = (2 * T, 64, 128, 64)     # in_conv's second conv input on a rank: B_d * T frames


def sp_rank(rank: int, world: int, store_dir: str, backend: str, cases: list) -> dict:
    """One rank of phase 18: ``cases`` (name, model config, dtype, steps)
    on the SP_MESH mesh, each rank its shard_batch_2d of phase 17's global
    batch on cuda:rank (NCCL) or, with gloo, on cuda:0 (``dp_step_record``);
    and the ms of a halo exchange of in_conv's width (one row each way)."""
    from crop2seg_tpu_torch.nn.layers import space_halo
    from crop2seg_tpu_torch.parallel import (
        data_space_parallel_step, init_group, make_mesh_2d, rank_seed, replicate,
        shard_batch_2d)

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    group = init_group(rank, world, store_dir, dev, backend=backend)
    mesh = make_mesh_2d(*SP_MESH, group)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = StepConfig(num_classes=N_CLASSES, class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
    out = {}
    for name, model_cfg, dtype, steps in cases:
        model = replicate(dp_model(model_cfg, dev), group)
        batch = train_batch(DP_B, torch.Generator(device=dev).manual_seed(DP_SEED), dev)
        step = data_space_parallel_step(model, cfg, mesh, device=dev, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(rank_seed(DP_SEED, rank))
        out[name] = dp_step_record(model, step, shard_batch_2d(batch, mesh, model), gen,
                                   steps)
        del model, step, batch
        torch.cuda.empty_cache()
    x = torch.randn(SP_HALO, device=dev)
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        space_halo(x, 1, mesh.space_group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["halo"] = {"shape": list(SP_HALO), "ms_median": float(np.median(times[1:]))}
    return out


def sp_logits(ranks: list) -> torch.Tensor:
    """The global batch's logits from the ranks' (rank d * S + s holds rows
    d of B and s of H)."""
    data, space = SP_MESH
    return torch.cat([torch.cat([ranks[d * space + s]["logits"] for s in range(space)], 1)
                      for d in range(data)])


def sp_cases(dev, backend: str, label: str) -> tuple:
    """SP_CASES over four ranks (gloo on cuda:0, or NCCL a card), each
    against phase 17's one-process step (``dp_check``); the checks and a
    rank's halo exchange ms."""
    from crop2seg_tpu_torch.parallel import run_workers

    world = SP_MESH[0] * SP_MESH[1]
    ranks = run_workers(sp_rank, world, backend,
                        [(n, c, d, s) for n, (c, d, s, _, _) in SP_CASES.items()])
    checks = {}
    for name, (model_cfg, dtype, steps, want, ref_name) in SP_CASES.items():
        ref, perturbed, y = dp_reference(ref_name, model_cfg, dtype, steps, dev)
        got = [r[name] for r in ranks]
        checks[name] = dp_check(f"(18{label}) {backend} {SP_MESH} {name}", got, ref, perturbed,
                                y, want, dtype, logits=sp_logits(got))
    halo = [r["halo"]["ms_median"] for r in ranks]
    print(f"data x space (18{label}): halo exchange of {list(SP_HALO)} fp32 (one row each "
          f"way), median ms per rank {[round(h, 3) for h in halo]}", flush=True)
    return checks, {"shape": list(SP_HALO), "ms_median_per_rank": halo}


def phase_space_parallel(dev) -> dict:
    """Phase 18: the 2-D data x space mesh. (a) NCCL, a card a rank, where
    four cards are visible; (b) TimeUNet fp32 on the kernel pair, (c) U-TAE
    fp32 with remat conv_out and (d) TimeUNet bf16 (the loss and statistics)
    over four gloo ranks on cuda:0, each rank launching its pair once a
    step, against phase 17's one-process steps; (e) ``dryrun_multichip(2)``
    (its two 2-D blocks on a (1, 2) mesh), on two cards, or on the CPU's
    gloo processes where one card is visible. Each part's seconds."""
    from crop2seg_tpu_torch import graft_entry

    out, seconds = {"checks": {}}, {}
    start = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards >= 4:
        checks, out["nccl_halo"] = sp_cases(dev, "nccl", "a")
        out["checks"].update({"nccl " + k: v for k, v in checks.items()})
    else:
        print(f"data x space (18a): the NCCL mesh across cards was not run: {cards} card "
              "is visible, and NCCL refuses two ranks on one device", flush=True)
    seconds["a"] = time.perf_counter() - start
    start = time.perf_counter()
    checks, out["gloo_halo"] = sp_cases(dev, "gloo", "b-d")
    out["checks"].update(checks)
    seconds["bcd"] = time.perf_counter() - start
    start = time.perf_counter()
    where = "cuda" if cards >= 2 else "cpu"
    print(f"data x space (18e): dryrun_multichip(2) on the {where}", flush=True)
    out["dryrun"] = graft_entry.dryrun_multichip(2, device=where)
    check("dp_sp_losses" in out["dryrun"] and "pair_sp_losses" in out["dryrun"],
          f"dryrun_multichip(2) ran no 2-D block: {sorted(out['dryrun'])}")
    seconds["e"] = time.perf_counter() - start
    out["seconds"] = seconds
    print(f"phase 18: seconds {json.dumps(seconds)}", flush=True)
    return out


# phase 19: the rest of the zoo on the 2-D data x space mesh (parallel/mesh.py),
# the boundary loss and test_region, on phase 17's global batch, each case
# against one process's step on the global batch, run first and freed before
# the ranks start
SZ_CFG = StepConfig(num_classes=N_CLASSES, class_weights=(1.0,) * (N_CLASSES - 1) + (0.0,))
SZ_CASES = {
    # name: (model config, steps, launches by variant a rank a step, StepConfig,
    # T, the modules whose outputs the gradient yardstick perturbs (every
    # recurrent conv, at each cell step: one stream's alone leaves the other's
    # gradients unmoved), the widest conv's input on a rank (its halo timed:
    # shape, H axis))
    "timeunet_v2": ({"model": "timeunet_v2"}, 1, {}, SZ_CFG, T,
                    ("temporal_encoder_full_resolution",), ((2 * T, 64, 128, 64), 1)),
    "unet3d": ({"model": "unet3d"}, 1, {}, SZ_CFG, T, ("en3",), ((2, T, 64, 128, 32), 2)),
    "convlstm": ({"model": "convlstm"}, 1, {}, SZ_CFG, T,
                 ("convlstm_encoder.cell_list.0.conv",), ((2, 64, 128, 170), 1)),
    "bconvlstm": ({"model": "bconvlstm"}, 1, {}, SZ_CFG, T,
                  ("convlstm_forward.cell_list.0.conv", "convlstm_backward.cell_list.0.conv"),
                  ((2, 64, 128, 170), 1)),
    "convgru": ({"model": "convgru"}, 1, {}, SZ_CFG, T,
                ("convgru_encoder.cell_list.0.in_conv", "convgru_encoder.cell_list.0.out_conv"),
                ((2, 64, 128, 190), 1)),
    "uconvlstm": ({"model": "uconvlstm"}, 1, {}, SZ_CFG, T,
                  ("temporal_encoder.cell_list.0.conv",), ((2 * T, 64, 128, 64), 1)),
    "unet_naive": ({"model": "unet_naive", "max_temp": T}, 1, {}, SZ_CFG, T, ("in_conv",),
                   ((2, 64, 128, 10 * T), 1)),
    "utae boundary loss": ({"model": "utae", "add_boundary_loss": True}, 1, {},
                           dataclasses.replace(SZ_CFG, add_boundary_loss=True), T,
                           ("temporal_encoder",), ((2 * T, 64, 128, 64), 1)),
    "timeunet test_region boundary": (
        {"model": "timeunet"}, 2, {lp.variant(True, torch.float32, d): 1 for d in ("fwd", "bwd")},
        dataclasses.replace(SZ_CFG, test_region="boundary"), T, ("temporal_encoder",),
        ((2 * T, 64, 128, 64), 1)),
}


def sz_model(model_cfg: dict, dev):
    """A phase 19 model: the factory's defaults (BConvLSTMSeg, which no
    factory name builds, at ConvLSTM's widths), weights drawn from DP_SEED,
    every dropout rate at 0 (the ranks draw their own masks)."""
    from crop2seg_tpu_torch.models import BConvLSTMSeg
    from crop2seg_tpu_torch.nn.tae2d import TAE2d

    gen = torch.Generator().manual_seed(DP_SEED)
    if model_cfg["model"] == "bconvlstm":
        model = init_weights(BConvLSTMSeg(N_CLASSES, 10, 160), gen).to(dev)
    else:
        model = get_model(model_cfg, device=dev, generator=gen)
    for m in model.modules():
        if isinstance(m, LTAE):
            m.attn_dropout = 0.0
            m.mlp[1].p = 0.0
        elif isinstance(m, TAE2d):
            m.dropout = m.attn_dropout = 0.0
            for stage in m.attention_heads:
                if hasattr(stage, "dropout"):
                    stage.dropout = 0.0
    return model


def sz_reference(case: tuple, dev) -> tuple:
    """One process's first step on the global batch, the same step with the
    case's modules' outputs perturbed by GRAD_EPS (the yardstick), and the
    global labels as the step scores them (``test_region``'s relabelling)."""
    from crop2seg_tpu_torch.learning.trainer import region_target

    model_cfg, steps, _, cfg, t, hooked, _ = case
    out = []
    for eps in (0.0, GRAD_EPS):
        model = sz_model(model_cfg, dev)
        for name in hooked if eps else ():
            model.get_submodule(name).register_forward_hook(perturb_hook(eps, dev))
        batch = train_batch(DP_B, torch.Generator(device=dev).manual_seed(DP_SEED), dev, t)
        step = make_train_step(model, cfg)
        out.append(dp_step_record(model, step, batch, torch.Generator(device=dev).manual_seed(
            DP_SEED), steps if not eps else 1))
        del model, step
        torch.cuda.empty_cache()
    y = batch["y"]
    return out[0], out[1]["grads"], region_target(cfg, y).cpu(), y.cpu()


def sz_rank(rank: int, world: int, store_dir: str, backend: str, cases: list) -> dict:
    """One rank of phase 19: ``cases`` (name, model config, steps,
    StepConfig, T) on the SP_MESH mesh, each rank its shard_batch_2d of
    phase 17's global batch (T steps) on cuda:rank (NCCL) or, with gloo, on
    cuda:0 (``dp_step_record``); and per case the ms of a halo exchange (one
    row each way) of its widest conv's input."""
    from crop2seg_tpu_torch.nn.layers import space_halo
    from crop2seg_tpu_torch.parallel import (
        data_space_parallel_step, init_group, make_mesh_2d, rank_seed, replicate,
        shard_batch_2d)

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    group = init_group(rank, world, store_dir, dev, backend=backend)
    mesh = make_mesh_2d(*SP_MESH, group)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, model_cfg, steps, cfg, t, (shape, axis) in cases:
        model = replicate(sz_model(model_cfg, dev), group)
        batch = train_batch(DP_B, torch.Generator(device=dev).manual_seed(DP_SEED), dev, t)
        step = data_space_parallel_step(model, cfg, mesh, device=dev)
        gen = torch.Generator(device=dev).manual_seed(rank_seed(DP_SEED, rank))
        out[name] = dp_step_record(model, step, shard_batch_2d(batch, mesh, model), gen, steps)
        del model, step, batch
        torch.cuda.empty_cache()
        x = torch.randn(shape, device=dev)
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            space_halo(x, 1, mesh.space_group, axis)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name]["halo"] = {"shape": list(shape), "ms_median": float(np.median(times[1:]))}
        del x
    return out


def sz_boundary_check(label: str, ranks: list, ref: dict, logits_b, y) -> dict:
    """The boundary head's loss and matrix: every rank's loss_b within the
    fp32 tolerance of one process's, cm_b its logits' and equal to one
    process's but where the one-process boundary logits' top two are within
    the tie (fp32 sums in another order)."""
    from crop2seg_tpu_torch.learning.metrics import confusion_matrix
    from crop2seg_tpu_torch.ops.boundary import boundary_mask

    tol = DP_TOL[torch.float32]
    y_b = boundary_mask(y, N_CLASSES)
    loss_rel = max(abs(r["loss_b"] - ref["loss_b"]) / abs(ref["loss_b"]) for r in ranks)
    top = ref["logits_b"].topk(2, dim=-1).values
    tie = (top[..., 0] - top[..., 1]) <= tol["tie"]
    bad = int(((logits_b.argmax(-1) != ref["logits_b"].argmax(-1)) & ~tie).sum())
    equal = all(torch.equal(r["cm_b"], ref["cm_b"]) for r in ranks)
    print(f"data x space (19) {label}: loss_b {ranks[0]['loss_b']!r} vs one process "
          f"{ref['loss_b']!r} (relative {loss_rel:.3e}); cm_b {'equal' if equal else 'differs'}, "
          f"{bad} boundary argmax pixels differ beyond a tie of {tol['tie']} "
          f"({int(tie.sum())} within it)", flush=True)
    check(torch.equal(ranks[0]["cm_b"], confusion_matrix(logits_b.argmax(-1), y_b, 2)),
          f"{label}: the group's cm_b is not its ranks' boundary predictions'")
    check(bad == 0, f"{label}: {bad} boundary predictions differ beyond a tie")
    check(loss_rel <= tol["loss"], f"{label}: loss_b relative {loss_rel:.3e}")
    return {"loss_b": ranks[0]["loss_b"], "loss_b_rel": loss_rel, "cm_b_equal": equal}


def sz_cases(dev, backend: str, label: str) -> tuple:
    """SZ_CASES over four ranks (gloo on cuda:0, or NCCL a card), each
    against one process's step on the global batch (``dp_check``, and
    ``sz_boundary_check`` for the boundary head); the one-process steps run
    first, and are freed before the ranks start. The checks and each case's
    halo exchange ms per rank."""
    from crop2seg_tpu_torch.parallel import run_workers

    refs = {name: sz_reference(case, dev) for name, case in SZ_CASES.items()}
    torch.cuda.empty_cache()
    world = SP_MESH[0] * SP_MESH[1]
    ranks = run_workers(sz_rank, world, backend,
                        [(n, c[0], c[1], c[3], c[4], c[6]) for n, c in SZ_CASES.items()])
    checks, halos = {}, {}
    for name, (model_cfg, steps, want, cfg, t, hooked, _) in SZ_CASES.items():
        ref, perturbed, y_m, y = refs[name]
        got = [r[name] for r in ranks]
        res = dp_check(f"(19{label}) {backend} {SP_MESH} {name}", got, ref, perturbed, y_m,
                       want, logits=sp_logits(got), what=" and ".join(hooked) + "'s outputs")
        if "logits_b" in ref:
            res.update(sz_boundary_check(name, got, ref, sp_logits(
                [{"logits": r["logits_b"]} for r in got]), y))
        res.update(t=t, perturbed=list(hooked))
        checks[name] = res
        halos[name] = {"shape": got[0]["halo"]["shape"],
                       "ms_median_per_rank": [r["halo"]["ms_median"] for r in got]}
        print(f"data x space (19{label}) {name}: halo exchange of {halos[name]['shape']} fp32 "
              f"(one row each way), median ms per rank "
              f"{[round(h, 3) for h in halos[name]['ms_median_per_rank']]}", flush=True)
    return checks, halos


def phase_space_zoo(dev) -> dict:
    """Phase 19: the rest of the zoo on the 2-D data x space mesh, the
    boundary loss and test_region. (a) NCCL, a card a rank, where four cards
    are visible; (b) over four gloo ranks on cuda:0: TimeUNet_v2, UNet3D,
    ConvLSTM, BConvLSTM, ConvGRU, uconvlstm and U-Net naive at the factory's
    widths, U-TAE with its boundary head and the boundary loss, and
    TimeUNet on the tail pair with test_region "boundary" (each rank
    launching the pair once a step), fp32, dropout 0, each against one
    process's step on phase 17's global batch (``sz_cases``). Each part's
    seconds."""
    out, seconds = {"checks": {}}, {}
    start = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards >= 4:
        checks, out["nccl_halo"] = sz_cases(dev, "nccl", "a")
        out["checks"].update({"nccl " + k: v for k, v in checks.items()})
    else:
        print(f"data x space (19a): the NCCL mesh across cards was not run: {cards} card "
              "is visible, and NCCL refuses two ranks on one device", flush=True)
    seconds["a"] = time.perf_counter() - start
    start = time.perf_counter()
    checks, out["gloo_halo"] = sz_cases(dev, "gloo", "b")
    out["checks"].update(checks)
    seconds["b"] = time.perf_counter() - start
    out["seconds"] = seconds
    print(f"phase 19: seconds {json.dumps(seconds)}", flush=True)
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
    libs = _build.build_all(["ltae_fused_fwd", "ltae_pool", "ltae_stages",
                             "temporal_aggregate"])
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
    launches, pps_bf16, pps_fp32, _, _ = phase_main_path(model, dev)
    del model
    torch.cuda.empty_cache()
    pool_launches, runs = phase_train(dev)
    utae = get_model({"model": "utae"}, generator=torch.Generator().manual_seed(0))
    utae_errs, utae_t = phase_kernel_utae(utae, dev)
    stages = phase_stages(dev)
    entry_launches, utae_launches, utae_pps, utae_pps32, agg_launches = phase_utae(utae, dev)
    agg = phase_aggregate(dev)
    timeunet = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    models = {"utae": utae, "timeunet": timeunet}
    q_errs, q_t, q_launches = phase_kernel_queries(models, dev)
    gen_t = phase_general_timing(models, dev)
    torch.cuda.empty_cache()
    gen_launches, gen_errs, gen_train, pad_value_errs, year = phase_routing(models, dev)
    del utae, timeunet, models
    torch.cuda.empty_cache()
    utae_runs, remat_worst = phase_plain_train(
        dev, "utae", ("temporal_encoder.mlp.2.running_mean", "up_blocks.0.up.1.running_var",
                      "out_conv.conv.conv.1.running_mean"), aggregate_per_step=3)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as cli_tmp:
        cli_data = os.path.join(cli_tmp, "data")
        cli_out = phase_train_cli(dev, cli_data)
        torch.cuda.empty_cache()
        serving = phase_serving_from_disk(dev, cli_out)
        torch.cuda.empty_cache()
        variants = phase_variants(dev, cli_data, cli_tmp)
        torch.cuda.empty_cache()
        zoo = phase_zoo(dev, cli_data, cli_tmp)
        torch.cuda.empty_cache()
        pastis = phase_pastis(dev, cli_tmp)
        torch.cuda.empty_cache()
        dp = phase_data_parallel(dev, cli_data, cli_tmp)
        torch.cuda.empty_cache()
        sp = phase_space_parallel(dev)
        torch.cuda.empty_cache()
        sz = phase_space_zoo(dev)

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
    # the skip aggregator's pair: the port's own kernels (the JAX package
    # sums the skips in XLA), launched by U-TAE's tile (phase 6) and its
    # training runs (phase 12)
    aggregate = []
    for i, direction in enumerate(("fwd", "bwd")):
        aggregate.append({
            "name": f"temporal_aggregate_{direction}", "route": "cuda",
            "source": "crop2seg_tpu_torch/csrc/temporal_aggregate.cu",
            "replaces": "crop2seg_tpu_torch/ops/aggregate.py::weighted_sum_reference",
            "kernel": f"agg_{direction}_vec<Tin, L> (agg_{direction}_gen off the vector route)",
            "launches": agg_launches if direction == "fwd" else 0,
            "launches_train": {k: r["aggregate_launches"][i] for k, r in utae_runs.items()},
            "max_abs_err": agg["worst"]["out" if direction == "fwd" else "dw"],
            "ms": agg["timings"]["pair"][i], "plain_ms": agg["timings"]["plain"][i],
            "bound_ms": agg["bound_ms"][i], "bound_by": "bytes",
            "library_ms": agg["timings"]["library"][i],
            "dtype": "bfloat16", "shape": agg["shape"], "k": agg["k"],
        })
    aggregate[1].update(max_abs_err_dx=agg["worst"]["dx"],
                        dw_worst_ratio_to_bound=agg["worst"]["dw_ratio"])
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
    tu = variants["timeunet"]
    kernel["launches_conv_variants"] = sum(r["launches"].get("eval_group", 0)
                                           for r in tu.values())
    kernel["untailed"] = variants["untailed_timing"]
    kernel_utae["launches_mbconv"] = (variants["utae_mbconv"]["launches"]["eval_wide"]
                                      + variants["cli"]["eval_wide_launches"])
    for entry in pool:
        entry["launches_conv_variants"] = sum(
            r[f"train_{d}"]["launches"].get(entry["name"], 0)
            for r in tu.values() for d in ("fp32", "bf16"))
    print("variants " + json.dumps(variants), flush=True)
    # phase 15's paths launched no kernel (zoo_tile, timeunet_v2_train and
    # one_train_step check each path's counts; cli_run the CLI's)
    counts = [zoo["timeunet_v2_tile"]["launches"][d] for d in ("bf16", "fp32")]
    for z in zoo["zoo"].values():
        counts += [z["launches"]["bf16"], z["launches"]["fp32"], z["train_step"]["launches"]]
    zoo_launches = sum(sum(c.values()) for c in counts)
    for entry in [kernel, kernel_utae] + pool + [kernel_stages, kernel_q] + general:
        entry["launches_timeunet_v2_and_zoo"] = zoo_launches
    print("zoo " + json.dumps(zoo), flush=True)
    # phase 16: the PASTIS runs' launches by route and variant; the chunked
    # L-TAE and the M10b modules launched none (chunked_ltae and
    # m10b_modules check it)
    pastis_launches = pastis["cli"]["launches"]
    kernel["launches_pastis"] = pastis_launches.get("eval_group", 0)
    kernel_utae["launches_pastis"] = pastis_launches.get("eval_wide", 0)
    for entry in pool:
        entry["launches_pastis"] = pastis_launches.get(entry["name"], 0)
    for entry in [kernel_stages, kernel_q] + general:
        entry["launches_pastis"] = 0
    for entry in [kernel, kernel_utae] + pool + [kernel_stages, kernel_q] + general:
        entry["launches_chunked_and_m10b"] = 0
    print("pastis " + json.dumps(pastis), flush=True)
    # phase 17: the eval kernel's tile launches (one card and the mesh), U-TAE's
    # entry forward, the ranks' pair launches (their counts sent back)
    kernel["launches_data_parallel"] = sum(
        t["launches_mesh"] + t["launches_one_device"] for t in dp["tiles"].values())
    kernel_utae["launches_data_parallel"] = dp["entry_launches"].get("wide", 0)
    by_variant = collections.Counter()
    for c in dp["checks"].values():
        by_variant.update(c["launches_by_variant"])
    for entry in pool:
        entry["launches_data_parallel"] = by_variant.get(entry["name"], 0)
    for entry in [kernel_stages, kernel_q] + general:
        entry["launches_data_parallel"] = 0
    print("data_parallel " + json.dumps(dp), flush=True)
    # phase 18: the ranks' pair launches on the 2-D mesh (their counts sent back)
    by_variant = collections.Counter()
    for c in sp["checks"].values():
        by_variant.update(c["launches_by_variant"])
    for entry in pool:
        entry["launches_space_parallel"] = by_variant.get(entry["name"], 0)
    for entry in [kernel, kernel_utae, kernel_stages, kernel_q] + general:
        entry["launches_space_parallel"] = 0
    print("space_parallel " + json.dumps(sp), flush=True)
    # phase 19: the ranks' pair launches on the zoo's 2-D mesh (their counts
    # sent back; only TimeUNet's test_region case reaches the pair)
    by_variant = collections.Counter()
    for c in sz["checks"].values():
        by_variant.update(c["launches_by_variant"])
    for entry in pool:
        entry["launches_space_zoo"] = by_variant.get(entry["name"], 0)
    for entry in [kernel, kernel_utae, kernel_stages, kernel_q] + general:
        entry["launches_space_zoo"] = 0
    print("space_zoo " + json.dumps(sz), flush=True)
    print(f"chip_smoke.py ran {time.perf_counter() - start:.1f} s, the build included",
          flush=True)
    print(json.dumps({"kernels": [kernel, kernel_utae] + pool + [kernel_stages, kernel_q]
                      + general + aggregate}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
