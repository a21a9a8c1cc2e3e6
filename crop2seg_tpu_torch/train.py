"""Training / evaluation CLI of crop2seg_tpu_torch (the counterpart of the
JAX package's train.py, with its flags and its files):

    python -m crop2seg_tpu_torch.train --dataset synthetic --model timeunet \\
        --bf16 --epochs 2 --res_dir results       # on the CUDA card
    python -m crop2seg_tpu_torch.train ... --device cpu   # on the CPU

``--dataset`` reads S2TSCzCrop (``s2tsczcrops``), a synthetic dataset in
its layout (``synthetic``) or PASTIS (``pastis``): PASTIS runs its five-fold
protocol, all five folds in turn (train on three, validate on one, test on
one: ``PASTIS_FOLD_SEQUENCE``) unless ``--fold`` or ``--test`` names one,
each normalized by its training folds' statistics.

It trains, validates every ``--val_every`` epochs after ``--val_after``,
keeps the ``--keep_ckpts`` best checkpoints by val mIoU, reloads the best,
tests it (``--test_region``) and aggregates the test confusion matrices over
the folds. ``--weight_folder`` resumes a run it wrote (the model, Adam's
moments and step count, the epoch and the trainlog), tests it (``--test``)
or fine-tunes from it (``--finetune``: every leaf whose shape matches, the
rest freshly initialized). It writes conf.json, Fold_k/trainlog.json,
Fold_k/{region}_test_metrics.json, Fold_k/{region}_conf_mat.pkl and
{region}_overall.json / {region}_per_class.json.

``--model`` takes every name of the JAX CLI's: utae, wtae, timeunet
(timeunet_v1), timeunet_v2, unet3d, convlstm, convgru, uconvlstm and
unet_naive; unet_naive needs ``--max_temp``, the T its batches are padded
to (``--t_buckets [61] --max_temp 61``, as in the JAX package).

The L-TAE's routes follow ``--use_pallas`` and ``--use_pallas_train`` as in
the JAX CLI: ``--use_pallas auto`` (the default) is on for ``--device cuda``
and off for the CPU, and U-TAE's and TimeUNet's val and test steps then run
the eval kernel; ``--use_pallas_train`` (off unless given) trains
TimeUNet's L-TAE on the kernel pair, and without it TimeUNet trains on the
plain ops, or streamed over T with ``--seq_chunk`` (``LTAE._chunked``), as
the JAX CLI trains on XLA ops. W-TAE's attention-only L-TAE, TimeUNet_v2's
TAE2d and the baselines have no kernel, as in the JAX package.

``--num_devices N`` (N > 1) trains data-parallel: N worker processes (spawn)
in one ``torch.distributed`` group, one a card (``cuda:r``, NCCL) or, with
``--device cpu``, N CPU processes (gloo), rendezvous through a ``FileStore``
in a temporary directory under ``--res_dir``. Each rank reads its rows of
every global batch of ``--batch_size`` (``data/batcher.py``), the step is
the global batch's (``parallel/mesh.py``), and rank 0 alone writes the
run's files and logs. The CUDA sources are built before the workers start.
Flags of features not ported yet raise and name their ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import json
import logging
import math
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from crop2seg_tpu_torch.models.factory import MODELS

log = logging.getLogger("crop2seg_tpu_torch.train")

# --profile's window over the first epoch's train steps: the first step (the
# kernels' build, cuDNN's first use) skipped, one step of the profiler's
# warm-up, then the steps traced (fewer where the epoch ends first)
PROFILE_SKIP, PROFILE_WARMUP, PROFILE_STEPS = 1, 1, 5

parser = argparse.ArgumentParser(prog="python -m crop2seg_tpu_torch.train")
# model
parser.add_argument("--model", default="utae", type=str,
                    help="utae/wtae/timeunet/timeunet_v2/unet3d/convlstm/convgru/"
                         "uconvlstm/unet_naive")
parser.add_argument("--encoder_widths", default="[64,64,64,128]", type=str)
parser.add_argument("--decoder_widths", default="[32,32,64,128]", type=str)
parser.add_argument("--out_conv", default="[32, 15]")
parser.add_argument("--str_conv_k", default=4, type=int)
parser.add_argument("--str_conv_s", default=2, type=int)
parser.add_argument("--str_conv_p", default=1, type=int)
parser.add_argument("--agg_mode", default="att_group", type=str)
parser.add_argument("--encoder_norm", default="group", type=str)
parser.add_argument("--n_head", default=16, type=int)
parser.add_argument("--d_model", default=256, type=int)
parser.add_argument("--d_k", default=4, type=int)
parser.add_argument("--input_dim", default=10, type=int)
parser.add_argument("--num_queries", default=1, type=int)
parser.add_argument("--temporal_dropout", default=0., type=float)
parser.add_argument("--augment", action="store_true")
parser.add_argument("--add_linear", action="store_true")
parser.add_argument("--add_boundary_loss", action="store_true")
parser.add_argument("--get_affine", action="store_true")
parser.add_argument("--max_temp", default=None, type=int)
parser.add_argument("--dataset", default="s2tsczcrops", type=str,
                    help="s2tsczcrops/pastis/synthetic")
# set-up
parser.add_argument("--test", action="store_true")
parser.add_argument("--test_region", default="all")
parser.add_argument("--finetune", action="store_true")
parser.add_argument("--dataset_folder", default="", type=str)
parser.add_argument("--norm_values_folder", default="", type=str)
parser.add_argument("--weight_folder", default=None, type=str)
parser.add_argument("--res_dir", default="./results", type=str)
parser.add_argument("--rdm_seed", default=1, type=int)
parser.add_argument("--device", default="cuda", type=str,
                    help="the torch device: the CUDA card by default, 'cpu' "
                         "to run on the CPU")
parser.add_argument("--display_step", default=50, type=int)
parser.add_argument("--cache", dest="cache", action="store_true")
# training
parser.add_argument("--epochs", default=25, type=int)
parser.add_argument("--batch_size", default=4, type=int)
parser.add_argument("--lr", default=0.001, type=float)
parser.add_argument("--mono_date", default=None, type=str)
parser.add_argument("--ref_date", default="2018-09-01", type=str)
parser.add_argument("--fold", default=None, type=int)
parser.add_argument("--num_classes", default=15, type=int)
parser.add_argument("--ignore_index", default=-1, type=int)
parser.add_argument("--pad_value", default=0, type=float)
parser.add_argument("--padding_mode", default="reflect", type=str)
parser.add_argument("--conv_type", default="2d", type=str)
parser.add_argument("--use_mbconv", action="store_true")
parser.add_argument("--add_squeeze", action="store_true")
parser.add_argument("--use_doy", action="store_true")
parser.add_argument("--add_ndvi", action="store_true")
parser.add_argument("--use_abs_rel_enc", action="store_true")
parser.add_argument("--label_smoothing", default=0.0, type=float)
parser.add_argument("--val_every", default=1, type=int)
parser.add_argument("--val_after", default=0, type=int)
parser.add_argument("--keep_ckpts", default=3, type=int,
                    help="keep the k best checkpoints by val mIoU "
                         "(model.ckpt points at the best)")
parser.add_argument("--t_buckets", default="[32,48,61]", type=str,
                    help="the fixed T buckets batches are padded to")
parser.add_argument("--bf16", action="store_true",
                    help="bf16 compute under autocast (parameters and Adam "
                         "state stay fp32)")
parser.add_argument("--remat", action="store_true",
                    help="activation checkpointing of the conv blocks "
                         "(recomputed in the backward pass); it lowers "
                         "U-TAE's peak memory, not TimeUNet's (its peak is "
                         "in_conv's backward, which is not recomputed)")
parser.add_argument("--remat_policy", default="conv_out",
                    choices=["conv_out", "full"],
                    help="U-TAE with --remat: 'conv_out' keeps each "
                         "convolution's output, 'full' recomputes everything")
parser.add_argument("--num_devices", default=None, type=int,
                    help="data-parallel over N processes: N cards (NCCL), or "
                         "N CPU processes with --device cpu (gloo)")
parser.add_argument("--platform", default=None, type=str,
                    help="the JAX package's device pin; here --device")
parser.add_argument("--profile", default=None, type=str, metavar="DIR",
                    help=f"trace train steps {PROFILE_SKIP + PROFILE_WARMUP + 1}-"
                         f"{PROFILE_SKIP + PROFILE_WARMUP + PROFILE_STEPS} of the "
                         "first epoch with torch.profiler (step 1 builds the "
                         "kernels and meets cuDNN's first use, step 2 starts the "
                         "profiler): the chrome trace into DIR/trace.json, "
                         "the program's spans and counters into DIR/spans.json")
parser.add_argument("--use_pallas", default="auto", type=str,
                    choices=("auto", "true", "false"),
                    help="the eval L-TAE kernel on the val and test steps "
                         "(U-TAE, TimeUNet); 'auto' = on for --device cuda, "
                         "off for the CPU")
parser.add_argument("--use_pallas_train", action="store_true",
                    help="TimeUNet trains its L-TAE on the kernel pair; "
                         "without it on the plain ops (or --seq_chunk)")
parser.add_argument("--seq_chunk", default=None, type=int,
                    help="TimeUNet's L-TAE streamed over T in chunks of this "
                         "many steps with an online softmax, where no kernel "
                         "route takes it (training without "
                         "--use_pallas_train)")
parser.add_argument("--synthetic_patches", default=12, type=int)
parser.add_argument("--freeze_layers", default=None, type=str,
                    help="comma-separated module-path prefixes of the JAX "
                         "model to freeze, e.g. 'in_conv,down' freezes the "
                         "spatial encoder")
parser.add_argument("--use_weighted_sampling", action="store_true",
                    help="weighted sampling with replacement by the "
                         "metadata's 'weight' field")
parser.add_argument("--device_cache", action="store_true",
                    help="keep the train and val batches on the device after "
                         "epoch 1 (later epochs gather fresh shuffles there; "
                         "augmentation frozen at its epoch-1 draw)")

LIST_ARGS = ("encoder_widths", "decoder_widths", "out_conv", "t_buckets")
BOUNDARY_MODELS = ("utae", "wtae")


def parse_config(argv=None):
    config = parser.parse_args(argv)
    for name in LIST_ARGS:
        v = getattr(config, name)
        if isinstance(v, str):
            setattr(config, name, list(ast.literal_eval(v)))
    return config


def model_config(config, dev: torch.device) -> dict:
    """The factory's config of a run: the CLI's flags with ``--use_pallas``
    resolved on ``dev`` (``models/factory.py::resolve_use_pallas``, the JAX
    CLI's ``resolve_use_pallas``) and ``--use_pallas_train`` as given."""
    from crop2seg_tpu_torch.models.factory import resolve_use_pallas

    cfg = dict(vars(config))
    cfg["use_pallas"] = resolve_use_pallas(config.use_pallas, dev)
    cfg["use_pallas_train"] = bool(config.use_pallas_train)
    return cfg


def check_ported(config) -> None:
    """Raise SystemExit, naming the ROADMAP.md item, for every flag whose
    feature the port does not have yet."""
    refusals = [
        (config.model not in MODELS,
         f"--model {config.model}: no such model; the models: {', '.join(MODELS)}"),
        (config.add_boundary_loss and config.model not in BOUNDARY_MODELS,
         f"--add_boundary_loss: --model {config.model} has no boundary head "
         "(U-TAE and W-TAE have)"),
        (config.platform is not None,
         "--platform pins a JAX device; pass --device (cuda, cpu) instead"),
    ]
    for refused, why in refusals:
        if refused:
            raise SystemExit(why)


# PASTIS's five-fold cross-validation: fold k trains on three folds,
# validates on one and tests on one
PASTIS_FOLD_SEQUENCE = (
    ((1, 2, 3), (4,), (5,)),
    ((2, 3, 4), (5,), (1,)),
    ((3, 4, 5), (1,), (2,)),
    ((4, 5, 1), (2,), (3,)),
    ((5, 1, 2), (3,), (4,)),
)


def ensure_synthetic(config) -> str:
    """The synthetic dataset's folder (default ``res_dir/synthetic_data``),
    written there unless one exists."""
    from crop2seg_tpu_torch.data import make_synthetic_dataset

    folder = config.dataset_folder or os.path.join(config.res_dir, "synthetic_data")
    if not os.path.exists(os.path.join(folder, "metadata.json")):
        make_synthetic_dataset(folder, n_patches=config.synthetic_patches)
    return folder


def build_datasets(config):
    """(train, val, test) datasets of ``config.dataset_folder``: the
    S2TSCzCrop reader's sets, with ``--dataset synthetic`` on a synthetic
    dataset written there (default ``res_dir/synthetic_data``) unless one
    exists; with ``--dataset pastis`` the PASTIS reader's folds of
    ``config.fold`` (``PASTIS_FOLD_SEQUENCE``), normalized by the training
    folds' statistics."""
    from crop2seg_tpu_torch.data import S2TSCZCropDataset, Transform, load_norm_values

    folder = ensure_synthetic(config) if config.dataset == "synthetic" else \
        config.dataset_folder
    norm_folder = config.norm_values_folder or folder
    norm_path = os.path.join(norm_folder, "NORM_S2_patch.json")
    common = dict(
        folder=folder, reference_date=config.ref_date, mono_date=config.mono_date,
        use_doy=config.use_doy, use_abs_rel_enc=config.use_abs_rel_enc,
        add_ndvi=config.add_ndvi, cache=config.cache, seed=config.rdm_seed)
    train_tr = Transform() if config.augment else None
    if config.dataset == "pastis":
        from crop2seg_tpu_torch.data.pastis import PASTISDataset

        folds = PASTIS_FOLD_SEQUENCE[(config.fold or 1) - 1]
        norm_values = (load_norm_values(norm_path, folds=folds[0])
                       if os.path.exists(norm_path) else None)

        def mk_pastis(set_type, fold_ids, transform=None, temporal_dropout=0.0):
            return PASTISDataset(set_type=set_type, folds=fold_ids, transform=transform,
                                 temporal_dropout=temporal_dropout,
                                 norm=norm_values is not None, norm_values=norm_values,
                                 **common)
        return (mk_pastis("train", folds[0], train_tr, config.temporal_dropout),
                mk_pastis("val", folds[1]), mk_pastis("test", folds[2]))
    norm_values = load_norm_values(norm_path) if os.path.exists(norm_path) else None

    def mk(set_type, transform=None, temporal_dropout=0.0):
        return S2TSCZCropDataset(set_type=set_type, transform=transform,
                                 temporal_dropout=temporal_dropout,
                                 get_affine=config.get_affine,
                                 norm=norm_values is not None, norm_values=norm_values,
                                 **common)
    return (mk("train", train_tr, config.temporal_dropout), mk("val"), mk("test"))


def merge_pretrained(fresh: Dict[str, torch.Tensor], loaded: Dict[str, torch.Tensor]):
    """Pretrained state merged into a fresh one: each entry of ``fresh``
    takes ``loaded``'s value where the name exists there with the same shape
    and keeps its fresh value elsewhere (a head of another class count).
    Returns (state dict, [names kept fresh])."""
    merged, skipped = {}, []
    for k, v in fresh.items():
        if k not in loaded:
            merged[k] = v
            skipped.append(f"{k} (missing)")
        elif tuple(loaded[k].shape) == tuple(v.shape):
            merged[k] = loaded[k]
        else:
            merged[k] = v
            skipped.append(k)
    return merged, skipped


def sample_weights(dataset) -> Optional[np.ndarray]:
    """The train set's metadata 'weight' field, 1 where a record lacks it or
    holds null / NaN; None when no record has the field."""
    records = [dataset.meta_patch[i] for i in dataset.id_patches]
    if not any("weight" in r for r in records):
        return None
    w = [r.get("weight") for r in records]
    return np.asarray([1.0 if v is None or (isinstance(v, float) and math.isnan(v))
                       else float(v) for v in w], np.float64)


@dataclass
class TrainRun:
    """What ``main`` returns: the test metrics, the trainlog, the first epoch
    this run trained, Adam's step count as restored (None unless resumed
    with optimizer state) and at the end."""
    test_metrics: Dict[str, float]
    trainlog: Dict[int, Dict[str, float]]
    start_epoch: int
    restored_adam_step: Optional[int]
    adam_step: int


def adam_step(optimizer: torch.optim.Optimizer) -> int:
    """Adam's step count (that of its parameters' state; 0 before a step)."""
    steps = {int(s["step"]) for s in optimizer.state.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters disagree on the step count: {steps}")
    return steps.pop() if steps else 0


# config keys a resumed or tested run keeps from its command line instead of
# taking them from the weight folder's conf.json: the JAX CLI's, and the
# device (which the JAX CLI's --device does not choose), so that a run of the
# card can be tested on the CPU
KEEP_ON_RESUME = {"dataset_folder", "norm_values_folder", "res_dir", "weight_folder",
                  "test", "test_region", "finetune", "epochs", "batch_size",
                  "num_devices", "device"}


def main(config) -> TrainRun:
    from crop2seg_tpu_torch.device import resolve_device

    check_ported(config)
    dev = resolve_device(config.device)
    n = config.num_devices or 1
    if n > 1:
        return _main_data_parallel(config, dev, n)
    with _repeatable_backends():
        return _run(config, dev)


def _main_data_parallel(config, dev: torch.device, n: int) -> TrainRun:
    """``--num_devices n``: n spawned workers in one group (``_dp_worker``),
    rank 0's run returned. Refuses, as the JAX CLI does, fewer visible cards
    than n and a batch that does not divide; builds the CUDA sources and
    the native loader, and writes the synthetic dataset, before the workers
    start."""
    from crop2seg_tpu_torch import native
    from crop2seg_tpu_torch.ops import _build
    from crop2seg_tpu_torch.parallel import run_workers

    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"--num_devices {n} but only {torch.cuda.device_count()} "
                         "cuda devices are visible")
    if config.batch_size % n:
        raise SystemExit("--batch_size must be divisible by --num_devices")
    if dev.type == "cuda":
        _build.build_all(["ltae_fused_fwd", "ltae_pool"])
    native.load_library()
    if config.dataset == "synthetic":
        ensure_synthetic(config)
    os.makedirs(config.res_dir, exist_ok=True)
    threads = max(1, torch.get_num_threads() // n) if dev.type == "cpu" else None
    runs = run_workers(_dp_worker, n, config, dev.type, log.getEffectiveLevel(),
                       base_dir=config.res_dir, threads=threads)
    return runs[0]


def _dp_worker(rank: int, world: int, store_dir: str, config, dev_type: str,
               level: int) -> TrainRun:
    """One rank of ``--num_devices``: card ``cuda:rank`` (NCCL) or the CPU
    (gloo); rank 0 logs at the parent's level, the others warnings only."""
    from crop2seg_tpu_torch.parallel import init_group

    logging.basicConfig(level=level if rank == 0 else logging.WARNING,
                        format=f"%(asctime)s [rank {rank}] %(message)s", force=True)
    dev = torch.device(f"cuda:{rank}" if dev_type == "cuda" else "cpu")
    group = init_group(rank, world, store_dir, dev)
    with _repeatable_backends():
        return _run(config, dev, group)


@contextlib.contextmanager
def _repeatable_backends():
    """fp32 means fp32 (no TF32 in convolutions and matmuls), and cuDNN picks
    its algorithms without benchmarking, so a --test rerun repeats a run; the
    process's own settings come back on exit."""
    flags = ((torch.backends.cudnn, "benchmark", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cuda.matmul, "allow_tf32", False))
    saved = [getattr(owner, name) for owner, name, _ in flags]
    for owner, name, value in flags:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for (owner, name, _), value in zip(flags, saved):
            setattr(owner, name, value)


def _run(config, dev: torch.device, group=None) -> TrainRun:
    """One run (a fold) on ``dev``; with ``group`` one rank of a
    data-parallel run: its rows of every batch, the group's steps, and the
    files written by rank 0 alone."""
    from crop2seg_tpu_torch.data import BatchLoader, DeviceCacheLoader, PrefetchLoader
    from crop2seg_tpu_torch.learning import checkpoint as ckpt
    from crop2seg_tpu_torch.learning.trainer import (
        StepConfig, create_train_state, freeze_labels, make_eval_step,
        make_train_step, run_epoch)
    from crop2seg_tpu_torch.learning.weight_init import apply_reference_init
    from crop2seg_tpu_torch.models.factory import get_model
    from crop2seg_tpu_torch.parallel import barrier, rank_seed, replicate

    rank = dist.get_rank(group) if group is not None else 0
    world = dist.get_world_size(group) if group is not None else 1
    writer = rank == 0

    random.seed(config.rdm_seed)
    np.random.seed(config.rdm_seed)
    torch.manual_seed(config.rdm_seed)

    is_test_run = config.test
    fold = config.fold or 1
    config.fold = fold

    # resume / test: conf.json of the weight folder wins; fine-tuning keeps
    # the command line's config (the head and classes may change)
    if config.weight_folder and not config.finetune:
        if os.path.exists(os.path.join(config.weight_folder, "conf.json")):
            for k, v in ckpt.load_conf(config.weight_folder).items():
                if k not in KEEP_ON_RESUME and hasattr(config, k):
                    setattr(config, k, v)
        check_ported(config)

    fold_dir = os.path.join(config.res_dir, f"Fold_{fold}")
    if writer:
        os.makedirs(config.res_dir, exist_ok=True)
        ckpt.prepare_output(config.res_dir, fold)
        ckpt.save_conf(config.res_dir, vars(config))

    dt_train, dt_val, dt_test = build_datasets(config)
    log.info("train/val/test sizes: %d/%d/%d", len(dt_train), len(dt_val), len(dt_test))

    loader_kw = dict(t_buckets=tuple(config.t_buckets), pad_value=config.pad_value)
    if group is not None:
        # each rank its rows of every global batch; a ragged eval batch
        # padded with ignored rows (the JAX CLI's to_host_batch(pad_to=...))
        loader_kw.update(shard=(rank, world),
                         ignore_label=config.ignore_index % config.num_classes)
    weights_s = sample_weights(dt_train) if config.use_weighted_sampling else None
    train_loader = PrefetchLoader(BatchLoader(
        dt_train, config.batch_size, shuffle=True, drop_last=True,
        seed=config.rdm_seed, sample_weights=weights_s, **loader_kw))
    val_loader = BatchLoader(dt_val, config.batch_size, shuffle=False,
                             drop_last=False, **loader_kw)
    test_loader = BatchLoader(dt_test, config.batch_size, shuffle=False,
                              drop_last=False, **loader_kw)
    dtype = torch.bfloat16 if config.bf16 else None
    if config.device_cache and group is not None:
        log.warning("--device_cache is single-device only; ignoring it for the "
                    "%d-rank data-parallel run", world)
    elif config.device_cache:
        if config.augment:
            log.warning("--device_cache freezes augmentation at its epoch-1 "
                        "draw; leave it off for augmented runs")
        if config.use_weighted_sampling:
            log.warning("--device_cache freezes the weighted sampler at its "
                        "epoch-1 draw: later epochs reshuffle that sample set")
        train_loader = DeviceCacheLoader(train_loader, cast=dtype, shuffle=True,
                                         seed=config.rdm_seed, device=dev)
        val_loader = DeviceCacheLoader(val_loader, cast=dtype, shuffle=False, device=dev)
    model = get_model(model_config(config, dev), device=dev)
    init_gen = torch.Generator(device=dev).manual_seed(config.rdm_seed)
    start_epoch, best_miou, trainlog = 1, 0.0, {}
    resume_opt = None
    if config.weight_folder:
        wdir = os.path.join(config.weight_folder, f"Fold_{fold}")
        torch_path = os.path.join(wdir, "model.pth.tar")
        if ckpt.has_state(wdir):
            payload = ckpt.load_state(wdir)
            loaded = payload["model"]
            log.info("restored checkpoint (epoch %s, best %s)",
                     payload["meta"]["epoch"], payload["meta"]["best_mIoU"])
            if not is_test_run and not config.finetune:
                start_epoch = int(payload["meta"]["epoch"]) + 1
                best_miou = float(payload["meta"]["best_mIoU"])
                resume_opt = payload.get("optimizer")
                log_path = os.path.join(wdir, "trainlog.json")
                if os.path.exists(log_path):
                    with open(log_path) as f:
                        trainlog = {int(k): v for k, v in json.load(f).items()}
        elif os.path.exists(torch_path):
            loaded = ckpt.load_torch_checkpoint(torch_path)
            log.info("imported reference torch checkpoint %s", torch_path)
        else:
            raise FileNotFoundError(f"no checkpoint under {config.weight_folder}")
        if config.finetune:
            apply_reference_init(model, init_gen)
            merged, skipped = merge_pretrained(model.state_dict(), loaded)
            model.load_state_dict(merged)
            for name in skipped:
                log.info("finetune: keeping fresh init for %s (shape mismatch)", name)
        else:
            model.load_state_dict(loaded)
    else:
        apply_reference_init(model, init_gen)
    if group is not None:
        replicate(model, group)

    weights = [1.0] * config.num_classes
    weights[config.ignore_index] = 0.0
    step_cfg = StepConfig(
        num_classes=config.num_classes, ignore_index=config.ignore_index,
        class_weights=tuple(weights), label_smoothing=config.label_smoothing,
        add_boundary_loss=config.add_boundary_loss, test_region="all")
    frozen = tuple(p.strip() for p in (config.freeze_layers or "").split(",")
                   if p.strip())
    if frozen:
        labels = freeze_labels(model, frozen)
        log.info("freezing %d/%d parameters (prefixes: %s)",
                 sum(v == "frozen" for v in labels.values()), len(labels),
                 ", ".join(frozen))
    optimizer = create_train_state(model, config.lr, frozen_prefixes=frozen)
    restored_step = None
    if config.weight_folder and not is_test_run and not config.finetune:
        if resume_opt is not None:
            optimizer.load_state_dict(resume_opt)
            restored_step = adam_step(optimizer)
            log.info("restored optimizer state (Adam moments, step %d)", restored_step)
        else:
            log.warning("checkpoint carries no optimizer state (weights "
                        "saved alone); Adam starts fresh")

    train_step = make_train_step(model, step_cfg, optimizer, device=dev, dtype=dtype,
                                 group=group)
    eval_step = make_eval_step(model, step_cfg, device=dev, dtype=dtype, group=group)
    generator = torch.Generator(device=dev).manual_seed(rank_seed(config.rdm_seed, rank))

    if not is_test_run:
        ckptr = ckpt.StateCheckpointer(fold_dir, keep=config.keep_ckpts) if writer else None
        for epoch in range(start_epoch, config.epochs + 1):
            log.info("EPOCH %d/%d", epoch, config.epochs)
            profiling = config.profile and epoch == start_epoch and writer
            with (_profiler(dev, config.profile) if profiling
                  else contextlib.nullcontext()) as prof:
                train_metrics, _ = run_epoch(
                    train_step if prof is None else _profiled(train_step, prof),
                    train_loader, step_cfg, mode="train",
                    generator=generator, display_step=config.display_step,
                    log_fn=log.info)
            n_steps = len(train_loader)
            log.info("epoch %d: %d train steps in %.3f s (%.3f steps/s)", epoch,
                     n_steps, train_metrics["train_epoch_time"],
                     n_steps / max(train_metrics["train_epoch_time"], 1e-9))
            if epoch % config.val_every == 0 and epoch > config.val_after:
                val_metrics, _ = run_epoch(eval_step, val_loader, step_cfg,
                                           mode="val", log_fn=log.info)
                log.info("Loss %.4f, Acc %.2f, IoU %.4f", val_metrics["val_loss"],
                         val_metrics["val_accuracy"], val_metrics["val_IoU"])
                trainlog[epoch] = {**train_metrics, **val_metrics}
                if val_metrics["val_IoU"] >= best_miou:
                    best_miou = val_metrics["val_IoU"]
                    if writer:
                        ckptr.save(model, optimizer, epoch, best_miou)
            else:
                trainlog[epoch] = dict(train_metrics)
            if writer:
                ckpt.checkpoint_log(fold_dir, trainlog)
        if writer:
            ckptr.wait()
        if group is not None:
            barrier(group)      # rank 0's checkpoints are on disk for every rank
        # reload the best (a resumed run that added no better epoch keeps
        # the restored weights)
        if ckpt.has_state(fold_dir):
            model.load_state_dict(ckpt.load_state(fold_dir)["model"])

    log.info("TESTING BEST EPOCH (region=%s)...", config.test_region)
    test_cfg = StepConfig(
        num_classes=config.num_classes, ignore_index=config.ignore_index,
        class_weights=tuple(weights), label_smoothing=config.label_smoothing,
        add_boundary_loss=config.add_boundary_loss, test_region=config.test_region)
    test_step = make_eval_step(model, test_cfg, device=dev, dtype=dtype, group=group)
    test_metrics, cms = run_epoch(test_step, test_loader, test_cfg, mode="test",
                                  log_fn=log.info)
    log.info("test metrics: %s", test_metrics)
    if writer:
        ckpt.save_results(fold_dir, test_metrics, cms, region=config.test_region)
        # aggregate over every Fold_k finished so far
        cm = ckpt.aggregate_fold_cms(config.res_dir, region=config.test_region)
        ign = config.ignore_index % config.num_classes
        cm[:, ign] = 0
        cm[ign, :] = 0
        ckpt.overall_performance(config.res_dir, cm, region=config.test_region)
    return TrainRun(test_metrics, trainlog, start_epoch, restored_step,
                    adam_step(optimizer))


def _profiler(dev: torch.device, out_dir: str):
    """torch.profiler over --profile's window (PROFILE_*); when the window
    ends, the chrome trace and the spans' table go to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from crop2seg_tpu_torch.utils.profiling import reset_spans, span_table

    def write(prof):
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        with open(os.path.join(out_dir, "spans.json"), "w") as f:
            json.dump(span_table(), f, indent=1)
        log.info("profiler trace and spans written to %s", out_dir)

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    reset_spans()
    return profile(activities=activities, on_trace_ready=write,
                   schedule=schedule(skip_first=PROFILE_SKIP, wait=0, warmup=PROFILE_WARMUP,
                                     active=PROFILE_STEPS, repeat=1))


def _profiled(step, prof):
    """``step`` followed by the profiler's step count."""
    def profiled(batch, generator):
        aux = step(batch, generator)
        prof.step()
        return aux
    return profiled


def fold_sequence(config) -> List[int]:
    """The folds to run: PASTIS all five unless ``--fold`` names one (or
    ``--test`` tests one, fold 1 by default); S2TSCzCrop and synthetic have
    one split."""
    if config.test or config.dataset != "pastis":
        return [config.fold or 1]
    return list(range(1, 6)) if config.fold is None else [config.fold]


def cli(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = parse_config(argv)
    t0 = time.time()
    for fold in fold_sequence(cfg):
        cfg.fold = fold
        main(cfg)
    log.info("total time: %.1fs", time.time() - t0)


if __name__ == "__main__":
    cli()
