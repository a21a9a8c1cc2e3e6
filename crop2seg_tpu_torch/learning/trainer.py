"""The training and eval steps and the epoch loop (port of
crop2seg_tpu/learning/trainer.py).

One train step is forward, loss, backward, Adam update and the confusion
matrices, on the card by default, in fp32 or, with ``dtype=torch.bfloat16``,
under ``torch.autocast`` in bf16 with fp32 parameters, fp32 Adam state and the
loss taken on fp32 logits (the JAX train CLI's ``--bf16``; like it, no loss
scaling). With ``StepConfig.add_boundary_loss`` the model returns the
boundary head's logits beside the class logits, and the step adds their focal
loss on the label map's boundary classes (``loss_b``, ``cm_b``);
``test_region`` scores only the boundary or the interior pixels.
``create_train_state`` takes the prefixes of frozen parameters
(``freeze_labels``), and ``run_epoch`` runs an epoch of steps, keeping the
loss and the confusion matrices on the device until its flushes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from crop2seg_tpu_torch.device import resolve_device
from crop2seg_tpu_torch.learning.losses import cross_entropy, focal_cross_entropy
from crop2seg_tpu_torch.learning.metrics import (
    IoUMeter, confusion_matrix, top2_prediction)
from crop2seg_tpu_torch.ops.boundary import boundary_mask


@dataclass(frozen=True)
class StepConfig:
    num_classes: int = 15
    ignore_index: int = -1          # an index into the class axis (may be negative)
    class_weights: Optional[tuple] = None   # an ignored class is weighted 0
    label_smoothing: float = 0.0
    add_boundary_loss: bool = False
    boundary_gamma: float = 2.0
    # score only the 'boundary' or the 'interior' pixels, the others
    # relabelled to the ignore class; 'all' scores every pixel
    test_region: str = "all"


def freeze_labels(model: torch.nn.Module, frozen_prefixes: Sequence[str]
                  ) -> Dict[str, str]:
    """Each parameter name -> "frozen" when the slash-joined flax path of its
    counterpart in the JAX model (``utils/convert.py::flax_param_paths``)
    starts with one of ``frozen_prefixes`` (``in_conv``, ``down``,
    ``temporal_encoder/attention``, ...), else "train": the JAX package's
    ``freeze_labels`` on the same prefixes."""
    from crop2seg_tpu_torch.utils.convert import flax_param_paths

    return {k: ("frozen" if any(p.startswith(f) for f in frozen_prefixes) else "train")
            for k, p in flax_param_paths(model).items()}


def create_train_state(model: torch.nn.Module, learning_rate: float,
                       frozen_prefixes: Sequence[str] = ()) -> torch.optim.Optimizer:
    """Adam with torch defaults (betas 0.9/0.999, eps 1e-8), as the JAX
    package's optax.adam, over the parameters that ``frozen_prefixes`` does
    not freeze (``freeze_labels``): a frozen parameter gets no update and no
    Adam state. BatchNorm's running statistics keep updating everywhere."""
    labels = (freeze_labels(model, tuple(frozen_prefixes)) if frozen_prefixes
              else {})
    params = [p for k, p in model.named_parameters() if labels.get(k) != "frozen"]
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _to(batch: Mapping, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=dev)
            for k in ("x", "dates", "pad_mask", "y")}


def region_target(cfg: StepConfig, y: torch.Tensor) -> torch.Tensor:
    """``y`` with the pixels outside ``cfg.test_region`` relabelled to the
    ignore class (``y`` itself for "all")."""
    if cfg.test_region not in ("boundary", "interior"):
        return y
    ignore_label = cfg.ignore_index % cfg.num_classes
    on_boundary = boundary_mask(y, cfg.num_classes).bool()
    drop = ~on_boundary if cfg.test_region == "boundary" else on_boundary
    return torch.where(drop, torch.full_like(y, ignore_label), y)


def _split_heads(cfg: StepConfig, out):
    """The model's output -> (class logits, boundary logits or None)."""
    if cfg.add_boundary_loss:
        if not isinstance(out, tuple) or len(out) != 2:
            raise ValueError("add_boundary_loss needs a model with a boundary "
                             "head (U-TAE built with add_boundary_loss=True)")
        return out
    if isinstance(out, tuple):
        raise ValueError(
            "the model returns a tuple (a boundary head, or maps or attention "
            "beside the logits): set StepConfig.add_boundary_loss=True for "
            "U-TAE's boundary head (the boundary loss, ROADMAP.md M4), or "
            "build the model without the extra outputs")
    return out, None


def _metrics(cfg: StepConfig, out, y: torch.Tensor, weight: torch.Tensor | None,
             want_pred: bool = False) -> Dict[str, torch.Tensor]:
    logits, logits_b = _split_heads(cfg, out)
    logits = logits.float()
    loss = cross_entropy(logits, y, weight=weight, label_smoothing=cfg.label_smoothing)
    aux = {}
    if logits_b is not None:
        y_b = boundary_mask(y, cfg.num_classes)
        loss_b = focal_cross_entropy(logits_b.float(), y_b, gamma=cfg.boundary_gamma)
        loss = loss + loss_b
        aux["loss_b"] = loss_b.detach()
        aux["cm_b"] = confusion_matrix(logits_b.detach().argmax(-1), y_b, 2)
    with torch.no_grad():
        lg = logits.detach()
        pred = lg.argmax(-1)
        y_m = region_target(cfg, y)
        aux["cm"] = confusion_matrix(pred, y_m, cfg.num_classes)
        aux["cm_top2"] = confusion_matrix(top2_prediction(lg, y_m), y_m, cfg.num_classes)
    aux["loss"] = loss
    if want_pred:
        aux["pred"] = pred
    return aux


def _weight(cfg: StepConfig, dev: torch.device) -> torch.Tensor | None:
    if cfg.class_weights is None:
        return None
    return torch.tensor(cfg.class_weights, dtype=torch.float32, device=dev)


def _autocast(dev: torch.device, dtype: torch.dtype | None):
    """The forward's compute dtype: autocast to ``dtype`` (bf16), or fp32."""
    return torch.autocast(dev.type, dtype=dtype,
                          enabled=dtype is not None and dtype != torch.float32)


def make_train_step(model: torch.nn.Module, cfg: StepConfig,
                    optimizer: torch.optim.Optimizer | None = None,
                    device=None, dtype: torch.dtype | None = None) -> Callable:
    """Returns ``step(batch, generator) -> aux``: one training step of
    ``model`` (moved to ``device``, the CUDA card unless "cpu" is asked for,
    and set to training mode at each step). ``batch`` holds x (B, T, H, W, C), dates
    (B, T), pad_mask (B, T) bool and y (B, H, W), as arrays or tensors
    (x may be bf16 already, as ``DeviceCacheLoader(cast=torch.bfloat16)``
    gives it). ``generator`` (a ``torch.Generator`` on the model's device)
    draws every dropout mask of the step. ``optimizer`` defaults to
    ``create_train_state(model, 1e-3)`` and is exposed as ``step.optimizer``.
    ``dtype``: the forward's compute dtype under autocast (torch.bfloat16);
    None runs fp32. ``aux`` holds the loss and the (K, K) confusion matrices
    ``cm`` and ``cm_top2`` of the step's forward, and with the boundary loss
    ``loss_b`` and the (2, 2) ``cm_b``, all on the device."""
    dev = resolve_device(device)
    model.to(dev)
    if optimizer is None:
        optimizer = create_train_state(model, 1e-3)
    weight = _weight(cfg, dev)

    def step(batch: Mapping, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        b = _to(batch, dev)
        model.zero_grad(set_to_none=True)
        with _autocast(dev, dtype):
            out = model(b["x"], b["dates"], b["pad_mask"], generator=generator)
        aux = _metrics(cfg, out, b["y"], weight)
        aux["loss"].backward()
        optimizer.step()
        aux["loss"] = aux["loss"].detach()
        return aux

    step.optimizer = optimizer
    return step


def make_eval_step(model: torch.nn.Module, cfg: StepConfig,
                   device=None, dtype: torch.dtype | None = None,
                   return_pred: bool = False) -> Callable:
    """Returns ``step(batch) -> aux`` (loss, cm, cm_top2; with the boundary
    loss also loss_b and cm_b) of ``model`` in eval mode on ``device``: the
    served path, so on the card the fused eval L-TAE kernel runs. ``dtype``
    as in ``make_train_step``. ``return_pred`` adds the (B, H, W) argmax
    ``pred`` of the same forward."""
    dev = resolve_device(device)
    weight = _weight(cfg, dev)

    def step(batch: Mapping) -> Dict[str, torch.Tensor]:
        model.to(dev).eval()
        b = _to(batch, dev)
        with torch.inference_mode():
            with _autocast(dev, dtype):
                out = model(b["x"], b["dates"], b["pad_mask"])
            return _metrics(cfg, out, b["y"], weight, want_pred=return_pred)

    return step


def run_epoch(step_fn: Callable, loader: Iterable, cfg: StepConfig,
              mode: str = "train", generator: torch.Generator | None = None,
              display_step: int = 50, log_fn=print,
              homogenizer: Optional[Callable] = None) -> tuple:
    """One epoch of ``step_fn`` over ``loader``'s batches: ``step_fn(batch,
    generator)`` in "train" mode, ``step_fn(batch)`` otherwise. Returns
    (metrics, cms): ``{mode}_accuracy``, ``_accuracy_top2``, ``_loss``,
    ``_IoU``, ``_IoU_top2``, ``_epoch_time`` (and ``_accuracy_b``,
    ``_IoU_b`` with the boundary loss), and the summed confusion matrices
    {"top1", "top2"[, "boundary"]} as int64 numpy arrays.

    The loss and the confusion matrices are summed on the device and read
    on the host only every ``display_step`` batches and at the end, so a
    step waits for no copy to the host. ``homogenizer(pred (B, H, W) numpy,
    batch) -> (B, H, W)`` rewrites the predictions before they enter the
    confusion matrix (the get_affine evaluation; the eval step is built with
    ``return_pred=True``), with ``cfg.test_region``'s relabelling of y."""
    ignore = (None if cfg.ignore_index is None
              else cfg.ignore_index % cfg.num_classes)
    meter = IoUMeter(cfg.num_classes, ignore)
    meter2 = IoUMeter(cfg.num_classes, ignore)
    meter_b = IoUMeter(2) if cfg.add_boundary_loss else None
    losses_sum, n_batches = 0.0, 0
    acc_keys = ("loss", "cm", "cm_top2") + (("cm_b",) if meter_b is not None else ())
    acc = None

    def flush():
        nonlocal acc, losses_sum
        if acc is None:
            return
        losses_sum += float(acc["loss"])
        meter.add_cm(acc["cm"])
        meter2.add_cm(acc["cm_top2"])
        if meter_b is not None:
            meter_b.add_cm(acc["cm_b"])
        acc = None

    t0 = time.time()
    for i, batch in enumerate(loader):
        aux = step_fn(batch, generator) if mode == "train" else step_fn(batch)
        if homogenizer is not None and "pred" in aux:
            # the predictions round-trip through the host here anyway
            pred_h = homogenizer(aux["pred"].cpu().numpy(), batch)
            dev = aux["cm"].device
            y_m = region_target(cfg, torch.as_tensor(batch["y"], device=dev))
            aux = dict(aux)
            aux["cm"] = confusion_matrix(torch.as_tensor(np.asarray(pred_h), device=dev),
                                         y_m, cfg.num_classes)
        step_vals = {k: aux[k] for k in acc_keys}
        acc = step_vals if acc is None else {k: acc[k] + step_vals[k] for k in acc_keys}
        n_batches += 1
        if (i + 1) % display_step == 0:
            flush()
            miou, acc_pct = meter.get_miou_acc()
            log_fn(f"Step [{i + 1}], Loss: {losses_sum / n_batches:.4f}, "
                   f"Acc: {acc_pct:.2f}, mIoU: {miou:.2f}")
    flush()
    total_time = time.time() - t0
    miou, acc_pct = meter.get_miou_acc()
    miou2, acc2 = meter2.get_miou_acc()
    metrics = {
        f"{mode}_accuracy": acc_pct,
        f"{mode}_accuracy_top2": acc2,
        f"{mode}_loss": losses_sum / max(n_batches, 1),
        f"{mode}_IoU": miou,
        f"{mode}_IoU_top2": miou2,
        f"{mode}_epoch_time": total_time,
    }
    cms = {"top1": meter.cm, "top2": meter2.cm}
    if meter_b is not None:
        miou_b, acc_b = meter_b.get_miou_acc()
        metrics[f"{mode}_accuracy_b"] = acc_b
        metrics[f"{mode}_IoU_b"] = miou_b
        cms["boundary"] = meter_b.cm
    return metrics, cms
