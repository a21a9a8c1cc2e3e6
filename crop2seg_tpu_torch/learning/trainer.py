"""The training and eval steps (port of crop2seg_tpu/learning/trainer.py:48-160).

One train step is forward, loss, backward, Adam update and the confusion
matrices, on the card by default, in fp32 or, with ``dtype=torch.bfloat16``,
under ``torch.autocast`` in bf16 with fp32 parameters, fp32 Adam state and the
loss taken on fp32 logits (the JAX train CLI's ``--bf16``, train.py:88-89,
367-372; like it, no loss scaling). ``freeze_labels``, ``run_epoch``, the
boundary loss and region masking come later (ROADMAP.md), and with them the
JAX ``StepConfig``'s ``ignore_index``, ``add_boundary_loss``,
``boundary_gamma`` and ``test_region``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch

from crop2seg_tpu_torch.device import resolve_device
from crop2seg_tpu_torch.learning.losses import cross_entropy
from crop2seg_tpu_torch.learning.metrics import confusion_matrix, top2_prediction


@dataclass(frozen=True)
class StepConfig:
    num_classes: int = 15
    class_weights: Optional[tuple] = None   # an ignored class is weighted 0
    label_smoothing: float = 0.0


def create_train_state(model: torch.nn.Module, learning_rate: float
                       ) -> torch.optim.Optimizer:
    """Adam with torch defaults (betas 0.9/0.999, eps 1e-8), as the JAX
    package's optax.adam."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def _to(batch: Mapping, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=dev)
            for k in ("x", "dates", "pad_mask", "y")}


def _metrics(cfg: StepConfig, logits: torch.Tensor, y: torch.Tensor,
             weight: torch.Tensor | None) -> Dict[str, torch.Tensor]:
    loss = cross_entropy(logits, y, weight=weight,
                         label_smoothing=cfg.label_smoothing)
    with torch.no_grad():
        lg = logits.detach()
        return {"loss": loss,
                "cm": confusion_matrix(lg.argmax(-1), y, cfg.num_classes),
                "cm_top2": confusion_matrix(top2_prediction(lg, y), y,
                                            cfg.num_classes)}


def _weight(cfg: StepConfig, dev: torch.device) -> torch.Tensor | None:
    if cfg.class_weights is None:
        return None
    return torch.tensor(cfg.class_weights, dtype=torch.float32, device=dev)


def _logits(model: torch.nn.Module, b: Mapping, **kw) -> torch.Tensor:
    out = model(b["x"], b["dates"], b["pad_mask"], **kw)
    if isinstance(out, tuple):
        raise ValueError(
            "the model returns a tuple (a boundary head, or maps or attention "
            "beside the logits): the boundary loss is not ported yet "
            "(ROADMAP.md); build the model without add_boundary_loss")
    return out


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
    (B, T), pad_mask (B, T) bool and y (B, H, W), as arrays or tensors.
    ``generator`` (a ``torch.Generator`` on the model's device) draws every
    dropout mask of the step. ``optimizer`` defaults to
    ``create_train_state(model, 1e-3)`` and is exposed as ``step.optimizer``.
    ``dtype``: the forward's compute dtype under autocast (torch.bfloat16);
    None runs fp32. ``aux`` holds the loss and the (K, K) confusion matrices
    ``cm`` and ``cm_top2`` of the step's forward, on the device."""
    dev = resolve_device(device)
    model.to(dev)
    if optimizer is None:
        optimizer = create_train_state(model, 1e-3)
    weight = _weight(cfg, dev)

    def step(batch: Mapping, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        b = _to(batch, dev)
        optimizer.zero_grad(set_to_none=True)
        with _autocast(dev, dtype):
            logits = _logits(model, b, generator=generator)
        aux = _metrics(cfg, logits.float(), b["y"], weight)
        aux["loss"].backward()
        optimizer.step()
        aux["loss"] = aux["loss"].detach()
        return aux

    step.optimizer = optimizer
    return step


def make_eval_step(model: torch.nn.Module, cfg: StepConfig,
                   device=None, dtype: torch.dtype | None = None) -> Callable:
    """Returns ``step(batch) -> aux`` (loss, cm, cm_top2) of ``model`` in
    eval mode on ``device``: the served path, so on the card the fused eval
    L-TAE kernel runs. ``dtype`` as in ``make_train_step``."""
    dev = resolve_device(device)
    weight = _weight(cfg, dev)

    def step(batch: Mapping) -> Dict[str, torch.Tensor]:
        model.to(dev).eval()
        b = _to(batch, dev)
        with torch.inference_mode():
            with _autocast(dev, dtype):
                logits = _logits(model, b)
            return _metrics(cfg, logits.float(), b["y"], weight)

    return step
