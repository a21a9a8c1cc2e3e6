"""Segmentation losses (port of crop2seg_tpu/learning/losses.py), on
channels-last logits (B, H, W, K) and integer targets (B, H, W), all in fp32:

- ``cross_entropy``: weighted, label-smoothed cross entropy, the training
  step's main loss;
- ``focal_cross_entropy``: the boundary head's loss (gamma 2 by default);
- ``soft_cross_entropy`` and ``smooth_cross_entropy_2d``: cross entropy with
  probability targets, and its boundary-aware label smoothing;
- ``recall_cross_entropy``: cross entropy weighted per class by the batch's
  false-negative rate.
"""
from __future__ import annotations

from typing import Sequence

import torch

from crop2seg_tpu_torch.ops.boundary import dilate_classes

# S2TSCzCrop class proportions without the background, the smooth loss's
# prior for background pixels
S2TSCZ_CLASS_PROPORTIONS = (
    0.3111, 0.0193, 0.0809, 0.2809, 0.1084, 0.0892, 0.0350, 0.0170, 0.0007,
    0.0047, 0.0015, 0.0044, 0.0394, 0.0074)


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  weight: torch.Tensor | None = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(weight, label_smoothing) semantics.

    Per pixel n with target y: q = (1-eps)*onehot(y) + eps/K;
    loss_n = -w[y] * sum_c q_c log p_c; reduction = sum(loss) / sum(w[y]).
    An ignore class is expressed as weight 0. Computed in fp32."""
    k = logits.shape[-1]
    eps = label_smoothing
    logp = torch.log_softmax(logits.float(), dim=-1)
    target = target.long()
    nll = -logp.gather(-1, target[..., None])[..., 0]
    if weight is not None:
        # the hard term is weighted by w[y], the smooth term by the per-class
        # weights, and the mean divides by sum(w[y])
        wc = weight.to(logp.device, torch.float32)
        wy = wc[target]
        per_pixel = (1.0 - eps) * wy * nll
        if eps > 0.0:
            per_pixel = per_pixel + eps / k * (-(wc * logp).sum(-1))
        return per_pixel.sum() / wy.sum().clamp_min(1e-12)
    per_pixel = nll if eps == 0.0 else (1.0 - eps) * nll + eps * (-logp.mean(-1))
    return per_pixel.mean()


def _weights(weight, k: int, like: torch.Tensor) -> torch.Tensor:
    if weight is None:
        return torch.ones(k, dtype=torch.float32, device=like.device)
    return torch.as_tensor(weight, dtype=torch.float32, device=like.device)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor,
                       weight: torch.Tensor | None = None) -> torch.Tensor:
    """Cross entropy with probability targets q: the mean over pixels of
    -sum_c w_c q_c log p_c."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    w = _weights(weight, logits.shape[-1], logp)
    return (-(w * target_probs.float() * logp).sum(-1)).mean()


def focal_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                        gamma: float = 2.0, ignore_index: int = -100,
                        weight: torch.Tensor | None = None) -> torch.Tensor:
    """Focal cross entropy -(1 - p_y)^gamma log p_y (times w[y] with
    ``weight``), the mean over pixels whose target is not ``ignore_index``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    target = target.long()
    safe_t = torch.where(target == ignore_index, 0, target)
    logpt = logp.gather(-1, safe_t[..., None])[..., 0]
    loss = -torch.pow(1.0 - logpt.exp(), gamma) * logpt
    if weight is not None:
        loss = loss * _weights(weight, logits.shape[-1], logp)[safe_t]
    keep = (target != ignore_index).float()
    return (loss * keep).sum() / keep.sum().clamp_min(1.0)


def smooth_cross_entropy_2d(
        logits: torch.Tensor, target: torch.Tensor, label_smoothing: float = 0.1,
        background_treatment: bool = True, background_index: int = 0,
        background_label_value: float = 0.6,
        class_proportions: Sequence[float] = S2TSCZ_CLASS_PROPORTIONS,
        weight: torch.Tensor | None = None) -> torch.Tensor:
    """Boundary-aware label smoothing: mass eps/K on each class absent from
    the pixel's plus-shaped neighbourhood, the rest shared equally by the
    classes present; background pixels take the fixed prior
    [v, (1 - v) * proportions]."""
    k = logits.shape[-1]
    dilated = dilate_classes(target, k, connectivity=4).float()
    eps = label_smoothing / k
    n_present = dilated.sum(-1, keepdim=True)
    exp_small = eps * (k - n_present)
    exp_large = (1.0 - exp_small) / n_present
    target_probs = torch.where(dilated == 1, exp_large,
                               torch.tensor(eps, device=dilated.device))
    if background_treatment:
        bg = torch.cat([
            torch.tensor([background_label_value], dtype=torch.float32),
            (1.0 - background_label_value)
            * torch.tensor(class_proportions, dtype=torch.float32)]).to(dilated.device)
        target_probs = torch.where((target == background_index)[..., None], bg,
                                   target_probs)
    return soft_cross_entropy(logits, target_probs, weight=weight)


def recall_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         n_classes: int, ignore_index: int = -100) -> torch.Tensor:
    """Cross entropy weighted per pixel by its class's share of false
    negatives in the batch (fn / gt counts, each at least 1); pixels whose
    target is ``ignore_index`` are left out of the counts and of the mean."""
    target = target.long()
    pred = logits.argmax(-1)
    valid = target != ignore_index
    safe_t = torch.where(valid, target, 0)
    classes = torch.arange(n_classes, device=target.device)
    onehot_t = (safe_t[..., None] == classes).float() * valid[..., None]
    dims = tuple(range(onehot_t.dim() - 1))
    gt_count = onehot_t.sum(dims).clamp_min(1.0)
    fn_mask = (pred != target) & valid
    fn_count = (onehot_t * fn_mask[..., None]).sum(dims).clamp_min(1.0)
    weight = fn_count / gt_count
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, safe_t[..., None])[..., 0]
    loss = weight[safe_t] * ce * valid
    return loss.sum() / valid.float().sum().clamp_min(1.0)
