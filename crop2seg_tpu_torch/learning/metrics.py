"""Confusion matrices of the training step (port of
crop2seg_tpu/learning/metrics.py:18-40 and :93-100). The IoU meter comes with
the epoch loop (ROADMAP.md)."""
from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """Integer predictions / targets of any shape -> (K, K) int64 counts,
    rows = ground truth. Labels outside [0, K), negatives included, are
    dropped, as the JAX package's one-hot formulation drops them."""
    t, p = target.reshape(-1).long(), pred.reshape(-1).long()
    ok = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    idx = torch.where(ok, t * num_classes + p, num_classes * num_classes)
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def top2_prediction(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The lenient top-2 prediction: the 2nd-best class counts as the
    prediction where it matches the target, else the best one."""
    top2 = torch.topk(logits, 2, dim=-1).indices
    return torch.where(target == top2[..., 1], top2[..., 1], top2[..., 0])
