"""Segmentation loss of the training step (port of
crop2seg_tpu/learning/losses.py:31-55): weighted, label-smoothed cross
entropy on channels-last logits (B, H, W, K) and integer targets (B, H, W).
The focal, smooth and recall losses come with the boundary-head models
(ROADMAP.md)."""
from __future__ import annotations

import torch


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
