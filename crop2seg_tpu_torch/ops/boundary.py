"""Boundary classes from a label map (port of crop2seg_tpu/ops/boundary.py).

A pixel is a boundary pixel when the 3x3 (or plus-shaped) neighbourhood
around it touches two or more classes. Each class's binary dilation is a
3x3 max-pool of its one-hot mask (stride 1, pads of -inf, as the JAX
``reduce_window``), so the results are the JAX package's integers exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from crop2seg_tpu_torch.nn.layers import space_group, space_label_rows


def dilate_classes(target: torch.Tensor, n_classes: int,
                   connectivity: int = 4) -> torch.Tensor:
    """(B, H, W) int labels -> (B, H, W, K) int32 0/1 dilated class masks.
    Labels outside [0, K) have no class. connectivity 4 uses the plus-shaped
    element {self, up, down, left, right}, 8 the full 3x3 square. Inside
    ``nn/layers.py::space_shards`` H holds this rank's rows: they take one
    label row of each neighbour, and a row of label K (no class, as the
    -inf padding adds none) beyond the global edges."""
    group = space_group()
    if group is None:
        return _dilate(target, n_classes, connectivity)
    rows = space_label_rows(target, 1, group, fill=n_classes)
    return _dilate(rows, n_classes, connectivity)[:, 1:-1]


def _dilate(target: torch.Tensor, n_classes: int, connectivity: int) -> torch.Tensor:
    classes = torch.arange(n_classes, device=target.device)
    onehot = (target.long()[:, None] == classes[None, :, None, None]).float()
    if connectivity == 8:
        dil = F.max_pool2d(onehot, 3, stride=1, padding=1)
    else:
        vert = F.max_pool2d(onehot, (3, 1), stride=1, padding=(1, 0))
        horiz = F.max_pool2d(onehot, (1, 3), stride=1, padding=(0, 1))
        dil = torch.maximum(vert, horiz)
    return (dil > 0).to(torch.int32).permute(0, 2, 3, 1)


def boundary_mask(target: torch.Tensor, n_classes: int,
                  connectivity: int = 4) -> torch.Tensor:
    """(B, H, W) labels -> (B, H, W) int32: 1 where the neighbourhood
    touches two or more classes, else 0."""
    dil = dilate_classes(target, n_classes, connectivity)
    return (dil.sum(-1) > 1).to(torch.int32)
