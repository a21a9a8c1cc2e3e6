"""Preprocessing of a whole padded batch on its device (port of
crop2seg_tpu/ops/preprocess.py): raw reflectances are uploaded once and
transformed there in one pass,

    reorder channels -> NDVI -> standardize -> geometric augmentation
    (flips + 90-degree rotations, joint with the target) -> temporal dropout
    (mask only: dropped frames become pad steps, shapes stay the same)

Every random draw is apart from its application: ``draw_geometry`` gives the
per-sample flip and rotation that ``augment_geometric`` applies, and
``draw_temporal_dropout`` the drop mask that ``temporal_dropout_mask``
applies, each drawn from a ``torch.Generator``; ``preprocess_batch`` takes
the draws, or draws them itself. All ops take channels-last batches:
x (B, T, H, W, C), y (B, H, W), pad_mask (B, T) bool, True at pads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from crop2seg_tpu_torch.data.s2tsczcrop import PASTIS_CHANNEL_ORDER


def reorder_channels(x: torch.Tensor, order=PASTIS_CHANNEL_ORDER) -> torch.Tensor:
    """.SAFE band order -> PASTIS band order."""
    return x[..., torch.as_tensor(order, device=x.device)]


def add_ndvi(x: torch.Tensor, nir_idx: int = 6, red_idx: int = 2) -> torch.Tensor:
    """Append the NDVI channel computed on the raw reflectances (B08 and B04
    at 6 and 2 in PASTIS order), 0 where undefined or outside [-1, 1]."""
    nir, red = x[..., nir_idx], x[..., red_idx]
    denom = nir + red
    ndvi = torch.where(denom == 0, 0.0, (nir - red) / torch.where(denom == 0, 1.0, denom))
    ndvi = torch.where((ndvi < -1) | (ndvi > 1), 0.0, ndvi)
    return torch.cat([x, ndvi[..., None]], dim=-1)


def standardize(x: torch.Tensor, mean, std, skip_last: int = 0) -> torch.Tensor:
    """Per-channel standardization; ``skip_last`` trailing channels (NDVI,
    already in [-1, 1]) are left as they are."""
    c = x.shape[-1] - skip_last
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)[:c]
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)[:c]
    xs = (x[..., :c] - mean) / std
    return xs if skip_last == 0 else torch.cat([xs, x[..., c:]], dim=-1)


def draw_geometry(b: int, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample flip (0 none, 1 horizontal, 2 vertical) and number of
    90-degree rotations (0-3), int64 (B,) on the generator's device."""
    dev = generator.device
    flip = torch.randint(0, 3, (b,), generator=generator, device=dev)
    rot = torch.randint(0, 4, (b,), generator=generator, device=dev)
    return flip, rot


def augment_geometric(x: torch.Tensor, y: torch.Tensor, flip, rot
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample i flipped by ``flip[i]`` (1: W reversed, 2: H reversed), then
    rotated ``rot[i]`` times by 90 degrees from H towards W, image series and
    target together."""
    xs, ys = [], []
    for xi, yi, f, k in zip(x, y, map(int, flip), map(int, rot)):
        if f:
            xi, yi = xi.flip(-1 - f), yi.flip(-f)
        xs.append(torch.rot90(xi, k, (-3, -2)))
        ys.append(torch.rot90(yi, k, (-2, -1)))
    return torch.stack(xs), torch.stack(ys)


def draw_temporal_dropout(shape, rate: float, generator: torch.Generator) -> torch.Tensor:
    """(B, T) bool drop mask, each frame dropped with probability ``rate``,
    on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device) < rate


def temporal_dropout_mask(pad_mask: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """The pad mask with the dropped frames added as pads. A sample that
    would lose every valid frame keeps its first valid one; its pad frames
    stay pads (a length-1 sample never un-masks them)."""
    new_mask = pad_mask | drop.to(pad_mask.device)
    all_dropped = new_mask.all(dim=1, keepdim=True)
    valid = ~pad_mask
    first_valid = valid & (torch.cumsum(valid.int(), dim=1) == 1)
    return torch.where(all_dropped & first_valid, False, new_mask)


def preprocess_batch(x: torch.Tensor, mean, std, y: Optional[torch.Tensor] = None,
                     pad_mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     reorder: bool = False, ndvi: bool = False,
                     augment: bool = False, temporal_dropout: float = 0.0,
                     flip=None, rot=None, drop=None) -> Dict[str, torch.Tensor]:
    """Preprocessing of a raw padded batch on its device: {"x"[, "y"][,
    "pad_mask"]}. Pad frames are zeroed. ``augment`` (with ``y``) applies
    ``flip`` and ``rot`` and ``temporal_dropout`` (with ``pad_mask``) the
    ``drop`` mask; each draw not given comes from ``generator``."""
    if reorder:
        x = reorder_channels(x)
    skip_last = 0
    if ndvi:
        x = add_ndvi(x)
        skip_last = 1
    x = standardize(x, mean, std, skip_last=skip_last)
    if pad_mask is not None:  # pads exactly at pad_value 0
        x = x * (~pad_mask).to(x.dtype)[:, :, None, None, None]
    out = {"x": x}
    if y is not None:
        if augment:
            if flip is None or rot is None:
                flip, rot = draw_geometry(x.shape[0], generator)
            out["x"], y = augment_geometric(x, y, flip, rot)
        out["y"] = y
    if pad_mask is not None:
        if temporal_dropout > 0.0:
            if drop is None:
                drop = draw_temporal_dropout(pad_mask.shape, temporal_dropout, generator)
            pad_mask = temporal_dropout_mask(pad_mask, drop)
        out["pad_mask"] = pad_mask
    return out
