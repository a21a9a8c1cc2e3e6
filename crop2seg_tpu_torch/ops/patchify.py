"""Tile <-> patch reshaping (port of crop2seg_tpu/ops/patchify.py).

- inference patchify: zero-pad the 1098^2 tile crop to 1280^2 and split it
  into a 10x10 grid of 128^2 patches, row-major;
- stitch: the 10x10 grid back to 1280^2, cropped to 1098^2;
- ``np_stitch_inference_tile``: the host (numpy) twin of the stitch;
- training patchify: crop the 10980^2 tile to 10496^2 at a 484 px offset
  and split it into 82x82 = 6724 patches of 128^2.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INFER_TILE = 1098        # webapp tile crop edge (px @ 10 m)
INFER_PADDED = 1280      # padded edge = 10 * 128
PATCH = 128
TRAIN_TILE = 10980       # full Sentinel-2 tile edge
TRAIN_CROP = 10496       # 82 * 128
TRAIN_OFFSET = 484       # crop offset of the training grid


def patchify_grid(x: torch.Tensor, patch: int = PATCH) -> torch.Tensor:
    """(..., H, W, C) with H=W=n*patch -> (n*n, ..., patch, patch, C), row-major."""
    *lead, h, w, c = x.shape
    n_h, n_w = h // patch, w // patch
    x = x.reshape(*lead, n_h, patch, n_w, patch, c)
    nl = len(lead)
    perm = (nl, nl + 2) + tuple(range(nl)) + (nl + 1, nl + 3, nl + 4)
    return x.permute(perm).reshape(n_h * n_w, *lead, patch, patch, c)


def unpatchify_grid(patches: torch.Tensor, n_h: int, n_w: int) -> torch.Tensor:
    """(n_h*n_w, ..., patch, patch, C) -> (..., n_h*patch, n_w*patch, C)."""
    _, *lead, p, p2, c = patches.shape
    nl = len(lead)
    x = patches.reshape(n_h, n_w, *lead, p, p2, c)
    perm = tuple(range(2, 2 + nl)) + (0, 2 + nl, 1, 3 + nl, 4 + nl)
    return x.permute(perm).reshape(*lead, n_h * p, n_w * p2, c)


def patchify_inference_tile(tile: torch.Tensor) -> torch.Tensor:
    """(T, 1098, 1098, C) -> (100, T, 128, 128, C), zero-padded to 1280^2."""
    _, h, w, _ = tile.shape
    tile = F.pad(tile, (0, 0, 0, INFER_PADDED - w, 0, INFER_PADDED - h))
    return patchify_grid(tile, PATCH)


def stitch_inference_tile(patches: torch.Tensor,
                          out_hw: int = INFER_TILE) -> torch.Tensor:
    """(100, 128, 128, K) -> (out_hw, out_hw, K): stitch the grid, crop."""
    n = int(round(float(patches.shape[0]) ** 0.5))
    return unpatchify_grid(patches, n, n)[:out_hw, :out_hw, :]


def np_stitch_inference_tile(patches, out_hw: int = INFER_TILE):
    """Host twin of :func:`stitch_inference_tile`:
    (100, 128, 128[, K]) -> (out_hw, out_hw[, K])."""
    patches = np.asarray(patches)
    squeeze = patches.ndim == 3
    if squeeze:
        patches = patches[..., None]
    n = int(round(float(patches.shape[0]) ** 0.5))
    p, k = patches.shape[1], patches.shape[-1]
    full = patches.reshape(n, n, p, p, k).transpose(0, 2, 1, 3, 4)
    full = full.reshape(n * p, n * p, k)[:out_hw, :out_hw]
    return full[..., 0] if squeeze else full


def patchify_training_tile(tile: torch.Tensor) -> torch.Tensor:
    """(..., 10980, 10980, C) -> (6724, ..., 128, 128, C): the 10496^2 crop
    at the 484 px offset, split into the 82x82 grid, row-major."""
    cropped = tile[..., TRAIN_OFFSET:TRAIN_OFFSET + TRAIN_CROP,
                   TRAIN_OFFSET:TRAIN_OFFSET + TRAIN_CROP, :]
    return patchify_grid(cropped, PATCH)
