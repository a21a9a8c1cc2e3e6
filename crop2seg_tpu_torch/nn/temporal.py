"""Temporally shared application of spatial blocks + pad-mask utilities
(port of crop2seg_tpu/nn/temporal.py).

Every frame is computed densely and pad frames are overwritten with
``pad_value`` afterwards: each per-frame op is independent across T, and
every cross-T consumer masks pads explicitly.
"""
from __future__ import annotations

import torch

from crop2seg_tpu_torch.nn.layers import space_group


def pad_mask_from_input(x: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
    """(B, T, H, W, C) -> bool (B, T), True where the frame is all pad.
    Inside ``nn/layers.py::space_shards`` x is a slice of each frame, which
    cannot decide for the frame: ValueError (pass the batch's pad mask)."""
    if space_group() is not None:
        raise ValueError("a space shard cannot tell a pad frame from its rows alone: "
                         "pass the batch's pad_mask")
    return (x == pad_value).flatten(2).all(dim=-1)


def pad_mask_from_lengths(lengths: torch.Tensor, max_t: int) -> torch.Tensor:
    """(B,) valid lengths -> bool (B, T_max), True at padded steps."""
    t = torch.arange(max_t, device=lengths.device)
    return t[None, :] >= lengths[:, None]


def temporally_shared(block_fn, x: torch.Tensor,
                      pad_mask: torch.Tensor | None = None,
                      pad_value: float = 0.0) -> torch.Tensor:
    """Apply a per-frame NHWC function over (B, T, H, W, C); pad frames of
    the result hold exactly ``pad_value``."""
    b, t = x.shape[:2]
    y = block_fn(x.reshape((b * t,) + tuple(x.shape[2:])))
    y = y.reshape((b, t) + tuple(y.shape[1:]))
    if pad_mask is not None:
        y = y.masked_fill(pad_mask.reshape(b, t, 1, 1, 1), pad_value)
    return y
