"""3-D conv U-Net over (T, H, W), the Rustowicz et al. baseline (port of
crop2seg_tpu/models/unet3d.py:43-86).

Channels-last (B, T, H, W, C): T is the depth axis. Two conv + max-pool
stages, a centre block ending in a transposed conv (torch's
ConvTranspose3d(k=3, s=2, p=1, output_padding=1), which doubles T, H and
W), the skips cut on T to the upsampled length, and a head that takes the
masked temporal mean over the T that survive, with the pad mask cut to that
length (the reference's quirk, kept by the JAX package). 3-D convs mix pad
frames into valid ones, so the output depends on what the pad frames hold.
Sequential indices follow the reference's state dict (en3.0 conv, en3.1
BatchNorm, en3.2 LeakyReLU, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crop2seg_tpu_torch.nn.blocks3d import (
    BatchNorm3d, Conv3d, ConvTranspose3d, _ncdhw, _ndhwc)
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_input


def _conv_bn(d_in: int, d_out: int):
    return [Conv3d(d_in, d_out, 3, padding=1), BatchNorm3d(d_out, eps=1e-5),
            nn.LeakyReLU(0.01)]


def _up(d_in: int, d_out: int) -> ConvTranspose3d:
    return ConvTranspose3d(d_in, d_out, 3, stride=2, padding=1, output_padding=1)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return _ndhwc(F.max_pool3d(_ncdhw(x), 2, 2))


class UNet3D(nn.Module):
    def __init__(self, n_classes: int = 15, in_channel: int = 10, feats: int = 8,
                 pad_value: float | None = 0.0):
        super().__init__()
        f = feats
        self.pad_value = pad_value
        # space shards (parallel/mesh.py::shard_batch_2d): two max-pools of H
        # by 2 need shards of a multiple of 4 rows, the bottleneck's 3-D convs
        # a row to send to a neighbour
        self.space_rows = (4, 4)
        self.en3 = nn.Sequential(*_conv_bn(in_channel, f * 4), *_conv_bn(f * 4, f * 4))
        self.en4 = nn.Sequential(*_conv_bn(f * 4, f * 8), *_conv_bn(f * 8, f * 8))
        self.center_in = nn.Sequential(*_conv_bn(f * 8, f * 16))
        self.center_out = nn.Sequential(*_conv_bn(f * 16, f * 16), _up(f * 16, f * 8))
        self.dc4 = nn.Sequential(*_conv_bn(f * 16, f * 8), *_conv_bn(f * 8, f * 8))
        self.trans3 = nn.Sequential(_up(f * 8, f * 4), BatchNorm3d(f * 4, eps=1e-5),
                                    nn.LeakyReLU(0.01))
        self.dc3 = nn.Sequential(*_conv_bn(f * 8, f * 4), *_conv_bn(f * 4, f * 2))
        self.final = Conv3d(f * 2, n_classes, 3, padding=1)

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None, *,
                generator=None):
        """x (B, T, H, W, C), pad_mask (B, T) bool -> logits (B, H, W, K)."""
        if pad_mask is None and self.pad_value is not None:
            pad_mask = pad_mask_from_input(x, self.pad_value)
        en3 = self.en3(x)
        en4 = self.en4(_max_pool(en3))
        center = self.center_out(self.center_in(_max_pool(en4)))
        dc4 = self.dc4(torch.cat([center, en4[:, :center.shape[1]]], dim=-1))
        tr3 = self.trans3(dc4)
        final = self.final(self.dc3(torch.cat([tr3, en3[:, :tr3.shape[1]]], dim=-1)))
        if pad_mask is None:
            return final.mean(dim=1)
        valid = (~pad_mask[:, :final.shape[1]]).to(final.dtype)
        num = torch.einsum("bt,bthwc->bhwc", valid, final)
        return num / valid.sum(dim=1).clamp_min(1.0)[:, None, None, None]
