"""Plain U-Net baselines (port of crop2seg_tpu/models/unet.py:22-122).

- ``Unet``: the time-agnostic 2-D U-Net with no in_conv: its input already
  carries ``encoder_widths[0]`` channels (the reference's unwired ablation
  block; no factory name builds it).
- ``UnetNaive``: folds a fixed-length T into channels, t-major (channel
  t * C + c), with every width scaled by temporal_length // 2; T must equal
  ``temporal_length`` (the factory's ``max_temp``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from crop2seg_tpu_torch.nn.layers import (
    ConvBlock, DownConvBlock, UpConvBlock, unet_space_rows)


class _UNetBody(nn.Module):
    """The down blocks, the up blocks (BatchNorm) and out_conv that both
    U-Nets share; ``forward`` takes the in_conv's output (B, H, W, C)."""

    def __init__(self, enc_w, dec_w, out_conv, k, s, p, norm, padding_mode,
                 conv_type, add_squeeze):
        super().__init__()
        n = len(enc_w)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(enc_w[i], enc_w[i + 1], k=k, s=s, p=p, norm=norm,
                          padding_mode=padding_mode, conv_type=conv_type,
                          add_squeeze=add_squeeze)
            for i in range(n - 1))
        self.up_blocks = nn.ModuleList(
            UpConvBlock(dec_w[i], dec_w[i - 1], enc_w[i - 1], k=k, s=s, p=p,
                        norm="batch", padding_mode=padding_mode)
            for i in range(n - 1, 0, -1))
        self.out_conv = ConvBlock(tuple(out_conv), padding_mode=padding_mode)
        self.space_rows = unet_space_rows(n, s, padding_mode == "reflect")

    def body(self, out: torch.Tensor, encoder: bool = False):
        feature_maps = [out]
        for down in self.down_blocks:
            feature_maps.append(down(feature_maps[-1]))
        out = feature_maps[-1]
        maps = [out]
        for i, up in enumerate(self.up_blocks):
            out = up(out, feature_maps[-(i + 2)])
            maps.append(out)
        return (out, maps) if encoder else self.out_conv(out)


class Unet(_UNetBody):
    """x (B, H, W, encoder_widths[0]) -> logits (B, H, W, K); with
    ``encoder`` the decoder output and its maps instead."""

    def __init__(self, encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (32, 20), str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1,
                 encoder_norm: str = "group", encoder: bool = False,
                 padding_mode: str = "reflect", conv_type: str = "2d",
                 add_squeeze_excit: bool = False):
        super().__init__(tuple(encoder_widths), tuple(decoder_widths),
                         (decoder_widths[0],) + tuple(out_conv), str_conv_k,
                         str_conv_s, str_conv_p, encoder_norm, padding_mode,
                         conv_type, add_squeeze_excit)
        self.encoder = encoder

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None, *,
                generator=None):
        return self.body(x, self.encoder)


class UnetNaive(_UNetBody):
    """x (B, T, H, W, C) with T == ``temporal_length`` -> logits (B, H, W,
    K). Every norm is BatchNorm."""

    def __init__(self, input_dim: int = 10, temporal_length: int = 61,
                 encoder_widths: Sequence[int] = (8, 8, 8, 16),
                 decoder_widths: Sequence[int] = (4, 4, 8, 16),
                 out_conv: Sequence[int] = (4, 20), str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1,
                 pad_value: float = 0.0, padding_mode: str = "reflect",
                 conv_type: str = "2d", add_squeeze_excit: bool = False):
        tl = temporal_length
        enc_w = tuple(w * tl // 2 for w in encoder_widths)
        dec_w = tuple(w * tl // 2 for w in decoder_widths)
        super().__init__(enc_w, dec_w, (dec_w[0], out_conv[0] * tl, out_conv[1]),
                         str_conv_k, str_conv_s, str_conv_p, "batch", padding_mode,
                         conv_type, add_squeeze_excit)
        self.temporal_length = tl
        self.in_conv = ConvBlock((input_dim * tl, enc_w[0], enc_w[0]), norm="batch",
                                 padding_mode=padding_mode, conv_type=conv_type,
                                 add_squeeze=add_squeeze_excit)

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None, *,
                generator=None):
        b, t, h, w, c = x.shape
        if t != self.temporal_length:
            raise ValueError(f"unet_naive needs batches padded to exactly "
                             f"temporal_length={self.temporal_length} steps, got T={t}")
        folded = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
        return self.body(self.in_conv(folded))
