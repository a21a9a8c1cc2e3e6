"""RecUNet: a U-Net with a recurrent temporal bottleneck (port of
crop2seg_tpu/models/recunet.py:21-99).

A shared conv encoder over the frames (in_conv pads by reflection whatever
``padding_mode`` says, as in the JAX package), then at the lowest
resolution ``temporal``: "lstm" (ConvLSTM, its final cell state through
``out_convlstm``), "blstm" (both directions' final cell states) or "mean"
(the masked temporal mean); the skips take the masked temporal mean, and
the decoder's blocks use ``encoder_norm``. The JAX module's fourth mode,
"mono", hands the (B, T, H, W, C) frames to the 2-D decoder and fails
there on every input; the port refuses it when the module is built.
The factory's ``uconvlstm`` is "lstm" with hidden width 64 and zero
padding.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from crop2seg_tpu_torch.models.convlstm import BConvLSTM, ConvLSTM
from crop2seg_tpu_torch.nn.aggregator import temporal_aggregate
from crop2seg_tpu_torch.nn.layers import (
    Conv2d, ConvBlock, DownConvBlock, UpConvBlock, unet_space_rows)
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_input, temporally_shared


class RecUNet(nn.Module):
    def __init__(self, input_dim: int = 10,
                 encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (32, 20), str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1, temporal: str = "lstm",
                 encoder_norm: str = "group", hidden_dim: int = 128,
                 encoder: bool = False, padding_mode: str = "reflect",
                 pad_value: float = 0.0):
        super().__init__()
        if temporal == "mono":
            raise ValueError("temporal='mono' feeds (B, T, H, W, C) frames to the "
                             "2-D decoder, where the JAX RecUNet fails too")
        if temporal not in ("mean", "lstm", "blstm"):
            raise ValueError(f"unknown temporal mode {temporal!r}")
        enc_w, dec_w = tuple(encoder_widths), tuple(decoder_widths)
        n = len(enc_w)
        self.temporal, self.encoder, self.pad_value = temporal, encoder, pad_value
        # in_conv mirrors a row at full resolution whatever the padding mode
        align, least = unet_space_rows(n, str_conv_s, padding_mode == "reflect")
        self.space_rows = (align, max(2, least))
        self.in_conv = ConvBlock((input_dim, enc_w[0], enc_w[0]), norm=encoder_norm)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(enc_w[i], enc_w[i + 1], k=str_conv_k, s=str_conv_s,
                          p=str_conv_p, norm=encoder_norm, padding_mode=padding_mode)
            for i in range(n - 1))
        if temporal in ("lstm", "blstm"):
            cls = ConvLSTM if temporal == "lstm" else BConvLSTM
            self.temporal_encoder = cls(enc_w[-1], hidden_dim, 3)
            width = hidden_dim * (1 if temporal == "lstm" else 2)
            self.out_convlstm = Conv2d(width, enc_w[-1], 3, padding=1)
        self.up_blocks = nn.ModuleList(
            UpConvBlock(dec_w[i], dec_w[i - 1], enc_w[i - 1], k=str_conv_k,
                        s=str_conv_s, p=str_conv_p, norm=encoder_norm,
                        padding_mode=padding_mode)
            for i in range(n - 1, 0, -1))
        self.out_conv = ConvBlock((dec_w[0],) + tuple(out_conv), padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None, *,
                generator=None):
        """x (B, T, H, W, C), pad_mask (B, T) bool -> logits (B, H, W, K);
        with ``encoder`` the decoder output and its maps instead."""
        if pad_mask is None:
            pad_mask = pad_mask_from_input(x, self.pad_value)
        feature_maps = [temporally_shared(self.in_conv, x, pad_mask, self.pad_value)]
        for down in self.down_blocks:
            feature_maps.append(temporally_shared(down, feature_maps[-1], pad_mask,
                                                  self.pad_value))
        last = feature_maps[-1]
        if self.temporal == "mean":
            out = temporal_aggregate(last, pad_mask=pad_mask, mode="mean")
        elif self.temporal == "lstm":
            _, (_, c_t) = self.temporal_encoder(last, keep_outputs=False)
            out = self.out_convlstm(c_t)
        else:
            out = self.out_convlstm(self.temporal_encoder(last, pad_mask))
        maps = [out]
        for i, up in enumerate(self.up_blocks):
            skip = temporal_aggregate(feature_maps[-(i + 2)], pad_mask=pad_mask, mode="mean")
            out = up(out, skip)
            maps.append(out)
        if self.encoder:
            return out, maps
        return self.out_conv(out)
