"""TimeUNet_v2 (port of crop2seg_tpu/models/timeunet_v2.py:24-108).

    x (B,T,H,W,C) --shared in_conv--> (B,T,H,W,64)
    --classical TAE2d at full resolution--> a new sequence (B,T,H,W,64)
    --shared down blocks over the sequence--> ... (B,T,16,16,128)
    --lightweight TAE2d at the lowest resolution--> (B,16,16,128) + attention
    --decoder on the attention-aggregated skips--> logits (B,H,W,K)

The full-resolution classical TAE2d runs its per-pixel work in chunks of
pixel rows (``nn/tae2d.py``), checkpointed in training; its T x T attention
is never gathered (TimeUNet_v2 does not use it). Neither TAE2d reaches an
L-TAE kernel: the JAX package computes both on XLA ops, and the port on
plain PyTorch ops. ``return_att`` adds the lightweight attention (B, H', W',
head, T) to the logits; ``generator`` draws every dropout mask in training.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from crop2seg_tpu_torch.nn.aggregator import temporal_aggregate
from crop2seg_tpu_torch.nn.layers import (
    ConvBlock, DownConvBlock, UpConvBlock, unet_space_rows)
from crop2seg_tpu_torch.nn.tae2d import TAE2d
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_input, temporally_shared


class TimeUNetV2(nn.Module):
    def __init__(self, input_dim: int = 10,
                 encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (32, 20), str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1,
                 agg_mode: str = "att_group", encoder_norm: str = "group",
                 n_head: int = 16, d_model: int = 256, d_k: int = 4,
                 pad_value: float = 0.0, padding_mode: str = "reflect",
                 conv_type: str = "2d", add_squeeze_excit: bool = False,
                 use_abs_rel_enc: bool = False):
        super().__init__()
        enc_w, dec_w = tuple(encoder_widths), tuple(decoder_widths)
        n = len(enc_w)
        self.pad_value, self.agg_mode = pad_value, agg_mode
        self.space_rows = unet_space_rows(n, str_conv_s, padding_mode == "reflect")
        conv_kw = dict(padding_mode=padding_mode, conv_type=conv_type,
                       add_squeeze=add_squeeze_excit)
        self.in_conv = ConvBlock((input_dim, enc_w[0], enc_w[0]), norm=encoder_norm,
                                 **conv_kw)
        self.temporal_encoder_full_resolution = TAE2d(
            attention_type="classical", embedding_reduction=None,
            attention_mask_reduction=None, in_channels=enc_w[0], d_model=d_model,
            n_head=n_head, d_k=d_k, mlp=(d_model, enc_w[0]),
            use_abs_rel_enc=use_abs_rel_enc)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(enc_w[i], enc_w[i + 1], k=str_conv_k, s=str_conv_s,
                          p=str_conv_p, norm=encoder_norm, **conv_kw)
            for i in range(n - 1))
        self.temporal_encoder_low_resolution = TAE2d(
            attention_type="lightweight", in_channels=enc_w[-1], d_model=d_model,
            n_head=n_head, d_k=d_k, mlp=(d_model, enc_w[-1]),
            use_abs_rel_enc=use_abs_rel_enc)
        self.up_blocks = nn.ModuleList(
            UpConvBlock(dec_w[i], dec_w[i - 1], enc_w[i - 1], k=str_conv_k,
                        s=str_conv_s, p=str_conv_p, norm="batch",
                        padding_mode=padding_mode)
            for i in range(n - 1, 0, -1))
        self.out_conv = ConvBlock((dec_w[0],) + tuple(out_conv), padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *, return_att: bool = False,
                generator: torch.Generator | None = None):
        """x (B, T, H, W, C), batch_positions (B, T) or (B, T, 2), pad_mask
        (B, T) bool -> logits (B, H, W, K)."""
        if pad_mask is None:
            pad_mask = pad_mask_from_input(x, self.pad_value)
        out = temporally_shared(self.in_conv, x, pad_mask, self.pad_value)
        out, _ = self.temporal_encoder_full_resolution(
            out, batch_positions, pad_mask, need_attn=False, generator=generator)
        feature_maps = [out]
        for down in self.down_blocks:
            feature_maps.append(temporally_shared(down, feature_maps[-1], pad_mask,
                                                  self.pad_value))
        out, attn = self.temporal_encoder_low_resolution(
            feature_maps[-1], batch_positions, pad_mask, generator=generator)
        for i, up in enumerate(self.up_blocks):
            skip = temporal_aggregate(feature_maps[-(i + 2)], attn=attn,
                                      pad_mask=pad_mask, mode=self.agg_mode)
            out = up(out, skip)
        logits = self.out_conv(out)
        return (logits, attn) if return_att else logits
