"""W-TAE (port of crop2seg_tpu/models/wtae.py): the attention masks come
first, from a reduced copy of the features, and collapse the full-resolution
ones.

    x (B,T,H,W,C) --shared in_conv--> full (B,T,H,W,enc_w[0])
    full --shared depthwise-separable reduction pyramid--> (B,T,h,w,enc_w[-1])
    --LTAE4WTAE--> attention masks only (B,h,w,head,T)
    temporal_aggregate(full, masks resampled to H x W) --> (B,H,W,enc_w[0])
    --plain U-Net (down blocks, up blocks with skips)--> logits [+ boundary]

The L-TAE here is ``LTAE4WTAE``: plain attention at the lowest resolution,
with no kernel, as in the JAX package (its factory gives W-TAE no
``use_pallas``). Every tensor is channels-last; pad frames of each shared
block's output hold ``pad_value``, and the attention and the aggregator mask
them. In training mode every BatchNorm uses batch statistics and updates its
running ones, and the attention is dropped after the softmax (masks from the
step's ``generator``) before it weighs the features.

``remat`` checkpoints activations in training as the JAX ``nn.remat`` does:
in_conv, the reduction pyramid and the post-collapse down blocks (in_conv and
the pyramid run over all B * T frames). ``remat_policy`` None or ``"full"``
recomputes each block whole in the backward pass; ``"conv_out"`` saves every
convolution's output and recomputes only the norm and ReLU tails. Recompute
leaves BatchNorm's running statistics alone.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from crop2seg_tpu_torch.models.utae import REMAT_POLICIES
from crop2seg_tpu_torch.nn.aggregator import temporal_aggregate
from crop2seg_tpu_torch.nn.layers import conv_blocks, remat, unet_space_rows
from crop2seg_tpu_torch.nn.ltae import LTAE4WTAE
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_input, temporally_shared


class WTAE(nn.Module):
    def __init__(self, input_dim: int = 10,
                 encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (32, 20), str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1,
                 agg_mode: str = "att_group", encoder_norm: str = "group",
                 n_head: int = 16, d_model: int = 256, d_k: int = 4,
                 encoder: bool = False, return_maps: bool = False,
                 pad_value: float = 0.0, padding_mode: str = "reflect",
                 conv_type: str = "2d", use_mbconv: bool = False,
                 add_squeeze_excit: bool = False, use_abs_rel_enc: bool = False,
                 num_queries: int = 1, use_doy: bool = False,
                 add_linear: bool = False, add_boundary_loss: bool = False,
                 remat: bool = False, remat_policy: str | None = None):
        super().__init__()
        if num_queries != 1:
            raise ValueError(
                "W-TAE takes num_queries=1 only: with more queries the JAX "
                "W-TAE fails too (its aggregator cannot take the (B, h, w, "
                "head, nq, T) attention)")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}: expected "
                             "None, 'full' or 'conv_out'")
        self.remat, self.remat_policy = remat, remat_policy
        enc_w, dec_w = tuple(encoder_widths), tuple(decoder_widths)
        n = len(enc_w)
        self.agg_mode, self.pad_value = agg_mode, pad_value
        self.encoder, self.return_maps = encoder, return_maps
        # MBConv units pad by reflection whatever padding_mode says
        self.space_rows = unet_space_rows(n, str_conv_s,
                                          padding_mode == "reflect" or use_mbconv)
        in_block, down_block, up_block, out_block = conv_blocks(use_mbconv)
        down_kw = dict(k=str_conv_k, s=str_conv_s, p=str_conv_p, norm=encoder_norm,
                       padding_mode=padding_mode, add_squeeze=add_squeeze_excit)
        self.in_conv = in_block((input_dim, enc_w[0], enc_w[0]), norm=encoder_norm,
                                padding_mode=padding_mode, conv_type=conv_type,
                                add_squeeze=add_squeeze_excit)
        self.spatial_reduction = nn.ModuleList(
            down_block(enc_w[i], enc_w[i + 1], conv_type="depthwise_separable",
                       **down_kw)
            for i in range(n - 1))
        self.temporal_encoder = LTAE4WTAE(
            in_channels=enc_w[-1], d_model=d_model, n_head=n_head, d_k=d_k,
            use_abs_rel_enc=use_abs_rel_enc, num_queries=num_queries,
            use_doy=False if use_abs_rel_enc else use_doy, add_linear=add_linear)
        self.down_blocks = nn.ModuleList(
            down_block(enc_w[i], enc_w[i + 1], conv_type=conv_type, **down_kw)
            for i in range(n - 1))
        # the first up block takes the last down block's output
        self.up_blocks = nn.ModuleList(
            up_block(enc_w[-1] if i == n - 1 else dec_w[i], dec_w[i - 1],
                     enc_w[i - 1], k=str_conv_k, s=str_conv_s, p=str_conv_p,
                     norm="batch", padding_mode=padding_mode)
            for i in range(n - 1, 0, -1))
        self.out_conv = out_block((dec_w[0],) + tuple(out_conv),
                                  padding_mode=padding_mode)
        self.boundary_conv = (out_block((dec_w[0], 32, 2), padding_mode=padding_mode)
                              if add_boundary_loss else None)

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *, return_att: bool = False,
                generator: torch.Generator | None = None):
        """x (B, T, H, W, C), batch_positions (B, T) or (B, T, 2), pad_mask
        (B, T) bool -> logits (B, H, W, K); with the boundary head also its
        (B, H, W, 2) logits; ``return_att`` adds the attention (B, h, w,
        head, T), ``return_maps`` the decoder maps; ``encoder`` returns
        (decoder output, maps) before the head. ``generator`` (training)
        draws the attention's dropout masks."""
        if pad_mask is None:
            pad_mask = pad_mask_from_input(x, self.pad_value)
        on = self.remat and self.training and torch.is_grad_enabled()

        def wrap(block):
            return remat(block, self.remat_policy) if on else block
        full = temporally_shared(wrap(self.in_conv), x, pad_mask, self.pad_value)
        reduced = full
        for blk in self.spatial_reduction:
            reduced = temporally_shared(wrap(blk), reduced, pad_mask, self.pad_value)
        att = self.temporal_encoder(reduced, batch_positions, pad_mask,
                                    generator=generator)
        del reduced
        feature_maps = [temporal_aggregate(full, attn=att, pad_mask=pad_mask,
                                           mode=self.agg_mode)]
        del full
        for down in self.down_blocks:
            feature_maps.append(wrap(down)(feature_maps[-1]))
        out = feature_maps[-1]
        maps = [out]
        for i, up in enumerate(self.up_blocks):
            out = up(out, feature_maps[-(i + 2)])
            maps.append(out)
        if self.encoder:
            return out, maps
        heads = (self.out_conv(out),)
        if self.boundary_conv is not None:
            heads += (self.boundary_conv(out),)
        if return_att:
            return heads + (att,)
        if self.return_maps:
            return heads + (maps,)
        return heads if len(heads) > 1 else heads[0]
