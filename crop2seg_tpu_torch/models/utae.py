"""U-TAE (port of crop2seg_tpu/models/utae.py:30-181).

    x (B,T,H,W,C) --shared in_conv--> f0 --shared down blocks--> f3 (T kept)
    f3 --L-TAE--> bottleneck (B,h,w,dec_w[-1]) + attention (B,h,w,head,T)
    skips: temporal_aggregate(f_i, attn); decoder: UpConvBlock chain
    head: out_conv -> logits (B,H,W,K) [+ boundary head (B,H,W,2)]

The L-TAE runs at the lowest resolution with C = encoder_widths[-1] (128 at
the factory defaults): in eval with ``use_pallas`` (True by default; the JAX
module's default is False, and its serving callers pass True) on a CUDA
input it takes the fused eval kernel with its attention output (``fused``,
as in ``TimeUNet``), on a CPU input the plain ops; without ``use_pallas``
the plain ops. in_conv feeds a convolution, not the L-TAE, so no GroupNorm tail
is deferred on this path. Every tensor is channels-last; pad frames of each
shared block's output hold ``pad_value``, and every cross-T consumer masks
them.

In training mode (``model.train()``) the L-TAE takes its plain path, as the
JAX U-TAE does (it has no ``use_pallas_train``: its L-TAE is built without
the pair), whatever ``fused`` says: attention dropout after the softmax, and
the skips aggregate the dropped attention. No kernel runs there, in JAX
either; with ``agg_mode="mean"`` too, which asks for no attention.
Every BatchNorm (the up blocks, the heads, and the encoder with
``encoder_norm="batch"``) uses batch statistics and updates its running ones.

``conv_type="depthwise_separable"`` and ``add_squeeze_excit`` change the
encoder's blocks (in_conv and the down blocks), as in the JAX U-TAE;
``use_mbconv`` makes every block an MBConv one (``nn/layers.py``), whose
GroupNorm heads need widths divisible by 4 (out_conv (32, 15) fails, in the
JAX package too).

``remat`` checkpoints activations as the JAX ``nn.remat`` does: in_conv
always, the down blocks with ``remat_down``, the up blocks and the heads with
``remat_decoder``. ``remat_policy`` None or ``"full"`` recomputes each block
whole in the backward pass; ``"conv_out"`` saves every convolution's output
and recomputes only the norm and ReLU tails. Recompute leaves BatchNorm's
running statistics alone, so gradients and statistics do not depend on the
remat settings.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from crop2seg_tpu_torch.nn.aggregator import temporal_aggregate
from crop2seg_tpu_torch.nn.layers import conv_blocks, remat, unet_space_rows
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_input, temporally_shared

REMAT_POLICIES = (None, "full", "conv_out")


class UTAE(nn.Module):
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
                 remat: bool = False, remat_decoder: bool = True,
                 remat_down: bool = True, remat_policy: str | None = None,
                 use_pallas: bool = True):
        super().__init__()
        if num_queries != 1:
            raise ValueError(
                "U-TAE takes num_queries=1 only: with more queries the JAX "
                "U-TAE fails too (its aggregator cannot take the (B, h, w, "
                "head, nq, T) attention); the LTAE module alone takes "
                "num_queries > 1")
        if remat_policy not in REMAT_POLICIES:
            # a typo would silently change what is recomputed
            raise ValueError(f"unknown remat_policy {remat_policy!r}: expected "
                             "None, 'full' or 'conv_out'")
        self.remat, self.remat_policy = remat, remat_policy
        self.remat_down, self.remat_decoder = remat_down, remat_decoder
        enc_w, dec_w = tuple(encoder_widths), tuple(decoder_widths)
        n = len(enc_w)
        self.agg_mode, self.pad_value = agg_mode, pad_value
        self.encoder, self.return_maps = encoder, return_maps
        # MBConv units pad by reflection whatever padding_mode says
        self.space_rows = unet_space_rows(n, str_conv_s,
                                          padding_mode == "reflect" or use_mbconv)
        in_block, down_block, up_block, out_block = conv_blocks(use_mbconv)
        self.in_conv = in_block((input_dim, enc_w[0], enc_w[0]), norm=encoder_norm,
                                padding_mode=padding_mode, conv_type=conv_type,
                                add_squeeze=add_squeeze_excit)
        self.down_blocks = nn.ModuleList(
            down_block(enc_w[i], enc_w[i + 1], k=str_conv_k, s=str_conv_s,
                       p=str_conv_p, norm=encoder_norm, padding_mode=padding_mode,
                       conv_type=conv_type, add_squeeze=add_squeeze_excit)
            for i in range(n - 1))
        self.up_blocks = nn.ModuleList(
            up_block(dec_w[i], dec_w[i - 1], enc_w[i - 1], k=str_conv_k,
                     s=str_conv_s, p=str_conv_p, norm="batch",
                     padding_mode=padding_mode)
            for i in range(n - 1, 0, -1))
        self.temporal_encoder = LTAE(
            in_channels=enc_w[-1], d_model=d_model, n_head=n_head, d_k=d_k,
            mlp=(d_model, dec_w[-1]), use_abs_rel_enc=use_abs_rel_enc,
            num_queries=num_queries,
            use_doy=False if use_abs_rel_enc else use_doy, add_linear=add_linear,
            use_pallas=use_pallas, use_pallas_train=False)
        self.out_conv = out_block((dec_w[0],) + tuple(out_conv),
                                  padding_mode=padding_mode)
        self.boundary_conv = (out_block((dec_w[0], 32, 2), padding_mode=padding_mode)
                              if add_boundary_loss else None)

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *, return_att: bool = False,
                fused: bool | None = None,
                generator: torch.Generator | None = None):
        """x (B, T, H, W, C), batch_positions (B, T) or (B, T, 2), pad_mask
        (B, T) bool -> logits (B, H, W, K); with the boundary head also its
        (B, H, W, 2) logits; ``return_att`` adds the attention (B, h, w,
        head, T), ``return_maps`` the decoder maps; ``encoder`` returns
        (decoder output, maps) before the head. ``fused`` (eval mode with
        ``use_pallas``): None picks the kernel for a CUDA input and the plain
        L-TAE for a CPU input; True/False force one. Training takes the
        plain L-TAE.
        ``generator`` (training) draws the L-TAE's dropout masks."""
        if pad_mask is None:
            pad_mask = pad_mask_from_input(x, self.pad_value)
        on = self.remat and self.training and torch.is_grad_enabled()

        def wrap(block, enabled=True):
            return remat(block, self.remat_policy) if on and enabled else block
        feature_maps = [temporally_shared(wrap(self.in_conv), x, pad_mask,
                                          self.pad_value)]
        for down in self.down_blocks:
            feature_maps.append(temporally_shared(
                wrap(down, self.remat_down), feature_maps[-1], pad_mask,
                self.pad_value))
        out, att = self.temporal_encoder(
            feature_maps[-1], batch_positions, pad_mask,
            need_attn=return_att or self.agg_mode != "mean",
            fused=fused, generator=generator)
        maps = [out]
        for i, up in enumerate(self.up_blocks):
            skip = temporal_aggregate(feature_maps[-(i + 2)], attn=att,
                                      pad_mask=pad_mask, mode=self.agg_mode)
            out = wrap(up, self.remat_decoder)(out, skip)
            maps.append(out)
        if self.encoder:
            return out, maps
        heads = (wrap(self.out_conv, self.remat_decoder)(out),)
        if self.boundary_conv is not None:
            heads += (wrap(self.boundary_conv, self.remat_decoder)(out),)
        if return_att:
            return heads + (att,)
        if self.return_maps:
            return heads + (maps,)
        return heads if len(heads) > 1 else heads[0]
