"""TimeUNet_v1 (port of crop2seg_tpu/models/timeunet.py:26-168).

    x (B,T,H,W,C) --shared in_conv--> (B,T,H,W,64)
    --L-TAE at full resolution--> (B,H,W,64)      # collapses T before the UNet
    --plain UNet encoder/decoder--> logits (B,H,W,K)

On the kernel path (``fused``, the default for a CUDA input) in_conv defers
its last GroupNorm + ReLU: it returns the raw conv output with the per-frame
affine ``(sc, sh)``, the pad mask is folded in as zeroed rows, and the L-TAE
kernels apply ``max(z * sc + sh, 0)`` on load: the fused eval kernel in eval
mode, the ``ltae_pool_tail`` pair in training mode (the JAX package's
``use_pallas_train`` path, crop2seg_tpu/models/timeunet.py:89-120). The
plain path (the default for a CPU input) runs in_conv through
``temporally_shared``, and so does the kernel path when the tail cannot be
deferred: in_conv does not end in GroupNorm + ReLU (``encoder_norm="batch"``)
or ``pad_value`` is not 0 (the kernels fold pads in as zero rows); the L-TAE
then takes the untailed pair in training. ``defer_tail`` forces the
choice: True defers the tail on the plain path too (training mode:
``ltae_pool_tail``'s plain version; it raises with ``pad_value`` != 0),
False never defers it. All routes give the same result.

In training mode (``model.train()``) the L-TAE takes its training path and
every BatchNorm uses batch statistics and updates its running ones. Under
``torch.autocast`` every normalization keeps fp32 statistics, and the L-TAE's
folds and PE stay fp32.

``remat`` checkpoints activations in training: the down blocks, the up
blocks and out_conv each recompute whole in the backward pass
(``nn/layers.py::remat``, which leaves BatchNorm's running statistics alone
on the recompute). The JAX ``nn.remat`` also checkpoints in_conv; here in_conv
stays outside, with the L-TAE and its kernel pair. in_conv's backward comes
last and its activations (all B * T frames at full resolution) set the
step's peak memory: recomputing them there rebuilds them at the moment of
the peak, so it would cost a whole in_conv forward and save nothing. The
blocks that are checkpointed run at B frames, so ``remat`` has no visible
effect on the peak memory of a TimeUNet step (PERF.md).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from crop2seg_tpu_torch.nn.layers import ConvBlock, DownConvBlock, UpConvBlock, remat
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_input, temporally_shared


class TimeUNet(nn.Module):
    def __init__(self, input_dim: int = 10,
                 encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (32, 20), str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1,
                 encoder_norm: str = "group", n_head: int = 16,
                 d_model: int = 256, d_k: int = 4, pad_value: float = 0.0,
                 padding_mode: str = "reflect", use_abs_rel_enc: bool = False,
                 num_queries: int = 1, use_doy: bool = False,
                 add_linear: bool = False, defer_tail: bool | None = None,
                 remat: bool = False):
        super().__init__()
        if num_queries != 1:
            raise ValueError(
                "TimeUNet takes num_queries=1 only: with more queries the JAX "
                "TimeUNet fails too (its U-Net cannot take the (B, nq, H, W, C) "
                "L-TAE output); the LTAE module alone takes num_queries > 1")
        enc_w, dec_w = tuple(encoder_widths), tuple(decoder_widths)
        n = len(enc_w)
        self.pad_value, self.remat = pad_value, remat
        # None: defer on the kernel path when in_conv ends in GroupNorm + ReLU
        # and pads are zeros
        self.defer_tail = defer_tail
        self._tail_deferrable = encoder_norm == "group" and pad_value == 0
        self.in_conv = ConvBlock((input_dim, enc_w[0], enc_w[0]),
                                 norm=encoder_norm, padding_mode=padding_mode)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(enc_w[i], enc_w[i + 1], k=str_conv_k, s=str_conv_s,
                          p=str_conv_p, norm=encoder_norm,
                          padding_mode=padding_mode)
            for i in range(n - 1))
        self.up_blocks = nn.ModuleList(
            UpConvBlock(dec_w[i], dec_w[i - 1], enc_w[i - 1], k=str_conv_k,
                        s=str_conv_s, p=str_conv_p, norm="batch",
                        padding_mode=padding_mode)
            for i in range(n - 1, 0, -1))
        self.temporal_encoder = LTAE(
            in_channels=enc_w[0], d_model=d_model, n_head=n_head, d_k=d_k,
            mlp=(d_model, enc_w[0]),
            use_abs_rel_enc=use_abs_rel_enc, num_queries=num_queries,
            use_doy=False if use_abs_rel_enc else use_doy,
            add_linear=add_linear)
        self.out_conv = ConvBlock((dec_w[0],) + tuple(out_conv),
                                  padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *,
                fused: bool | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, T, H, W, C), batch_positions (B, T), pad_mask (B, T) bool ->
        logits (B, H, W, K). ``fused``: None picks the kernel path for a CUDA
        input and the plain path for a CPU input; True/False force one.
        ``generator`` draws the L-TAE's dropout masks in training mode."""
        if pad_mask is None:
            pad_mask = pad_mask_from_input(x, self.pad_value)
        if fused is None:
            fused = x.is_cuda
        b, t = x.shape[:2]
        on = self.remat and self.training and torch.is_grad_enabled()

        def wrap(block):
            return remat(block) if on else block
        defer = (fused and self._tail_deferrable if self.defer_tail is None
                 else self.defer_tail)
        if defer:
            if self.pad_value != 0:
                raise NotImplementedError(
                    "the deferred tail folds pads in as zero rows: pad_value "
                    "must be 0 with defer_tail=True")
            z, sc, sh = self.in_conv(x.reshape((b * t,) + tuple(x.shape[2:])), True)
            valid = (~pad_mask).reshape(b * t, 1).to(sc.dtype)
            tail = ((sc * valid).reshape(b, t, -1), (sh * valid).reshape(b, t, -1))
            out, _ = self.temporal_encoder(
                z.reshape((b, t) + tuple(z.shape[1:])), batch_positions,
                pad_mask, need_attn=False, tail_affine=tail, fused=fused,
                generator=generator)
        else:
            out = temporally_shared(self.in_conv, x, pad_mask, self.pad_value)
            out, _ = self.temporal_encoder(out, batch_positions, pad_mask,
                                           need_attn=False, fused=fused,
                                           generator=generator)
        feature_maps = [out]
        for down in self.down_blocks:
            feature_maps.append(wrap(down)(feature_maps[-1]))
        out = feature_maps[-1]
        for i, up in enumerate(self.up_blocks):
            out = wrap(up)(out, feature_maps[-(i + 2)])
        return wrap(self.out_conv)(out)
