"""TimeUNet_v1, plain float32 (Crop2Seg ``src/backbones/timeunet.py``
``TimeUNet_v1``, the model ``src/webapp/prediction.py`` serves).

    x (B, T, H, W, C) --in_conv on every frame--> (B, T, 64, H, W), pad frames 0
    --L-TAE at full resolution--> (B, 64, H, W)
    --U-Net encoder (strided down blocks) and decoder (up blocks)--> out_conv
    --> logits (B, H, W, K)

Every width comes from the configuration file. Training mode draws the
L-TAE's dropout masks from the caller's generator as the kernel-pair route
draws them (``ops.HashDrops``).
"""
from __future__ import annotations

from torch import nn

from portbench.reference import ops


class Model(nn.Module):
    def __init__(self, cfg: dict, precision: str = "fp32"):
        super().__init__()
        enc, dec = list(cfg["encoder_widths"]), list(cfg["decoder_widths"])
        k, s, p = cfg["str_conv_k"], cfg["str_conv_s"], cfg["str_conv_p"]
        pm, nk = cfg["padding_mode"], cfg["encoder_norm"]
        self.prec = ops.Precision(precision)
        self.n_head = cfg["n_head"]
        self.in_conv = ops.ConvBlock((cfg["input_dim"], enc[0], enc[0]), nk, pm)
        self.down_blocks = nn.ModuleList(
            ops.DownConvBlock(enc[i], enc[i + 1], k, s, p, nk, pm) for i in range(len(enc) - 1))
        self.up_blocks = nn.ModuleList(
            ops.UpConvBlock(dec[i], dec[i - 1], enc[i - 1], k, s, p, pm)
            for i in range(len(enc) - 1, 0, -1))
        self.temporal_encoder = ops.LTAE(enc[0], cfg["n_head"], cfg["d_k"], cfg["d_model"],
                                         enc[0], cfg["dropout"], cfg["attn_dropout"])
        self.out_conv = ops.ConvBlock([dec[0]] + list(cfg["out_conv"]), "batch", pm)

    def drops(self, generator, x_shape):
        b, t, hh, ww, _ = x_shape
        te = self.temporal_encoder
        return ops.HashDrops(generator, te.attn_dropout, te.dropout, b, t, hh * ww, self.n_head)

    def forward(self, x, dates, pad, generator=None, checkpointed=False):
        """x (B, T, H, W, C), dates (B, T), pad (B, T) bool -> logits (B, H,
        W, K). ``generator``: training's dropout draws. ``checkpointed``:
        recompute the frame-wise encoder and the L-TAE's pixel chunks in the
        backward pass (memory only)."""
        b, t, hh, ww, c = x.shape
        drops = (self.drops(generator, x.shape) if self.training and generator is not None
                 else None)
        frames = x.reshape(b * t, hh, ww, c).permute(0, 3, 1, 2)
        f = ops.run_checkpointed(self.in_conv, frames, self.prec, enabled=checkpointed)
        f = f.reshape(b, t, -1, hh, ww) * (~pad).float()[:, :, None, None, None]
        out, _ = self.temporal_encoder(f, dates, pad, self.prec, drops, checkpointed)
        maps = [out]
        for down in self.down_blocks:
            maps.append(down(maps[-1], self.prec))
        out = maps[-1]
        for i, up in enumerate(self.up_blocks):
            out = up(out, maps[-(i + 2)], self.prec)
        return self.out_conv(out, self.prec).permute(0, 2, 3, 1)

    def ltae_launch(self, batch: int, t: int, side: int) -> dict:
        """The shape of one launch of the L-TAE's kernels on ``batch``
        samples of T dates and side^2 pixels: N pixel rows of C channels,
        d_out outputs; the producing conv's GroupNorm affine is applied on
        load (``tail``), the attention is not returned."""
        te = self.temporal_encoder
        return dict(b=batch, t=t, n=side * side, c=te.in_norm.num_channels,
                    d=te.d_model, g=te.n_head, d_out=te.out_norm.num_channels,
                    tail=True, need_attn=False)
