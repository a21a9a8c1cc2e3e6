"""U-TAE, plain float32 (Garnot & Chamard, ICCV 2021, arXiv:2107.07933;
utae-paps ``src/backbones/utae.py``).

    x (B, T, H, W, C) --in_conv and the strided down blocks, on every frame-->
    f0..f3 (T kept; pad frames 0) --L-TAE on f3--> bottleneck + attention
    skips: the attention-weighted sums of f2, f1, f0 over T (``att_group``)
    decoder: up blocks --> out_conv --> logits (B, H, W, K)

Every width comes from the configuration file. Training mode draws the
L-TAE's dropout masks from the caller's generator as ``torch.rand`` draws
(``ops.RandDrops``): the attention's, then the MLP's.
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
        if cfg["agg_mode"] != "att_group":
            raise ValueError("the reference U-TAE aggregates with att_group only")
        self.prec = ops.Precision(precision)
        self.n_head, self.levels = cfg["n_head"], len(enc)
        self.stride = s
        self.in_conv = ops.ConvBlock((cfg["input_dim"], enc[0], enc[0]), nk, pm)
        self.down_blocks = nn.ModuleList(
            ops.DownConvBlock(enc[i], enc[i + 1], k, s, p, nk, pm) for i in range(len(enc) - 1))
        self.up_blocks = nn.ModuleList(
            ops.UpConvBlock(dec[i], dec[i - 1], enc[i - 1], k, s, p, pm)
            for i in range(len(enc) - 1, 0, -1))
        self.temporal_encoder = ops.LTAE(enc[-1], cfg["n_head"], cfg["d_k"], cfg["d_model"],
                                         dec[-1], cfg["dropout"], cfg["attn_dropout"])
        self.out_conv = ops.ConvBlock([dec[0]] + list(cfg["out_conv"]), "batch", pm)

    def _shared(self, block, f, b, t, checkpointed):
        """``block`` on every frame of f (B, T, C, H, W); pad frames are
        zeroed by the caller."""
        y = ops.run_checkpointed(block, f.reshape(b * t, *f.shape[2:]), self.prec,
                                 enabled=checkpointed)
        return y.reshape(b, t, *y.shape[1:])

    def forward(self, x, dates, pad, generator=None, checkpointed=False):
        """x (B, T, H, W, C), dates (B, T), pad (B, T) bool -> logits (B, H,
        W, K). ``generator``: training's dropout draws. ``checkpointed``:
        recompute the frame-wise encoder in the backward pass (memory
        only)."""
        b, t, hh, ww, c = x.shape
        live = (~pad).float()[:, :, None, None, None]
        f = x.permute(0, 1, 4, 2, 3)
        maps = [self._shared(self.in_conv, f, b, t, checkpointed) * live]
        for down in self.down_blocks:
            maps.append(self._shared(down, maps[-1], b, t, checkpointed) * live)
        drops = None
        if self.training and generator is not None:
            n = maps[-1].shape[-2] * maps[-1].shape[-1]
            te = self.temporal_encoder
            drops = ops.RandDrops(generator, te.attn_dropout, te.dropout,
                                  (b, n, self.n_head, t))
        out, att = self.temporal_encoder(maps[-1], dates, pad, self.prec, drops)
        for i, up in enumerate(self.up_blocks):
            skip = ops.aggregate(maps[-(i + 2)], att, pad, self.prec)
            out = up(out, skip, self.prec)
        return self.out_conv(out, self.prec).permute(0, 2, 3, 1)

    def ltae_launch(self, batch: int, t: int, side: int) -> dict:
        """The shape of one launch of the L-TAE's eval kernel on ``batch``
        samples: the bottleneck's pixel rows, the attention returned for the
        skips."""
        te = self.temporal_encoder
        low = side // self.stride ** (self.levels - 1)
        return dict(b=batch, t=t, n=low * low, c=te.in_norm.num_channels,
                    d=te.d_model, g=te.n_head, d_out=te.out_norm.num_channels,
                    tail=False, need_attn=True)
