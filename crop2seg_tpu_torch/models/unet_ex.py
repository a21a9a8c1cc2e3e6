"""mmseg-style U-Net blocks, the "Exchanger" variants (port of
crop2seg_tpu/models/unet_ex.py): ``ConvModuleEx``, ``BasicConvBlockEx``,
``DeconvModuleEx``, ``InterpConvEx``, ``UpConvBlockEx`` and ``UNetEx``, a
standalone 2-D segmentation backbone that no model of the factory uses:
bias-free convs, exact-erf GELU by default, a MaxPool entry on each
stride-1 downsampled stage, and a decoder that returns every resolution.

Channels-last NHWC like the rest of the port. Inside
``nn/layers.py::space_shards`` each rank holds a slice of H: the convs
(dilated ones included) and the transposed conv take their neighbours'
rows, the bilinear upsample too, the MaxPool pools whole windows on each
shard (an even number of rows at every pooled stage) and BatchNorm takes
the global batch's statistics under ``global_batch_stats``. Module names
follow the reference's state dict (``encoder.{i}.{0|1}.convs.{j}.conv`` /
``.norm``, ``decoder.{j}.upsample.interp_upsample.1`` /
``deconv_upsamping``, ``decoder.{j}.conv_block.convs.{k}``), so its state
dicts load with ``load_state_dict``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from crop2seg_tpu_torch.nn.layers import (
    Conv2d, ConvTranspose2d, _nchw, _nhwc, make_norm, space_group, upsample_rows)


def _act(name: str) -> nn.Module:
    return nn.GELU() if name == "gelu" else nn.ReLU()  # GELU: exact erf


class _NHWCConv2d(Conv2d):
    """torch Conv2d (zero padding, dilation) on NHWC (``nn/layers.py::
    Conv2d``, which halos inside ``space_shards``)."""


class _MaxPool2d(nn.MaxPool2d):
    """MaxPool2d(2) on NHWC: a stage's entry. Inside ``space_shards`` each
    shard pools its own rows, in whole windows."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if space_group() is not None and x.shape[1] % self.kernel_size:
            raise ValueError(f"space shards of {x.shape[1]} rows do not pool by "
                             f"{self.kernel_size}")
        return _nhwc(super().forward(_nchw(x)))


class _Upsample(nn.Module):
    """Bilinear x2 upsampling, align_corners=False, on NHWC
    (``nn/layers.py::upsample_rows``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(upsample_rows(_nchw(x), 2 * x.shape[1], 2 * x.shape[2]))


class ConvModuleEx(nn.Module):
    """Bias-free conv -> norm -> activation (mmseg ConvModule)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, padding: int = 0,
                 norm: str = "batch", act: str = "relu"):
        super().__init__()
        self.conv = _NHWCConv2d(in_channels, features, kernel_size, stride=stride,
                                padding=padding, dilation=dilation, bias=False)
        norm_fn = make_norm(norm)
        self.norm = norm_fn(features) if norm_fn is not None else None
        self.act = _act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class BasicConvBlockEx(nn.Module):
    """``num_convs`` stacked 3x3 ConvModules (``convs``): the first may
    stride, the others dilate."""

    def __init__(self, in_channels: int, features: int, num_convs: int = 2,
                 stride: int = 1, dilation: int = 1, norm: str = "batch",
                 act: str = "relu"):
        super().__init__()
        self.convs = nn.Sequential(*(
            ConvModuleEx(in_channels if i == 0 else features, features,
                         stride=stride if i == 0 else 1,
                         dilation=1 if i == 0 else dilation,
                         padding=1 if i == 0 else dilation, norm=norm, act=act)
            for i in range(num_convs)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


class DeconvModuleEx(nn.Module):
    """Transposed-conv x2 upsampling (with its bias) + norm + activation,
    ``deconv_upsamping`` as mmseg names it."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 norm: str = "batch", act: str = "relu"):
        super().__init__()
        norm_fn = make_norm(norm)
        layers = [ConvTranspose2d(in_channels, features, kernel_size, stride=2,
                                  padding=(kernel_size - 2) // 2)]
        if norm_fn is not None:
            layers.append(norm_fn(features))
        layers.append(_act(act))
        self.deconv_upsamping = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv_upsamping(x)


class InterpConvEx(nn.Module):
    """Bilinear x2 (align_corners=False) upsampling, then a 1x1 ConvModule
    (``interp_upsample``: Upsample at index 0, the ConvModule at 1)."""

    def __init__(self, in_channels: int, features: int, norm: str = "batch",
                 act: str = "relu"):
        super().__init__()
        self.interp_upsample = nn.Sequential(
            _Upsample(), ConvModuleEx(in_channels, features, kernel_size=1,
                                      norm=norm, act=act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.interp_upsample(x)


class UpConvBlockEx(nn.Module):
    """Upsample the deep map to the skip's width, concat [skip, up], then a
    conv block on 2 * skip channels."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 num_convs: int = 2, dilation: int = 1, use_deconv: bool = False,
                 norm: str = "batch", act: str = "relu"):
        super().__init__()
        self.conv_block = BasicConvBlockEx(2 * skip_channels, features, num_convs,
                                           dilation=dilation, norm=norm, act=act)
        up_cls = DeconvModuleEx if use_deconv else InterpConvEx
        self.upsample = up_cls(in_channels, skip_channels, norm=norm, act=act)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([skip, self.upsample(x)], dim=-1))


class UNetEx(nn.Module):
    """mmseg-style encoder/decoder U-Net. Defaults as the reference's: 4
    stages, stride-1 encoder convs with MaxPool(2) stage entries, GELU,
    bilinear InterpConv upsampling. x (B, H, W, in_channels) -> the
    full-resolution decoder output (B, H, W, base_channels), plus every
    decoder resolution (bottleneck first) with ``return_maps``;
    ``num_classes`` adds a 1x1 head (``head``)."""

    def __init__(self, in_channels: int = 10, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 1, 1, 1),
                 enc_num_convs: Sequence[int] = (2, 2, 2, 2),
                 dec_num_convs: Sequence[int] = (2, 2, 2),
                 downsamples: Sequence[bool] = (True, True, True),
                 enc_dilations: Sequence[int] = (1, 1, 1, 1),
                 dec_dilations: Sequence[int] = (1, 1, 1), act: str = "gelu",
                 norm: str = "batch", use_deconv: bool = False,
                 num_classes: int | None = None, return_maps: bool = False):
        super().__init__()
        self.return_maps = return_maps
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        width = in_channels
        for i in range(num_stages):
            stage = []
            if i != 0 and strides[i] == 1 and downsamples[i - 1]:
                stage.append(_MaxPool2d(2))
            feats = base_channels * 2 ** i
            stage.append(BasicConvBlockEx(width, feats, enc_num_convs[i], strides[i],
                                          enc_dilations[i], norm=norm, act=act))
            self.encoder.append(nn.Sequential(*stage))
            if i != 0:
                self.decoder.append(UpConvBlockEx(
                    feats, base_channels * 2 ** (i - 1), base_channels * 2 ** (i - 1),
                    dec_num_convs[i - 1], dec_dilations[i - 1], use_deconv,
                    norm=norm, act=act))
            width = feats
        self.head = (_NHWCConv2d(base_channels, num_classes, 1)
                     if num_classes is not None else None)

    def forward(self, x: torch.Tensor):
        enc_outs = []
        for stage in self.encoder:
            x = stage(x)
            enc_outs.append(x)
        dec_outs = [x]
        for i in range(len(self.decoder) - 1, -1, -1):
            x = self.decoder[i](x, enc_outs[i])
            dec_outs.append(x)
        out = x if self.head is None else self.head(x)
        return (out, dec_outs) if self.return_maps else out
