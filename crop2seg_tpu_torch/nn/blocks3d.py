"""3-D conv blocks sliding over (T, H, W) and the aggregator with a learned
upsampling of the attention masks (port of crop2seg_tpu/nn/blocks3d.py).

- ``ConvLayer3D`` / ``ConvBlock3D`` / ``DownConvBlock3D``: 3-D convolutions
  with their stride and padding spatial only (the temporal kernel pads 1),
  zero padding; the layer's units sit in one ``nn.Sequential`` named
  ``conv`` (conv, [norm], [ReLU] per unit), as ``nn/layers.py::ConvLayer``
  lays out the 2-D ones.
- ``TemporalAggregator3D``: ``att_group`` / ``att_mean`` aggregation whose
  attention masks, where coarser than the skip, are upsampled x2 by a
  learned 3-D transposed conv + conv + softmax over T (``up_deconv``,
  ``up_conv``), where finer, average-pooled down; ``mean`` is the masked
  temporal mean.

Layout (B, T, H, W, C), depth = time. The modules no entry point of the
JAX package reaches; they are kept for its component inventory. Inside
``nn/layers.py::space_shards`` each rank holds a slice of H (dim 2): the
3-D convolutions and transposed convolutions halo along it; GroupNorm3d
and InstanceNorm3d fold T into H, whose moments ``frame_mean`` sums over
the shards; the attention masks' learned upsampling halos too, and their
pooling needs whole windows on each shard.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from crop2seg_tpu_torch.nn.layers import (
    GroupNorm, InstanceNorm2d, batch_norm, conv_rows, space_group, transposed_conv_rows)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1).contiguous()


class Conv3d(nn.Conv3d):
    """torch Conv3d (zero padding) on (B, T, H, W, C). Inside
    ``nn/layers.py::space_shards`` H (dim 2) takes its neighbours' rows
    (``conv_rows``) and zeros only at the global top and bottom."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = space_group()
        if group is None:
            return _ndhwc(F.conv3d(_ncdhw(x), self.weight, self.bias, self.stride,
                                   self.padding, self.dilation, self.groups))
        pt, ph, pw = self.padding
        x, top, bottom = conv_rows(x, self.kernel_size[1], self.stride[1], ph,
                                   self.dilation[1], group, dim=2)
        return _ndhwc(F.conv3d(F.pad(_ncdhw(x), (pw, pw, top, bottom, pt, pt)), self.weight,
                               self.bias, self.stride, 0, self.dilation, self.groups))


class ConvTranspose3d(nn.ConvTranspose3d):
    """torch ConvTranspose3d on (B, T, H, W, C). Inside
    ``nn/layers.py::space_shards`` H (dim 2) takes the neighbours' rows that
    reach this rank's output rows (``transposed_conv_rows``), and the output
    is cropped back to the rows this rank owns."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = space_group()
        if group is None:
            return _ndhwc(F.conv_transpose3d(_ncdhw(x), self.weight, self.bias, self.stride,
                                             self.padding, self.output_padding, self.groups,
                                             self.dilation))
        s, h = self.stride[1], x.shape[2]
        op_t, op_h, op_w = self.output_padding
        x, m = transposed_conv_rows(x, self.kernel_size[1], s, self.padding[1], op_h,
                                    self.dilation[1], group, dim=2)
        y = F.conv_transpose3d(_ncdhw(x), self.weight, self.bias, self.stride, self.padding,
                               (op_t, 0, op_w), self.groups, self.dilation)
        return _ndhwc(y[:, :, :, s * m:s * (m + h)])


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm3d on (B, T, H, W, C), in either mode (``nn/layers.py::batch_norm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self)


class GroupNorm3d(GroupNorm):
    """GroupNorm of (B, T, H, W, C), statistics over (T, H, W, C/G) per sample."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        return super().forward(x.reshape(b, t * h, w, c)).reshape(x.shape)


class InstanceNorm3d(InstanceNorm2d):
    """InstanceNorm3d(affine=False) on (B, T, H, W, C): each channel of each
    sample normalized over (T, H, W)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        return super().forward(x.reshape(b, t * h, w, c)).reshape(x.shape)


def make_norm3d(norm: str, n_groups: int = 4):
    """``norm`` ("batch", "group", "instance"; else none) -> (features ->
    module) or None."""
    if norm == "batch":
        return lambda c: BatchNorm3d(c, eps=1e-5)
    if norm == "group":
        return lambda c: GroupNorm3d(n_groups, c, eps=1e-5)
    if norm == "instance":
        return lambda c: InstanceNorm3d(c, eps=1e-5, affine=False)
    return None


class ConvLayer3D(nn.Module):
    """Stacked (Conv3d -> norm -> ReLU) units: kernel (k_3d, k, k), stride
    (1, s, s), padding (1, p, p). ``nkernels`` lists the widths including the
    input width; ``last_relu=False`` drops the final ReLU."""

    def __init__(self, nkernels: Sequence[int], norm: str = "batch", k: int = 3,
                 k_3d: int = 3, s: int = 1, p: int = 1, n_groups: int = 4,
                 last_relu: bool = True):
        super().__init__()
        norm_fn = make_norm3d(norm, n_groups)
        layers = []
        n = len(nkernels) - 1
        for i in range(n):
            layers.append(Conv3d(nkernels[i], nkernels[i + 1], (k_3d, k, k),
                                 stride=(1, s, s), padding=(1, p, p)))
            if norm_fn is not None:
                layers.append(norm_fn(nkernels[i + 1]))
            if last_relu or i < n - 1:
                layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvBlock3D(nn.Module):
    """Resolution-preserving 3-D block: ``conv`` is one ConvLayer3D."""

    def __init__(self, nkernels: Sequence[int], norm: str = "batch",
                 last_relu: bool = True):
        super().__init__()
        self.conv = ConvLayer3D(nkernels, norm=norm, last_relu=last_relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DownConvBlock3D(nn.Module):
    """Spatially strided 3-D down conv (``down``, d_in -> d_in, kernel
    (k_3d, k, k), stride (1, s, s)), then ``conv1`` (d_in -> d_out) and the
    residual ``out + conv2(out)``."""

    def __init__(self, d_in: int, d_out: int, k: int = 4, k_3d: int = 3, s: int = 2,
                 p: int = 1, norm: str = "batch"):
        super().__init__()
        self.down = ConvLayer3D((d_in, d_in), norm=norm, k=k, k_3d=k_3d, s=s, p=p)
        self.conv1 = ConvLayer3D((d_in, d_out), norm=norm)
        self.conv2 = ConvLayer3D((d_out, d_out), norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.down(x))
        return x + self.conv2(x)


class TemporalAggregator3D(nn.Module):
    """Aggregation of x (B, T, H, W, C) over T with the attention masks attn
    (B, h_a, w_a, head, T) and pad_mask (B, T). Returns (out (B, H, W, C),
    the masks at the skip's resolution: (B, head, H, W, T) in ``att_group``,
    (B, H, W, T) in ``att_mean``, None in ``mean``).

    ``att_group`` weighs each head's channel group with its head's mask,
    ``att_mean`` every channel with the mean of the head masks (averaged
    before the learned upsampling); pad steps get weight 0. Masks coarser
    than the skip are upsampled x2 (``up_deconv``: ConvTranspose3d, kernel
    (3, 4, 4), stride (1, 2, 2); ``up_conv``: Conv3d 3; softmax over T), finer
    ones average-pooled down by the ratio."""

    def __init__(self, mode: str = "att_group"):
        super().__init__()
        self.mode = mode
        if mode != "mean":
            self.up_deconv = ConvTranspose3d(1, 1, (3, 4, 4), stride=(1, 2, 2), padding=1)
            self.up_conv = Conv3d(1, 1, 3, padding=1)

    def forward(self, x: torch.Tensor, attn: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None):
        b, t, h, w, c = x.shape
        valid = None if pad_mask is None else (~pad_mask).to(x.dtype)
        if self.mode == "mean":
            if valid is None:
                return x.mean(dim=1), None
            num = torch.einsum("bt,bthwc->bhwc", valid, x)
            return num / valid.sum(dim=1)[:, None, None, None], None

        ha, wa, n_head = attn.shape[1], attn.shape[2], attn.shape[3]
        a = attn.permute(0, 3, 4, 1, 2)                  # (B, head, T, ha, wa)
        streams = n_head
        if self.mode == "att_mean":
            a, streams = a.mean(dim=1, keepdim=True), 1
        a = a.reshape(b * streams, t, ha, wa, 1)
        if h > ha:
            a = torch.softmax(self.up_conv(self.up_deconv(a)), dim=1)
        elif ha > h:
            k = ha // h
            if space_group() is not None and ha != k * h:
                raise ValueError(f"space shards of {ha} attention rows do not pool by {k} "
                                 f"into {h} rows")
            a = _ndhwc(F.avg_pool3d(_ncdhw(a), (1, k, k), (1, k, k)))
        a = a[..., 0].reshape(b, streams, t, h, w).movedim(2, 4)   # (B, s, H, W, T)
        if self.mode == "att_mean":
            a = a[:, 0]
            if valid is not None:
                a = a * valid[:, None, None, :]
            return torch.einsum("bhwt,bthwc->bhwc", a.to(x.dtype), x), a
        if valid is not None:
            a = a * valid[:, None, None, None, :]
        xg = x.reshape(b, t, h, w, n_head, c // n_head)
        out = torch.einsum("bghwt,bthwgd->bhwgd", a.to(xg.dtype), xg)
        return out.reshape(b, h, w, c), a
