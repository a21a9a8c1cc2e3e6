"""Spatial conv layers of TimeUNet (port of crop2seg_tpu/nn/layers.py:280-695).

Every module takes and returns channels-last NHWC tensors, as in the JAX
package. Inside, a convolution sees the NCHW view of the same memory
(``permute(0, 3, 1, 2)``, which PyTorch treats as the channels_last memory
format), so cuDNN runs its NHWC kernels and no layout copy is made.
Normalizations are per-channel affines on the NHWC tensor, with statistics in
fp32. In training mode BatchNorm normalizes with the batch statistics and
updates its running ones as flax ``BatchNorm(momentum=0.9)`` does (see
``batch_norm``), except inside ``frozen_running_stats`` (the recompute of an
activation-checkpointed block); GroupNorm is the same in both modes. Module and parameter
names follow the reference's torch modules, so its state dicts load with
``load_state_dict``.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Conv2d):
    """torch Conv2d(k, s, p, padding_mode) on NHWC: explicit reflect pad, then
    a VALID convolution (k3/s1, k4/s2 and the 1x1 skip conv)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = _nchw(x)
        p = self.padding[0]
        if p and self.padding_mode != "zeros":
            xc = F.pad(xc, (p, p, p, p), mode=self.padding_mode)
            p = 0
        return _nhwc(F.conv2d(xc, self.weight, self.bias, self.stride, p))


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch-exact ConvTranspose2d on NHWC (the decoder's k4/s2/p1 up-conv)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.conv_transpose2d(_nchw(x), self.weight, self.bias,
                                        self.stride, self.padding))


def _apply_affine(x: torch.Tensor, sc: torch.Tensor,
                  sh: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C) * sc + sh, with sc/sh (N, C) or (C,), in fp32."""
    if sc.dim() == 2:
        sc, sh = sc[:, None, None, :], sh[:, None, None, :]
    return torch.addcmul(sh, x.float(), sc).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over each NHWC frame, two-pass fp32 statistics."""

    def frame_affine(self, x: torch.Tensor):
        """Per-frame affine ``(sc, sh)``, each (N, C) fp32, such that
        ``x * sc + sh`` is the normalized frame."""
        n, h, w, c = x.shape
        g = x.float().reshape(n, h * w, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        inv = torch.rsqrt(var + self.eps)                   # (N, 1, G, 1)
        sc = (self.weight.float().reshape(1, self.num_groups, -1)
              * inv[:, 0]).reshape(n, c)
        sh = self.bias.float() - (mean[:, 0] * sc.reshape(
            n, self.num_groups, -1)).reshape(n, c)
        return sc, sh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply_affine(x, *self.frame_affine(x))


def batchnorm_affine(bn: nn.modules.batchnorm._BatchNorm):
    """Eval BatchNorm as ``(scale, shift)`` per channel, fp32."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


_stats_frozen = 0


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode BatchNorm inside keeps its running statistics as they are.
    Activation checkpointing runs a block's forward a second time in the
    backward pass; the JAX package's remat recomputes without a second state
    update, and so must the port."""
    global _stats_frozen
    _stats_frozen += 1
    try:
        yield
    finally:
        _stats_frozen -= 1


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """BatchNorm of a channels-last tensor (statistics over every dim but the
    last). Eval: the running statistics. Training: the batch mean and the
    biased batch variance in fp32, for the output and for the running update
    ``r = (1 - momentum) * r + momentum * batch`` (flax's ``BatchNorm(
    momentum=0.9)`` with torch's ``momentum=0.1``). torch's own
    ``F.batch_norm`` would put the unbiased variance into ``running_var``."""
    if not bn.training:
        return _apply_affine(x, *batchnorm_affine(bn))
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = (xf - mean).square().mean(dims)
    if not _stats_frozen:
        with torch.no_grad():
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
            bn.num_batches_tracked.add_(1)
    scale = bn.weight.float() * torch.rsqrt(var + bn.eps)
    return torch.addcmul(bn.bias.float() - mean * scale, xf, scale).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d on NHWC, in either mode (``batch_norm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self)


def make_norm(norm: str, n_groups: int = 4):
    """Normalization factory: ``norm`` -> (features -> module) or None."""
    if norm == "batch":
        return lambda c: BatchNorm2d(c, eps=1e-5)
    if norm == "group":
        return lambda c: GroupNorm(n_groups, c, eps=1e-5)
    if norm == "instance":
        raise NotImplementedError(
            "instance norm is not ported yet (slice F of ROADMAP.md)")
    return None


class ConvLayer(nn.Module):
    """Stack of (conv -> norm -> ReLU) units in one ``nn.Sequential`` named
    ``conv``, indexed like the reference (conv 3i, norm 3i+1, ReLU 3i+2).
    ``nkernels`` lists the widths including the input width;
    ``last_relu=False`` drops the final ReLU."""

    def __init__(self, nkernels: Sequence[int], norm: str = "batch",
                 k: int = 3, s: int = 1, p: int = 1, n_groups: int = 4,
                 last_relu: bool = True, padding_mode: str = "reflect"):
        super().__init__()
        norm_fn = make_norm(norm, n_groups)
        layers = []
        n = len(nkernels) - 1
        for i in range(n):
            layers.append(Conv2d(nkernels[i], nkernels[i + 1], k, stride=s,
                                 padding=p, padding_mode=padding_mode))
            if norm_fn is not None:
                layers.append(norm_fn(nkernels[i + 1]))
            if last_relu or i < n - 1:
                layers.append(nn.ReLU(inplace=True))
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, defer_tail_norm: bool = False):
        """defer_tail_norm: return the last unit as ``(z_raw, sc, sh)`` — the
        raw conv output plus its per-frame GroupNorm affine (N, C) fp32 —
        without normalizing or applying the ReLU; the consumer applies
        ``max(z * sc + sh, 0)`` (the fused L-TAE kernel does it on load)."""
        layers = list(self.conv)
        if not defer_tail_norm:
            for layer in layers:
                x = layer(x)
            return x
        norm, relu = layers[-2], layers[-1]
        if not (isinstance(norm, GroupNorm) and isinstance(relu, nn.ReLU)):
            raise ValueError("defer_tail_norm needs a GroupNorm+ReLU tail")
        for layer in layers[:-2]:
            x = layer(x)
        sc, sh = norm.frame_affine(x)
        return x, sc, sh


class ConvBlock(nn.Module):
    """Resolution-preserving conv block: ``conv`` is one ConvLayer."""

    def __init__(self, nkernels: Sequence[int], norm: str = "batch",
                 last_relu: bool = True, padding_mode: str = "reflect"):
        super().__init__()
        self.conv = ConvLayer(nkernels, norm=norm, last_relu=last_relu,
                              padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, defer_tail_norm: bool = False):
        return self.conv(x, defer_tail_norm=defer_tail_norm)


class DownConvBlock(nn.Module):
    """Strided down conv + residual conv pair:
    out = conv1(down(x)); out = out + conv2(out)."""

    def __init__(self, d_in: int, d_out: int, k: int = 4, s: int = 2,
                 p: int = 1, norm: str = "batch",
                 padding_mode: str = "reflect"):
        super().__init__()
        self.down = ConvLayer((d_in, d_in), norm=norm, k=k, s=s, p=p,
                              padding_mode=padding_mode)
        self.conv1 = ConvLayer((d_in, d_out), norm=norm,
                               padding_mode=padding_mode)
        self.conv2 = ConvLayer((d_out, d_out), norm=norm,
                               padding_mode=padding_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.down(x))
        return x + self.conv2(x)


class UpConvBlock(nn.Module):
    """Decoder block: deconv-up(x) ++ 1x1-conv(skip) -> conv1 -> +conv2."""

    def __init__(self, d_in: int, d_out: int, d_skip: int, k: int = 4,
                 s: int = 2, p: int = 1, norm: str = "batch",
                 padding_mode: str = "reflect"):
        super().__init__()
        self.skip_conv = nn.Sequential(
            Conv2d(d_skip, d_skip, 1), BatchNorm2d(d_skip), nn.ReLU(inplace=True))
        self.up = nn.Sequential(
            ConvTranspose2d(d_in, d_out, k, stride=s, padding=p),
            BatchNorm2d(d_out), nn.ReLU(inplace=True))
        self.conv1 = ConvLayer((d_out + d_skip, d_out), norm=norm,
                               padding_mode=padding_mode)
        self.conv2 = ConvLayer((d_out, d_out), norm=norm,
                               padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.up(x), self.skip_conv(skip)], dim=-1)
        out = self.conv1(out)
        return out + self.conv2(out)
