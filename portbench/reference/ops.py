"""Plain float32 PyTorch building blocks of the benchmark's reference models.

Written from the published U-TAE and Crop2Seg code (github.com/VSainteuf/
utae-paps ``src/backbones``, github.com/Many98/Crop2Seg ``src/backbones``),
with no kernel, no cache and no batching tricks. The modules hold their
parameters under the published state-dict names (``conv.0.weight``,
``mlp.2.running_var``, ...), so one state dict loads into the reference and
into the system under test; every forward is written out here in functional
ops on NCHW frames.

Departures from the published code, all shared with the system under test:

- BatchNorm's running variance takes the biased batch variance (flax's
  ``BatchNorm(momentum=0.9)``), where torch keeps the unbiased one;
- the L-TAE's MLP applies its dropout after the ReLU (the published
  ``nn.Sequential`` order puts it before the BatchNorm);
- the L-TAE's attention dropout of the kernel-pair route draws its keep mask
  from a stateless hash of (seed, b, t, n, g) (``hash_keep``).

``Precision`` decides how the operands of every convolution and matrix
product are rounded: "fp32" not at all, "fp8" to float8 e4m3 with one scale
per tensor (gradients to e5m2), the control that has to fail the check.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fake_quant(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to ``dtype`` under one scale that maps its largest |value|
    to ``top``, and back to x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fake_quant(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _fake_quant(grad, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """Rounds the operands of the reference's products: "fp32" leaves them
    as they are; "fp8" rounds each to float8 e4m3 (current per-tensor
    scaling) and its gradient to e5m2, as float8 training recipes do."""

    NAMES = ("fp32", "fp8")

    def __init__(self, name: str = "fp32"):
        if name not in self.NAMES:
            raise ValueError(f"unknown precision {name!r}: expected one of {self.NAMES}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Float8.apply(x) if self.name == "fp8" else x


def run_checkpointed(fn, *args, enabled: bool):
    """``fn(*args)``, its activations recomputed in the backward pass when
    ``enabled`` (memory only: the blocks that take it hold no BatchNorm and
    draw no random numbers)."""
    if enabled:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --- convolutions and norms (NCHW) -----------------------------------------

def conv2d(prec: Precision, x, conv: nn.Conv2d, padding_mode: str = "reflect"):
    """The published ``nn.Conv2d(padding_mode=...)``: pad, then convolve."""
    ph, pw = conv.padding
    if ph or pw:
        mode = "constant" if padding_mode == "zeros" else padding_mode
        x = F.pad(x, (pw, pw, ph, ph), mode=mode)
    return F.conv2d(prec(x), prec(conv.weight), conv.bias, conv.stride)


def batch_norm(x, bn: nn.modules.batchnorm._BatchNorm, training: bool):
    """BatchNorm over every dim but dim 1. Training: the batch's mean and
    biased variance, and ``running = 0.9 running + 0.1 batch``; eval: the
    running statistics."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    if training:
        mean = x.mean(dims)
        var = (x - mean.reshape(shape)).square().mean(dims)
        with torch.no_grad():
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    inv = torch.rsqrt(var + bn.eps)
    return (x - mean.reshape(shape)) * (inv * bn.weight).reshape(shape) + bn.bias.reshape(shape)


def norm(x, module, training: bool):
    if isinstance(module, nn.GroupNorm):
        return F.group_norm(x, module.num_groups, module.weight, module.bias, module.eps)
    return batch_norm(x, module, training)


class ConvLayer(nn.Module):
    """(conv -> norm -> ReLU) units in ``conv`` at the published indices
    (conv 3i, norm 3i+1, ReLU 3i+2); GroupNorm takes 4 groups."""

    def __init__(self, nkernels, norm_kind: str = "batch", k: int = 3, s: int = 1,
                 p: int = 1, last_relu: bool = True, padding_mode: str = "reflect"):
        super().__init__()
        layers = []
        for i in range(len(nkernels) - 1):
            layers.append(nn.Conv2d(nkernels[i], nkernels[i + 1], k, stride=s, padding=p))
            layers.append(nn.GroupNorm(4, nkernels[i + 1]) if norm_kind == "group"
                          else nn.BatchNorm2d(nkernels[i + 1]))
            layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)
        self.last_relu, self.padding_mode = last_relu, padding_mode

    def forward(self, x, prec: Precision):
        units = len(self.conv) // 3
        for i in range(units):
            x = conv2d(prec, x, self.conv[3 * i], self.padding_mode)
            x = norm(x, self.conv[3 * i + 1], self.training)
            if self.last_relu or i < units - 1:
                x = torch.relu(x)
        return x


class ConvBlock(nn.Module):
    def __init__(self, nkernels, norm_kind: str = "batch", padding_mode: str = "reflect"):
        super().__init__()
        self.conv = ConvLayer(nkernels, norm_kind, padding_mode=padding_mode)

    def forward(self, x, prec: Precision):
        return self.conv(x, prec)


class DownConvBlock(nn.Module):
    """out = conv1(down(x)); out + conv2(out)."""

    def __init__(self, d_in: int, d_out: int, k: int, s: int, p: int,
                 norm_kind: str, padding_mode: str):
        super().__init__()
        self.down = ConvLayer((d_in, d_in), norm_kind, k, s, p, padding_mode=padding_mode)
        self.conv1 = ConvLayer((d_in, d_out), norm_kind, padding_mode=padding_mode)
        self.conv2 = ConvLayer((d_out, d_out), norm_kind, padding_mode=padding_mode)

    def forward(self, x, prec: Precision):
        x = self.conv1(self.down(x, prec), prec)
        return x + self.conv2(x, prec)


class UpConvBlock(nn.Module):
    """[ReLU(BN(deconv(x))), ReLU(BN(conv1x1(skip)))] -> conv1 -> + conv2."""

    def __init__(self, d_in: int, d_out: int, d_skip: int, k: int, s: int, p: int,
                 padding_mode: str):
        super().__init__()
        self.skip_conv = nn.Sequential(nn.Conv2d(d_skip, d_skip, 1), nn.BatchNorm2d(d_skip),
                                       nn.ReLU())
        self.up = nn.Sequential(nn.ConvTranspose2d(d_in, d_out, k, stride=s, padding=p),
                                nn.BatchNorm2d(d_out), nn.ReLU())
        self.conv1 = ConvLayer((d_out + d_skip, d_out), "batch", padding_mode=padding_mode)
        self.conv2 = ConvLayer((d_out, d_out), "batch", padding_mode=padding_mode)

    def forward(self, x, skip, prec: Precision):
        de = self.up[0]
        up = F.conv_transpose2d(prec(x), prec(de.weight), de.bias, de.stride, de.padding)
        up = torch.relu(batch_norm(up, self.up[1], self.training))
        sk = conv2d(prec, skip, self.skip_conv[0])
        sk = torch.relu(batch_norm(sk, self.skip_conv[1], self.training))
        out = self.conv1(torch.cat([up, sk], dim=1), prec)
        return out + self.conv2(out, prec)


# --- the L-TAE ---------------------------------------------------------------

def sinusoid_pe(dates: torch.Tensor, d: int, repeat: int, period: float = 1000.0):
    """dates (B, T) -> (B, T, d * repeat): sin at even, cos at odd dims of
    dates / period^(2 (i // 2) / d), the table tiled ``repeat`` times."""
    i = torch.arange(d, device=dates.device)
    denom = period ** ((2 * (i // 2)).double() / d)
    ang = dates.double()[..., None] / denom
    table = torch.where(i % 2 == 0, torch.sin(ang), torch.cos(ang)).float()
    return table.repeat(1, 1, repeat)


_M32 = 0xFFFFFFFF


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def hash_keep(seed: int, b: int, t: int, n: int, g: int, n0: int, n1: int,
              drop_p: float, device) -> torch.Tensor:
    """Keep mask (B, T, n1 - n0, G) of pixel rows n0..n1 of the kernel-pair
    route's attention dropout: element (b, t, n, g) is kept when
    mix32(mix32(i) ^ mix32(seed)) >= drop_p * 2^32, i = ((b T + t) N + n) G + g
    mod 2^32."""
    bb = torch.arange(b, device=device, dtype=torch.int64)[:, None, None, None]
    tt = torch.arange(t, device=device, dtype=torch.int64)[None, :, None, None]
    nn_ = torch.arange(n0, n1, device=device, dtype=torch.int64)[None, None, :, None]
    gg = torch.arange(g, device=device, dtype=torch.int64)[None, None, None, :]
    i = (((bb * t + tt) * n + nn_) * g + gg) & _M32
    h = _mix32(_mix32(i) ^ _mix32(int(seed) & _M32))
    return h >= min(int(drop_p * 2.0 ** 32), _M32)


class MaskedAttention(nn.Module):
    def __init__(self, n_head: int, d_k: int, d_model: int):
        super().__init__()
        self.Q = nn.Parameter(torch.empty(n_head, 1, d_k))
        self.fc1_k = nn.Linear(d_model, n_head * d_k)


class LTAE(nn.Module):
    """Lightweight temporal attention encoder, one query a head (Garnot &
    Landrieu 2020; utae-paps ``src/backbones/ltae.py``): per pixel,
    GroupNorm over (T, C/G), a 1x1 projection to d_model plus the sinusoid
    PE of the dates, masked softmax over T of the query against the keys,
    the heads' values summed, then Linear -> BatchNorm -> ReLU -> dropout ->
    GroupNorm. Pixel rows run in chunks of ``chunk`` (memory only)."""

    def __init__(self, in_channels: int, n_head: int, d_k: int, d_model: int,
                 d_out: int, dropout: float, attn_dropout: float, chunk: int = 1024):
        super().__init__()
        self.n_head, self.d_k, self.d_model = n_head, d_k, d_model
        self.dropout, self.attn_dropout, self.chunk = dropout, attn_dropout, chunk
        self.in_norm = nn.GroupNorm(n_head, in_channels)
        self.inconv = nn.Conv1d(in_channels, d_model, 1)
        self.attention_head = MaskedAttention(n_head, d_k, d_model)
        self.mlp = nn.Sequential(nn.Linear(d_model, d_out), nn.Dropout(dropout),
                                 nn.BatchNorm1d(d_out), nn.ReLU())
        self.out_norm = nn.GroupNorm(n_head, d_out)

    def _pool(self, x, pe, pad, keep, prec: Precision):
        """x (B, T, C, n) pixel rows -> o (B, n, d_model), attention (B, n,
        G, T). ``keep``: None, or the (B, n, G, T) attention-dropout mask
        (kept / (1 - p))."""
        b, t, c, n = x.shape
        g = self.n_head
        xg = x.reshape(b, t, g, c // g, n)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        xh = ((xg - mean) * torch.rsqrt(var + self.in_norm.eps)).reshape(b, t, c, n)
        xh = xh * self.in_norm.weight[:, None] + self.in_norm.bias[:, None]
        w_in = self.inconv.weight[:, :, 0]
        h = torch.einsum("btcn,dc->btnd", prec(xh), prec(w_in))
        h = h + self.inconv.bias + pe[:, :, None, :]                  # (B, T, n, D)
        att = self.attention_head
        k = F.linear(prec(h), prec(att.fc1_k.weight), att.fc1_k.bias)
        k = k.reshape(b, t, n, g, self.d_k)
        s = torch.einsum("gk,btngk->bngt", prec(att.Q[:, 0]), prec(k)) / math.sqrt(self.d_k)
        s = s.masked_fill(pad[:, None, None, :], -1e6)
        a = torch.softmax(s, dim=-1)
        if keep is not None:
            a = a * keep
        v = h.reshape(b, t, n, g, self.d_model // g)
        o = torch.einsum("bngt,btngd->bngd", prec(a), prec(v))
        return o.reshape(b, n, self.d_model), a

    def forward(self, x, dates, pad, prec: Precision, drops=None, checkpointed=False):
        """x (B, T, C, H, W), dates (B, T), pad (B, T) bool -> out (B, d_out,
        H, W), attention (B, G, T, H, W). ``drops`` (training): the
        attention-dropout keep factors as ``drops.attention(n0, n1)`` and the
        MLP's as ``drops.mlp(shape)``, in the order the module draws them."""
        b, t, c, hh, ww = x.shape
        n = hh * ww
        rows = x.reshape(b, t, c, n)
        pe = sinusoid_pe(dates, self.d_model // self.n_head, self.n_head)
        outs, atts = [], []
        for n0 in range(0, n, self.chunk):
            n1 = min(n, n0 + self.chunk)
            keep = drops.attention(n0, n1) if drops is not None else None
            o, a = run_checkpointed(self._pool, rows[..., n0:n1], pe, pad, keep, prec,
                                    enabled=checkpointed)
            outs.append(o)
            atts.append(a)
        o = torch.cat(outs, dim=1)                                      # (B, N, D)
        a = torch.cat(atts, dim=1)                                      # (B, N, G, T)
        lin = self.mlp[0]
        m = F.linear(prec(o), prec(lin.weight), lin.bias)               # (B, N, d_out)
        m = torch.relu(batch_norm(m.reshape(b * n, -1), self.mlp[2], self.training))
        if drops is not None:
            m = m * drops.mlp(m.shape).reshape(m.shape)
        m = F.group_norm(m, self.n_head, self.out_norm.weight, self.out_norm.bias,
                         self.out_norm.eps)
        out = m.reshape(b, hh, ww, -1).permute(0, 3, 1, 2)
        att = a.reshape(b, hh, ww, self.n_head, t).permute(0, 3, 4, 1, 2)
        return out, att


class RandDrops:
    """Dropout keep factors drawn as ``torch.rand(shape, generator) >= p``,
    scaled by 1 / (1 - p), in draw order: the attention's (B, N, G, T) at
    once on the first ``attention`` call, then the MLP's."""

    def __init__(self, generator: torch.Generator, p_attn: float, p_mlp: float,
                 attn_shape: tuple):
        self.gen, self.p_attn, self.p_mlp = generator, p_attn, p_mlp
        self.attn_shape, self._attn = attn_shape, None

    def _keep(self, shape, p):
        if p <= 0:
            return torch.ones(shape, device=self.gen.device)
        r = torch.rand(shape, generator=self.gen, device=self.gen.device)
        return (r >= p).float() / (1.0 - p)

    def attention(self, n0, n1):
        if self._attn is None:
            self._attn = self._keep(self.attn_shape, self.p_attn)
        return self._attn[:, n0:n1]

    def mlp(self, shape):
        return self._keep(shape, self.p_mlp)


class HashDrops(RandDrops):
    """The kernel-pair route's draws: one ``randint(0, 2^31 - 1)`` from the
    generator seeds the attention's hash mask (``hash_keep``, laid out
    (B, N, G, T) here), then the MLP's keep factors as ``RandDrops``; a
    rate of 0 draws nothing."""

    def __init__(self, generator, p_attn, p_mlp, b, t, n, g):
        super().__init__(generator, p_attn, p_mlp, (b, n, g, t))
        self.seed = None
        if p_attn > 0:
            self.seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                          device=generator.device))
        self.dims = (b, t, n, g)

    def attention(self, n0, n1):
        if self.seed is None:
            return None
        b, t, n, g = self.dims
        keep = hash_keep(self.seed, b, t, n, g, n0, n1, self.p_attn, self.gen.device)
        return keep.permute(0, 2, 3, 1).float() / (1.0 - self.p_attn)


# --- the U-TAE skip aggregator, tiles, loss, Adam ---------------------------

def aggregate(x, attn, pad, prec: Precision):
    """U-TAE's ``att_group`` aggregator: x (B, T, C, H, W), attn (B, G, T,
    h, w) -> (B, C, H, W). Each head's attention is upsampled bilinearly
    (half-pixel centres) to H x W, zeroed at pad dates, and weighs its
    group of C / G channels."""
    b, t, c, hh, ww = x.shape
    g = attn.shape[1]
    a = attn.reshape(b * g, t, *attn.shape[-2:])
    if a.shape[-2:] != (hh, ww):
        a = F.interpolate(a, size=(hh, ww), mode="bilinear", align_corners=False)
    a = a.reshape(b, g, t, hh, ww) * (~pad).float()[:, None, :, None, None]
    xg = x.reshape(b, t, g, c // g, hh, ww)
    out = torch.einsum("bgthw,btgchw->bgchw", prec(a), prec(xg))
    return out.reshape(b, c, hh, ww)


def patchify(tile: torch.Tensor, n: int, patch: int) -> torch.Tensor:
    """(T, side, side, C) -> (n^2, T, patch, patch, C): zero-padded to
    n * patch, the n x n grid taken row by row."""
    t, side, _, c = tile.shape
    full = F.pad(tile, (0, 0, 0, n * patch - side, 0, n * patch - side))
    grid = full.reshape(t, n, patch, n, patch, c).permute(1, 3, 0, 2, 4, 5)
    return grid.reshape(n * n, t, patch, patch, c)


def stitch(patches: torch.Tensor, side: int) -> torch.Tensor:
    """(n^2, patch, patch, K) -> (side, side, K)."""
    m, p, _, k = patches.shape
    n = int(round(m ** 0.5))
    return patches.reshape(n, n, p, p, k).permute(0, 2, 1, 3, 4).reshape(
        n * p, n * p, k)[:side, :side]


def weighted_cross_entropy(logits, y, weight):
    """logits (B, H, W, K), y (B, H, W) -> sum w[y] (-log p_y) / sum w[y]."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, y[..., None])[..., 0]
    wy = weight[y]
    return (wy * nll).sum() / wy.sum()


class Adam:
    """torch.optim.Adam's defaults written out: betas (0.9, 0.999), eps
    1e-8, bias-corrected moments."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.n = 0

    @torch.no_grad()
    def step(self):
        self.n += 1
        c1, c2 = 1 - self.b1 ** self.n, 1 - self.b2 ** self.n
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(self.b1).add_(p.grad, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1 - self.b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
