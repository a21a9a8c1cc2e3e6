"""Spatial conv layers (port of crop2seg_tpu/nn/layers.py:280-836): the
plain conv blocks, their depthwise-separable and squeeze-excitation variants,
instance norm, and the MBConv family.

Every module takes and returns channels-last NHWC tensors, as in the JAX
package. Inside, a convolution sees the NCHW view of the same memory
(``permute(0, 3, 1, 2)``, which PyTorch treats as the channels_last memory
format), so cuDNN runs its NHWC kernels and no layout copy is made.
Normalizations are per-channel affines on the NHWC tensor, with statistics in
fp32. In training mode BatchNorm normalizes with the batch statistics and
updates its running ones as flax ``BatchNorm(momentum=0.9)`` does (see
``batch_norm``), except inside ``frozen_running_stats`` (the recompute of an
activation-checkpointed block); inside ``global_batch_stats`` (a
data-parallel step) its batch statistics are the global batch's, summed over
the ranks. GroupNorm is the same in both modes. Module and parameter
names follow the reference's torch modules, so its state dicts load with
``load_state_dict``.

Inside ``space_shards`` (the step of a 2-D data x space mesh) each rank
holds a slice of H of every frame: a convolution (``conv_rows``: any
kernel, stride, padding and dilation that keep the grid), a transposed
convolution (``transposed_conv_rows``, output padding included) or a
bilinear upsample (``upsample_rows``) that reads across H first takes its
neighbours' edge rows (``space_halo``, differentiable; integer label maps
through ``space_label_rows``), and GroupNorm, InstanceNorm and the
squeeze-excitation gate's mean sum their statistics over the space shards,
so every rank computes its rows of the one-device result. The 3-D
convolutions of ``nn/blocks3d.py`` take the same halos along their H axis.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of statistics and sums for tensors of ``dtype``: fp32, or
    fp64 for fp64 tensors."""
    return torch.promote_types(dtype, torch.float32)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


# the most elements CUDA's reflection pad takes in one call (32-bit indices)
MAX_PAD_ELEMENTS = 2 ** 31 - 1


class Conv2d(nn.Conv2d):
    """torch Conv2d(k, s, p, padding_mode, dilation) on NHWC: explicit
    reflect pad, then a VALID convolution (k3/s1, k4/s2, the 1x1 skip conv,
    the dilated zero-pad convs). Where the padded frames exceed
    MAX_PAD_ELEMENTS (MBConv's 256-wide expansion over 610 frames of
    128^2), the frames are padded and convolved in chunks. Inside
    ``space_shards`` H takes the rows its neighbours hold that the
    convolution reads (``conv_rows``, once for all chunks), and is padded
    by reflection or zeros only at the global top and bottom."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.padding
        group = _space_group
        if group is None and (not (ph or pw) or self.padding_mode == "zeros"):
            return _nhwc(F.conv2d(_nchw(x), self.weight, self.bias, self.stride,
                                  self.padding, self.dilation, self.groups))
        top = bottom = ph
        if group is not None:
            x, top, bottom = conv_rows(x, self.kernel_size[0], self.stride[0], ph,
                                       self.dilation[0], group)
            if not (top or bottom or pw):
                return _nhwc(F.conv2d(_nchw(x), self.weight, self.bias, self.stride, 0,
                                      self.dilation, self.groups))
        xc = _nchw(x)
        mode = "constant" if self.padding_mode == "zeros" else self.padding_mode
        n, c, h, w = xc.shape
        per = max(1, MAX_PAD_ELEMENTS // (c * (h + top + bottom) * (w + 2 * pw)))
        out = [F.conv2d(F.pad(chunk, (pw, pw, top, bottom), mode=mode),
                        self.weight, self.bias, self.stride, 0, self.dilation, self.groups)
               for chunk in xc.split(per)]
        return _nhwc(out[0] if len(out) == 1 else torch.cat(out))


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch-exact ConvTranspose2d on NHWC (the decoder's k4/s2/p1 up-conv).
    Inside ``space_shards`` the input takes the rows that reach this rank's
    output rows from its neighbours (``transposed_conv_rows``: zeros at the
    global edges, no input there), and the output is cropped back to the
    s * h rows this rank owns."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _space_group is None:
            return _nhwc(F.conv_transpose2d(_nchw(x), self.weight, self.bias, self.stride,
                                            self.padding, self.output_padding, self.groups,
                                            self.dilation))
        s, h = self.stride[0], x.shape[1]
        x, m = transposed_conv_rows(x, self.kernel_size[0], s, self.padding[0],
                                    self.output_padding[0], self.dilation[0], _space_group)
        y = F.conv_transpose2d(_nchw(x), self.weight, self.bias, self.stride, self.padding,
                               (0, self.output_padding[1]), self.groups, self.dilation)
        return _nhwc(y[:, :, s * m:s * (m + h)])


def _apply_affine(x: torch.Tensor, sc: torch.Tensor,
                  sh: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C) * sc + sh, with sc/sh (N, C) or (C,), in fp32."""
    if sc.dim() == 2:
        sc, sh = sc[:, None, None, :], sh[:, None, None, :]
    return torch.addcmul(sh, x.to(acc_dtype(x.dtype)), sc).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over each NHWC frame, two-pass fp32 statistics (fp64 for
    fp64 frames)."""

    def frame_affine(self, x: torch.Tensor):
        """Per-frame affine ``(sc, sh)``, each (N, C) fp32 (fp64 for fp64
        frames), such that ``x * sc + sh`` is the normalized frame (the
        whole frame's moments inside ``space_shards``)."""
        n, h, w, c = x.shape
        dt = acc_dtype(x.dtype)
        g = x.to(dt).reshape(n, h * w, self.num_groups, c // self.num_groups)
        mean = frame_mean(g, (1, 3))
        var = frame_mean((g - mean).square(), (1, 3))
        inv = torch.rsqrt(var + self.eps)                   # (N, 1, G, 1)
        sc = (self.weight.to(dt).reshape(1, self.num_groups, -1)
              * inv[:, 0]).reshape(n, c)
        sh = self.bias.to(dt) - (mean[:, 0] * sc.reshape(
            n, self.num_groups, -1)).reshape(n, c)
        return sc, sh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply_affine(x, *self.frame_affine(x))


def batchnorm_affine(bn: nn.modules.batchnorm._BatchNorm):
    """Eval BatchNorm as ``(scale, shift)`` per channel, fp32 (fp64 for an
    fp64 module)."""
    dt = acc_dtype(bn.weight.dtype)
    scale = bn.weight.to(dt) * torch.rsqrt(bn.running_var.to(dt) + bn.eps)
    return scale, bn.bias.to(dt) - bn.running_mean.to(dt) * scale


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


_stats_group = None


@contextlib.contextmanager
def global_batch_stats(group):
    """Train-mode BatchNorm inside takes its batch statistics over the
    global batch of ``group``'s ranks (a ``torch.distributed`` process group,
    each rank holding an equal shard): the sums are added across the ranks
    by an all-reduce that autograd differentiates, as the JAX package's
    data-parallel step computes them on the global batch. None leaves the
    statistics local. The context must also cover the backward pass, whose
    activation-checkpointed recompute runs the same all-reduces again (every
    rank recomputes the same blocks in the same order)."""
    global _stats_group
    outer, _stats_group = _stats_group, group
    try:
        yield
    finally:
        _stats_group = outer


_space_group = None


@contextlib.contextmanager
def space_shards(group):
    """The layers inside take frames cut along H over ``group``'s ranks (a
    ``torch.distributed`` process group, rank s holding the s-th of equal
    slices of H): convolutions exchange halo rows with the neighbours, and
    the per-frame statistics are summed over the group (module docstring).
    A group of one rank, or None, leaves the layers as they are. Every rank
    runs the same layers in the same order; like ``global_batch_stats`` the
    context must also cover the backward pass, whose halo exchanges and
    activation-checkpointed recompute talk to the neighbours too."""
    import torch.distributed as dist

    global _space_group
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    outer, _space_group = _space_group, group
    try:
        yield
    finally:
        _space_group = outer


def space_group():
    """The group of the ``space_shards`` context around the call, or None."""
    return _space_group


def _exchange(buf: torch.Tensor, group) -> None:
    """Each rank's rows of ``buf`` (zeros elsewhere) to every rank of
    ``group``: an all-reduce of the raw bytes, exact for any dtype since
    each byte has one writer (gloo's CUDA tensors take all-reduce and no
    point-to-point op)."""
    import torch.distributed as dist

    dist.all_reduce(buf.view(-1).view(torch.uint8), group=group)


def _place(group) -> tuple:
    """(this rank's index, the ranks) in ``group``."""
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def _halo_rows(x: torch.Tensor, before: int, after: int, dim: int, group) -> torch.Tensor:
    """x extended along ``dim`` by the ``before`` rows that precede it (the
    last rows of rank s - 1 of the group) and the ``after`` rows that follow
    it (the first rows of rank s + 1); the global edges get none. One
    exchange: boundary b between ranks b and b + 1 has a slot of before +
    after rows, the first ``before`` carried down from b, the rest carried
    up from b + 1."""
    s, n = _place(group)
    h = x.shape[dim]
    if h < max(before, after):
        raise ValueError(f"a halo of {max(before, after)} rows needs shards of as many "
                         f"rows, not {h}")
    shape = list(x.shape)
    shape[dim] = before + after
    buf = x.new_zeros([n - 1] + shape)
    if s > 0:
        buf[s - 1].narrow(dim, before, after).copy_(x.narrow(dim, 0, after))
    if s < n - 1:
        buf[s].narrow(dim, 0, before).copy_(x.narrow(dim, h - before, before))
    _exchange(buf, group)
    parts = (([buf[s - 1].narrow(dim, 0, before)] if s > 0 else []) + [x]
             + ([buf[s].narrow(dim, before, after)] if s < n - 1 else []))
    return torch.cat(parts, dim)


class _Halo(torch.autograd.Function):
    """``_halo_rows``, differentiable: the backward pass returns each halo
    row's gradient to the rank that owns the row, which adds it to its edge
    rows."""

    @staticmethod
    def forward(ctx, x, before, after, dim, group):
        ctx.before, ctx.after, ctx.dim, ctx.group = before, after, dim, group
        return _halo_rows(x, before, after, dim, group)

    @staticmethod
    def backward(ctx, grad):
        before, after, dim = ctx.before, ctx.after, ctx.dim
        s, n = _place(ctx.group)
        top = before if s > 0 else 0
        h = grad.shape[dim] - top - (after if s < n - 1 else 0)
        gx = grad.narrow(dim, top, h).clone(memory_format=torch.contiguous_format)
        # the halo's gradients go back the way its rows came
        shape = list(gx.shape)
        shape[dim] = before + after
        buf = gx.new_zeros([n - 1] + shape)
        if s > 0:
            buf[s - 1].narrow(dim, 0, before).copy_(grad.narrow(dim, 0, before))
        if s < n - 1:
            buf[s].narrow(dim, before, after).copy_(grad.narrow(dim, top + h, after))
        _exchange(buf, ctx.group)
        if s > 0:
            gx.narrow(dim, 0, after).add_(buf[s - 1].narrow(dim, before, after))
        if s < n - 1:
            gx.narrow(dim, h - before, before).add_(buf[s].narrow(dim, 0, before))
        return gx, None, None, None, None


def space_halo(x: torch.Tensor, k: int, group, dim: int = 1):
    """``x`` (this rank's slice of H along ``dim``: 1 for NHWC) with the k
    rows of its space neighbours on each side (differentiable). Returns the
    extended tensor and the rows still missing at the global top and bottom
    (k on the first and last shard, else 0), which the caller pads."""
    s, n = _place(group)
    return _Halo.apply(x, k, k, dim, group), (k if s == 0 else 0), (k if s == n - 1 else 0)


def conv_rows(x: torch.Tensor, k: int, s: int, p: int, d: int, group, dim: int = 1):
    """``x`` (this rank's rows along ``dim``) with the rows of its space
    neighbours that a convolution of kernel k, stride s, padding p and
    dilation d along that axis reads: p rows before, d (k - 1) - p - s + 1
    after. Returns the tensor and the padding rows still to add at the
    global top and bottom (p on the first and on the last shard, else 0).
    The sharded convolution keeps the grid (s x the output's rows in, so
    that each rank's output rows are the one-device output's): 2p - d (k -
    1) lies in [1 - s, 0] and the shard's rows are a multiple of s; else
    ValueError."""
    span = d * (k - 1)
    if not 1 - s <= 2 * p - span <= 0 or x.shape[dim] % s:
        raise ValueError(f"a space-sharded conv keeps the grid only where 2p - d(k - 1) "
                         f"lies in [1 - s, 0] on shards of a multiple of s rows: k {k}, "
                         f"s {s}, p {p}, d {d}, {x.shape[dim]} rows")
    after = span - p - s + 1
    if p or after:
        x = _Halo.apply(x, p, after, dim, group)
    rank, n = _place(group)
    return x, (p if rank == 0 else 0), (p if rank == n - 1 else 0)


def transposed_conv_rows(x: torch.Tensor, k: int, s: int, p: int, op: int, d: int, group,
                         dim: int = 1):
    """``x`` (this rank's h rows along ``dim``) with the m rows on each side
    that reach this rank's output rows through a transposed convolution of
    kernel k, stride s, padding p, output padding op and dilation d (zeros
    beyond the global edges, where there is no input). Returns the tensor
    and m: rows s m .. s (m + h) of the transposed convolution of it (its
    output padding 0 along ``dim``) are this rank's. ValueError unless the
    convolution maps H rows to s H (d (k - 1) + 1 + op = 2p + s)."""
    span = d * (k - 1) + 1
    if span + op != 2 * p + s:
        raise ValueError(f"a space-sharded transposed conv needs d(k - 1) + 1 + op = 2p + s: "
                         f"k {k}, s {s}, p {p}, op {op}, d {d}")
    m = max(-(-(span - 1 - p) // s), (s - 1 + p) // s, -(-op // s))
    x, top, bottom = space_halo(x, m, group, dim)
    return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [top, bottom]), m


def space_label_rows(y: torch.Tensor, k: int, group, fill: int) -> torch.Tensor:
    """(B, h, W) integer labels of this rank with the k label rows of each
    space neighbour and ``fill`` in the k rows beyond the global top and
    bottom: (B, h + 2k, W). Not differentiable (``_exchange`` moves the
    bytes of any dtype)."""
    s, n = _place(group)
    y = _halo_rows(y, k, k, 1, group)
    return F.pad(y, (0, 0, k if s == 0 else 0, k if s == n - 1 else 0), value=fill)


def upsample_rows(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upsampling (align_corners=False) of (N, K, h_a, w_a) to (N,
    K, h, w). Inside ``space_shards`` h_a and h are this rank's rows, h a
    whole multiple f of h_a: the rows take one row of each neighbour (the
    edge row repeated at the global edges, which is ``F.interpolate``'s
    clamp), (h_a + 2) f rows are interpolated and the middle h kept, which
    are this rank's rows of the one-device upsample."""
    if _space_group is None:
        return F.interpolate(a, size=(h, w), mode="bilinear", align_corners=False)
    ha = a.shape[-2]
    f = h // ha
    if h != f * ha:
        raise ValueError(f"space shards upsample by whole factors, not {ha} -> {h} rows")
    a, top, bottom = space_halo(a, 1, _space_group, dim=2)
    a = F.pad(a, (0, 0, top, bottom), mode="replicate")
    up = F.interpolate(a, size=((ha + 2) * f, w), mode="bilinear", align_corners=False)
    return up[:, :, f:f + h]


def unet_space_rows(levels: int, stride: int, reflect: bool) -> tuple:
    """(multiple, least): the rows of a U-Net's space shard, for ``levels``
    resolutions each cut by ``stride``. Every level keeps its grid (a
    multiple of stride ** (levels - 1) rows), and the bottleneck's shard has
    two rows, one to mirror, where its convolutions pad by reflection, one
    to send to a neighbour where they pad with zeros."""
    multiple = stride ** (levels - 1)
    return multiple, multiple * (2 if reflect else 1)


def frame_mean(t: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``t.mean(dims, keepdim=True)``, the frame's mean: inside
    ``space_shards`` the dims hold this rank's rows and the sum is taken over
    the group (differentiable), divided by the whole frame's count."""
    if _space_group is None:
        return t.mean(dim=dims, keepdim=True)
    import torch.distributed as dist

    count = math.prod(t.shape[d] for d in dims) * dist.get_world_size(_space_group)
    return _GroupSum.apply(t.sum(dim=dims, keepdim=True), _space_group) / count


class _GroupSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of a group, differentiable: the
    gradient of every rank's input is the sum of every rank's output
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _GroupSum.apply(grad, ctx.group), None


def _global_moments(xf: torch.Tensor, dims: tuple, group):
    """The global batch's mean and biased variance per channel, two-pass, the
    sums all-reduced over ``group``; every rank holds as many rows."""
    import torch.distributed as dist

    count = xf.numel() // xf.shape[-1] * dist.get_world_size(group)
    mean = _GroupSum.apply(xf.sum(dims), group) / count
    var = _GroupSum.apply((xf - mean).square().sum(dims), group) / count
    return mean, var


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """``conv_out``: keep what each convolution (and transposed convolution)
    returns, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.convolution.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recompute(ctx):
    with ctx, frozen_running_stats():
        yield


def _contexts(policy):
    fwd, rec = ((contextlib.nullcontext(), contextlib.nullcontext())
                if policy != "conv_out"
                else create_selective_checkpoint_contexts(_save_conv_outputs))
    return fwd, _recompute(rec)


def remat(block, policy=None):
    """``block`` under activation checkpointing (``policy``: None or "full",
    or "conv_out"); the recompute leaves BatchNorm's running statistics
    alone (``frozen_running_stats``)."""
    context_fn = functools.partial(_contexts, policy)

    def run(*args):
        return checkpoint(block, *args, use_reentrant=False, context_fn=context_fn)
    return run


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """BatchNorm of a channels-last tensor (statistics over every dim but the
    last). Eval: the running statistics. Training: the batch mean and the
    biased batch variance in fp32, for the output and for the running update
    ``r = (1 - momentum) * r + momentum * batch`` (flax's ``BatchNorm(
    momentum=0.9)`` with torch's ``momentum=0.1``). torch's own
    ``F.batch_norm`` would put the unbiased variance into ``running_var``.
    Inside ``global_batch_stats`` the batch is the global one."""
    if not bn.training:
        return _apply_affine(x, *batchnorm_affine(bn))
    xf = x.to(acc_dtype(x.dtype))
    dims = tuple(range(x.dim() - 1))
    if _stats_group is None:
        mean = xf.mean(dims)
        var = (xf - mean).square().mean(dims)
    else:
        mean, var = _global_moments(xf, dims, _stats_group)
    if not _stats_frozen:
        with torch.no_grad():
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
            bn.num_batches_tracked.add_(1)
    scale = bn.weight.to(xf.dtype) * torch.rsqrt(var + bn.eps)
    return torch.addcmul(bn.bias.to(xf.dtype) - mean * scale, xf, scale).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d on NHWC, in either mode (``batch_norm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self)


class InstanceNorm2d(nn.InstanceNorm2d):
    """InstanceNorm2d(affine=False) on NHWC: each channel of each frame
    normalized over (H, W), two-pass fp32 statistics (fp64 for fp64 frames),
    no parameters (the JAX ``GroupNorm(group_size=1)`` without scale or
    bias)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(acc_dtype(x.dtype))
        mean = frame_mean(xf, (1, 2))
        var = frame_mean((xf - mean).square(), (1, 2))
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def make_norm(norm: str, n_groups: int = 4):
    """Normalization factory: ``norm`` -> (features -> module) or None."""
    if norm == "batch":
        return lambda c: BatchNorm2d(c, eps=1e-5)
    if norm == "group":
        return lambda c: GroupNorm(n_groups, c, eps=1e-5)
    if norm == "instance":
        return lambda c: InstanceNorm2d(c, eps=1e-5, affine=False)
    return None


class DepthwiseSeparableConv2d(nn.Module):
    """Depthwise k x k (stride s, ``padding_mode``) then pointwise 1x1, both
    without bias (crop2seg_tpu/nn/layers.py:465-489)."""

    def __init__(self, d_in: int, d_out: int, k: int = 3, s: int = 1,
                 p: int = 1, padding_mode: str = "zeros"):
        super().__init__()
        self.depthwise = Conv2d(d_in, d_in, k, stride=s, padding=p, groups=d_in,
                                bias=False, padding_mode=padding_mode)
        self.pointwise = Conv2d(d_in, d_out, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class _SpatialMean(nn.Module):
    """(N, H, W, C) -> (N, C) fp32 mean over the frame (``frame_mean``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return frame_mean(x.float(), (1, 2))[:, 0, 0]


class SqueezeAndExcitation(nn.Module):
    """Channel gate x * sigmoid(W2 relu(W1 mean_hw(x))), W1 (C/r, C) and W2
    (C, C/r) without bias, r = 16 (crop2seg_tpu/nn/layers.py:492-507). The
    Linears are ``sae.1`` and ``sae.3``, as in the reference state dicts.
    Below 16 channels the hidden width is 0 (the JAX package cannot
    initialize such a gate)."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        hidden = channels // reduction_ratio
        self.sae = nn.Sequential(_SpatialMean(), nn.Linear(channels, hidden, bias=False),
                                 nn.ReLU(), nn.Linear(hidden, channels, bias=False),
                                 nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.sae(x).to(x.dtype)[:, None, None, :]


class ConvLayer(nn.Module):
    """Stack of (conv -> norm -> ReLU) units in one ``nn.Sequential`` named
    ``conv``, indexed like the reference (conv 3i, norm 3i+1, ReLU 3i+2; an
    instance norm takes its index without parameters), and with
    ``add_squeeze`` a ``SqueezeAndExcitation`` at the next index.
    ``nkernels`` lists the widths including the input width;
    ``last_relu=False`` drops the final ReLU; ``conv_type``
    "depthwise_separable" makes each conv a ``DepthwiseSeparableConv2d``."""

    def __init__(self, nkernels: Sequence[int], norm: str = "batch",
                 k: int = 3, s: int = 1, p: int = 1, n_groups: int = 4,
                 last_relu: bool = True, padding_mode: str = "reflect",
                 conv_type: str = "2d", add_squeeze: bool = False):
        super().__init__()
        if conv_type not in ("2d", "depthwise_separable"):
            raise ValueError(f"unknown conv_type {conv_type!r}: expected '2d' "
                             "or 'depthwise_separable'")
        norm_fn = make_norm(norm, n_groups)
        layers = []
        n = len(nkernels) - 1
        for i in range(n):
            if conv_type == "depthwise_separable":
                layers.append(DepthwiseSeparableConv2d(
                    nkernels[i], nkernels[i + 1], k, s, p, padding_mode))
            else:
                layers.append(Conv2d(nkernels[i], nkernels[i + 1], k, stride=s,
                                     padding=p, padding_mode=padding_mode))
            if norm_fn is not None:
                layers.append(norm_fn(nkernels[i + 1]))
            if last_relu or i < n - 1:
                layers.append(nn.ReLU(inplace=True))
        if add_squeeze:
            layers.append(SqueezeAndExcitation(nkernels[-1]))
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
                 last_relu: bool = True, padding_mode: str = "reflect",
                 conv_type: str = "2d", add_squeeze: bool = False):
        super().__init__()
        self.conv = ConvLayer(nkernels, norm=norm, last_relu=last_relu,
                              padding_mode=padding_mode, conv_type=conv_type,
                              add_squeeze=add_squeeze)

    def forward(self, x: torch.Tensor, defer_tail_norm: bool = False):
        return self.conv(x, defer_tail_norm=defer_tail_norm)


class DownConvBlock(nn.Module):
    """Strided down conv + residual conv pair:
    out = conv1(down(x)); out = out + conv2(out); with ``add_squeeze`` a
    trailing ``SqueezeAndExcitation`` named ``sae``."""

    def __init__(self, d_in: int, d_out: int, k: int = 4, s: int = 2,
                 p: int = 1, norm: str = "batch",
                 padding_mode: str = "reflect", conv_type: str = "2d",
                 add_squeeze: bool = False):
        super().__init__()
        kw = dict(norm=norm, padding_mode=padding_mode, conv_type=conv_type)
        self.down = ConvLayer((d_in, d_in), k=k, s=s, p=p, **kw)
        self.conv1 = ConvLayer((d_in, d_out), **kw)
        self.conv2 = ConvLayer((d_out, d_out), **kw)
        self.sae = SqueezeAndExcitation(d_out) if add_squeeze else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.down(x))
        x = x + self.conv2(x)
        return x if self.sae is None else self.sae(x)


class UpConvBlock(nn.Module):
    """Decoder block: deconv-up(x) ++ 1x1-conv(skip) -> conv1 -> +conv2; with
    ``add_squeeze`` a trailing ``SqueezeAndExcitation`` named ``sae``."""

    def __init__(self, d_in: int, d_out: int, d_skip: int, k: int = 4,
                 s: int = 2, p: int = 1, norm: str = "batch",
                 padding_mode: str = "reflect", conv_type: str = "2d",
                 add_squeeze: bool = False):
        super().__init__()
        self.skip_conv = nn.Sequential(
            Conv2d(d_skip, d_skip, 1), BatchNorm2d(d_skip), nn.ReLU(inplace=True))
        self.up = nn.Sequential(
            ConvTranspose2d(d_in, d_out, k, stride=s, padding=p),
            BatchNorm2d(d_out), nn.ReLU(inplace=True))
        kw = dict(norm=norm, padding_mode=padding_mode, conv_type=conv_type)
        self.conv1 = ConvLayer((d_out + d_skip, d_out), **kw)
        self.conv2 = ConvLayer((d_out, d_out), **kw)
        self.sae = SqueezeAndExcitation(d_out) if add_squeeze else None

    def _merge(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.up(x), self.skip_conv(skip)], dim=-1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        out = self.conv1(self._merge(x, skip))
        out = out + self.conv2(out)
        return out if self.sae is None else self.sae(out)


class _ResidualAdd(nn.Module):
    """x + block(x); the block's parameters sit under ``block``."""

    def __init__(self, block: nn.Module):
        super().__init__()
        self.block = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class MBConv(nn.Sequential):
    """Inverted-residual unit (crop2seg_tpu/nn/layers.py:697-738): expand 1x1
    -> norm -> ReLU -> depthwise 3x3 (reflect, with bias) -> norm -> ReLU ->
    SE -> project 1x1 -> norm, plus x when d_in == d_out. The units are
    indexed 0 .. 8 in an inner Sequential that sits at ``0.0.block`` with the
    residual and at ``0.0.0`` without, the reference's names."""

    def __init__(self, d_in: int, d_out: int, expansion: int = 4,
                 n_groups: int = 4, norm: str = "group"):
        norm_fn = make_norm(norm, n_groups)
        if norm_fn is None:
            raise ValueError(f"MBConv needs a norm (batch, group or instance), "
                             f"got {norm!r}")
        wide = d_in * expansion
        units = nn.Sequential(
            Conv2d(d_in, wide, 1), norm_fn(wide), nn.ReLU(inplace=True),
            Conv2d(wide, wide, 3, padding=1, groups=wide, padding_mode="reflect"),
            norm_fn(wide), nn.ReLU(inplace=True), SqueezeAndExcitation(wide),
            Conv2d(wide, d_out, 1), norm_fn(d_out))
        inner = _ResidualAdd(units) if d_in == d_out else nn.Sequential(units)
        super().__init__(nn.Sequential(inner))


class MBConvLayer(nn.Module):
    """A stack of MBConv units in one Sequential named ``conv``."""

    def __init__(self, nkernels: Sequence[int], norm: str = "group"):
        super().__init__()
        self.conv = nn.Sequential(*(MBConv(nkernels[i], nkernels[i + 1], norm=norm)
                                    for i in range(len(nkernels) - 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MBConvBlock(nn.Module):
    """MBConv drop-in for ConvBlock: ``conv`` is one MBConvLayer.
    ``padding_mode``, ``conv_type`` and ``add_squeeze`` are taken and
    ignored, as in the JAX package: the unit pads by reflection and always
    has its SE gate."""

    def __init__(self, nkernels: Sequence[int], norm: str = "group",
                 padding_mode: str = "reflect", conv_type: str = "2d",
                 add_squeeze: bool = False):
        super().__init__()
        self.conv = MBConvLayer(nkernels, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MBDownConvBlock(nn.Module):
    """MBConv drop-in for DownConvBlock: the strided ConvLayer ``down``, then
    two MBConvLayers, with no residual add (``add_squeeze`` is ignored)."""

    def __init__(self, d_in: int, d_out: int, k: int = 4, s: int = 2,
                 p: int = 1, norm: str = "batch",
                 padding_mode: str = "reflect", conv_type: str = "2d",
                 add_squeeze: bool = False):
        super().__init__()
        self.down = ConvLayer((d_in, d_in), norm=norm, k=k, s=s, p=p,
                              padding_mode=padding_mode, conv_type=conv_type)
        self.conv1 = MBConvLayer((d_in, d_out), norm=norm)
        self.conv2 = MBConvLayer((d_out, d_out), norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(self.down(x)))


class MBUpConvBlock(UpConvBlock):
    """MBConv drop-in for UpConvBlock: the same up and skip paths, then two
    MBConvLayers with no residual add (``padding_mode`` and ``conv_type``
    are ignored)."""

    def __init__(self, d_in: int, d_out: int, d_skip: int, k: int = 4,
                 s: int = 2, p: int = 1, norm: str = "batch",
                 padding_mode: str = "reflect", conv_type: str = "2d"):
        super().__init__(d_in, d_out, d_skip, k, s, p, norm=norm)
        self.conv1 = MBConvLayer((d_out + d_skip, d_out), norm=norm)
        self.conv2 = MBConvLayer((d_out, d_out), norm=norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(self._merge(x, skip)))


def conv_blocks(use_mbconv: bool):
    """A model's (in, down, up, out) block classes: the plain ones, or with
    ``use_mbconv`` the MBConv family."""
    if use_mbconv:
        return MBConvBlock, MBDownConvBlock, MBUpConvBlock, MBConvBlock
    return ConvBlock, DownConvBlock, UpConvBlock, ConvBlock
