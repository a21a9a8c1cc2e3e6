"""Masked lightweight temporal attention encoder, one query
(port of crop2seg_tpu/nn/ltae.py:39-352).

Per pixel row, T steps, C channels:

    h   = GroupNorm_{n_head}(x)                       # over (C/G, T) jointly
    h   = W_in h + PE(dates)                          # 1x1 proj C -> d_model
    A   = softmax_T(q . (W_k h) / sqrt(d_k), -1e6 at pads)
    o   = head-grouped sum_t A h -> MLP + BN + ReLU -> GroupNorm_{n_head}

The input GroupNorm counts pad frames, as the reference does (its torch
GroupNorm over (C/G, T) sees the zero pad frames). In eval mode a CUDA tensor
runs the fused eval kernel (ops/ltae_fused.py) and a CPU tensor the plain
PyTorch ops below; both return ``(out (B, H, W, d_out), attn (B, H, W, head,
T))``, the JAX layouts. In training mode the pooling runs through
``ops/ltae_pool.py`` (its kernel pair on a CUDA tensor), as the JAX
``LTAE._fused_train`` does, with attention dropout after the softmax and the
MLP tail in training mode; it returns ``(out, None)``. Both modes take the
producer's deferred GroupNorm affine (``tail_affine``) on the kernel path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from crop2seg_tpu_torch.nn.layers import batch_norm
from crop2seg_tpu_torch.nn.positional import (
    AbsolutePositionalEncoder, PositionalEncoder)
from crop2seg_tpu_torch.ops.ltae_pool import (
    ltae_pool, ltae_pool_reference, ltae_pool_tail, ltae_pool_tail_reference)


def _group_norm_btc(x: torch.Tensor, n_groups: int, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of (B, T, H, W, C) with statistics over (T, C/G) per pixel,
    fp32 two-pass; returns x.dtype."""
    b, t, h, w, c = x.shape
    g = x.float().reshape(b, t, h, w, n_groups, c // n_groups)
    mean = g.mean(dim=(1, 5), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 5), keepdim=True)
    y = (g - mean) * torch.rsqrt(var + eps)
    y = y * scale.float().reshape(n_groups, -1) + bias.float().reshape(n_groups, -1)
    return y.reshape(x.shape).to(x.dtype)


def _group_norm_channels(x: torch.Tensor, n_groups: int, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel groups of (..., C), fp32 two-pass."""
    g = x.float().reshape(x.shape[:-1] + (n_groups, -1))
    mean = g.mean(dim=-1, keepdim=True)
    var = (g - mean).square().mean(dim=-1, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * scale.float() + bias.float()).to(x.dtype)


class MaskedLightweightAttention(nn.Module):
    """Learnable-query masked attention over time, one query.

    h: (B, T, H, W, d_model) time-major; pad_mask (B, T) True at pads.
    Returns out (B, H, W, d_model) and attn (B, H, W, head, T).
    """

    def __init__(self, n_head: int, d_k: int, d_model: int):
        super().__init__()
        self.n_head, self.d_k = n_head, d_k
        self.Q = nn.Parameter(torch.empty(n_head, 1, d_k))
        self.fc1_k = nn.Linear(d_model, n_head * d_k)
        std = math.sqrt(2.0 / d_k)
        nn.init.normal_(self.Q, std=std)
        nn.init.normal_(self.fc1_k.weight, std=std)

    def forward(self, h: torch.Tensor, pad_mask: torch.Tensor | None = None):
        b, t, hh, ww, d = h.shape
        k = self.fc1_k(h).reshape(b, t, hh, ww, self.n_head, self.d_k)
        scores = torch.einsum("gk,btxygk->bxygt", self.Q[:, 0].to(k.dtype), k)
        scores = scores.float() / math.sqrt(self.d_k)
        if pad_mask is not None:
            scores = scores.masked_fill(pad_mask[:, None, None, None, :], -1e6)
        attn = torch.softmax(scores, dim=-1)
        v = h.reshape(b, t, hh, ww, self.n_head, d // self.n_head)
        out = torch.einsum("bxygt,btxygd->bxygd", attn.to(v.dtype), v)
        return out.reshape(b, hh, ww, d), attn


class LTAE(nn.Module):
    """Lightweight temporal attention encoder, ``num_queries=1``.

    Call: x (B, T, H, W, C), batch_positions (B, T) or (B, T, 2), pad_mask
    (B, T) bool. ``fused`` picks the path: None means the kernel for a CUDA
    tensor and the plain ops for a CPU tensor; True/False force one (the
    tests and chip_smoke.py compare the two). ``tail_affine`` is the
    producer's deferred GroupNorm affine ``(sc, sh)`` of shape (B, T, C),
    applied as ``max(x * sc + sh, 0)`` (fused path in eval mode; in training
    mode ``ltae_pool_tail``, or its plain version when not fused). ``generator``
    (training only) draws the dropout masks; None uses PyTorch's global RNG.
    ``dropout`` is the MLP's rate, ``attn_dropout`` the attention's.
    """

    def __init__(self, in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 mlp: tuple = (256, 128), dropout: float = 0.2,
                 d_model: int = 256, T: float = 1000.0,
                 positional_encoding: bool = True,
                 use_abs_rel_enc: bool = False, use_doy: bool = False,
                 num_queries: int = 1, add_linear: bool = False,
                 attn_dropout: float = 0.1):
        super().__init__()
        if num_queries != 1:
            raise NotImplementedError(
                "num_queries > 1 is not ported yet (ROADMAP.md, open items)")
        if d_model is None or mlp[0] != d_model:
            raise ValueError("the port needs d_model set and mlp[0] == d_model")
        self.n_head, self.d_k, self.d_model = n_head, d_k, d_model
        self.attn_dropout = attn_dropout
        self.use_abs_rel_enc = use_abs_rel_enc
        self.in_norm = nn.GroupNorm(n_head, in_channels, eps=1e-5)
        self.inconv = nn.Conv1d(in_channels, d_model, 1)
        self.positional_encoder = None
        if positional_encoding:
            if use_doy and not add_linear:
                self.positional_encoder = AbsolutePositionalEncoder(
                    d_model // n_head, repeat=n_head)
            else:
                self.positional_encoder = PositionalEncoder(
                    d_model // n_head, T=T, repeat=n_head, add_linear=add_linear)
            if use_abs_rel_enc:
                self.positional_encoder_abs = AbsolutePositionalEncoder(
                    d_model // n_head, repeat=n_head)
        self.attention_head = MaskedLightweightAttention(n_head, d_k, d_model)
        # mlp.2 is the BN, as in the reference state dict; index 1 holds the
        # dropout rate only: _mlp_tail applies it after the ReLU, the JAX order
        self.mlp = nn.Sequential(nn.Linear(mlp[0], mlp[1]), nn.Dropout(dropout),
                                 nn.BatchNorm1d(mlp[1], eps=1e-5), nn.ReLU())
        self.out_norm = nn.GroupNorm(n_head, mlp[1], eps=1e-5)

    def pe(self, batch_positions: torch.Tensor) -> torch.Tensor:
        """(B, T[, 2]) -> (B, T, d_model) fp32 positional encoding."""
        if self.use_abs_rel_enc:
            return (self.positional_encoder(batch_positions[..., 0])
                    + self.positional_encoder_abs(batch_positions[..., 1]))
        bp = batch_positions if batch_positions.dim() == 2 else batch_positions[..., 0]
        return self.positional_encoder(bp)

    def _mlp_tail(self, o: torch.Tensor, generator=None) -> torch.Tensor:
        """MLP -> BN -> ReLU -> Dropout -> out GroupNorm on (..., d_model),
        the order of crop2seg_tpu/nn/ltae.py:340-352 (BN and dropout in
        training mode only when the module trains)."""
        lin, drop, bn, _ = self.mlp
        m = torch.relu(batch_norm(lin(o), bn))
        if self.training and drop.p > 0.0:
            keep = torch.rand(m.shape, generator=generator, device=m.device) >= drop.p
            m = m * keep / (1.0 - drop.p)
        return _group_norm_channels(m, self.n_head, self.out_norm.weight,
                                    self.out_norm.bias, self.out_norm.eps)

    def _plain(self, x, batch_positions, pad_mask):
        h = _group_norm_btc(x, self.n_head, self.in_norm.weight,
                            self.in_norm.bias, self.in_norm.eps)
        h = F.linear(h, self.inconv.weight[:, :, 0], self.inconv.bias)
        if self.positional_encoder is not None:
            h = h + self.pe(batch_positions)[:, :, None, None, :].to(h.dtype)
        out, attn = self.attention_head(h, pad_mask)
        return self._mlp_tail(out), attn

    def _fused(self, x, batch_positions, pad_mask, need_attn, tail_affine):
        from crop2seg_tpu_torch.ops.ltae_fused import (
            ltae_fused_forward, params_from_ltae_variables)

        b, t, hh, ww, c = x.shape
        pe = (self.pe(batch_positions) if self.positional_encoder is not None
              else torch.zeros(b, t, self.d_model, device=x.device))
        if pad_mask is None:
            pad_mask = torch.zeros(b, t, dtype=torch.bool, device=x.device)
        params = params_from_ltae_variables(self.state_dict())
        out, attn = ltae_fused_forward(
            x.reshape(b, t, hh * ww, c), pe, pad_mask, params,
            n_head=self.n_head, d_k=self.d_k, need_attn=need_attn,
            tail_affine=tail_affine)
        return (out.reshape(b, hh, ww, -1),
                None if attn is None else attn.reshape(b, hh, ww, self.n_head, t))

    def pool_params(self):
        """``(win_f, bin_f, u, cs)`` of ``ops/ltae_pool.py`` from the raw
        parameters (crop2seg_tpu/nn/ltae.py:301-311): the input GroupNorm's
        affine folded into the projection, the query into the keys. Plain
        torch ops, so autograd reaches the parameters through them."""
        g, dk, d = self.n_head, self.d_k, self.d_model
        win = self.inconv.weight[:, :, 0].t()
        win_f = win * self.in_norm.weight[:, None]
        bin_f = self.inconv.bias + self.in_norm.bias @ win
        att = self.attention_head
        q = att.Q[:, 0]
        u = torch.einsum("dgk,gk->dg", att.fc1_k.weight.t().reshape(d, g, dk),
                         q) / math.sqrt(dk)
        cs = (torch.einsum("gk,gk->g", att.fc1_k.bias.reshape(g, dk), q)
              / math.sqrt(dk))[None]
        return win_f, bin_f, u, cs

    def _train(self, x, batch_positions, pad_mask, fused, generator,
               tail_affine):
        """Training path (crop2seg_tpu/nn/ltae.py:279-338): ``ltae_pool``, or
        ``ltae_pool_tail`` with the deferred tail. PE and the folds are taken
        in fp32 with autocast off, as the JAX package takes them from its fp32
        parameters."""
        b, t, hh, ww, c = x.shape
        with torch.autocast(x.device.type, enabled=False):
            pe = (self.pe(batch_positions) if self.positional_encoder is not None
                  else torch.zeros(b, t, self.d_model, device=x.device))
            params = self.pool_params()
        if pad_mask is None:
            pad_mask = torch.zeros(b, t, dtype=torch.bool, device=x.device)
        seed = 0
        if self.attn_dropout > 0.0:
            seed = int(torch.randint(
                0, 2 ** 31 - 1, (1,), generator=generator,
                device=generator.device if generator is not None else "cpu"))
        rows = x.reshape(b, t, hh * ww, c)
        kw = dict(n_head=self.n_head, drop_p=self.attn_dropout)
        if tail_affine is None:
            pool = ltae_pool if fused else ltae_pool_reference
            o = pool(rows, pe, pad_mask, *params, seed, **kw)
        else:
            pool = ltae_pool_tail if fused else ltae_pool_tail_reference
            o = pool(rows, *tail_affine, pe, pad_mask, *params, seed, **kw)
        return self._mlp_tail(o.reshape(b, hh, ww, self.d_model), generator), None

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *, need_attn: bool = True,
                tail_affine=None, fused: bool | None = None,
                generator: torch.Generator | None = None):
        if fused is None:
            fused = x.is_cuda
        if self.training:
            if need_attn:
                raise NotImplementedError(
                    "the training path returns no attention masks: pass "
                    "need_attn=False (attention output in training is not "
                    "ported yet, ROADMAP.md)")
            return self._train(x, batch_positions, pad_mask, fused, generator,
                               tail_affine)
        if fused:
            return self._fused(x, batch_positions, pad_mask, need_attn,
                               tail_affine)
        if tail_affine is not None:
            raise ValueError("tail_affine needs the fused path")
        out, attn = self._plain(x, batch_positions, pad_mask)
        return out, (attn if need_attn else None)
