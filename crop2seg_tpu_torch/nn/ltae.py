"""Masked lightweight temporal attention encoder, nq learnable queries per
head (port of crop2seg_tpu/nn/ltae.py:39-495), and W-TAE's ``LTAE4WTAE``,
which returns the attention only (:495-548).

Per pixel row, T steps, C channels:

    h   = GroupNorm_{n_head}(x)                       # over (C/G, T) jointly
    h   = W_in h + PE(dates)                          # 1x1 proj C -> d_model
    A_q = softmax_T(q . (W_k h) / sqrt(d_k), -1e6 at pads)   # per query q
    o_q = head-grouped sum_t A_q h -> MLP + BN + ReLU
    out = GroupNorm_{n_head} over (nq, d_out/G) per group

The input GroupNorm counts pad frames, as the reference does (its torch
GroupNorm over (C/G, T) sees the zero pad frames). Outputs have the JAX
layouts: out (B, H, W, d_out) and attn (B, H, W, head, T) for one query,
out (B, nq, H, W, d_out) and attn (B, H, W, head, nq, T) for nq > 1.

Eval mode with ``use_pallas``: a CUDA tensor runs the fused eval kernel
(ops/ltae_fused.py), any nq; a CPU tensor the plain PyTorch ops below.
Training mode, as the JAX ``LTAE`` routes it: with ``use_pallas_train``, one
query and no attention output the pooling runs through ``ops/ltae_pool.py``
(its kernel pair on a CUDA tensor, the JAX ``_fused_train``) and returns
``(out, None)``; otherwise ``_chunked`` (with ``seq_chunk``) or the plain
ops run, with attention dropout after the softmax, and the
returned attention is the dropped, rescaled one that weighed the values (U-TAE
aggregates its skips with it). The MLP tail runs in training mode either way.

``seq_chunk`` streams T in chunks of that many steps with an online
softmax (``LTAE._chunked``, crop2seg_tpu/nn/ltae.py:354-459), so the
(B, T, H, W, d_model) embed never exists whole.

The route follows the JAX ``LTAE``'s flags in its gate order
(crop2seg_tpu/nn/ltae.py:471-485, ``LTAE.route``): the eval kernel when
``use_pallas`` and not training; the kernel pair when ``use_pallas_train``
with one query and no attention output, in training and in eval alike (the
JAX gate has no training condition); ``_chunked`` when ``seq_chunk`` is set
(one query, no attention output); else the plain ops. On a CUDA tensor a
kernel route launches the CUDA kernels. On a CPU tensor (``fused`` None or
False) the eval kernel's route runs the plain ops and the pair's route its
plain version ``ltae_pool_reference``; ``fused=True`` on a CPU tensor calls
the kernel wrappers, which run their plain versions there. Both flags
default to True here (the JAX module's default False): the port's models
serve and train on the kernels on the card unless a caller turns them off,
as the JAX callers that serve pass ``use_pallas=True`` themselves.

The kernel route (``fused``) takes every shape the module is defined at,
as the JAX ``LTAE`` with ``use_pallas`` runs its Pallas kernel at any T:
the wrappers send a shape their fast kernels take (``LTAE.kernel_takes``:
T <= 64, C <= 128 in eval and C <= 64 in training, ...) to those, and any
other (T > 64 above all) to their general kernels. The producer's deferred
GroupNorm affine (``tail_affine``) is taken on the eval kernel's route
with ``fused`` only, on the pair's route either way.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from crop2seg_tpu_torch.nn.layers import acc_dtype, batch_norm
from crop2seg_tpu_torch.nn.positional import (
    AbsolutePositionalEncoder, PositionalEncoder)
from crop2seg_tpu_torch.ops import ltae_fused, ltae_pool as pool_ops
from crop2seg_tpu_torch.ops.ltae_pool import (
    ltae_pool, ltae_pool_reference, ltae_pool_tail, ltae_pool_tail_reference)


def _group_norm_btc(x: torch.Tensor, n_groups: int, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of (B, T, H, W, C) with statistics over (T, C/G) per pixel,
    fp32 two-pass (fp64 for fp64 x); returns x.dtype."""
    b, t, h, w, c = x.shape
    g = x.to(acc_dtype(x.dtype)).reshape(b, t, h, w, n_groups, c // n_groups)
    mean = g.mean(dim=(1, 5), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 5), keepdim=True)
    y = (g - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(g.dtype).reshape(n_groups, -1) + bias.to(g.dtype).reshape(n_groups, -1)
    return y.reshape(x.shape).to(x.dtype)


def _group_norm_queries(x: torch.Tensor, n_groups: int, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of (..., nq, C) over channel groups, each group pooled over
    the nq queries (torch GroupNorm on (N, C, nq)), fp32 two-pass; the affine
    is shared across queries."""
    *lead, nq, c = x.shape
    g = x.to(acc_dtype(x.dtype)).reshape(*lead, nq, n_groups, c // n_groups).transpose(-3, -2)
    g = g.reshape(*lead, n_groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = (g - mean).square().mean(dim=-1, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(
        *lead, n_groups, nq, c // n_groups).transpose(-3, -2).reshape(x.shape)
    return (y * scale.to(y.dtype) + bias.to(y.dtype)).to(x.dtype)


def encode_positions(encoder: nn.Module, encoder_abs: nn.Module | None,
                     batch_positions: torch.Tensor) -> torch.Tensor:
    """(B, T[, 2]) -> (B, T, d_model): ``encoder`` on the relative dates,
    plus ``encoder_abs`` on the days of year where there is one (dates
    (B, T, 2): relative, day of year)."""
    if encoder_abs is not None:
        return encoder(batch_positions[..., 0]) + encoder_abs(batch_positions[..., 1])
    bp = batch_positions if batch_positions.dim() == 2 else batch_positions[..., 0]
    return encoder(bp)


def _dropout(x: torch.Tensor, p: float, generator=None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (flax
    ``nn.Dropout``: kept values scaled by 1/(1-p))."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


class MaskedLightweightAttention(nn.Module):
    """Learnable-query masked attention over time, ``num_queries`` queries
    per head (crop2seg_tpu/nn/ltae.py:77-125).

    h: (B, T, H, W, d_model) time-major; pad_mask (B, T) True at pads.
    Returns out (B, H, W, nq, d_model), each query's heads concatenated
    head-major, and attn (B, H, W, head, nq, T). ``attn_dropout`` > 0 drops
    attention weights after the softmax (masks from ``generator``); the
    returned attention is then the dropped one that weighed the values.
    """

    def __init__(self, n_head: int, d_k: int, d_model: int, num_queries: int = 1):
        super().__init__()
        self.n_head, self.d_k = n_head, d_k
        self.Q = nn.Parameter(torch.empty(n_head, num_queries, d_k))
        self.fc1_k = nn.Linear(d_model, n_head * d_k)
        std = math.sqrt(2.0 / d_k)
        nn.init.normal_(self.Q, std=std)
        nn.init.normal_(self.fc1_k.weight, std=std)

    def forward(self, h: torch.Tensor, pad_mask: torch.Tensor | None = None,
                attn_dropout: float = 0.0, generator=None):
        b, t, hh, ww, d = h.shape
        k = self.fc1_k(h).reshape(b, t, hh, ww, self.n_head, self.d_k)
        scores = torch.einsum("gqk,btxygk->bxygqt", self.Q.to(k.dtype), k)
        scores = scores.to(acc_dtype(scores.dtype)) / math.sqrt(self.d_k)
        if pad_mask is not None:
            scores = scores.masked_fill(pad_mask[:, None, None, None, None, :], -1e6)
        attn = _dropout(torch.softmax(scores, dim=-1), attn_dropout, generator)
        v = h.reshape(b, t, hh, ww, self.n_head, d // self.n_head)
        out = torch.einsum("bxygqt,btxygd->bxyqgd", attn.to(v.dtype), v)
        return out.reshape(b, hh, ww, -1, d), attn


class _AttentionEncoder(nn.Module):
    """What ``LTAE`` and ``LTAE4WTAE`` share: the input GroupNorm
    (``in_norm``), the 1x1 projection C -> d_model (``inconv``, a Conv1d as
    in the reference), the positional encoders and the attention head, and
    ``embed``, the plain ops up to the attention."""

    def __init__(self, in_channels: int, n_head: int, d_k: int, d_model: int,
                 T: float, positional_encoding: bool, use_abs_rel_enc: bool,
                 use_doy: bool, num_queries: int, add_linear: bool,
                 attn_dropout: float):
        super().__init__()
        if d_model is None:
            raise ValueError("the port needs d_model set")
        self.n_head, self.d_k, self.d_model = n_head, d_k, d_model
        self.num_queries = num_queries
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
        self.attention_head = MaskedLightweightAttention(n_head, d_k, d_model,
                                                         num_queries)

    def pe(self, batch_positions: torch.Tensor) -> torch.Tensor:
        """(B, T[, 2]) -> (B, T, d_model) fp32 positional encoding."""
        return encode_positions(
            self.positional_encoder,
            self.positional_encoder_abs if self.use_abs_rel_enc else None,
            batch_positions)

    def embed(self, x: torch.Tensor, batch_positions) -> torch.Tensor:
        """GroupNorm over (T, C/G) per pixel, the projection, plus PE (taken
        in fp32 with autocast off): (B, T, H, W, C) -> (B, T, H, W,
        d_model)."""
        h = _group_norm_btc(x, self.n_head, self.in_norm.weight,
                            self.in_norm.bias, self.in_norm.eps)
        h = F.linear(h, self.inconv.weight[:, :, 0], self.inconv.bias)
        if self.positional_encoder is not None:
            with torch.autocast(x.device.type, enabled=False):
                pe = self.pe(batch_positions)
            h = h + pe[:, :, None, None, :].to(h.dtype)
        return h


class LTAE(_AttentionEncoder):
    """Lightweight temporal attention encoder.

    Call: x (B, T, H, W, C), batch_positions (B, T) or (B, T, 2), pad_mask
    (B, T) bool. ``use_pallas`` and ``use_pallas_train`` choose the route as
    the JAX module's fields do (``route``; both True by default, module
    docstring). ``fused`` picks how a kernel route runs: None means the
    kernel for a CUDA tensor and the plain version for a CPU tensor;
    True/False force one (the tests and chip_smoke.py compare the two). The
    kernel route takes any shape: a fast kernel where ``kernel_takes``, a
    general one elsewhere.
    ``tail_affine`` is the producer's deferred GroupNorm affine ``(sc, sh)``
    of shape (B, T, C), applied as ``max(x * sc + sh, 0)`` (the eval
    kernel's route with ``fused``; the pair's route through
    ``ltae_pool_tail``, or its plain version when not fused; any other route
    raises). ``generator`` (training only) draws the dropout masks; None
    uses PyTorch's global RNG.
    ``dropout`` is the MLP's rate, ``attn_dropout`` the attention's.
    ``num_queries`` > 1 adds a query axis to both outputs (module docstring).
    ``seq_chunk`` (None or 0: off) streams T in chunks of that many steps
    where no kernel route takes the call (module docstring, ``_chunked``).
    """

    def __init__(self, in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 mlp: tuple = (256, 128), dropout: float = 0.2,
                 d_model: int = 256, T: float = 1000.0,
                 positional_encoding: bool = True,
                 use_abs_rel_enc: bool = False, use_doy: bool = False,
                 num_queries: int = 1, add_linear: bool = False,
                 attn_dropout: float = 0.1, seq_chunk: int | None = None,
                 use_pallas: bool = True, use_pallas_train: bool = True):
        if d_model is None or mlp[0] != d_model:
            raise ValueError("the port needs d_model set and mlp[0] == d_model")
        super().__init__(in_channels, n_head, d_k, d_model, T,
                         positional_encoding, use_abs_rel_enc, use_doy,
                         num_queries, add_linear, attn_dropout)
        # mlp.2 is the BN, as in the reference state dict; index 1 holds the
        # dropout rate only: _mlp_tail applies it after the ReLU, the JAX order
        self.mlp = nn.Sequential(nn.Linear(mlp[0], mlp[1]), nn.Dropout(dropout),
                                 nn.BatchNorm1d(mlp[1], eps=1e-5), nn.ReLU())
        self.out_norm = nn.GroupNorm(n_head, mlp[1], eps=1e-5)
        self.seq_chunk = seq_chunk
        self.use_pallas, self.use_pallas_train = use_pallas, use_pallas_train

    def _mlp_tail(self, o: torch.Tensor, generator=None) -> torch.Tensor:
        """MLP -> BN -> ReLU -> Dropout -> out GroupNorm on (..., nq,
        d_model), the order of crop2seg_tpu/nn/ltae.py:340-352 (BN and
        dropout in training mode only when the module trains)."""
        lin, drop, bn, _ = self.mlp
        m = torch.relu(batch_norm(lin(o), bn))
        if self.training:
            m = _dropout(m, drop.p, generator)
        return _group_norm_queries(m, self.n_head, self.out_norm.weight,
                                   self.out_norm.bias, self.out_norm.eps)

    def _with_query_axes(self, out, attn):
        """(B, H, W, nq, d) and (B, H, W, G, nq, T) -> the JAX ranks: the
        query axes dropped for one query, out as (B, nq, H, W, d) else."""
        if self.num_queries == 1:
            return out[:, :, :, 0], None if attn is None else attn[..., 0, :]
        return out.permute(0, 3, 1, 2, 4), attn

    def _plain(self, x, batch_positions, pad_mask, generator=None):
        """The plain ops in either mode (crop2seg_tpu/nn/ltae.py:486-492); in
        training mode with attention and MLP dropout. PE is taken in fp32
        with autocast off."""
        out, attn = self.attention_head(
            self.embed(x, batch_positions), pad_mask,
            self.attn_dropout if self.training else 0.0, generator)
        return self._with_query_axes(self._mlp_tail(out, generator), attn)

    def _fused(self, x, batch_positions, pad_mask, need_attn, tail_affine):
        b, t, hh, ww, c = x.shape
        pe = (self.pe(batch_positions) if self.positional_encoder is not None
              else torch.zeros(b, t, self.d_model, device=x.device))
        if pad_mask is None:
            pad_mask = torch.zeros(b, t, dtype=torch.bool, device=x.device)
        params = ltae_fused.params_from_ltae_variables(self.state_dict())
        out, attn = ltae_fused.ltae_fused_forward(
            x.reshape(b, t, hh * ww, c), pe, pad_mask, params,
            n_head=self.n_head, d_k=self.d_k, need_attn=need_attn,
            tail_affine=tail_affine)
        nq = self.num_queries
        return self._with_query_axes(
            out.reshape(b, hh, ww, nq, -1),
            None if attn is None else attn.reshape(b, hh, ww, self.n_head, nq, t))

    def pool_params(self):
        """``(win_f, bin_f, u, cs)`` of ``ops/ltae_pool.py`` from the raw
        parameters (crop2seg_tpu/nn/ltae.py:301-311): the input GroupNorm's
        affine folded into the projection, the (one) query into the keys.
        Plain torch ops, so autograd reaches the parameters through them."""
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
        """The kernel pair's route, one query, no attention output
        (crop2seg_tpu/nn/ltae.py:279-338, the JAX ``_fused_train``):
        ``ltae_pool``, or ``ltae_pool_tail`` with the deferred tail; in eval
        mode without dropout and with the MLP tail's running statistics. PE
        and the folds are taken in fp32 with autocast off, as the JAX package
        takes them from its fp32 parameters."""
        b, t, hh, ww, c = x.shape
        with torch.autocast(x.device.type, enabled=False):
            pe = (self.pe(batch_positions) if self.positional_encoder is not None
                  else torch.zeros(b, t, self.d_model, device=x.device))
            params = self.pool_params()
        if pad_mask is None:
            pad_mask = torch.zeros(b, t, dtype=torch.bool, device=x.device)
        seed, drop_p = 0, self.attn_dropout if self.training else 0.0
        if drop_p > 0.0:
            seed = int(torch.randint(
                0, 2 ** 31 - 1, (1,), generator=generator,
                device=generator.device if generator is not None else "cpu"))
        rows = x.reshape(b, t, hh * ww, c)
        kw = dict(n_head=self.n_head, drop_p=drop_p)
        if tail_affine is None:
            pool = ltae_pool if fused else ltae_pool_reference
            o = pool(rows, pe, pad_mask, *params, seed, **kw)
        else:
            pool = ltae_pool_tail if fused else ltae_pool_tail_reference
            o = pool(rows, *tail_affine, pe, pad_mask, *params, seed, **kw)
        out = self._mlp_tail(o.reshape(b, hh, ww, 1, self.d_model), generator)
        return out[:, :, :, 0], None

    def _chunk(self, x, pe, mask, sc, sh, m, l, acc, seed):
        """One chunk of T steps of ``_chunked``: x (B, tc, H, W, C) through the
        input GroupNorm (the whole T's affine ``sc``, ``sh``), the projection
        and PE, the masked scores, and the running max ``m``, normalizer ``l``
        and fp32 value accumulator ``acc`` (B, H, W, G[, d_v]) moved on by the
        chunk. ``seed`` (training with attention dropout) seeds the chunk's
        dropout generator."""
        b, tc, hh, ww, c = x.shape
        g, dk = self.n_head, self.d_k
        h = (x.to(sc.dtype).reshape(b, tc, hh, ww, g, c // g) * sc + sh).to(x.dtype)
        h = F.linear(h.reshape(b, tc, hh, ww, c), self.inconv.weight[:, :, 0],
                     self.inconv.bias)
        h = h + pe[:, :, None, None, :].to(h.dtype)
        att = self.attention_head
        k = att.fc1_k(h).reshape(b, tc, hh, ww, g, dk)
        scores = torch.einsum("gk,btxygk->bxygt", att.Q[:, 0].to(k.dtype), k)
        scores = scores.to(acc.dtype) / math.sqrt(dk)
        scores = scores.masked_fill(mask[:, None, None, None, :], -1e6)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        w = torch.exp(scores - m_new[..., None])
        l_new = l * corr + w.sum(dim=-1)
        if seed is not None:
            # dropout on the normalized weights: l counts the undropped ones
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
            w = _dropout(w, self.attn_dropout, gen)
        v = h.reshape(b, tc, hh, ww, g, -1)
        pv = torch.einsum("bxygt,btxygd->bxygd", w.to(v.dtype), v)
        return m_new, l_new, acc * corr[..., None] + pv.to(acc.dtype)

    def _chunked(self, x, batch_positions, pad_mask, generator=None):
        """The L-TAE streamed over T in chunks of ``seq_chunk`` steps, one
        query, no attention output (crop2seg_tpu/nn/ltae.py:354-459), in
        either mode: the input GroupNorm's statistics over the whole T (pad
        frames included, as in the plain path), then per chunk the embed,
        the masked scores and an online softmax (``_chunk``), exact up to
        the order of fp32 sums. The last chunk holds what T leaves (the JAX
        path pads it to a full chunk and masks the padding out of the
        attention and the statistics: the same sums for a sample with any
        valid step). In training each chunk runs under
        ``torch.utils.checkpoint`` (non-reentrant), so the backward pass
        recomputes one chunk's embed at a time; the attention dropout masks
        come from a generator made in the chunk from one host draw of
        ``generator`` a forward plus the chunk's index, so the recompute
        draws the same masks. The MLP tail runs on the whole batch."""
        b, t, hh, ww, c = x.shape
        g, d = self.n_head, self.d_model
        if pad_mask is None:
            pad_mask = torch.zeros(b, t, dtype=torch.bool, device=x.device)
        adt = acc_dtype(x.dtype)
        g32 = x.to(adt).reshape(b, t, hh, ww, g, c // g)
        mean = g32.mean(dim=(1, 5), keepdim=True)
        var = (g32 - mean).square().mean(dim=(1, 5), keepdim=True)
        del g32
        sc = self.in_norm.weight.to(adt).reshape(g, -1) * torch.rsqrt(var + self.in_norm.eps)
        sh = self.in_norm.bias.to(adt).reshape(g, -1) - mean * sc
        with torch.autocast(x.device.type, enabled=False):
            pe = (self.pe(batch_positions) if self.positional_encoder is not None
                  else torch.zeros(b, t, d, device=x.device))
        seed = None
        if self.training and self.attn_dropout > 0.0:
            # one host draw a forward; chunk i seeds its generator with seed + i
            seed = int(torch.randint(
                0, 2 ** 31 - 1, (1,), generator=generator,
                device=generator.device if generator is not None else "cpu"))
        ckpt = self.training and torch.is_grad_enabled()
        m = torch.full((b, hh, ww, g), -math.inf, dtype=adt, device=x.device)
        l = torch.zeros(b, hh, ww, g, dtype=adt, device=x.device)
        acc = torch.zeros(b, hh, ww, g, d // g, dtype=adt, device=x.device)
        tc = int(self.seq_chunk)
        for i, s in enumerate(range(0, t, tc)):
            args = (x[:, s:s + tc], pe[:, s:s + tc], pad_mask[:, s:s + tc], sc, sh,
                    m, l, acc, None if seed is None else seed + i)
            if ckpt:
                m, l, acc = checkpoint(self._chunk, *args, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                m, l, acc = self._chunk(*args)
        o = (acc / l[..., None]).to(x.dtype).reshape(b, hh, ww, 1, d)
        return self._mlp_tail(o, generator)[:, :, :, 0], None

    def kernel_route(self, t: int, c: int) -> str:
        """The kernel that serves T steps of C channels on this mode's kernel
        route: in eval ``ops/ltae_fused.py::kernel_route`` ("group", "wide",
        "queries" or "general"); in training, where the pair serves one query
        without the attention output, "pair" where the fast pair takes the
        shape (``ops/ltae_pool.py::kernel_takes``), else "general".
        ValueError where the module is not defined (G not dividing C,
        d_model and the MLP's width)."""
        g, d, d_out = self.n_head, self.d_model, self.out_norm.num_channels
        route = ltae_fused.kernel_route(t, c, d, g, d_out, self.num_queries)
        if not self.training:
            return route
        return "pair" if pool_ops.kernel_takes(t, c, d, g) else "general"

    def kernel_takes(self, t: int, c: int) -> bool:
        """Whether this mode's kernel route takes T steps of C channels: at
        every shape where the module is defined, by a fast kernel or by a
        general one (``kernel_route``), as the JAX ``LTAE`` runs its Pallas
        kernel at any T."""
        try:
            self.kernel_route(t, c)
        except ValueError:
            return False
        return True

    def route(self, need_attn: bool = True) -> str:
        """The JAX ``LTAE``'s gate (crop2seg_tpu/nn/ltae.py:471-485) in this
        mode: "eval" (the eval kernel), "pair" (the kernel pair, in either
        mode), "chunked" (``_chunked``) or "plain"."""
        one_query = not need_attn and self.num_queries == 1
        if self.use_pallas and not self.training:
            return "eval"
        if self.use_pallas_train and one_query:
            return "pair"
        if self.seq_chunk and one_query:
            return "chunked"
        return "plain"

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *, need_attn: bool = True,
                tail_affine=None, fused: bool | None = None,
                generator: torch.Generator | None = None):
        if fused is None:
            fused = x.is_cuda
        route = self.route(need_attn)
        if tail_affine is not None and not (route == "pair" or (route == "eval" and fused)):
            raise ValueError(
                "tail_affine needs a kernel path: the eval kernel's route with "
                f"fused, or the kernel pair's route; this call takes {route!r}")
        if route == "eval" and fused:
            return self._fused(x, batch_positions, pad_mask, need_attn,
                               tail_affine)
        if route == "pair":
            return self._train(x, batch_positions, pad_mask, fused, generator,
                               tail_affine)
        if route == "chunked":
            return self._chunked(x, batch_positions, pad_mask, generator)
        out, attn = self._plain(x, batch_positions, pad_mask, generator)
        return out, (attn if need_attn else None)


class LTAE4WTAE(_AttentionEncoder):
    """The L-TAE that returns the attention masks only (W-TAE's temporal
    encoder; crop2seg_tpu/nn/ltae.py:495-548): GroupNorm over (T, C/G) ->
    ``inconv`` -> + PE -> ``MaskedLightweightAttention``, plain ops in either
    mode (the JAX package has no kernel for it). Call: x (B, T, H, W, C),
    batch_positions (B, T) or (B, T, 2), pad_mask (B, T) bool -> attn (B, H,
    W, head, T), or (B, H, W, head, nq, T) for nq > 1. In training mode the
    attention is dropped after the softmax (rate ``attn_dropout``, masks from
    ``generator``) and rescaled, as the JAX module returns it."""

    def __init__(self, in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 d_model: int = 256, T: float = 1000.0,
                 positional_encoding: bool = True,
                 use_abs_rel_enc: bool = False, use_doy: bool = False,
                 num_queries: int = 1, add_linear: bool = False,
                 attn_dropout: float = 0.1):
        super().__init__(in_channels, n_head, d_k, d_model, T,
                         positional_encoding, use_abs_rel_enc, use_doy,
                         num_queries, add_linear, attn_dropout)

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        _, attn = self.attention_head(
            self.embed(x, batch_positions), pad_mask,
            self.attn_dropout if self.training else 0.0, generator)
        return attn[..., 0, :] if self.num_queries == 1 else attn
