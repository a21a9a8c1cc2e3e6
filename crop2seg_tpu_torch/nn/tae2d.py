"""TAE2d, the generic temporal attention encoder, with its classical
multi-head attention (port of crop2seg_tpu/nn/tae2d.py:44-280).

- ``ClassicalMultiHeadAttention``: full T x T self-attention per pixel row,
  each head with queries and keys ``d_hidden`` wide and values as wide as
  the input, output projection, dropout, residual + LayerNorm.
- ``PositionwiseFeedForward``: the two-layer FFN with residual + LayerNorm.
- ``TAE2d``: GroupNorm over (T, C/G) -> 1x1 projection -> + PE -> [cls
  tokens] -> attention (lightweight, or N classical stages) -> reductions
  of the embedding and of the attention (None | mean | cls | linear) ->
  MLP + BatchNorm + ReLU + dropout -> GroupNorm. With no embedding
  reduction the classical encoder returns a sequence (B, T, H, W, C_out).

The memory plan of the classical encoder. Its values are as wide as the
input for every head: at TimeUNet_v2's full width (T = 61, 16 heads, d_model
256) a pixel row holds about 2.5 MB of fp32 intermediates, 40 GB for one
128^2 patch. So everything that works per pixel row (the input GroupNorm,
the projection and PE, every attention stage with its dropouts, the
reductions and the MLP's Linear) runs in chunks of B*H*W rows
(``_rows``): ``chunk_rows`` derives their number from the shapes, so that
no tensor of a chunk passes 2**31 elements (CUDA's 32-bit indexing) and
the chunk's forward stays within ``CHUNK_BYTES``. The chunks end before the
MLP's BatchNorm, whose batch statistics span every pixel and date of the
batch; BatchNorm, ReLU, dropout and the out GroupNorm run on the whole
batch, at the MLP's width. The T x T attention leaves a chunk only where the
caller asks for it (``need_attn``), reduced where a reduction is set.

In training each chunk runs under ``torch.utils.checkpoint`` (non-reentrant;
``checkpoint_chunks``): only its input is kept, and the backward pass runs
the chunk again. The dropout masks come from a ``torch.Generator`` made in
the chunk from a seed (one host draw from the caller's generator a forward,
plus the chunk's index), so the recompute draws the same masks. The input
GroupNorm's statistics, the softmax and the LayerNorm stay fp32 under
autocast.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from crop2seg_tpu_torch.nn.layers import batch_norm
from crop2seg_tpu_torch.nn.ltae import (
    MaskedLightweightAttention, _dropout, _group_norm_btc, encode_positions)
from crop2seg_tpu_torch.nn.positional import AbsolutePositionalEncoder, PositionalEncoder

# the most elements one tensor of a chunk may hold: CUDA's 32-bit indexing
MAX_CHUNK_ELEMENTS = 2 ** 31 - 1
# the live bytes a chunk's forward may take, as ``chunk_rows`` counts them
CHUNK_BYTES = 4 * 2 ** 30


def chunk_rows(t: int, d_in: int, n_head: int, d_hidden: int, itemsize: int) -> int:
    """Pixel rows a chunk of the classical attention takes, for T steps
    (cls tokens included) of width ``d_in``, ``n_head`` heads with queries
    and keys ``d_hidden`` wide, and the big tensors' element size
    ``itemsize``. Per row a chunk holds up to four tensors of the values'
    size (T * n_head * d_in: the values, their contiguous copy for the
    product, the heads' outputs and their concatenation), the queries and
    keys, and six of the scores' size (n_head * T * T fp32: scores, masked,
    softmax, the dropout draw, its mask, the dropped attention). The rows
    are capped so that the largest tensor stays under MAX_CHUNK_ELEMENTS
    and the row count times those bytes under CHUNK_BYTES."""
    values, scores = t * n_head * d_in, n_head * t * t
    per_row = itemsize * (4 * values + 2 * t * n_head * d_hidden) + 4 * 6 * scores
    return max(1, min(MAX_CHUNK_ELEMENTS // max(values, scores), CHUNK_BYTES // per_row))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in fp32 (statistics and output)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class ClassicalMultiHeadAttention(nn.Module):
    """Full T x T self-attention (crop2seg_tpu/nn/tae2d.py:44-88): fc_q and
    fc_k map d_in -> n_head * d_hidden, fc_v d_in -> n_head * d_in (each
    head's values as wide as the input), scores / sqrt(d_hidden) masked at
    -1e6 on padded keys, softmax, dropout, the heads concatenated through
    fc_out (no bias) back to d_in, dropout, LayerNorm(eps 1e-6) of the sum
    with the input. ``dropout`` is both dropouts' rate (training only)."""

    def __init__(self, n_head: int, d_hidden: int, d_in: int, dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_hidden, self.dropout = n_head, d_hidden, dropout
        self.fc_q = nn.Linear(d_in, n_head * d_hidden)
        self.fc_k = nn.Linear(d_in, n_head * d_hidden)
        self.fc_v = nn.Linear(d_in, n_head * d_in)
        self.fc_out = nn.Linear(n_head * d_in, d_in, bias=False)
        self.layer_norm = nn.LayerNorm(d_in, eps=1e-6)

    def forward(self, v: torch.Tensor, pad_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None, need_attn: bool = True):
        """v (N, T, d_in), pad_mask (N, T) True at pads -> out (N, T, d_in)
        fp32 and the attention (N, head, T, T) fp32 (the dropped one that
        weighed the values), or None without ``need_attn``."""
        n, t, d = v.shape
        g, dh = self.n_head, self.d_hidden
        q = self.fc_q(v).reshape(n, t, g, dh).transpose(1, 2)
        k = self.fc_k(v).reshape(n, t, g, dh).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(dh)
        if pad_mask is not None:
            scores = scores.masked_fill(pad_mask[:, None, None, :], -1e6)
        p = self.dropout if self.training else 0.0
        attn = _dropout(torch.softmax(scores, dim=-1), p, generator)
        val = self.fc_v(v).reshape(n, t, g, d).transpose(1, 2)
        out = torch.matmul(attn.to(val.dtype), val).transpose(1, 2).reshape(n, t, g * d)
        out = _dropout(self.fc_out(out), p, generator)
        return _layer_norm(out + v, self.layer_norm), (attn if need_attn else None)


class PositionwiseFeedForward(nn.Module):
    """Two-layer FFN w_2(ReLU(w_1 x)), dropout, LayerNorm(eps 1e-6) of the
    sum with the input (crop2seg_tpu/nn/tae2d.py:91-104; TAE2d does not use
    it, in the JAX package either)."""

    def __init__(self, d_in: int, d_hid: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.w_1 = nn.Linear(d_in, d_hid)
        self.w_2 = nn.Linear(d_hid, d_in)
        self.layer_norm = nn.LayerNorm(d_in, eps=1e-6)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        h = self.w_2(torch.relu(self.w_1(x)))
        if self.training:
            h = _dropout(h, self.dropout, generator)
        return _layer_norm(h + x, self.layer_norm)


class TAE2d(nn.Module):
    """Temporal attention encoder (crop2seg_tpu/nn/tae2d.py:107-280).

    Call: x (B, T, H, W, C), batch_positions (B, T) or (B, T, 2), pad_mask
    (B, T) bool True at pads. Returns (out, attn):
    - lightweight: out (B, H, W, mlp[-1]), attn (B, H, W, head, T);
    - classical, reduced: out (B, H, W, mlp[-1]), attn (B, H, W, head, T);
    - classical with no embedding reduction: out (B, T, H, W, mlp[-1]) (the
      cls tokens dropped), attn (B, H, W, head, T', T) with no attention
      reduction (T' = T + the cls tokens), else as above.
    The classical encoder returns attn None without ``need_attn``.

    ``cls_hw`` (H, W) sizes the learned spatial cls tokens (nct, C, H, W),
    which the classical encoder prepends to the raw sequence with position
    -1 and no padding where a reduction is "cls". ``chunk_rows`` forces the
    pixel rows of a chunk (None: ``chunk_rows`` of the shapes);
    ``checkpoint_chunks`` (training) recomputes each chunk in the backward
    pass. ``generator`` draws the dropout masks in training: the attention's
    (``attn_dropout`` for the lightweight head, each classical stage's own
    rate) and the MLP's (``dropout``).
    """

    def __init__(self, attention_type: str = "lightweight",
                 embedding_reduction: Optional[str] = "mean",
                 attention_mask_reduction: Optional[str] = "mean",
                 num_attention_stages: int = 1, num_cls_tokens: int = 1,
                 in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 mlp: Sequence[int] = (256, 128), dropout: float = 0.2,
                 d_model: int | None = 256, T: float = 1000.0,
                 positional_encoding: bool = True, use_abs_rel_enc: bool = False,
                 num_queries: int = 1, add_linear: bool = False,
                 cls_hw: tuple | None = None):
        super().__init__()
        if attention_type not in ("lightweight", "classical"):
            raise ValueError(f"unknown attention_type {attention_type!r}")
        self.attention_type = attention_type
        self.embedding_reduction = embedding_reduction
        self.attention_mask_reduction = attention_mask_reduction
        self.n_head, self.dropout, self.attn_dropout = n_head, dropout, 0.1
        self.num_cls_tokens = num_cls_tokens
        self.chunk_rows: int | None = None
        self.checkpoint_chunks = True
        d = d_model if d_model is not None else in_channels
        self.in_norm = nn.GroupNorm(n_head, in_channels, eps=1e-5)
        self.inconv = nn.Conv1d(in_channels, d, 1) if d_model is not None else None
        self.positional_encoder = self.positional_encoder_abs = None
        if positional_encoding:
            self.positional_encoder = PositionalEncoder(
                d // n_head, T=T, repeat=n_head, add_linear=add_linear)
            if use_abs_rel_enc:
                self.positional_encoder_abs = AbsolutePositionalEncoder(
                    d // n_head, repeat=n_head)
        self.use_cls = attention_type == "classical" and "cls" in (
            embedding_reduction, attention_mask_reduction)
        if attention_type == "lightweight":
            self.attention_heads = nn.ModuleList(
                [MaskedLightweightAttention(n_head, d_k, d, num_queries)])
        else:
            self.attention_heads = nn.ModuleList(
                ClassicalMultiHeadAttention(n_head, d_k, d)
                for _ in range(num_attention_stages))
            nct = num_cls_tokens
            if self.use_cls:
                if cls_hw is None:
                    raise ValueError("the cls tokens need cls_hw (H, W)")
                self.cls_token = nn.Parameter(torch.randn(nct, in_channels, *cls_hw))
                self.register_buffer("cls_position", torch.full((nct,), -1.0))
                self.register_buffer("cls_pad_mask", torch.zeros(nct, dtype=torch.bool))
            if embedding_reduction == "cls" and nct > 1:
                self.cls_emb_conv = nn.Conv1d(nct, 1, 1)
            if attention_mask_reduction == "cls" and nct > 1:
                self.cls_attn_conv = nn.Conv1d(nct, 1, 1)
            if embedding_reduction == "linear":
                self.linear_embedding_reduction = nn.Sequential(
                    nn.AdaptiveAvgPool1d(45), nn.Linear(45, 1))
            if attention_mask_reduction == "linear":
                self.linear_attention_mask_reduction = nn.Sequential(
                    nn.AdaptiveAvgPool1d(45), nn.Linear(45, 1))
        # mlp.1 is the BatchNorm, as in the reference state dicts
        self.mlp = nn.Sequential(nn.Linear(d, mlp[1]), nn.BatchNorm1d(mlp[1], eps=1e-5),
                                 nn.ReLU())
        self.out_norm = nn.GroupNorm(n_head, mlp[-1], eps=1e-5)

    def _pe(self, batch_positions):
        """(B, T[, 2]) -> (B, T, d) fp32, autocast off; None without PE."""
        if self.positional_encoder is None:
            return None
        with torch.autocast(batch_positions.device.type, enabled=False):
            return encode_positions(self.positional_encoder,
                                    self.positional_encoder_abs, batch_positions)

    def _embed(self, x: torch.Tensor, pe: torch.Tensor | None) -> torch.Tensor:
        """GroupNorm over (T, C/G) per pixel, the projection, + PE: (B, T,
        H, W, C) -> (B, T, H, W, d); pe (B, T, d)."""
        h = _group_norm_btc(x, self.n_head, self.in_norm.weight, self.in_norm.bias,
                            self.in_norm.eps)
        if self.inconv is not None:
            h = F.linear(h, self.inconv.weight[:, :, 0], self.inconv.bias)
        if pe is not None:
            h = h + pe[:, :, None, None, :].to(h.dtype)
        return h

    def _reduce_embedding(self, out: torch.Tensor) -> torch.Tensor:
        """(n, S, d) -> (n, d) by the embedding reduction, or as it is."""
        r, nct = self.embedding_reduction, self.num_cls_tokens
        if r == "mean":
            return out.mean(dim=1)
        if r == "cls":
            if nct == 1:
                return out[:, 0]
            conv = self.cls_emb_conv
            return F.linear(out[:, :nct].transpose(1, 2), conv.weight[:, :, 0], conv.bias)[..., 0]
        if r == "linear":
            return self.linear_embedding_reduction(out.transpose(1, 2))[..., 0]
        return out

    def _reduce_attention(self, attn: torch.Tensor) -> torch.Tensor:
        """(n, head, S, S) -> (n, head, T) by the attention reduction (over
        the queries), or (n, head, S, T); cls keys dropped."""
        r, nct, s = self.attention_mask_reduction, self.num_cls_tokens, attn.shape[-1]
        if r == "mean":
            attn = attn.mean(dim=-2)
        elif r == "cls":
            sel = attn[..., :nct, nct:]             # cls queries x real-date keys
            if nct == 1:
                attn = sel[..., 0, :]
            else:
                conv = self.cls_attn_conv
                attn = F.linear(sel.transpose(-1, -2), conv.weight[:, :, 0], conv.bias)[..., 0]
        elif r == "linear":
            pool, lin = self.linear_attention_mask_reduction
            n, g = attn.shape[:2]
            pooled = pool(attn.transpose(-1, -2).reshape(n * g, s, s))
            attn = lin(pooled.reshape(n, g, s, -1))[..., 0]
        if self.use_cls and r != "cls" and attn.shape[-1] == s:
            attn = attn[..., nct:]
        return attn

    def _rows(self, x, pe, pad_mask, start: int, hw: int, seed, need_attn: bool):
        """One chunk of pixel rows x (n, S, C), rows start .. start + n of
        the batch's B * H * W (row r of batch item r // hw): embed, attention
        stages, reductions and the MLP's Linear. ``seed`` (training) seeds
        the chunk's dropout generator. Returns (n, [S,] mlp[1]) and the
        reduced attention, or None without ``need_attn``."""
        n, s, c = x.shape
        item = torch.arange(start, start + n, device=x.device) // hw
        h = self._embed(x.reshape(n, s, 1, 1, c), None if pe is None else pe[item])
        h = h.reshape(n, s, -1)
        mask = None if pad_mask is None else pad_mask[item]
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        attn = None
        for i, stage in enumerate(self.attention_heads):
            last = i == len(self.attention_heads) - 1
            h, attn = stage(h, mask, gen, need_attn=need_attn and last)
        out = self.mlp[0](self._reduce_embedding(h))
        return out, (None if attn is None else self._reduce_attention(attn))

    def _classical(self, x, batch_positions, pad_mask, need_attn, generator):
        b, t, hh, ww, c = x.shape
        hw = hh * ww
        rows = x.permute(0, 2, 3, 1, 4).reshape(b * hw, t, c)
        if self.use_cls:
            nct = self.num_cls_tokens
            cls = self.cls_token.permute(2, 3, 0, 1).reshape(hw, nct, c)
            rows = torch.cat([cls.to(rows.dtype).repeat(b, 1, 1), rows], dim=1)
            if pad_mask is not None:
                pad_mask = torch.cat([self.cls_pad_mask.expand(b, nct), pad_mask], dim=1)
            if batch_positions is not None:
                pos = self.cls_position.to(batch_positions.dtype).reshape(
                    (1, nct) + (1,) * (batch_positions.dim() - 2))
                batch_positions = torch.cat(
                    [pos.expand((b, nct) + tuple(batch_positions.shape[2:])),
                     batch_positions], dim=1)
        pe = self._pe(batch_positions)
        n_rows, s = rows.shape[:2]
        stage = self.attention_heads[0]
        dtype = (torch.get_autocast_dtype(x.device.type)
                 if torch.is_autocast_enabled(x.device.type) else rows.dtype)
        per = self.chunk_rows or chunk_rows(
            s, stage.fc_q.in_features, self.n_head, stage.d_hidden, dtype.itemsize)
        seed = None
        if self.training and any(st.dropout > 0 for st in self.attention_heads):
            # one host draw a forward; chunk i seeds its generator with seed + i
            seed = int(torch.randint(
                0, 2 ** 31 - 1, (1,), generator=generator,
                device=generator.device if generator is not None else "cpu"))
        ckpt = self.training and torch.is_grad_enabled() and self.checkpoint_chunks
        outs, attns = [], []
        for i, start in enumerate(range(0, n_rows, per)):
            args = (rows[start:start + per], pe, pad_mask, start, hw,
                    None if seed is None else seed + i, need_attn)
            if ckpt:
                o, a = checkpoint(self._rows, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                o, a = self._rows(*args)
            outs.append(o)
            attns.append(a)
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        attn = None
        if need_attn:
            attn = attns[0] if len(attns) == 1 else torch.cat(attns)
            attn = attn.reshape((b, hh, ww) + tuple(attn.shape[1:]))
        return out, attn

    def forward(self, x: torch.Tensor, batch_positions: torch.Tensor | None = None,
                pad_mask: torch.Tensor | None = None, *, need_attn: bool = True,
                generator: torch.Generator | None = None):
        b, t, hh, ww, _ = x.shape
        if self.attention_type == "lightweight":
            h = self._embed(x, self._pe(batch_positions))
            out, attn = self.attention_heads[0](
                h, pad_mask, self.attn_dropout if self.training else 0.0, generator)
            out, attn = self.mlp[0](out[:, :, :, 0]), attn[..., 0, :]
        else:
            out, attn = self._classical(x, batch_positions, pad_mask, need_attn, generator)
        # the whole batch: BatchNorm (statistics over every pixel and date),
        # ReLU, dropout, and the out GroupNorm over (T, C/G) per pixel
        o = torch.relu(batch_norm(out, self.mlp[1]))
        if self.training:
            o = _dropout(o, self.dropout, generator)
        c, sequence = o.shape[-1], out.dim() == 3      # (B*H*W, T', C) rows
        seq = o.shape[1] if sequence else 1
        o = _group_norm_btc(o.reshape(-1, seq, 1, 1, c), self.n_head,
                            self.out_norm.weight, self.out_norm.bias, self.out_norm.eps)
        if not sequence:
            return o.reshape(b, hh, ww, c), attn
        o = o.reshape(b, hh, ww, seq, c)[:, :, :, seq - t:]    # cls tokens dropped
        return o.permute(0, 3, 1, 2, 4).contiguous(), attn
