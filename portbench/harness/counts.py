"""The yardstick: the card's published peaks, the operations and bytes of
the L-TAE kernels counted from their shapes, and the model FLOPs counted on
the plain reference.

The kernel counts are a frozen copy of the repository's ``chip_smoke.py``
``ltae_flops`` / ``ltae_bytes`` / ``pool_flops`` / ``pool_bytes`` (the
kernels' bounds in PERF.md's kernel table), with the module's fixed sizes
turned into arguments.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _size(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def ltae_flops(b: int, tail: bool, n: int, c: int, d: int, g: int, d_out: int,
               t: int, nq: int = 1) -> float:
    """Operations the eval kernel (kernel 1) needs, counted per row: tail
    affine and input GroupNorm once; per query the scores, softmax,
    C-space pooling, the projection + PE term and the MLP; the out
    GroupNorm over all queries."""
    per_query = (2 * t * c * g + 4 * g * t + 2 * g * t * c + 2 * c * d + 2 * t * d
                 + d + 2 * d * d_out + 2 * d_out + 8 * d_out)
    per_row = (3 * t * c if tail else 0) + 6 * t * c + nq * per_query
    return float(b * n * per_row)


def ltae_bytes(b: int, dtype: torch.dtype, tail: bool, need_attn: bool, n: int,
               c: int, d: int, g: int, d_out: int, t: int, nq: int = 1) -> float:
    """Kernel 1: each input read once, each output written once."""
    es = _size(dtype)
    nb = b * t * n * c * es + b * n * nq * d_out * es     # x in, out
    nb += b * t * d * 4 + b * g * nq * t * 4               # pe, pes
    nb += (c * d + d + c * g * nq + d * d_out + 3 * d_out) * 4  # folded weights
    if tail:
        nb += 2 * b * t * c * 4
    if need_attn:
        nb += b * n * g * nq * t * 4
    return float(nb)


def pool_flops(b: int, backward: bool, tail: bool, n: int, c: int, d: int, g: int,
               t: int) -> float:
    """Kernels 2-3 (the training pair), counted per row. Forward: input
    GroupNorm, scores, softmax, C-space pooling, the projection + PE term,
    and in tail mode the affine and ReLU. Backward: the forward recomputed
    up to the softmax, Z and q, p1, the softmax jacobian, pooling, dxhat,
    the GroupNorm backward and the four sums; in tail mode also the affine
    and ReLU again, the mask, dz and the two tail sums."""
    tc, tcg, tg = t * c, t * c * g, t * g
    if backward:
        per_row = 14 * tc + 12 * tcg + 9 * tg + 4 * c * d + 4 * t * d
        per_row += 8 * tc if tail else 0
    else:
        per_row = 6 * tc + 4 * tcg + 4 * tg + 2 * c * d + 2 * t * d
        per_row += 3 * tc if tail else 0
    return float(b * n * per_row)


def pool_bytes(b: int, backward: bool, tail: bool, dtype: torch.dtype, n: int, c: int,
               d: int, g: int, t: int) -> float:
    """Kernels 2-3: each input read once, each output written once."""
    es = _size(dtype)
    nb = b * t * n * c * es + b * n * d * es           # x; o (fwd) or go (bwd)
    nb += (b * t * d + b * g * t + c * d + c * g) * 4  # bpe, pes, W_f, Ws
    if tail:
        nb += 2 * b * t * c * 4                        # tsc, tsh
    if backward:
        nb += b * t * n * c * es                       # dx
        nb += (c * g + c * d + b * t * g + b * t * d) * 4  # the four sums
        nb += 2 * b * t * c * 4 if tail else 0         # dtsc, dtsh
    return float(nb)


def bound_s(flops: float, nbytes: float, dtype: torch.dtype) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype])


def ltae_eval_bound_s(shape: dict, dtype: torch.dtype) -> float:
    """One kernel-1 launch at ``shape`` (``Model.ltae_launch``)."""
    s = {k: shape[k] for k in ("n", "c", "d", "g", "d_out", "t")}
    return bound_s(ltae_flops(shape["b"], shape["tail"], **s),
                   ltae_bytes(shape["b"], dtype, shape["tail"], shape["need_attn"], **s),
                   dtype)


def ltae_pool_bound_s(shape: dict, dtype: torch.dtype, backward: bool) -> float:
    """One launch of kernel 2 (forward) or kernel 3 (backward, with its
    reduce) at ``shape``."""
    s = {k: shape[k] for k in ("n", "c", "d", "g", "t")}
    return bound_s(pool_flops(shape["b"], backward, shape["tail"], **s),
                   pool_bytes(shape["b"], backward, shape["tail"], dtype, **s), dtype)


def model_flops(model: torch.nn.Module, x_shape: tuple, train: bool) -> float:
    """Convolution and matrix-product FLOPs of one forward (``train``:
    forward and backward) of the reference ``model`` on inputs of
    ``x_shape`` (B, T, H, W, C), counted by FlopCounterMode on the meta
    device, without recompute and without dropout."""
    b, t = x_shape[:2]
    model = model.to("meta")
    x = torch.zeros(x_shape, device="meta")
    dates = torch.zeros(b, t, device="meta")
    pad = torch.zeros(b, t, dtype=torch.bool, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            model.train()
            for m in model.modules():
                if hasattr(m, "attn_dropout"):
                    m.dropout = m.attn_dropout = 0.0
            model(x, dates, pad, generator=None).sum().backward()
        else:
            with torch.no_grad():
                model.eval()(x, dates, pad)
    return float(counter.get_total_flops())
