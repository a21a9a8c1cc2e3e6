"""Attention-guided temporal collapse of U-TAE's skip feature maps (port of
crop2seg_tpu/nn/aggregator.py:19-84).

Modes:
- ``att_group``: resample each head's attention to the skip resolution
  (bilinear up, average pooling down), zero padded dates, head-grouped
  weighted sum over T.
- ``att_mean``: the same with the head-averaged attention.
- ``mean``: masked temporal mean.

As in the JAX package the attention is resampled in x's dtype (bf16 under
autocast) and the weighted sum accumulates in fp32; the result has x's
dtype. The upsampled masks are the largest tensor on this path: at U-TAE's
128^2 skip and B=10, T=61 they take 10*16*128^2*61*4 B = 640 MB in fp32.

Inside ``nn/layers.py::space_shards`` the maps hold this rank's rows of H,
and the bilinear upsample takes one row of its neighbours' attention on each
side (``space_halo``; at the global edges the edge row repeated, which is
``F.interpolate``'s clamp), so each rank computes its rows of the whole
map's resample.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from crop2seg_tpu_torch.nn.layers import space_group, upsample_rows
from crop2seg_tpu_torch.utils.profiling import span


def _resample_attn(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, K, h_a, w_a) -> (N, K, h, w): bilinear with half-pixel centres
    (align_corners=False) when upsampling (``nn/layers.py::upsample_rows``,
    which halos inside ``space_shards``), average pooling with kernel
    w_a // w when downsampling. Inside ``space_shards`` h_a and h are this
    rank's rows, and the pooling needs h_a = k * h."""
    ha, wa = a.shape[-2:]
    if (h, w) == (ha, wa):
        return a
    if h > ha:
        return upsample_rows(a, h, w)
    k = wa // w
    if space_group() is not None and ha != k * h:
        raise ValueError(f"space shards of {ha} attention rows do not pool by {k} "
                         f"into {h} rows")
    return F.avg_pool2d(a, kernel_size=k, stride=k)


def _weighted_sum(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_t a[:, t] * x[:, t] in fp32. a (B, T, H, W, K), x (B, T, H, W, K,
    C/K); returns (B, H, W, K, C/K) fp32."""
    out = torch.zeros(x.shape[:1] + x.shape[2:], dtype=torch.float32,
                      device=x.device)
    for t in range(x.shape[1]):
        out += a[:, t, ..., None].float() * x[:, t]
    return out


def temporal_aggregate(x: torch.Tensor, attn: torch.Tensor | None = None,
                       pad_mask: torch.Tensor | None = None,
                       mode: str = "att_group") -> torch.Tensor:
    """Collapse (B, T, H, W, C) skips to (B, H, W, C).

    attn: (B, h_a, w_a, head, T) attention masks from the L-TAE; pad_mask:
    (B, T) bool, True at padded dates. The call is the span ``aggregate``."""
    with span("aggregate"):
        b, t, h, w, c = x.shape
        valid = None if pad_mask is None else (~pad_mask).to(x.dtype)
        with torch.autocast(x.device.type, enabled=False):
            if mode in ("att_group", "att_mean"):
                a = attn if mode == "att_group" else attn.mean(dim=3, keepdim=True)
                k = a.shape[3]
                a = a.permute(0, 4, 3, 1, 2).to(x.dtype)          # (B, T, K, ha, wa)
                a = _resample_attn(a.reshape((b * t, k) + a.shape[3:]), h, w)
                a = a.reshape(b, t, k, h, w).permute(0, 1, 3, 4, 2)  # (B, T, H, W, K)
                if valid is not None:
                    a = a * valid[:, :, None, None, None]
                out = _weighted_sum(a, x.reshape(b, t, h, w, k, c // k))
                return out.reshape(b, h, w, c).to(x.dtype)
            if mode == "mean":
                if valid is None:
                    return x.mean(dim=1)
                num = _weighted_sum(valid[:, :, None, None, None].expand(b, t, h, w, 1),
                                    x[..., None, :])
                den = valid.float().sum(dim=1)[:, None, None, None, None]
                return (num / den).reshape(b, h, w, c).to(x.dtype)
        raise ValueError(f"unknown aggregation mode {mode!r}")
