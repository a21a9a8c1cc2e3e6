"""ConvGRU recurrent baseline (port of crop2seg_tpu/models/convgru.py:16-75):
z, r = sigmoid(in_conv([x, h])), candidate = out_conv([x, r * h]),
h' = (1 - z) h + z tanh(candidate), the cell run in a loop over T; the
classifier takes the final hidden state (after the pad frames too, as in
the JAX package and the reference).

In fp32 the candidate's conv runs forward on PyTorch's own convolution,
cuDNN off: on the H100 cuDNN's fp32 kernels take ~380 ms for the
factory's 190 -> 180 3x3 conv at 4 x 128^2 frames, PyTorch's 1.4 ms
(PERF.md §5, ``scripts/bench_zoo_convs_torch.py``). Its backward, fast on
cuDNN (3.9 ms), stays there, and so does every bf16 conv."""
from __future__ import annotations

import torch
from torch import nn

from crop2seg_tpu_torch.models.convlstm import SPACE_ROWS
from crop2seg_tpu_torch.nn.layers import Conv2d


class ConvGRUCell(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        pad = kernel_size // 2
        self.in_conv = Conv2d(input_dim + hidden_dim, 2 * hidden_dim, kernel_size,
                              padding=pad, bias=bias)
        self.out_conv = Conv2d(input_dim + hidden_dim, hidden_dim, kernel_size,
                               padding=pad, bias=bias)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        z, r = torch.sigmoid(self.in_conv(torch.cat([x, h], dim=-1))).chunk(2, dim=-1)
        xr = torch.cat([x, r * h], dim=-1)
        if xr.dtype == torch.float32 and not torch.is_autocast_enabled(xr.device.type):
            with torch.backends.cudnn.flags(enabled=False):
                cand = self.out_conv(xr)
        else:
            cand = self.out_conv(xr)
        return (1 - z) * h + z * torch.tanh(cand)


class ConvGRU(nn.Module):
    """x (B, T, H, W, C) -> (outputs (B, T, H, W, hidden) or None without
    ``keep_outputs``, h_T); the cell is ``cell_list.0``."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell_list = nn.ModuleList([ConvGRUCell(input_dim, hidden_dim, kernel_size)])

    def forward(self, x: torch.Tensor, keep_outputs: bool = True):
        b, t, hh, ww, _ = x.shape
        h = x.new_zeros(b, hh, ww, self.hidden_dim)
        outputs = []
        for step in range(t):
            h = self.cell_list[0](x[:, step], h)
            if keep_outputs:
                outputs.append(h)
        return (torch.stack(outputs, dim=1) if keep_outputs else None), h


class ConvGRUSeg(nn.Module):
    """ConvGRU_Seg: x (B, T, H, W, C) -> logits (B, H, W, K)."""

    def __init__(self, num_classes: int, input_dim: int = 10, hidden_dim: int = 180,
                 kernel_size: int = 3, pad_value: float = 0.0):
        super().__init__()
        self.convgru_encoder = ConvGRU(input_dim, hidden_dim, kernel_size)
        self.classification_layer = Conv2d(hidden_dim, num_classes, kernel_size, padding=1)
        self.space_rows = SPACE_ROWS

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None, *,
                generator=None):
        _, h_t = self.convgru_encoder(x, keep_outputs=False)
        return self.classification_layer(h_t)
