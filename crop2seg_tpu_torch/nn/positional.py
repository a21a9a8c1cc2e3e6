"""Date positional encoders (port of crop2seg_tpu/nn/positional.py).

- ``PositionalEncoder``: interleaved sin/cos table over day offsets with
  period T, optionally followed by a learned Linear ``fc``.
- ``AbsolutePositionalEncoder``: Linear(one_hot(day-of-year, 365)), computed
  as a gather of the Linear's weight columns.

Both tile the per-head table ``repeat`` times along channels to span d_model.
"""
from __future__ import annotations

import torch
from torch import nn


def sinusoid_table(positions: torch.Tensor, d: int, period: float = 1000.0,
                   offset: int = 0, dtype=torch.float32) -> torch.Tensor:
    """positions (..., T) -> table (..., T, d) with sin at even dims, cos at odd."""
    i = torch.arange(offset, offset + d, device=positions.device)
    denom = torch.pow(torch.tensor(period, dtype=torch.float32,
                                   device=positions.device),
                      (2 * (i // 2)).to(torch.float32) / d)
    angles = positions[..., None].to(torch.float32) / denom
    table = torch.where(i % 2 == 0, torch.sin(angles), torch.cos(angles))
    return table.to(dtype)


def _tile(table: torch.Tensor, repeat: int | None) -> torch.Tensor:
    return table if repeat is None else table.repeat(
        (1,) * (table.dim() - 1) + (repeat,))


class PositionalEncoder(nn.Module):
    """Sinusoidal encoder over relative day offsets."""

    def __init__(self, d_model: int, T: float = 1000.0,
                 repeat: int | None = None, offset: int = 0,
                 add_linear: bool = False):
        super().__init__()
        self.d_model, self.T, self.repeat, self.offset = d_model, T, repeat, offset
        width = d_model * (repeat or 1)
        self.fc = nn.Linear(width, width) if add_linear else None

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        table = _tile(sinusoid_table(positions, self.d_model, self.T,
                                     self.offset), self.repeat)
        return table if self.fc is None else self.fc(table)


class AbsolutePositionalEncoder(nn.Module):
    """Learned day-of-year embedding: ``fc.weight[:, doy] + fc.bias``.
    Days outside [0, 365) contribute only the bias (one-hot of zeros)."""

    def __init__(self, d_model: int, repeat: int | None = None):
        super().__init__()
        self.d_model, self.repeat = d_model, repeat
        self.fc = nn.Linear(365, d_model)

    def forward(self, doy: torch.Tensor) -> torch.Tensor:
        idx = doy.to(torch.long)
        in_range = ((idx >= 0) & (idx < 365))[..., None]
        rows = self.fc.weight.t()[idx.clamp(0, 364)]
        emb = torch.where(in_range, rows, torch.zeros_like(rows)) + self.fc.bias
        return _tile(emb, self.repeat)
