"""ConvLSTM recurrent baselines (port of crop2seg_tpu/models/convlstm.py:23-138).

The JAX package scans one cell over T (``nn.scan``); here the cell runs in a
loop over T. As in the JAX package and the reference, ``ConvLSTMSeg``
classifies the cell state after all T frames, pad frames included (so its
output depends on what the pad frames hold), and ``BConvLSTMSeg`` the
forward and backward final cell states, the reversed stream's leading pad
frames zeroed. ``last_valid_output`` gathers each sample's hidden state at
its last valid step.
"""
from __future__ import annotations

import torch
from torch import nn

from crop2seg_tpu_torch.nn.layers import Conv2d
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_input


class ConvLSTMCell(nn.Module):
    """One step: gates = conv([x, h]) (k x k, zero padding) split i, f, o,
    g; c' = sigmoid(f) c + sigmoid(i) tanh(g), h' = sigmoid(o) tanh(c')."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim, kernel_size,
                           padding=kernel_size // 2, bias=bias)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        i, f, o, g = self.conv(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class ConvLSTM(nn.Module):
    """x (B, T, H, W, C) -> (outputs (B, T, H, W, hidden) or None without
    ``keep_outputs``, (h_T, c_T)); the cell is ``cell_list.0``, the
    reference's name."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3):
        super().__init__()
        self.cell_list = nn.ModuleList([ConvLSTMCell(input_dim, hidden_dim, kernel_size)])

    def forward(self, x: torch.Tensor, keep_outputs: bool = True):
        b, t, hh, ww, _ = x.shape
        cell = self.cell_list[0]
        h = c = x.new_zeros(b, hh, ww, cell.hidden_dim)
        outputs = []
        for step in range(t):
            h, c = cell(x[:, step], h, c)
            if keep_outputs:
                outputs.append(h)
        return (torch.stack(outputs, dim=1) if keep_outputs else None), (h, c)


def last_valid_output(outputs: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C), (B, T) -> (B, H, W, C): each sample's output at its
    last valid step."""
    last = (~pad_mask).sum(dim=1) - 1
    return outputs[torch.arange(outputs.shape[0], device=outputs.device), last]


class BConvLSTM(nn.Module):
    """Bidirectional ConvLSTM: the forward and backward streams' final cell
    states concatenated (B, H, W, 2 * hidden); the reversed stream's
    leading pad frames are zeroed."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3):
        super().__init__()
        self.convlstm_forward = ConvLSTM(input_dim, hidden_dim, kernel_size)
        self.convlstm_backward = ConvLSTM(input_dim, hidden_dim, kernel_size)

    def encode(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None):
        _, (_, c_fwd) = self.convlstm_forward(x, keep_outputs=False)
        x_rev = torch.flip(x, dims=(1,))
        if pad_mask is not None:
            keep = (~torch.flip(pad_mask, dims=(1,))).to(x.dtype)
            x_rev = x_rev * keep[:, :, None, None, None]
        _, (_, c_bwd) = self.convlstm_backward(x_rev, keep_outputs=False)
        return torch.cat([c_fwd, c_bwd], dim=-1)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None):
        return self.encode(x, pad_mask)


# space shards (parallel/mesh.py::shard_batch_2d) of any height: every conv
# is a zero-padded k x k at full resolution, with a row to send
SPACE_ROWS = (1, 1)


def _classifier(d_in: int, num_classes: int, kernel_size: int) -> Conv2d:
    return Conv2d(d_in, num_classes, kernel_size, padding=1)


class ConvLSTMSeg(nn.Module):
    """ConvLSTM_Seg: the final cell state through a k x k conv classifier.
    x (B, T, H, W, C) -> logits (B, H, W, K)."""

    def __init__(self, num_classes: int, input_dim: int = 10, hidden_dim: int = 160,
                 kernel_size: int = 3, pad_value: float = 0.0):
        super().__init__()
        self.convlstm_encoder = ConvLSTM(input_dim, hidden_dim, kernel_size)
        self.classification_layer = _classifier(hidden_dim, num_classes, kernel_size)
        self.space_rows = SPACE_ROWS

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None, *,
                generator=None):
        _, (_, c_t) = self.convlstm_encoder(x, keep_outputs=False)
        return self.classification_layer(c_t)


class BConvLSTMSeg(BConvLSTM):
    """BConvLSTM_Seg: both directions' final cell states through the
    classifier. x (B, T, H, W, C) -> logits (B, H, W, K)."""

    def __init__(self, num_classes: int, input_dim: int = 10, hidden_dim: int = 160,
                 kernel_size: int = 3, pad_value: float = 0.0):
        super().__init__(input_dim, hidden_dim, kernel_size)
        self.pad_value = pad_value
        self.classification_layer = _classifier(2 * hidden_dim, num_classes, kernel_size)
        self.space_rows = SPACE_ROWS

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None, *,
                generator=None):
        if pad_mask is None:
            pad_mask = pad_mask_from_input(x, self.pad_value)
        return self.classification_layer(self.encode(x, pad_mask))
