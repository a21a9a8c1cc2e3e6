"""MLP-Mixer over temporal tokens (port of crop2seg_tpu/models/mlp_mixer.py),
which no model of the factory uses: per pixel row (N, T, C), a token-mixing
MLP over T and a channel-mixing MLP over C, each after a LayerNorm (eps
1e-6) and with a residual; exact-erf GELU; no trailing norm. Module names
follow the reference's state dict (``layers.{i}.norm1``, ``token_mixer.0`` /
``.3``, ``norm2``, ``channel_mixer.0`` / ``.3``)."""
from __future__ import annotations

import torch
from torch import nn


def _mlp(d_in: int, d_hidden: int) -> nn.Sequential:
    """Linear -> GELU -> Dropout(0) -> Linear -> Dropout(0) (the Linears at
    indices 0 and 3, as in the reference)."""
    return nn.Sequential(nn.Linear(d_in, d_hidden), nn.GELU(), nn.Dropout(0.0),
                         nn.Linear(d_hidden, d_in), nn.Dropout(0.0))


class MLPMixerLayer(nn.Module):
    def __init__(self, num_tokens: int, hidden_dim: int, token_mlp_dim: int,
                 channel_mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.token_mixer = _mlp(num_tokens, token_mlp_dim)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.channel_mixer = _mlp(hidden_dim, channel_mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, T, C) -> (N, T, C)."""
        x = x + self.token_mixer(self.norm1(x).transpose(-1, -2)).transpose(-1, -2)
        return x + self.channel_mixer(self.norm2(x))


class MLPMixer(nn.Module):
    def __init__(self, num_tokens: int, hidden_dim: int, num_layers: int = 4,
                 token_mlp_dim: int = 64, channel_mlp_dim: int = 256):
        super().__init__()
        self.layers = nn.Sequential(*(
            MLPMixerLayer(num_tokens, hidden_dim, token_mlp_dim, channel_mlp_dim)
            for _ in range(num_layers)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)
