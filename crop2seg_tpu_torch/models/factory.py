"""Model factory (port of crop2seg_tpu/models/factory.py:21-69): U-TAE and
TimeUNet_v1, with the JAX package's config keys and defaults."""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
from torch import nn

from crop2seg_tpu_torch.device import resolve_device
from crop2seg_tpu_torch.nn.ltae import MaskedLightweightAttention


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every weight from ``generator`` with PyTorch's default schemes
    (Kaiming-uniform conv/linear weights, uniform(+-1/sqrt(fan_in)) biases)
    and the attention's normal(sqrt(2/d_k)) query and key weights; norms
    keep their identity initialization."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                if m.bias is not None:
                    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                    bound = 1.0 / math.sqrt(fan_in)
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        for m in model.modules():
            if isinstance(m, MaskedLightweightAttention):
                std = math.sqrt(2.0 / m.d_k)
                nn.init.normal_(m.Q, std=std, generator=generator)
                nn.init.normal_(m.fc1_k.weight, std=std, generator=generator)
    return model


def get_model(config: Mapping[str, Any] | Any, device=None,
              generator: torch.Generator | None = None) -> nn.Module:
    """Build the model named by ``config['model']`` (a dict or namespace
    with the reference train.py flag names) on ``device`` (default: the CUDA
    card), in eval mode. ``generator`` draws the weights (default: PyTorch's
    global RNG). ``use_pallas`` is accepted for config parity: on the card the
    fused kernel is the only eval path. U-TAE takes ``remat`` and
    ``remat_policy``, which act in training: "conv_out" by default (save each
    convolution's output, recompute the norm and ReLU tails, as
    crop2seg_tpu/models/factory.py:8-18 picks) or "full"; the model raises
    on any other string. TimeUNet takes ``remat`` (the down and up blocks
    and out_conv recomputed whole; in_conv, which the JAX TimeUNet's remat
    also recomputes, is not: on the card ``remat`` does not lower a
    TimeUNet step's peak memory, see models/timeunet.py);
    ``seq_chunk`` raises (not ported).
    Both models take ``num_queries=1`` only; the ``LTAE`` module takes
    more."""
    cfg = config if isinstance(config, Mapping) else vars(config)
    name = cfg["model"]
    if name not in ("utae", "timeunet", "timeunet_v1"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet: crop2seg_tpu_torch has "
            "U-TAE and TimeUNet_v1 only (ROADMAP.md lists the rest of the zoo)")
    if cfg.get("conv_type", "2d") != "2d" or cfg.get("add_squeeze", False):
        raise NotImplementedError(
            "conv_type != '2d' and add_squeeze are not ported yet (ROADMAP.md "
            "item M6)")
    if cfg.get("seq_chunk") is not None:
        raise NotImplementedError(
            "seq_chunk (the L-TAE streamed over T) is not ported yet "
            "(ROADMAP.md item M7); on the card the kernel pair keeps the "
            "embed out of memory without it")
    dev = resolve_device(device)
    common = dict(
        input_dim=cfg.get("input_dim", 10),
        encoder_widths=tuple(cfg.get("encoder_widths", (64, 64, 64, 128))),
        decoder_widths=tuple(cfg.get("decoder_widths", (32, 32, 64, 128))),
        out_conv=tuple(cfg.get("out_conv", (32, 15))),
        str_conv_k=cfg.get("str_conv_k", 4),
        str_conv_s=cfg.get("str_conv_s", 2),
        str_conv_p=cfg.get("str_conv_p", 1),
        encoder_norm=cfg.get("encoder_norm", "group"),
        n_head=cfg.get("n_head", 16),
        d_model=cfg.get("d_model", 256),
        d_k=cfg.get("d_k", 4),
        pad_value=cfg.get("pad_value", 0.0),
        padding_mode=cfg.get("padding_mode", "reflect"),
        use_abs_rel_enc=cfg.get("use_abs_rel_enc", False),
        num_queries=cfg.get("num_queries", 1),
        use_doy=cfg.get("use_doy", False),
        add_linear=cfg.get("add_linear", False),
    )
    if name == "utae":
        from crop2seg_tpu_torch.models.utae import UTAE
        model = UTAE(agg_mode=cfg.get("agg_mode", "att_group"),
                     use_mbconv=cfg.get("use_mbconv", False),
                     add_boundary_loss=cfg.get("add_boundary_loss", False),
                     remat=cfg.get("remat", False),
                     remat_policy=cfg.get("remat_policy", "conv_out"), **common)
    else:
        from crop2seg_tpu_torch.models.timeunet import TimeUNet
        model = TimeUNet(remat=cfg.get("remat", False), **common)
    if generator is not None:
        init_weights(model, generator)
    return model.to(dev).eval()
