"""Model factory (port of crop2seg_tpu/models/factory.py:21-116): every
name the JAX package builds (U-TAE, W-TAE, TimeUNet_v1 and _v2, UNet3D,
ConvLSTM, ConvGRU, the RecUNet ``uconvlstm`` and U-Net naive), with its
config keys and defaults."""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
from torch import nn

from crop2seg_tpu_torch.device import resolve_device
from crop2seg_tpu_torch.nn.ltae import MaskedLightweightAttention
from crop2seg_tpu_torch.nn.tae2d import TAE2d

ZOO = ("timeunet_v2", "unet3d", "convlstm", "convgru", "uconvlstm", "unet_naive")
MODELS = ("utae", "wtae", "timeunet", "timeunet_v1") + ZOO


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every weight from ``generator`` with PyTorch's default schemes
    (Kaiming-uniform conv/linear weights, 1-D, 2-D and 3-D and transposed,
    the depthwise convs' and the bias-free squeeze-excitation Linears'
    included, uniform(+-1/sqrt(fan_in)) biases), the attention's
    normal(sqrt(2/d_k)) query and key weights and TAE2d's N(0, 1) cls
    tokens; norms (GroupNorm, BatchNorm, LayerNorm) keep their identity
    initialization."""
    convs = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d,
             nn.Linear)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, convs):
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
            elif isinstance(m, TAE2d) and m.use_cls:
                nn.init.normal_(m.cls_token, generator=generator)
    return model


def resolve_use_pallas(value, device) -> bool:
    """A kernel flag as the JAX CLI's ``resolve_use_pallas`` reads it
    (train.py:269-281): True / "true" / "1" on, False / None / "false" /
    "0" / "none" off, "auto" on for a CUDA ``device`` and off for the CPU."""
    if isinstance(value, bool):
        return value
    val = str(value).lower()
    if val in ("true", "1"):
        return True
    if val in ("false", "0", "none"):
        return False
    if val != "auto":
        raise ValueError(f"a kernel flag is a bool, 'auto', 'true' or 'false', not {value!r}")
    return torch.device(device).type == "cuda"


def get_model(config: Mapping[str, Any] | Any, device=None,
              generator: torch.Generator | None = None) -> nn.Module:
    """Build the model named by ``config['model']`` (a dict or namespace
    with the reference train.py flag names) on ``device`` (default: the CUDA
    card), in eval mode. ``generator`` draws the weights (default: PyTorch's
    global RNG). ``use_pallas`` (U-TAE, TimeUNet) and ``use_pallas_train``
    (TimeUNet) choose the L-TAE's routes as crop2seg_tpu/models/factory.py:52,
    :66-67 pass them (``nn/ltae.py::LTAE.route``). Both default to True here,
    where the JAX factory's default is False: the port's serving and
    training paths stay on the kernels on the card unless the caller turns
    them off (the JAX callers that serve pass ``use_pallas=True``
    themselves; the train CLI passes both flags as the JAX CLI does). A
    string flag ("auto", "true", "false", as in a conf.json) is resolved by
    ``resolve_use_pallas`` on ``device``. U-TAE and W-TAE take ``remat`` and
    ``remat_policy``, which act in training: "conv_out" by default (save each
    convolution's output, recompute the norm and ReLU tails, as
    crop2seg_tpu/models/factory.py:8-18 picks) or "full"; the model raises
    on any other string. ``conv_type`` ("2d" or "depthwise_separable") and
    ``add_squeeze`` go to every model, ``use_mbconv`` to U-TAE and W-TAE.
    TimeUNet takes ``remat`` (the down and up blocks
    and out_conv recomputed whole; in_conv, which the JAX TimeUNet's remat
    also recomputes, is not: on the card ``remat`` does not lower a
    TimeUNet step's peak memory, see models/timeunet.py) and ``seq_chunk``
    (its L-TAE streamed over T where no kernel route takes it, see
    models/timeunet.py).
    The models take ``num_queries=1`` only; the ``LTAE`` module takes
    more. TimeUNet_v2 takes the common keys but ``num_queries``,
    ``use_doy`` and ``add_linear`` (the JAX ``common_v2``); UNet3D,
    ConvLSTM, ConvGRU and ``uconvlstm`` (RecUNet, "lstm") take
    ``num_classes`` (default 15), ``input_dim`` and ``pad_value`` at their
    fixed widths, ``uconvlstm`` the head's class count from ``out_conv``'s
    last entry where it is set; ``unet_naive`` needs ``max_temp``, the T its
    batches are padded to (the train CLI's ``--max_temp``)."""
    cfg = config if isinstance(config, Mapping) else vars(config)
    name = cfg["model"]
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}")
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
        conv_type=cfg.get("conv_type", "2d"),
        add_squeeze_excit=cfg.get("add_squeeze", False),
        use_abs_rel_enc=cfg.get("use_abs_rel_enc", False),
        num_queries=cfg.get("num_queries", 1),
        use_doy=cfg.get("use_doy", False),
        add_linear=cfg.get("add_linear", False),
    )
    use_pallas = resolve_use_pallas(cfg.get("use_pallas", True), dev)
    if name in ("utae", "wtae"):
        kw = dict(agg_mode=cfg.get("agg_mode", "att_group"),
                  use_mbconv=cfg.get("use_mbconv", False),
                  add_boundary_loss=cfg.get("add_boundary_loss", False),
                  remat=cfg.get("remat", False),
                  remat_policy=cfg.get("remat_policy", "conv_out"), **common)
        if name == "utae":
            from crop2seg_tpu_torch.models.utae import UTAE
            model = UTAE(use_pallas=use_pallas, **kw)
        else:
            from crop2seg_tpu_torch.models.wtae import WTAE
            model = WTAE(**kw)
    elif name in ("timeunet", "timeunet_v1"):
        from crop2seg_tpu_torch.models.timeunet import TimeUNet
        model = TimeUNet(
            remat=cfg.get("remat", False), seq_chunk=cfg.get("seq_chunk"),
            use_pallas=use_pallas,
            use_pallas_train=resolve_use_pallas(cfg.get("use_pallas_train", True), dev),
            **common)
    else:
        model = _zoo_model(name, cfg, common)
    if generator is not None:
        init_weights(model, generator)
    return model.to(dev).eval()


def _zoo_model(name: str, cfg: Mapping[str, Any], common: dict) -> nn.Module:
    """TimeUNet_v2 and the baselines, as crop2seg_tpu/models/factory.py:67-115
    builds them."""
    k = cfg.get("num_classes", 15)
    pad_value = cfg.get("pad_value", 0.0)
    if name == "timeunet_v2":
        from crop2seg_tpu_torch.models.timeunet_v2 import TimeUNetV2
        common_v2 = {key: v for key, v in common.items()
                     if key not in ("num_queries", "use_doy", "add_linear")}
        return TimeUNetV2(agg_mode=cfg.get("agg_mode", "att_group"), **common_v2)
    if name == "unet3d":
        from crop2seg_tpu_torch.models.unet3d import UNet3D
        return UNet3D(n_classes=k, in_channel=common["input_dim"], pad_value=pad_value)
    if name == "convlstm":
        from crop2seg_tpu_torch.models.convlstm import ConvLSTMSeg
        return ConvLSTMSeg(num_classes=k, input_dim=common["input_dim"], hidden_dim=160,
                           kernel_size=3, pad_value=pad_value)
    if name == "convgru":
        from crop2seg_tpu_torch.models.convgru import ConvGRUSeg
        return ConvGRUSeg(num_classes=k, input_dim=common["input_dim"], hidden_dim=180,
                          kernel_size=3, pad_value=pad_value)
    if name == "uconvlstm":
        from crop2seg_tpu_torch.models.recunet import RecUNet
        out_k = k if cfg.get("out_conv") is None else tuple(cfg["out_conv"])[-1]
        return RecUNet(input_dim=common["input_dim"], encoder_widths=(64, 64, 64, 128),
                       decoder_widths=(32, 32, 64, 128), out_conv=(32, out_k),
                       temporal="lstm", hidden_dim=64, encoder_norm="group",
                       padding_mode="zeros", pad_value=0.0)
    from crop2seg_tpu_torch.models.unet import UnetNaive
    if cfg.get("max_temp") is None:
        raise ValueError("unet_naive requires max_temp (the train CLI's --max_temp), "
                         "the T its batches are padded to")
    return UnetNaive(input_dim=common["input_dim"], temporal_length=cfg["max_temp"],
                     out_conv=tuple(cfg.get("out_conv", (32, 15))), pad_value=pad_value)
