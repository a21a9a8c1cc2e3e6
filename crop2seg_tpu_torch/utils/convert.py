"""Weights converter: the JAX package's flax variables of every model of
its factory (U-TAE, TimeUNet, W-TAE, TimeUNet_v2 and its TAE2d, the U-Nets,
the recurrent models, UNet3D) and of the modules no factory model uses
(the 3-D blocks, UNetEx, MLPMixer) -> the port's state dict (the inverse of
crop2seg_tpu/utils/torch_convert.py: the plain, depthwise-separable,
squeeze-excitation and MBConv blocks included). Leaves arrive as numpy
arrays; the result loads with the models' ``load_state_dict``.

    flax conv kernel   (kh, kw, I, O)              -> torch (O, I, kh, kw)
    flax conv-transpose forward HWIO, pre-flipped  -> torch (I, O, kh, kw)
    flax 3-D conv      (kd, kh, kw, I, O)          -> torch (O, I, kd, kh, kw)
    UNet3D's transposed conv, forward DHWIO, flipped -> torch (I, O, kd, kh, kw)
    flax Dense         (I, O)                      -> torch Linear (O, I)
    flax Dense C->D    (I, O)                      -> torch Conv1d (O, I, 1)
    flax depthwise     (kh, kw, 1, C)              -> torch (C, 1, kh, kw)
    flax scale / bias / mean / var                 -> weight / bias /
                                                      running_mean / running_var
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def conv2d_weight(k: np.ndarray) -> np.ndarray:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return np.transpose(k, (3, 2, 0, 1))


def conv_transpose2d_weight(k: np.ndarray) -> np.ndarray:
    """Forward-conv HWIO K[h, w, i, o] = W[i, o, kh-1-h, kw-1-w] -> W."""
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def linear_weight(k: np.ndarray) -> np.ndarray:
    """flax Dense (I, O) -> torch Linear (O, I)."""
    return np.transpose(k)


def _j(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _norm(sd, prefix, params, stats=None):
    sd[_j(prefix, "weight")] = params["scale"]
    sd[_j(prefix, "bias")] = params["bias"]
    if stats is not None:
        sd[_j(prefix, "running_mean")] = stats["mean"]
        sd[_j(prefix, "running_var")] = stats["var"]
        sd[_j(prefix, "num_batches_tracked")] = np.array(0, np.int64)


def _conv(sd, prefix, params):
    sd[_j(prefix, "weight")] = conv2d_weight(params["kernel"])
    if "bias" in params:
        sd[_j(prefix, "bias")] = params["bias"]


def _se(sd, prefix, params):
    """SqueezeAndExcitation: flax fc1 / fc2 -> ``{prefix}.sae.1`` / ``.3``."""
    sd[_j(prefix, "sae.1.weight")] = linear_weight(params["fc1"]["kernel"])
    sd[_j(prefix, "sae.3.weight")] = linear_weight(params["fc2"]["kernel"])


def _conv_layer(sd, prefix, params, stats, instance_norm=False):
    """ConvLayer: flax conv{i}/norm{i}[/se] -> torch Sequential
    ``{prefix}.conv``, its indices found by scanning the units as
    ``nn/layers.py::ConvLayer`` lays them out: conv, [norm], [ReLU], then the
    SE gate. Every unit but the last has a ReLU; the last one's
    (``last_relu``) comes after every index but the SE's, which the port
    builds with it. With a norm that is conv 3i, norm 3i+1; without one, conv
    2i. An instance norm (``instance_norm``) takes its index but has no flax
    parameters. A conv is a plain one (flax ``conv``) or depthwise-separable
    (``depthwise`` / ``pointwise``, neither with a bias)."""
    for key in params:
        if not re.fullmatch(r"(conv|norm)\d+|se", key):
            raise ValueError(f"unexpected ConvLayer entry {key!r}")
    idx = 0
    for i in range(sum(key.startswith("conv") for key in params)):
        conv, kp = params[f"conv{i}"], _j(prefix, f"conv.{idx}")
        if "depthwise" in conv:
            _conv(sd, _j(kp, "depthwise"), conv["depthwise"]["conv"])
            _conv(sd, _j(kp, "pointwise"), conv["pointwise"]["conv"])
        else:
            _conv(sd, kp, conv["conv"])
        idx += 1
        if f"norm{i}" in params:
            _norm(sd, _j(prefix, f"conv.{idx}"), params[f"norm{i}"],
                  stats.get(f"norm{i}"))
            idx += 1
        elif instance_norm:
            idx += 1
        idx += 1   # the unit's ReLU
    if "se" in params:
        _se(sd, _j(prefix, f"conv.{idx}"), params["se"])


def _mbconv_layer(sd, prefix, params, stats):
    """MBConvLayer: flax mbconv{j} -> the units at ``{prefix}.conv.{j}``,
    each's inner Sequential at ``.0.0.block`` (with the residual, d_in ==
    d_out) or ``.0.0.0``: 0 expand, 1 norm, 3 depthwise, 4 norm, 6 SE, 7
    project, 8 norm (crop2seg_tpu/utils/torch_convert.py:348-380)."""
    for j in range(len(params)):
        p, s = params[f"mbconv{j}"], stats.get(f"mbconv{j}", {})
        residual = p["expand"]["conv"]["kernel"].shape[2] == \
            p["project"]["conv"]["kernel"].shape[3]
        base = _j(prefix, f"conv.{j}.0.0." + ("block" if residual else "0"))
        _conv(sd, f"{base}.0", p["expand"]["conv"])
        _conv(sd, f"{base}.3", p["depthwise"]["conv"])
        _conv(sd, f"{base}.7", p["project"]["conv"])
        for name, idx in (("norm0", 1), ("norm1", 4), ("norm2", 8)):
            if name in p:
                _norm(sd, f"{base}.{idx}", p[name], s.get(name))
        _se(sd, f"{base}.6", p["se"])


def _layer(sd, prefix, params, stats, instance_norm=False):
    """A ConvLayer or, where the flax entries are mbconv{j}, an MBConvLayer."""
    if any(k.startswith("mbconv") for k in params):
        _mbconv_layer(sd, prefix, params, stats)
    else:
        _conv_layer(sd, prefix, params, stats, instance_norm)


def _ltae(sd, prefix, p, s):
    """LTAE, or LTAE4WTAE (no MLP and no out norm)."""
    sd[_j(prefix, "in_norm.weight")] = p["in_norm_scale"]
    sd[_j(prefix, "in_norm.bias")] = p["in_norm_bias"]
    sd[_j(prefix, "inconv.weight")] = linear_weight(p["inconv"]["kernel"])[:, :, None]
    sd[_j(prefix, "inconv.bias")] = p["inconv"]["bias"]
    att = p["attention"]
    sd[_j(prefix, "attention_head.Q")] = att["query"]
    sd[_j(prefix, "attention_head.fc1_k.weight")] = linear_weight(att["fc1_k"]["kernel"])
    sd[_j(prefix, "attention_head.fc1_k.bias")] = att["fc1_k"]["bias"]
    if "mlp_dense" in p:
        sd[_j(prefix, "mlp.0.weight")] = linear_weight(p["mlp_dense"]["kernel"])
        sd[_j(prefix, "mlp.0.bias")] = p["mlp_dense"]["bias"]
        _norm(sd, _j(prefix, "mlp.2"), p["mlp_bn"], s["mlp_bn"])
        sd[_j(prefix, "out_norm.weight")] = p["out_norm_scale"]
        sd[_j(prefix, "out_norm.bias")] = p["out_norm_bias"]
    _pe(sd, prefix, p)


def _pe(sd, prefix, p):
    """The positional encoders' learned parameters, where they have any."""
    pe = p.get("positional_encoder", {})
    if "fc" in pe:          # sinusoidal encoder with a learned Linear
        sd[_j(prefix, "positional_encoder.fc.weight")] = linear_weight(pe["fc"]["kernel"])
        sd[_j(prefix, "positional_encoder.fc.bias")] = pe["fc"]["bias"]
    for name in ("positional_encoder", "positional_encoder_abs"):
        emb = p.get(name, {})
        if "embedding" in emb:  # absolute day-of-year encoder
            sd[_j(prefix, f"{name}.fc.weight")] = linear_weight(emb["embedding"])
            sd[_j(prefix, f"{name}.fc.bias")] = emb["bias"]


def _dense(sd, prefix, params):
    """flax Dense -> torch Linear at ``prefix``."""
    sd[_j(prefix, "weight")] = linear_weight(params["kernel"])
    if "bias" in params:
        sd[_j(prefix, "bias")] = params["bias"]


def _tae2d(sd, prefix, p, s):
    """TAE2d (the inverse of crop2seg_tpu/utils/torch_convert.py:444-500):
    the classical stages ``attention_{i}`` -> ``attention_heads.{i}``, or
    the lightweight head ``attention`` -> ``attention_heads.0``; the cls
    tokens (nct, H, W, C) -> (nct, C, H, W) with the module's buffers
    (position -1, never padded); the cls merges (flax Dense nct -> 1) ->
    Conv1d(nct, 1, 1); the linear reductions -> index 1 of their
    Sequential(AdaptiveAvgPool1d(45), Linear(45, 1)); mlp.1 the BatchNorm."""
    sd[_j(prefix, "in_norm.weight")] = p["in_norm_scale"]
    sd[_j(prefix, "in_norm.bias")] = p["in_norm_bias"]
    if "inconv" in p:
        sd[_j(prefix, "inconv.weight")] = linear_weight(p["inconv"]["kernel"])[:, :, None]
        sd[_j(prefix, "inconv.bias")] = p["inconv"]["bias"]
    _pe(sd, prefix, p)
    if "cls_token" in p:
        cls = np.transpose(p["cls_token"], (0, 3, 1, 2))
        sd[_j(prefix, "cls_token")] = cls
        sd[_j(prefix, "cls_position")] = np.full(cls.shape[:1], -1.0, np.float32)
        sd[_j(prefix, "cls_pad_mask")] = np.zeros(cls.shape[:1], bool)
    for name in ("cls_emb_conv", "cls_attn_conv"):
        if name in p:
            sd[_j(prefix, f"{name}.weight")] = linear_weight(p[name]["kernel"])[:, :, None]
            sd[_j(prefix, f"{name}.bias")] = p[name]["bias"]
    for name, port in (("emb_reduce", "linear_embedding_reduction.1"),
                       ("attn_reduce", "linear_attention_mask_reduction.1")):
        if name in p:
            _dense(sd, _j(prefix, port), p[name])
    if "attention" in p:
        att = p["attention"]
        sd[_j(prefix, "attention_heads.0.Q")] = att["query"]
        _dense(sd, _j(prefix, "attention_heads.0.fc1_k"), att["fc1_k"])
    i = 0
    while f"attention_{i}" in p:
        att, ap = p[f"attention_{i}"], _j(prefix, f"attention_heads.{i}")
        for name in ("fc_q", "fc_k", "fc_v", "fc_out"):
            _dense(sd, f"{ap}.{name}", att[name])
        _norm(sd, f"{ap}.layer_norm", att["layer_norm"])
        i += 1
    _dense(sd, _j(prefix, "mlp.0"), p["mlp_dense"])
    _norm(sd, _j(prefix, "mlp.1"), p["mlp_bn"], s["mlp_bn"])
    sd[_j(prefix, "out_norm.weight")] = p["out_norm_scale"]
    sd[_j(prefix, "out_norm.bias")] = p["out_norm_bias"]


def _down_block(sd, prefix, p, s, instance_norm=False):
    """DownConvBlock or MBDownConvBlock, with DownConvBlock's trailing SE
    at ``sae``."""
    for name in ("down", "conv1", "conv2"):
        _layer(sd, _j(prefix, name), p[name], s.get(name, {}), instance_norm)
    if "se" in p:
        _se(sd, _j(prefix, "sae"), p["se"])


def _up_block(sd, prefix, p, s):
    """UpConvBlock or MBUpConvBlock, with UpConvBlock's trailing SE at
    ``sae``."""
    sd[_j(prefix, "up.0.weight")] = conv_transpose2d_weight(p["up_conv"]["kernel"])
    sd[_j(prefix, "up.0.bias")] = p["up_conv"]["bias"]
    _norm(sd, _j(prefix, "up.1"), p["up_norm"], s["up_norm"])
    _conv(sd, _j(prefix, "skip_conv.0"), p["skip_conv"]["conv"])
    _norm(sd, _j(prefix, "skip_conv.1"), p["skip_norm"], s["skip_norm"])
    for name in ("conv1", "conv2"):
        _layer(sd, _j(prefix, name), p[name], s.get(name, {}))
    if "se" in p:
        _se(sd, _j(prefix, "sae"), p["se"])


def _torch(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def _split(variables: Mapping):
    return variables["params"], variables.get("batch_stats", {})


def conv_block_state_dict_from_flax(variables: Mapping, norm: str = "batch"
                                    ) -> Dict[str, torch.Tensor]:
    """flax ConvBlock or MBConvBlock variables -> the port's state dict of
    the same block (``norm``: the block's, which says whether an instance
    norm holds an index)."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    _layer(sd, "conv", p["conv"], s.get("conv", {}), norm == "instance")
    return _torch(sd)


def down_block_state_dict_from_flax(variables: Mapping, norm: str = "batch"
                                    ) -> Dict[str, torch.Tensor]:
    """flax DownConvBlock or MBDownConvBlock variables -> the port's state
    dict of the same block."""
    sd: Dict[str, np.ndarray] = {}
    _down_block(sd, "", *_split(variables), norm == "instance")
    return _torch(sd)


def up_block_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax UpConvBlock or MBUpConvBlock variables -> the port's state dict
    of the same block."""
    sd: Dict[str, np.ndarray] = {}
    _up_block(sd, "", *_split(variables))
    return _torch(sd)


def ltae_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax LTAE or LTAE4WTAE variables -> the port's state dict of the same
    module."""
    sd: Dict[str, np.ndarray] = {}
    _ltae(sd, "", *_split(variables))
    return _torch(sd)


def _heads(sd, p, s):
    for head in ("out_conv", "boundary_conv"):
        if head in p:
            _layer(sd, f"{head}.conv", p[head]["conv"], s.get(head, {}).get("conv", {}))


def _unet(sd, p, s, instance_norm=False):
    """A U-Net's conv blocks: in_conv where there is one, ``down_{i}`` /
    ``up_{i}`` -> ``down_blocks.{i}`` / ``up_blocks.{i}``, and the heads."""
    if "in_conv" in p:
        _layer(sd, "in_conv.conv", p["in_conv"]["conv"],
               s.get("in_conv", {}).get("conv", {}), instance_norm)
    i = 0
    while f"down_{i}" in p:
        _down_block(sd, f"down_blocks.{i}", p[f"down_{i}"], s.get(f"down_{i}", {}),
                    instance_norm)
        _up_block(sd, f"up_blocks.{i}", p[f"up_{i}"], s[f"up_{i}"])
        i += 1
    _heads(sd, p, s)


def utae_state_dict_from_flax(variables: Mapping, encoder_norm: str = "group"
                              ) -> Dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` of crop2seg_tpu's U-TAE or TimeUNet
    (nested dicts of numpy arrays) -> the port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_utae, MBConv blocks
    included). The two models hold the same modules (U-TAE's aggregator has
    no parameters), and U-TAE may add the boundary head. ``encoder_norm``
    is the model's: with "instance" the encoder's norms hold indices without
    parameters."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    _unet(sd, p, s, encoder_norm == "instance")
    _ltae(sd, "temporal_encoder", p["temporal_encoder"],
          s.get("temporal_encoder", {}))
    return _torch(sd)


timeunet_state_dict_from_flax = utae_state_dict_from_flax


def wtae_state_dict_from_flax(variables: Mapping, encoder_norm: str = "group"
                              ) -> Dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` of crop2seg_tpu's W-TAE -> the
    port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_wtae; with ``use_mbconv``
    too, which that converter lacks): in_conv, ``spatial_reduction.{i}``,
    the attention-only ``temporal_encoder``, ``down_blocks.{i}``,
    ``up_blocks.{i}`` and the heads."""
    p, s = _split(variables)
    inst = encoder_norm == "instance"
    sd: Dict[str, np.ndarray] = {}
    _layer(sd, "in_conv.conv", p["in_conv"]["conv"],
           s.get("in_conv", {}).get("conv", {}), inst)
    i = 0
    while f"down_{i}" in p:
        _down_block(sd, f"spatial_reduction.{i}", p[f"spatial_reduction_{i}"],
                    s.get(f"spatial_reduction_{i}", {}), inst)
        _down_block(sd, f"down_blocks.{i}", p[f"down_{i}"], s.get(f"down_{i}", {}), inst)
        _up_block(sd, f"up_blocks.{i}", p[f"up_{i}"], s[f"up_{i}"])
        i += 1
    _ltae(sd, "temporal_encoder", p["temporal_encoder"], {})
    _heads(sd, p, s)
    return _torch(sd)


def tae2d_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax TAE2d variables (either attention type) -> the port's state dict
    of the same module."""
    sd: Dict[str, np.ndarray] = {}
    _tae2d(sd, "", *_split(variables))
    return _torch(sd)


TAE2D_NAMES = ("temporal_encoder_full_resolution", "temporal_encoder_low_resolution")


def timeunet_v2_state_dict_from_flax(variables: Mapping, encoder_norm: str = "group"
                                     ) -> Dict[str, torch.Tensor]:
    """flax TimeUNet_v2 variables -> the port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_timeunet_v2): the U-Net's
    blocks and the two TAE2d (``encoder_norm`` as for U-TAE)."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    _unet(sd, p, s, encoder_norm == "instance")
    for name in TAE2D_NAMES:
        _tae2d(sd, name, p[name], s.get(name, {}))
    return _torch(sd)


def unet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax Unet or UnetNaive variables -> the port's state dict (the
    inverse of crop2seg_tpu/utils/torch_convert.py::convert_unet_naive; the
    plain Unet has no in_conv)."""
    sd: Dict[str, np.ndarray] = {}
    _unet(sd, *_split(variables))
    return _torch(sd)


def _cell(sd, prefix, p):
    """A flax ConvLSTM's or ConvGRU's scanned ``cell`` (or a BConvLSTM's
    ``forward`` / ``backward``) -> ``{prefix}.cell_list.0`` (or
    ``{prefix}.convlstm_forward`` / ``_backward``)."""
    if "forward" in p:
        for d in ("forward", "backward"):
            _cell(sd, _j(prefix, f"convlstm_{d}"), p[d])
        return
    for name, conv in p["cell"].items():
        _conv(sd, _j(prefix, f"cell_list.0.{name}"), conv["conv"])


def convlstm_seg_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ConvLSTMSeg, BConvLSTMSeg or ConvGRUSeg variables -> the port's
    state dict (the inverse of convert_convlstm_seg, convert_bconvlstm_seg
    and convert_convgru_seg of crop2seg_tpu/utils/torch_convert.py): the
    encoder's cell at ``convlstm_encoder`` / ``convgru_encoder`` (the GRU's
    has ``in_conv`` and ``out_conv``), or the two directions at the top,
    and ``classification_layer``."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    enc = p["encoder"]
    gru = "forward" not in enc and "in_conv" in enc["cell"]
    _cell(sd, "" if "forward" in enc else
          ("convgru_encoder" if gru else "convlstm_encoder"), enc)
    _conv(sd, "classification_layer", p["classifier"]["conv"])
    return _torch(sd)


def recunet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax RecUNet variables -> the port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_recunet; "blstm"'s two
    directions under ``temporal_encoder.convlstm_forward`` / ``_backward``)."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    _unet(sd, p, s)
    if "temporal_encoder" in p:
        _cell(sd, "temporal_encoder", p["temporal_encoder"])
        _conv(sd, "out_convlstm", p["out_convlstm"]["conv"])
    return _torch(sd)


def conv3d_weight(k: np.ndarray) -> np.ndarray:
    """flax (kd, kh, kw, I, O) -> torch Conv3d (O, I, kd, kh, kw)."""
    return np.transpose(k, (4, 3, 0, 1, 2))


def conv_transpose3d_weight(k: np.ndarray) -> np.ndarray:
    """The JAX ``_deconv3d``'s forward-conv DHWIO kernel, spatially flipped
    against torch's -> torch ConvTranspose3d (I, O, kd, kh, kw), flipped back."""
    return np.transpose(k, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]


# UNet3D: the JAX names (conv ``{tag}_conv``, BatchNorm ``{tag}_bn``) -> the
# reference's Sequential indices
UNET3D_CONVS = tuple((f"{b}{ab}", f"{b}.{3 * i}", f"{b}.{3 * i + 1}")
                     for b in ("en3", "en4", "dc4", "dc3")
                     for i, ab in enumerate("ab")) + (
    ("center_in", "center_in.0", "center_in.1"),
    ("center_mid", "center_out.0", "center_out.1"))
UNET3D_DECONVS = (("center_out", "center_out.3", None), ("trans3", "trans3.0", "trans3.1"))


def unet3d_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax UNet3D variables -> the port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_unet3d: the transposed
    convs' kernels flipped back)."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    for tag, conv, bn in UNET3D_CONVS:
        sd[f"{conv}.weight"] = conv3d_weight(p[f"{tag}_conv"]["kernel"])
        sd[f"{conv}.bias"] = p[f"{tag}_conv"]["bias"]
        _norm(sd, bn, p[f"{tag}_bn"], s[f"{tag}_bn"])
    for tag, conv, bn in UNET3D_DECONVS:
        sd[f"{conv}.weight"] = conv_transpose3d_weight(p[f"{tag}_kernel"])
        sd[f"{conv}.bias"] = p[f"{tag}_bias"]
        if bn is not None:
            _norm(sd, bn, p[f"{tag}_bn"], s[f"{tag}_bn"])
    sd["final.weight"] = conv3d_weight(p["final"]["kernel"])
    sd["final.bias"] = p["final"]["bias"]
    return _torch(sd)


def _conv_layer3d(sd, prefix, params, stats, norm):
    """ConvLayer3D: flax conv{i}/norm{i} -> ``{prefix}.conv``, unit i at
    index i * 3 with a norm (an instance norm takes its index without
    parameters), i * 2 without: conv, [norm], ReLU."""
    per_unit = 3 if norm in ("batch", "group", "instance") else 2
    for i in range(sum(key.startswith("conv") for key in params)):
        idx = i * per_unit
        conv = params[f"conv{i}"]
        sd[_j(prefix, f"conv.{idx}.weight")] = conv3d_weight(conv["kernel"])
        sd[_j(prefix, f"conv.{idx}.bias")] = conv["bias"]
        if f"norm{i}" in params:
            _norm(sd, _j(prefix, f"conv.{idx + 1}"), params[f"norm{i}"],
                  stats.get(f"norm{i}"))


def blocks3d_state_dict_from_flax(variables: Mapping, norm: str = "batch"
                                  ) -> Dict[str, torch.Tensor]:
    """flax ConvLayer3D, ConvBlock3D, DownConvBlock3D or TemporalAggregator3D
    variables (crop2seg_tpu/nn/blocks3d.py) -> the port's state dict of the
    same module (``norm``: the blocks', which says whether a norm holds an
    index). The aggregator's transposed conv kernel is flipped back, as
    UNet3D's. An aggregator whose JAX module never upsampled has no
    ``up_deconv`` / ``up_conv`` parameters: load its state dict with
    ``strict=False``; one without parameters (no upsampling, or "mean")
    has no flax collections at all."""
    p, s = variables.get("params", {}), variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    if "conv0" in p:                                      # a ConvLayer3D
        _conv_layer3d(sd, "", p, s, norm)
    for name in ("conv", "down", "conv1", "conv2"):
        if name in p:
            _conv_layer3d(sd, name, p[name], s.get(name, {}), norm)
    for name, weight in (("up_deconv", conv_transpose3d_weight), ("up_conv", conv3d_weight)):
        if name in p:
            sd[f"{name}.weight"] = weight(p[name]["kernel"])
            sd[f"{name}.bias"] = p[name]["bias"]
    return _torch(sd)


def _convmodule_ex(sd, prefix, params, stats):
    """ConvModuleEx: the bias-free conv and its norm."""
    sd[f"{prefix}.conv.weight"] = conv2d_weight(params["conv"]["kernel"])
    if "norm" in params:
        _norm(sd, f"{prefix}.norm", params["norm"], stats.get("norm"))


def _basic_block_ex(sd, prefix, params, stats):
    for j in range(len(params)):
        _convmodule_ex(sd, f"{prefix}.convs.{j}", params[f"conv{j}"],
                       stats.get(f"conv{j}", {}))


def unet_ex_state_dict_from_flax(variables: Mapping, strides=(1, 1, 1, 1),
                                 downsamples=(True, True, True)
                                 ) -> Dict[str, torch.Tensor]:
    """flax UNetEx variables -> the port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_unet_ex, :538).
    ``strides`` and ``downsamples`` as the model was built with: they say
    which encoder stages open with a MaxPool (the block then sits at index
    1 of the stage's Sequential). A decoder upsamples with an InterpConv
    (``interp_upsample.1``) or, built with ``use_deconv``, a transposed
    conv (``deconv_upsamping``: the conv at 0, its norm at 1)."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    i = 0
    while f"encoder_{i}" in p:
        k = 1 if i and strides[i] == 1 and downsamples[i - 1] else 0
        _basic_block_ex(sd, f"encoder.{i}.{k}", p[f"encoder_{i}"],
                        s.get(f"encoder_{i}", {}))
        i += 1
    j = 0
    while f"decoder_{j}" in p:
        dp, ds = p[f"decoder_{j}"], s.get(f"decoder_{j}", {})
        _basic_block_ex(sd, f"decoder.{j}.conv_block", dp["conv_block"],
                        ds.get("conv_block", {}))
        up, us = dp["upsample"], ds.get("upsample", {})
        if "deconv" in up:
            base = f"decoder.{j}.upsample.deconv_upsamping"
            sd[f"{base}.0.weight"] = conv_transpose2d_weight(up["deconv"]["kernel"])
            sd[f"{base}.0.bias"] = up["deconv"]["bias"]
            if "norm" in up:
                _norm(sd, f"{base}.1", up["norm"], us.get("norm"))
        else:
            _convmodule_ex(sd, f"decoder.{j}.upsample.interp_upsample.1", up["conv"],
                           us.get("conv", {}))
        j += 1
    if "head" in p:
        sd["head.weight"] = conv2d_weight(p["head"]["kernel"])
        sd["head.bias"] = p["head"]["bias"]
    return _torch(sd)


# MLPMixerLayer: flax auto-named submodules -> the reference's names
MIXER_NORMS = (("LayerNorm_0", "norm1"), ("LayerNorm_1", "norm2"))
MIXER_DENSES = (("Dense_0", "token_mixer.0"), ("Dense_1", "token_mixer.3"),
                ("Dense_2", "channel_mixer.0"), ("Dense_3", "channel_mixer.3"))


def mlp_mixer_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax MLPMixer variables -> the port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_mlp_mixer, :565)."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    for i in range(len(p)):
        lp, base = p[f"layer_{i}"], f"layers.{i}"
        for flax, port in MIXER_NORMS:
            _norm(sd, f"{base}.{port}", lp[flax])
        for flax, port in MIXER_DENSES:
            sd[f"{base}.{port}.weight"] = linear_weight(lp[flax]["kernel"])
            sd[f"{base}.{port}.bias"] = lp[flax]["bias"]
    return _torch(sd)


def _se_paths(paths, port, flax) -> None:
    paths[f"{port}.sae.1.weight"] = f"{flax}/fc1/kernel"
    paths[f"{port}.sae.3.weight"] = f"{flax}/fc2/kernel"


def _conv_paths(paths, port, flax) -> None:
    for name in ("weight", "bias"):
        paths[f"{port}.{name}"] = f"{flax}/conv/" + ("kernel" if name == "weight" else name)


def _norm_paths(paths, port, flax) -> None:
    paths[f"{port}.weight"] = f"{flax}/scale"
    paths[f"{port}.bias"] = f"{flax}/bias"


def _mbconv_paths(paths, port, flax, layer) -> None:
    """An MBConvLayer's units -> flax mbconv{j}/expand, norm0, depthwise,
    norm1, se, project, norm2."""
    names = {0: "expand", 3: "depthwise", 7: "project"}
    for j, unit in enumerate(layer.conv):
        inner = unit[0][0]
        units, sub = ((inner.block, "0.0.block") if hasattr(inner, "block")
                      else (inner[0], "0.0.0"))
        for idx in range(len(units)):
            kp, fp = f"{port}.conv.{j}.{sub}.{idx}", f"{flax}/mbconv{j}"
            if idx in names:
                _conv_paths(paths, kp, f"{fp}/{names[idx]}")
            elif idx in (1, 4, 8):
                _norm_paths(paths, kp, f"{fp}/norm{(1, 4, 8).index(idx)}")
            elif idx == 6:
                _se_paths(paths, kp, f"{fp}/se")


def _layer_paths(paths, port, flax, layer) -> None:
    """A ConvLayer's units (conv, [norm], [ReLU], [SE]) -> flax conv{i}/conv
    (or conv{i}/depthwise/conv and conv{i}/pointwise/conv), norm{i} and se,
    the table of ``_conv_layer`` read the other way; an MBConvLayer's by
    ``_mbconv_paths``."""
    from crop2seg_tpu_torch.nn.layers import (
        DepthwiseSeparableConv2d, MBConvLayer, SqueezeAndExcitation)

    if isinstance(layer, MBConvLayer):
        _mbconv_paths(paths, port, flax, layer)
        return
    i = -1
    for idx, unit in enumerate(layer.conv):
        kp = f"{port}.conv.{idx}"
        if isinstance(unit, torch.nn.Conv2d):
            i += 1
            _conv_paths(paths, kp, f"{flax}/conv{i}")
        elif isinstance(unit, DepthwiseSeparableConv2d):
            i += 1
            for part in ("depthwise", "pointwise"):
                _conv_paths(paths, f"{kp}.{part}", f"{flax}/conv{i}/{part}")
        elif isinstance(unit, (torch.nn.GroupNorm, torch.nn.modules.batchnorm._BatchNorm)):
            _norm_paths(paths, kp, f"{flax}/norm{i}")
        elif isinstance(unit, SqueezeAndExcitation):
            _se_paths(paths, kp, f"{flax}/se")


def _block_paths(paths, port, flax, block) -> None:
    """A down or up block (plain or MBConv): its conv layers, the up
    block's up and skip paths, and a trailing SE."""
    if hasattr(block, "up"):
        for k, v in {"up.0.weight": "up_conv/kernel", "up.0.bias": "up_conv/bias",
                     "up.1.weight": "up_norm/scale", "up.1.bias": "up_norm/bias",
                     "skip_conv.0.weight": "skip_conv/conv/kernel",
                     "skip_conv.0.bias": "skip_conv/conv/bias",
                     "skip_conv.1.weight": "skip_norm/scale",
                     "skip_conv.1.bias": "skip_norm/bias"}.items():
            paths[f"{port}.{k}"] = f"{flax}/{v}"
    for name in ("down", "conv1", "conv2"):
        if hasattr(block, name):
            _layer_paths(paths, f"{port}.{name}", f"{flax}/{name}", getattr(block, name))
    if getattr(block, "sae", None) is not None:
        _se_paths(paths, f"{port}.sae", f"{flax}/se")


def _pe_paths(names, module) -> None:
    """The positional encoders' learned parameters of ``module``."""
    for name in ("positional_encoder", "positional_encoder_abs"):
        enc = getattr(module, name, None)
        if enc is None or getattr(enc, "fc", None) is None:
            continue
        if type(enc).__name__ == "AbsolutePositionalEncoder":
            names.update({f"{name}.fc.weight": f"{name}/embedding",
                          f"{name}.fc.bias": f"{name}/bias"})
        else:
            names.update({f"{name}.fc.weight": f"{name}/fc/kernel",
                          f"{name}.fc.bias": f"{name}/fc/bias"})


def _prefixed(paths, port, flax, names) -> None:
    for k, v in names.items():
        paths[f"{port}.{k}"] = f"{flax}/{v}"


def _dense_names(names, port, flax) -> None:
    names.update({f"{port}.weight": f"{flax}/kernel", f"{port}.bias": f"{flax}/bias"})


def _ltae_paths(paths, port, flax, ltae) -> None:
    names = {"in_norm.weight": "in_norm_scale", "in_norm.bias": "in_norm_bias",
             "inconv.weight": "inconv/kernel", "inconv.bias": "inconv/bias",
             "attention_head.Q": "attention/query",
             "attention_head.fc1_k.weight": "attention/fc1_k/kernel",
             "attention_head.fc1_k.bias": "attention/fc1_k/bias",
             "mlp.0.weight": "mlp_dense/kernel", "mlp.0.bias": "mlp_dense/bias",
             "mlp.2.weight": "mlp_bn/scale", "mlp.2.bias": "mlp_bn/bias",
             "out_norm.weight": "out_norm_scale", "out_norm.bias": "out_norm_bias"}
    _pe_paths(names, ltae)
    _prefixed(paths, port, flax, names)


def _tae2d_paths(paths, port, flax, tae) -> None:
    """A TAE2d's parameters, the table of ``_tae2d`` read the other way."""
    names = {"in_norm.weight": "in_norm_scale", "in_norm.bias": "in_norm_bias",
             "mlp.1.weight": "mlp_bn/scale", "mlp.1.bias": "mlp_bn/bias",
             "out_norm.weight": "out_norm_scale", "out_norm.bias": "out_norm_bias",
             "cls_token": "cls_token", "attention_heads.0.Q": "attention/query"}
    for port_name, flax_name in (("inconv", "inconv"), ("mlp.0", "mlp_dense"),
                                 ("cls_emb_conv", "cls_emb_conv"),
                                 ("cls_attn_conv", "cls_attn_conv"),
                                 ("linear_embedding_reduction.1", "emb_reduce"),
                                 ("linear_attention_mask_reduction.1", "attn_reduce"),
                                 ("attention_heads.0.fc1_k", "attention/fc1_k")):
        _dense_names(names, port_name, flax_name)
    for i in range(len(tae.attention_heads)):
        for part in ("fc_q", "fc_k", "fc_v", "fc_out"):
            _dense_names(names, f"attention_heads.{i}.{part}", f"attention_{i}/{part}")
        names.update({f"attention_heads.{i}.layer_norm.weight": f"attention_{i}/layer_norm/scale",
                      f"attention_heads.{i}.layer_norm.bias": f"attention_{i}/layer_norm/bias"})
    _pe_paths(names, tae)
    _prefixed(paths, port, flax, names)


def _cell_paths(paths, port, flax, encoder) -> None:
    """A ConvLSTM's, ConvGRU's or BConvLSTM's cell convs -> the flax scanned
    ``cell`` (``forward/cell``, ``backward/cell`` for the two directions)."""
    for name, m in encoder.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            rel = name.replace("convlstm_", "").replace("cell_list.0", "cell")
            _conv_paths(paths, f"{port}.{name}", f"{flax}/" + rel.replace(".", "/"))


def _unet3d_paths(paths) -> None:
    for tag, conv, bn in UNET3D_CONVS:
        _dense_names(paths, conv, f"{tag}_conv")
        _norm_paths(paths, bn, f"{tag}_bn")
    for tag, conv, bn in UNET3D_DECONVS:
        paths.update({f"{conv}.weight": f"{tag}_kernel", f"{conv}.bias": f"{tag}_bias"})
        if bn is not None:
            _norm_paths(paths, bn, f"{tag}_bn")
    _dense_names(paths, "final", "final")


def _fj(flax: str, name: str) -> str:
    return f"{flax}/{name}" if flax else name


def _layer3d_paths(paths, port, flax, layer) -> None:
    """A ConvLayer3D's units -> flax conv{i} (kernel, bias) and norm{i}."""
    i = -1
    for idx, unit in enumerate(layer.conv):
        kp = _j(port, f"conv.{idx}")
        if isinstance(unit, torch.nn.Conv3d):
            i += 1
            _dense_names(paths, kp, _fj(flax, f"conv{i}"))
        else:
            _norm_paths(paths, kp, _fj(flax, f"norm{i}"))


def _convmodule_ex_paths(paths, port, flax) -> None:
    paths[f"{port}.conv.weight"] = f"{flax}/conv/kernel"
    _norm_paths(paths, f"{port}.norm", f"{flax}/norm")


def _experimental_paths(paths, model) -> None:
    """The 3-D blocks, UNetEx and MLPMixer: the tables of their converters
    read the other way."""
    from crop2seg_tpu_torch.models.mlp_mixer import MLPMixer
    from crop2seg_tpu_torch.models.unet_ex import UNetEx
    from crop2seg_tpu_torch.nn import blocks3d

    if isinstance(model, blocks3d.ConvLayer3D):
        _layer3d_paths(paths, "", "", model)
    for name in ("conv", "down", "conv1", "conv2"):
        if isinstance(getattr(model, name, None), blocks3d.ConvLayer3D):
            _layer3d_paths(paths, name, name, getattr(model, name))
    if isinstance(model, blocks3d.TemporalAggregator3D) and model.mode != "mean":
        _dense_names(paths, "up_deconv", "up_deconv")
        _dense_names(paths, "up_conv", "up_conv")
    if isinstance(model, MLPMixer):
        for i in range(len(model.layers)):
            for flax, port in MIXER_NORMS:
                _norm_paths(paths, f"layers.{i}.{port}", f"layer_{i}/{flax}")
            for flax, port in MIXER_DENSES:
                _dense_names(paths, f"layers.{i}.{port}", f"layer_{i}/{flax}")
    if isinstance(model, UNetEx):
        for i, stage in enumerate(model.encoder):
            k = len(stage) - 1
            for j in range(len(stage[k].convs)):
                _convmodule_ex_paths(paths, f"encoder.{i}.{k}.convs.{j}",
                                     f"encoder_{i}/conv{j}")
        for j, dec in enumerate(model.decoder):
            for k in range(len(dec.conv_block.convs)):
                _convmodule_ex_paths(paths, f"decoder.{j}.conv_block.convs.{k}",
                                     f"decoder_{j}/conv_block/conv{k}")
            up, fup = f"decoder.{j}.upsample", f"decoder_{j}/upsample"
            _convmodule_ex_paths(paths, f"{up}.interp_upsample.1", f"{fup}/conv")
            _dense_names(paths, f"{up}.deconv_upsamping.0", f"{fup}/deconv")
            _norm_paths(paths, f"{up}.deconv_upsamping.1", f"{fup}/norm")
        _dense_names(paths, "head", "head")


def flax_param_paths(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter name of a model of the port's factory, or of a 3-D
    block, UNetEx or MLPMixer -> the slash-joined flax path of its
    counterpart in the JAX model's ``params``
    (``down_0/conv1/conv0/conv/kernel``, ``temporal_encoder/attention/query``,
    ``encoder/cell/conv/conv/kernel``, ...): the tables of the converters
    above read the other way. Raises if a parameter has no counterpart."""
    from crop2seg_tpu_torch.nn.ltae import LTAE, LTAE4WTAE

    paths: Dict[str, str] = {}
    _experimental_paths(paths, model)
    if getattr(model, "in_conv", None) is not None:
        _layer_paths(paths, "in_conv.conv", "in_conv/conv", model.in_conv.conv)
    for attr, flax in (("spatial_reduction", "spatial_reduction"),
                       ("down_blocks", "down"), ("up_blocks", "up")):
        for i, block in enumerate(getattr(model, attr, ())):
            _block_paths(paths, f"{attr}.{i}", f"{flax}_{i}", block)
    te = getattr(model, "temporal_encoder", None)
    if isinstance(te, (LTAE, LTAE4WTAE)):
        _ltae_paths(paths, "temporal_encoder", "temporal_encoder", te)
    elif te is not None:                                  # RecUNet's recurrent one
        _cell_paths(paths, "temporal_encoder", "temporal_encoder", te)
    for name in TAE2D_NAMES:
        if hasattr(model, name):
            _tae2d_paths(paths, name, name, getattr(model, name))
    for head in ("out_conv", "boundary_conv"):
        if getattr(model, head, None) is not None:
            _layer_paths(paths, f"{head}.conv", f"{head}/conv", getattr(model, head).conv)
    for name, flax in (("convlstm_encoder", "encoder"), ("convgru_encoder", "encoder"),
                       ("convlstm_forward", "encoder/forward"),
                       ("convlstm_backward", "encoder/backward")):
        if hasattr(model, name):
            _cell_paths(paths, name, flax, getattr(model, name))
    for name, flax in (("classification_layer", "classifier"),
                       ("out_convlstm", "out_convlstm")):
        if hasattr(model, name):
            _conv_paths(paths, name, flax)
    if hasattr(model, "en3"):
        _unet3d_paths(paths)
    names = [k for k, _ in model.named_parameters()]
    missing = [k for k in names if k not in paths]
    if missing:
        raise ValueError(f"parameters without a flax counterpart: {missing}")
    return {k: paths[k] for k in names}
