"""Weights converter: the JAX package's flax U-TAE and TimeUNet variables ->
the port's state dict (the inverse of crop2seg_tpu/utils/torch_convert.py:44-68
and :109-316). Leaves arrive as numpy arrays; the result loads with
``UTAE.load_state_dict`` / ``TimeUNet.load_state_dict``.

    flax conv kernel   (kh, kw, I, O)              -> torch (O, I, kh, kw)
    flax conv-transpose forward HWIO, pre-flipped  -> torch (I, O, kh, kw)
    flax Dense         (I, O)                      -> torch Linear (O, I)
    flax Dense C->D    (I, O)                      -> torch Conv1d (O, I, 1)
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


def _conv_layer(sd, prefix, params, stats):
    """ConvLayer: flax conv{i}/norm{i} -> torch Sequential ``{prefix}.conv``,
    its indices found by scanning the units as ``nn/layers.py::ConvLayer``
    lays them out: conv, [norm], [ReLU]. Every unit but the last has a ReLU;
    the last one's (``last_relu``) comes after every index, so it moves
    none. With a norm that is conv 3i, norm 3i+1; without one, conv 2i."""
    for key in params:
        if not re.fullmatch(r"(conv|norm)\d+", key):
            raise ValueError(f"unexpected ConvLayer entry {key!r}")
    idx = 0
    for i in range(sum(key.startswith("conv") for key in params)):
        _conv(sd, _j(prefix, f"conv.{idx}"), params[f"conv{i}"]["conv"])
        idx += 1
        if f"norm{i}" in params:
            _norm(sd, _j(prefix, f"conv.{idx}"), params[f"norm{i}"],
                  stats.get(f"norm{i}"))
            idx += 1
        idx += 1   # the unit's ReLU


def _ltae(sd, prefix, p, s):
    sd[_j(prefix, "in_norm.weight")] = p["in_norm_scale"]
    sd[_j(prefix, "in_norm.bias")] = p["in_norm_bias"]
    sd[_j(prefix, "inconv.weight")] = linear_weight(p["inconv"]["kernel"])[:, :, None]
    sd[_j(prefix, "inconv.bias")] = p["inconv"]["bias"]
    att = p["attention"]
    sd[_j(prefix, "attention_head.Q")] = att["query"]
    sd[_j(prefix, "attention_head.fc1_k.weight")] = linear_weight(att["fc1_k"]["kernel"])
    sd[_j(prefix, "attention_head.fc1_k.bias")] = att["fc1_k"]["bias"]
    sd[_j(prefix, "mlp.0.weight")] = linear_weight(p["mlp_dense"]["kernel"])
    sd[_j(prefix, "mlp.0.bias")] = p["mlp_dense"]["bias"]
    _norm(sd, _j(prefix, "mlp.2"), p["mlp_bn"], s["mlp_bn"])
    sd[_j(prefix, "out_norm.weight")] = p["out_norm_scale"]
    sd[_j(prefix, "out_norm.bias")] = p["out_norm_bias"]
    pe = p.get("positional_encoder", {})
    if "fc" in pe:          # sinusoidal encoder with a learned Linear
        sd[_j(prefix, "positional_encoder.fc.weight")] = linear_weight(pe["fc"]["kernel"])
        sd[_j(prefix, "positional_encoder.fc.bias")] = pe["fc"]["bias"]
    for name in ("positional_encoder", "positional_encoder_abs"):
        emb = p.get(name, {})
        if "embedding" in emb:  # absolute day-of-year encoder
            sd[_j(prefix, f"{name}.fc.weight")] = linear_weight(emb["embedding"])
            sd[_j(prefix, f"{name}.fc.bias")] = emb["bias"]


def _down_block(sd, prefix, p, s):
    for name in ("down", "conv1", "conv2"):
        _conv_layer(sd, _j(prefix, name), p[name], s.get(name, {}))


def _up_block(sd, prefix, p, s):
    sd[_j(prefix, "up.0.weight")] = conv_transpose2d_weight(p["up_conv"]["kernel"])
    sd[_j(prefix, "up.0.bias")] = p["up_conv"]["bias"]
    _norm(sd, _j(prefix, "up.1"), p["up_norm"], s["up_norm"])
    _conv(sd, _j(prefix, "skip_conv.0"), p["skip_conv"]["conv"])
    _norm(sd, _j(prefix, "skip_conv.1"), p["skip_norm"], s["skip_norm"])
    for name in ("conv1", "conv2"):
        _conv_layer(sd, _j(prefix, name), p[name], s.get(name, {}))


def _torch(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def _split(variables: Mapping):
    return variables["params"], variables.get("batch_stats", {})


def conv_block_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ConvBlock variables -> the port's ConvBlock state dict."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    _conv_layer(sd, "conv", p["conv"], s.get("conv", {}))
    return _torch(sd)


def down_block_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax DownConvBlock variables -> the port's DownConvBlock state dict."""
    sd: Dict[str, np.ndarray] = {}
    _down_block(sd, "", *_split(variables))
    return _torch(sd)


def up_block_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax UpConvBlock variables -> the port's UpConvBlock state dict."""
    sd: Dict[str, np.ndarray] = {}
    _up_block(sd, "", *_split(variables))
    return _torch(sd)


def ltae_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax LTAE variables -> the port's LTAE state dict."""
    sd: Dict[str, np.ndarray] = {}
    _ltae(sd, "", *_split(variables))
    return _torch(sd)


def utae_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` of crop2seg_tpu's U-TAE or TimeUNet
    (nested dicts of numpy arrays) -> the port's state dict (the inverse of
    crop2seg_tpu/utils/torch_convert.py::convert_utae). The two models hold
    the same modules (U-TAE's aggregator has no parameters), and U-TAE may
    add the boundary head."""
    p, s = _split(variables)
    sd: Dict[str, np.ndarray] = {}
    _conv_layer(sd, "in_conv.conv", p["in_conv"]["conv"],
                s.get("in_conv", {}).get("conv", {}))
    i = 0
    while f"down_{i}" in p:
        _down_block(sd, f"down_blocks.{i}", p[f"down_{i}"], s.get(f"down_{i}", {}))
        _up_block(sd, f"up_blocks.{i}", p[f"up_{i}"], s[f"up_{i}"])
        i += 1
    _ltae(sd, "temporal_encoder", p["temporal_encoder"],
          s.get("temporal_encoder", {}))
    for head in ("out_conv", "boundary_conv"):
        if head in p:
            _conv_layer(sd, f"{head}.conv", p[head]["conv"],
                        s.get(head, {}).get("conv", {}))
    return _torch(sd)


timeunet_state_dict_from_flax = utae_state_dict_from_flax


def _layer_paths(paths, port, flax, layer) -> None:
    """A ConvLayer's units (conv, [norm], [ReLU]) -> flax conv{i}/conv and
    norm{i}, the table of ``_conv_layer`` read the other way."""
    i = -1
    for idx, unit in enumerate(layer.conv):
        if isinstance(unit, torch.nn.Conv2d):
            i += 1
            paths[f"{port}.conv.{idx}.weight"] = f"{flax}/conv{i}/conv/kernel"
            paths[f"{port}.conv.{idx}.bias"] = f"{flax}/conv{i}/conv/bias"
        elif isinstance(unit, (torch.nn.GroupNorm, torch.nn.modules.batchnorm._BatchNorm)):
            paths[f"{port}.conv.{idx}.weight"] = f"{flax}/norm{i}/scale"
            paths[f"{port}.conv.{idx}.bias"] = f"{flax}/norm{i}/bias"


def _ltae_paths(paths, port, flax, ltae) -> None:
    names = {"in_norm.weight": "in_norm_scale", "in_norm.bias": "in_norm_bias",
             "inconv.weight": "inconv/kernel", "inconv.bias": "inconv/bias",
             "attention_head.Q": "attention/query",
             "attention_head.fc1_k.weight": "attention/fc1_k/kernel",
             "attention_head.fc1_k.bias": "attention/fc1_k/bias",
             "mlp.0.weight": "mlp_dense/kernel", "mlp.0.bias": "mlp_dense/bias",
             "mlp.2.weight": "mlp_bn/scale", "mlp.2.bias": "mlp_bn/bias",
             "out_norm.weight": "out_norm_scale", "out_norm.bias": "out_norm_bias"}
    for name in ("positional_encoder", "positional_encoder_abs"):
        enc = getattr(ltae, name, None)
        if enc is None or getattr(enc, "fc", None) is None:
            continue
        if type(enc).__name__ == "AbsolutePositionalEncoder":
            names.update({f"{name}.fc.weight": f"{name}/embedding",
                          f"{name}.fc.bias": f"{name}/bias"})
        else:
            names.update({f"{name}.fc.weight": f"{name}/fc/kernel",
                          f"{name}.fc.bias": f"{name}/fc/bias"})
    for k, v in names.items():
        paths[f"{port}.{k}"] = f"{flax}/{v}"


def flax_param_paths(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter name of the port's U-TAE or TimeUNet -> the
    slash-joined flax path of its counterpart in the JAX model's ``params``
    (``down_0/conv1/conv0/conv/kernel``, ``temporal_encoder/attention/query``,
    ...): the table of ``utae_state_dict_from_flax`` read the other way.
    Raises if a parameter has no counterpart."""
    paths: Dict[str, str] = {}
    _layer_paths(paths, "in_conv.conv", "in_conv/conv", model.in_conv.conv)
    for i, block in enumerate(model.down_blocks):
        for name in ("down", "conv1", "conv2"):
            _layer_paths(paths, f"down_blocks.{i}.{name}", f"down_{i}/{name}",
                         getattr(block, name))
    for i, block in enumerate(model.up_blocks):
        port, flax = f"up_blocks.{i}", f"up_{i}"
        for k, v in {"up.0.weight": "up_conv/kernel", "up.0.bias": "up_conv/bias",
                     "up.1.weight": "up_norm/scale", "up.1.bias": "up_norm/bias",
                     "skip_conv.0.weight": "skip_conv/conv/kernel",
                     "skip_conv.0.bias": "skip_conv/conv/bias",
                     "skip_conv.1.weight": "skip_norm/scale",
                     "skip_conv.1.bias": "skip_norm/bias"}.items():
            paths[f"{port}.{k}"] = f"{flax}/{v}"
        for name in ("conv1", "conv2"):
            _layer_paths(paths, f"{port}.{name}", f"{flax}/{name}", getattr(block, name))
    _ltae_paths(paths, "temporal_encoder", "temporal_encoder", model.temporal_encoder)
    for head in ("out_conv", "boundary_conv"):
        if getattr(model, head, None) is not None:
            _layer_paths(paths, f"{head}.conv", f"{head}/conv", getattr(model, head).conv)
    names = [k for k, _ in model.named_parameters()]
    missing = [k for k in names if k not in paths]
    if missing:
        raise ValueError(f"parameters without a flax counterpart: {missing}")
    return {k: paths[k] for k in names}
