"""Everything a run feeds the system and the reference, made from
``--seed``: the weights (one seeded state dict loaded into both sides) and
the traffic, one general generator reading a mix's parameters
(``traffic/<mix>.json``).

Every seed gives a run the same work: the valid lengths are a fixed set
spread over the mix's range, only their order drawn from the seed; the
dates, pixels and labels are drawn, and change no shape.
"""
from __future__ import annotations

import hashlib
import random

import numpy as np
import torch


def stream(seed: int, name: str) -> int:
    """A 63-bit seed for the named stream of the run's ``seed`` (any whole
    number)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, name))
    return g


def seeded_state(template: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``template``'s names and shapes, drawn on ``device``
    in one call: weights of the products normal with std 1/sqrt(fan in)
    (the attention's query and keys sqrt(2/d_k), as the published L-TAE
    draws them), biases normal(0, 0.05), norm scales 1 + normal(0, 0.1),
    norm shifts normal(0, 0.1), running means normal(0, 0.1), running
    variances exp(normal(0, 0.2))."""
    shapes = {k: v.shape for k, v in template.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    total = sum(int(np.prod(s)) for s in shapes.values())
    z = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        v = z[at:at + n].reshape(shape)
        at += n
        if name.endswith("running_var"):
            v = torch.exp(0.2 * v)
        elif name.endswith("running_mean") or (len(shape) == 1 and name.endswith(".bias")
                                               and _is_norm(template, name)):
            v = 0.1 * v
        elif len(shape) == 1 and name.endswith(".weight"):
            v = 1.0 + 0.1 * v
        elif name.endswith(".bias"):
            v = 0.05 * v
        elif name.endswith("attention_head.Q") or name.endswith("fc1_k.weight"):
            v = v * (2.0 / _d_k(template, name)) ** 0.5
        else:
            v = v * (n / shape[0]) ** -0.5
        out[name] = v.contiguous()
    for k, v in template.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros_like(v, device=device)
    return out


def _is_norm(model, name: str) -> bool:
    module = model.get_submodule(name.rsplit(".", 1)[0])
    return isinstance(module, (torch.nn.GroupNorm, torch.nn.modules.batchnorm._BatchNorm))


def _d_k(model, name: str) -> int:
    prefix = name.rsplit("attention_head", 1)[0]
    return model.get_submodule(prefix + "attention_head").Q.shape[-1]


def lengths(n: int, low: int, high: int, seed: int, name: str) -> list:
    """n valid lengths evenly spread over [low, high], in an order drawn
    from the seed."""
    base = [round(low + (high - low) * i / max(n - 1, 1)) for i in range(n)]
    random.Random(stream(seed, name)).shuffle(base)
    return base


def day_offsets(t: int, gaps: list, seed: int, name: str) -> np.ndarray:
    """T ascending day offsets: a first day in [0, 5), then gaps drawn from
    ``gaps``."""
    rng = random.Random(stream(seed, name))
    days = [rng.randrange(5)]
    for _ in range(t - 1):
        days.append(days[-1] + rng.choice(gaps))
    return np.asarray(days, dtype=np.float32)


def make_tiles(mix: dict, input_dim: int, seed: int, device) -> list:
    """The mix's distinct tiles, each {"tile": (T, side, side, C) float32 on
    ``device`` with the frames past its length zeroed, "dates": (T,)
    float32, "length": int}."""
    t, side = mix["t"], mix["side"]
    lo, hi = mix["lengths"]
    out = []
    for i, length in enumerate(lengths(mix["tiles"], lo, hi, seed, "tile-lengths")):
        tile = torch.randn((t, side, side, input_dim),
                           generator=generator(seed, f"tile-{i}", device), device=device)
        tile[length:] = 0.0
        out.append({"tile": tile, "dates": day_offsets(t, mix["date_gaps"], seed, f"dates-{i}"),
                    "length": length})
    return out


def make_batches(mix: dict, input_dim: int, seed: int, device) -> list:
    """The mix's pool of training batches, each {"x": (B, T, side, side, C)
    float32 with the frames past each sample's length zeroed, "dates": (B,
    T), "pad_mask": (B, T) bool, "y": (B, side, side) int64} on
    ``device``."""
    b, t, side, pool = mix["batch"], mix["t"], mix["side"], mix["pool"]
    lo, hi = mix["lengths"]
    lens = lengths(b * pool, lo, hi, seed, "batch-lengths")
    steps = torch.arange(t, device=device)
    out = []
    for i in range(pool):
        g = generator(seed, f"batch-{i}", device)
        ln = torch.tensor(lens[i * b:(i + 1) * b], device=device)
        pad = steps[None, :] >= ln[:, None]
        x = torch.randn((b, t, side, side, input_dim), generator=g, device=device)
        x.masked_fill_(pad[:, :, None, None, None], 0.0)
        y = torch.randint(0, mix["classes"], (b, side, side), generator=g, device=device)
        dates = np.stack([day_offsets(t, mix["date_gaps"], seed, f"dates-{i}-{j}")
                          for j in range(b)])
        out.append({"x": x, "dates": torch.as_tensor(dates, device=device),
                    "pad_mask": pad, "y": y})
    return out
