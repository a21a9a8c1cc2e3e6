"""crop2seg_tpu_torch's ``apply_reference_init`` against the JAX package's,
parameter by parameter on converted names.

For each parameter of five small models (U-TAE with batch norms in the
encoder, the boundary head and the absolute + relative date encoders;
TimeUNet with the learned Linear after the sinusoidal encoder; TimeUNet_v2
with its classical TAE2d and LayerNorms; UNet3D with Conv3d, BatchNorm3d
and the transposed convs; a classical TAE2d with cls tokens, their merge
and the linear attention reduction), JAX's
rule is read off its own draws on variables of the model's shapes: untouched
(equal to what it was given), zero, or a normal draw whose RMS over a few keys picks N(0, 1) or
Xavier-normal for the parameter's shape. The port's draws, pooled over 200
generator seeds, must follow the same rule: the untouched ones equal to
their init, the zeros zero, and the RMS within 10 % of the rule's std.
"""
import math

import jax
import numpy as np
import pytest
import torch

from crop2seg_tpu.learning.weight_init import apply_reference_init as japply
from crop2seg_tpu.models import TimeUNet as JTimeUNet
from crop2seg_tpu.models import UTAE as JUTAE
from crop2seg_tpu.models.timeunet_v2 import TimeUNetV2 as JTimeUNetV2
from crop2seg_tpu.models.unet3d import UNet3D as JUNet3D
from crop2seg_tpu.nn.tae2d import TAE2d as JTAE2d
from crop2seg_tpu_torch.learning.weight_init import apply_reference_init
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.models.timeunet_v2 import TimeUNetV2
from crop2seg_tpu_torch.models.unet3d import UNet3D
from crop2seg_tpu_torch.models.utae import UTAE
from crop2seg_tpu_torch.nn.tae2d import TAE2d
from crop2seg_tpu_torch.utils.convert import (
    tae2d_state_dict_from_flax, timeunet_v2_state_dict_from_flax,
    unet3d_state_dict_from_flax, utae_state_dict_from_flax)

KW = dict(input_dim=10, encoder_widths=(8, 16), decoder_widths=(8, 16),
          out_conv=(8, 15), n_head=4, d_model=32, d_k=4)
UTAE_KW = dict(encoder_norm="batch", add_boundary_loss=True, use_abs_rel_enc=True)
# 8 cls tokens: their merge's Xavier std, sqrt(2/9), stands clear of N(0, 1)
# in the few JAX draws that read the rule
TAE_KW = dict(attention_type="classical", embedding_reduction="cls",
              attention_mask_reduction="linear", num_cls_tokens=8, in_channels=16,
              n_head=4, d_k=4, d_model=32, mlp=(32, 16))
SEQ = (1, 3, 16, 16, 10)
# name -> (JAX model, port model, converter, input shape, dates shape)
CASES = {
    "utae_batchnorm_boundary_absrel": (
        lambda: JUTAE(**KW, **UTAE_KW), lambda: UTAE(**KW, **UTAE_KW),
        utae_state_dict_from_flax, SEQ, (1, 3, 2)),
    "timeunet_linear": (
        lambda: JTimeUNet(**KW, add_linear=True), lambda: TimeUNet(**KW, add_linear=True),
        utae_state_dict_from_flax, SEQ, (1, 3)),
    "timeunet_v2": (lambda: JTimeUNetV2(**KW), lambda: TimeUNetV2(**KW),
                    timeunet_v2_state_dict_from_flax, SEQ, (1, 3)),
    "unet3d": (lambda: JUNet3D(feats=2), lambda: UNet3D(feats=2),
               unet3d_state_dict_from_flax, (1, 4, 16, 16, 10), (1, 4)),
    "tae2d_cls8_linear": (lambda: JTAE2d(**TAE_KW), lambda: TAE2d(**TAE_KW, cls_hw=(4, 4)),
                          tae2d_state_dict_from_flax, (1, 3, 4, 4, 16), (1, 3)),
}
JAX_KEYS, PORT_SEEDS = 4, 200


def _xavier_std(shape) -> float:
    fan_in, fan_out = torch.nn.init._calculate_fan_in_and_fan_out(torch.empty(shape))
    return math.sqrt(2.0 / (fan_in + fan_out))


def _jax_rules(make, to_sd, x_shape, dates_shape):
    """port name -> ("untouched" | "zero" | "normal" | "xavier") by JAX's draws."""
    x = np.zeros(x_shape, np.float32)
    dates = np.zeros(dates_shape, np.float32)
    m = make()
    # the variables' shapes, filled with N(0, 1) values: a leaf the rule
    # leaves alone keeps them, a zeroed one loses them
    shapes = jax.eval_shape(
        lambda x: m.init(jax.random.PRNGKey(0), x, dates, train=False), x)
    fill = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda a: fill.standard_normal(a.shape).astype(a.dtype), shapes)
    before = to_sd(v)
    draw = jax.jit(japply)     # the "rbg" keys compile in a third of threefry's time
    draws = [to_sd(jax.tree_util.tree_map(
        np.asarray, draw(v, jax.random.key(k, impl="rbg")))) for k in range(JAX_KEYS)]
    rules = {}
    for k, b in before.items():
        if "running" in k or "num_batches" in k or k in ("cls_position", "cls_pad_mask"):
            continue                                     # buffers
        got = torch.stack([d[k] for d in draws])
        if all(torch.equal(d[k], b) for d in draws):
            rules[k] = "untouched"
            continue
        if not got.any():
            rules[k] = "zero"
            continue
        rms = got.square().mean().sqrt().item()
        xs = _xavier_std(b.shape) if b.dim() >= 2 else float("nan")
        rules[k] = ("xavier" if b.dim() >= 2 and abs(math.log(rms / xs)) < abs(math.log(rms))
                    else "normal")
    return rules


@pytest.mark.parametrize("name", list(CASES))
def test_reference_init_follows_the_jax_rules(name):
    jax_model, port_model, to_sd, x_shape, dates_shape = CASES[name]
    rules = _jax_rules(jax_model, to_sd, x_shape, dates_shape)
    torch.manual_seed(0)
    model = port_model()
    params = dict(model.named_parameters())
    assert set(rules) == set(params)
    before = {k: p.detach().clone() for k, p in params.items()}
    pooled = {k: [] for k in params}
    for seed in range(PORT_SEEDS):
        apply_reference_init(model, torch.Generator().manual_seed(seed))
        for k, p in params.items():
            pooled[k].append(p.detach().clone())
    assert {r for r in rules.values()} >= {"untouched", "normal", "xavier"}
    if name.startswith("utae"):
        assert rules["in_conv.conv.conv.1.bias"] == "zero"
        assert rules["in_conv.conv.conv.1.weight"] == "normal"
    for k, rule in rules.items():
        got = torch.stack(pooled[k])
        if rule == "untouched":
            assert all(torch.equal(g, before[k]) for g in got), k
        elif rule == "zero":
            assert not got.any(), k
        else:
            want = 1.0 if rule == "normal" else _xavier_std(before[k].shape)
            rms = got.square().mean().sqrt().item()
            assert abs(rms / want - 1) < 0.10, (k, rule, rms, want)
            assert not torch.equal(got[0], got[1]), k   # each seed its own draw


def test_reference_init_is_seeded():
    torch.manual_seed(0)
    a = UTAE(**KW)
    torch.manual_seed(0)
    b = UTAE(**KW)
    apply_reference_init(a, torch.Generator().manual_seed(3))
    apply_reference_init(b, torch.Generator().manual_seed(3))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
