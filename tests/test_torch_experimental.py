"""The modules no entry point reaches, port against JAX on the CPU, through
the converters of crop2seg_tpu_torch/utils/convert.py: the 3-D blocks
(ConvBlock3D, DownConvBlock3D with BatchNorm and GroupNorm, in eval and in
training with BatchNorm's running statistics; TemporalAggregator3D in each
mode, upsampling, pooling and at equal resolution), UNetEx (the reference
defaults, a transposed-conv decoder with a head, training mode) and
MLPMixer; each model's ``flax_param_paths`` covers the JAX parameters one
for one; and the unet_ex / mlp_mixer goldens load by ``load_state_dict``.
Tolerance 5e-4 (fp32 modules), as the goldens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.models.mlp_mixer import MLPMixer as JMLPMixer
from crop2seg_tpu.models.unet_ex import UNetEx as JUNetEx
from crop2seg_tpu.nn import blocks3d as jb
from crop2seg_tpu_torch.models import MLPMixer, UNetEx
from crop2seg_tpu_torch.nn import blocks3d as pb
from crop2seg_tpu_torch.utils import convert as cv
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc

TOL = dict(rtol=5e-4, atol=5e-4)
B, T, H, W = 2, 6, 16, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _check_paths(model, params):
    """flax_param_paths maps the port's parameters onto the JAX ones, one for
    one, with the same number of elements."""
    paths, flat = cv.flax_param_paths(model), _flat(params)
    assert sorted(paths.values()) == sorted(flat)
    for name, p in model.named_parameters():
        assert p.numel() == np.size(flat[paths[name]]), name


def _stats(v, rng):
    """Non-trivial BatchNorm running statistics."""
    if "batch_stats" not in v:
        return v
    return {**v, "batch_stats": jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        v["batch_stats"])}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


BLOCKS = {
    "conv_batch": (lambda: jb.ConvBlock3D(nkernels=(8, 12)),
                   lambda: pb.ConvBlock3D((8, 12)), "batch"),
    "conv_group": (lambda: jb.ConvBlock3D(nkernels=(8, 12, 12), norm="group"),
                   lambda: pb.ConvBlock3D((8, 12, 12), norm="group"), "group"),
    "conv_no_last_relu": (lambda: jb.ConvBlock3D(nkernels=(8, 8), last_relu=False),
                          lambda: pb.ConvBlock3D((8, 8), last_relu=False), "batch"),
    "down_batch": (lambda: jb.DownConvBlock3D(d_out=12), lambda: pb.DownConvBlock3D(8, 12),
                   "batch"),
    "down_group": (lambda: jb.DownConvBlock3D(d_out=12, norm="group"),
                   lambda: pb.DownConvBlock3D(8, 12, norm="group"), "group"),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks3d_match_jax(name):
    make_j, make_p, norm = BLOCKS[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, H, W, 8)).astype(np.float32)
    jm = make_j()
    v = _stats(_np(jm.init(jax.random.PRNGKey(1), x, train=False)), rng)
    m = make_p().eval()
    m.load_state_dict(cv.blocks3d_state_dict_from_flax(v, norm))
    _check_paths(m, v["params"])
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x, train=False)), **TOL)
    # training: batch statistics, and the running ones updated as flax does
    want, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    m.train()
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if norm == "batch":
        sd = m.state_dict()
        want_sd = cv.blocks3d_state_dict_from_flax(
            {"params": v["params"], "batch_stats": _np(upd["batch_stats"])}, norm)
        for k in want_sd:
            if "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode,attn_hw", [("att_group", 8), ("att_mean", 8),
                                          ("att_group", 32), ("att_mean", 16),
                                          ("mean", 8)])
def test_temporal_aggregator3d_matches_jax(mode, attn_hw):
    """Masks coarser than the skip (8 < 16: the learned x2 upsampling),
    finer (32: average-pooled), equal, and the masked mean; with pads."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, H, W, 8)).astype(np.float32)
    attn = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((B, attn_hw, attn_hw, 4, T)).astype(np.float32)), -1))
    pad = np.zeros((B, T), bool)
    pad[1, 4:] = True
    jm = jb.TemporalAggregator3D(mode=mode)
    v = _np(jm.init(jax.random.PRNGKey(2), x, attn, pad))
    want, want_a = jm.apply(v, x, attn, pad)
    m = pb.TemporalAggregator3D(mode)
    upsampled = "up_deconv" in v.get("params", {})
    assert upsampled == (mode != "mean" and attn_hw < H)
    m.load_state_dict(cv.blocks3d_state_dict_from_flax(v), strict=upsampled or mode == "mean")
    if upsampled:
        _check_paths(m, v["params"])
    with torch.no_grad():
        got, got_a = m(_t(x), _t(attn), _t(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "mean":
        assert got_a is None and want_a is None
    else:
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-6)


UNET_EX_SMALL = dict(base_channels=8, num_stages=3, strides=(1, 1, 1),
                     enc_num_convs=(2, 2, 2), dec_num_convs=(2, 2),
                     downsamples=(True, True), enc_dilations=(1, 1, 1),
                     dec_dilations=(1, 1))
UNET_EX = {
    "reference_defaults": dict(UNET_EX_SMALL, return_maps=True),
    "deconv_head_relu": dict(UNET_EX_SMALL, use_deconv=True, act="relu", num_classes=5),
    "dilated_group": dict(UNET_EX_SMALL, dec_dilations=(2, 2), enc_dilations=(1, 2, 2),
                          norm="group"),
}


@pytest.mark.parametrize("name", list(UNET_EX))
def test_unet_ex_matches_jax(name):
    kw = UNET_EX[name]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 10)).astype(np.float32)
    jm = JUNetEx(**kw)
    v = _stats(_np(jm.init(jax.random.PRNGKey(1), x, train=False)), rng)
    m = UNetEx(in_channels=10, **kw).eval()
    m.load_state_dict(cv.unet_ex_state_dict_from_flax(v))
    _check_paths(m, v["params"])
    for train in (False, True):
        want = jm.apply(v, x, train=train, mutable=["batch_stats"] if train else False)
        want = want[0] if train else want
        m.train(train)
        with torch.no_grad():
            got = m(_t(x))
        if kw.get("return_maps"):
            for g, w in zip(got[1], want[1]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
            got, want = got[0], want[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_mixer_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 6, 32)).astype(np.float32)
    jm = JMLPMixer(num_tokens=6, hidden_dim=32, num_layers=3, token_mlp_dim=16,
                   channel_mlp_dim=128)
    v = _np(jm.init(jax.random.PRNGKey(1), x))
    m = MLPMixer(6, 32, 3, 16, 128).eval()
    m.load_state_dict(cv.mlp_mixer_state_dict_from_flax(v))
    _check_paths(m, v["params"])
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x)), **TOL)


def test_unet_ex_golden():
    arrays, sd = load_fixture("unet_ex")
    m = UNetEx(in_channels=10, **UNET_EX["reference_defaults"]).eval()
    m.load_state_dict({k: _t(v) for k, v in sd.items()})
    with torch.no_grad():
        out, dec_outs = m(_t(to_nhwc(arrays["x"])))
    np.testing.assert_allclose(from_nhwc(out.numpy()), arrays["y"], **TOL)
    np.testing.assert_allclose(from_nhwc(dec_outs[0].numpy()), arrays["y_bottleneck"], **TOL)


def test_mlp_mixer_golden():
    arrays, sd = load_fixture("mlp_mixer")
    m = MLPMixer(num_tokens=6, hidden_dim=32, num_layers=2, token_mlp_dim=16,
                 channel_mlp_dim=128).eval()
    m.load_state_dict({k: _t(v) for k, v in sd.items()})
    with torch.no_grad():
        got = m(_t(arrays["x"]))
    np.testing.assert_allclose(got.numpy(), arrays["y"], **TOL)
