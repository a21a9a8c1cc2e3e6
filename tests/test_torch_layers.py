"""crop2seg_tpu_torch conv blocks, norms, positional encoders and temporal
helpers against the JAX package (same numpy inputs, weights converted by
crop2seg_tpu_torch.utils.convert) and against the reference goldens.

Tolerance: 5e-4 abs/rel, the goldens' fp32 tolerance (the two frameworks
sum convolutions and norm statistics in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.nn import layers as jl
from crop2seg_tpu.nn import positional as jpos
from crop2seg_tpu.nn import temporal as jtemp
from crop2seg_tpu_torch.nn import layers as tl
from crop2seg_tpu_torch.nn import positional as tpos
from crop2seg_tpu_torch.nn import temporal as ttemp
from crop2seg_tpu_torch.utils import convert
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc, to_nhwc_seq

TOL = dict(rtol=5e-4, atol=5e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_stats(variables, seed=3):
    """Non-trivial BatchNorm running statistics, so eval BN is exercised."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        variables.get("batch_stats", {}))
    return {"params": variables["params"], "batch_stats": stats}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def test_conv_block_group_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 16, 16, 10)).astype(np.float32)
    jm = jl.ConvBlock(nkernels=(10, 8, 8), norm="group")
    v = _np(jm.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jm.apply(v, x))
    tm = tl.ConvBlock((10, 8, 8), norm="group").eval()
    tm.load_state_dict(convert.conv_block_state_dict_from_flax(v))
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_down_block_matches_jax():
    x = np.random.default_rng(1).standard_normal((4, 16, 16, 8)).astype(np.float32)
    jm = jl.DownConvBlock(d_out=16, norm="group")
    v = _np(jm.init(jax.random.PRNGKey(1), x))
    want = np.asarray(jm.apply(v, x))
    tm = tl.DownConvBlock(8, 16, norm="group").eval()
    tm.load_state_dict(convert.down_block_state_dict_from_flax(v))
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    assert got.shape == (4, 8, 8, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_up_block_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    skip = rng.standard_normal((2, 16, 16, 12)).astype(np.float32)
    jm = jl.UpConvBlock(d_out=8, norm="batch")
    v = _perturb_stats(_np(jm.init(jax.random.PRNGKey(2), x, skip)))
    want = np.asarray(jm.apply(v, x, skip))
    tm = tl.UpConvBlock(16, 8, 12, norm="batch").eval()
    tm.load_state_dict(convert.up_block_state_dict_from_flax(v))
    with torch.inference_mode():
        got = tm(_t(x), _t(skip)).numpy()
    assert got.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got, want, **TOL)


def _shared(module, x_tcs):
    """Reference (B, T, C, H, W) input through a per-frame block, pads kept."""
    x = _t(to_nhwc_seq(x_tcs))
    mask = ttemp.pad_mask_from_input(x)
    with torch.inference_mode():
        y = ttemp.temporally_shared(module, x, mask)
    return np.transpose(y.numpy(), (0, 1, 4, 2, 3))


@pytest.mark.parametrize("name", ["conv_block_group", "down_block", "up_block",
                                  "conv_block_dws", "conv_block_batch_se"])
def test_block_goldens(name):
    arrays, sd = load_fixture(name)
    if name == "conv_block_group":
        m = tl.ConvBlock((10, 8, 8), norm="group")
    elif name == "conv_block_dws":
        m = tl.ConvBlock((10, 8, 8), norm="group", conv_type="depthwise_separable")
    elif name == "conv_block_batch_se":
        m = tl.ConvBlock((10, 32, 32), norm="batch", add_squeeze=True)
    elif name == "down_block":
        m = tl.DownConvBlock(8, 16, norm="group")
    else:
        m = tl.UpConvBlock(16, 8, 12, norm="batch")
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    m.eval()
    if name == "up_block":
        with torch.inference_mode():
            got = from_nhwc(m(_t(to_nhwc(arrays["x"])),
                              _t(to_nhwc(arrays["skip"]))).numpy())
    else:
        got = _shared(m, arrays["x"])
    np.testing.assert_allclose(got, arrays["y"], **TOL)


def test_positional_encoder_golden():
    arrays, sd = load_fixture("positional_encoder")
    m = tpos.PositionalEncoder(16, T=1000, repeat=4, add_linear=True)
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        got = m(_t(arrays["dates"])).numpy()
    np.testing.assert_allclose(got, arrays["y"], **TOL)


def test_abs_positional_encoder_golden():
    arrays, sd = load_fixture("abs_positional_encoder")
    m = tpos.AbsolutePositionalEncoder(16, repeat=4)
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        got = m(_t(arrays["doy"])).numpy()
    np.testing.assert_allclose(got, arrays["y"], **TOL)


def test_abs_positional_encoder_out_of_range_days_give_bias():
    m = tpos.AbsolutePositionalEncoder(4, repeat=2)
    doy = torch.tensor([[-1, 0, 364, 365, 366]])
    with torch.inference_mode():
        got = m(doy)
    bias = m.fc.bias.detach().repeat(2)
    for i in (0, 3, 4):
        torch.testing.assert_close(got[0, i], bias)
    torch.testing.assert_close(got[0, 1, :4], m.fc.weight[:, 0] + m.fc.bias)


def test_sinusoid_table_matches_jax():
    pos = np.array([[0.0, 3.0, 17.0, 250.0, 399.0]], np.float32)
    want = np.asarray(jpos.sinusoid_table(jnp.asarray(pos), 16, 1000.0))
    got = tpos.sinusoid_table(_t(pos), 16, 1000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_temporal_helpers_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 4, 3)).astype(np.float32)
    x[1, 3:] = 0.0
    lengths = np.array([5, 3])
    np.testing.assert_array_equal(
        ttemp.pad_mask_from_input(_t(x)).numpy(),
        np.asarray(jtemp.pad_mask_from_input(jnp.asarray(x))))
    mask = ttemp.pad_mask_from_lengths(_t(lengths), 5)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jtemp.pad_mask_from_lengths(jnp.asarray(lengths), 5)))
    got = ttemp.temporally_shared(lambda f: f * 2.0 + 1.0, _t(x), mask, 0.5)
    want = jtemp.temporally_shared(lambda f: f * 2.0 + 1.0, jnp.asarray(x),
                                   jnp.asarray(mask.numpy()), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert (got[1, 3:] == 0.5).all()


def test_defer_tail_norm_equals_plain_tail():
    """(z, sc, sh) from defer_tail_norm: max(z*sc + sh, 0) is the plain
    block output (up to fp32 rounding of the affine)."""
    torch.manual_seed(0)
    m = tl.ConvBlock((10, 16, 16), norm="group").eval()
    with torch.no_grad():
        for p in m.parameters():  # non-trivial GroupNorm affine
            p.add_(0.1 * torch.randn_like(p))
    x = torch.randn(6, 12, 12, 10)
    with torch.inference_mode():
        want = m(x)
        z, sc, sh = m(x, defer_tail_norm=True)
    assert z.shape == (6, 12, 12, 16) and sc.shape == sh.shape == (6, 16)
    got = torch.relu(z * sc[:, None, None, :] + sh[:, None, None, :])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_defer_tail_norm_needs_group_norm_tail():
    m = tl.ConvBlock((4, 8), norm="batch").eval()
    with pytest.raises(ValueError):
        m(torch.randn(1, 4, 4, 4), defer_tail_norm=True)


def test_modules_are_eval_only():
    """No module stays eval-only: a conv block in training mode (a new
    nn.Module's default) normalizes with the batch statistics and updates
    its running ones; instance norm, which has neither parameters nor
    running statistics, normalizes each channel of each frame in either
    mode."""
    m = tl.ConvBlock((4, 8), norm="batch", last_relu=False)
    with torch.no_grad():
        m.conv.conv[0].bias.fill_(0.5)
    y = m(torch.randn(2, 6, 6, 4, generator=torch.Generator().manual_seed(0)))
    bn = m.conv.conv[1]
    torch.testing.assert_close(y.mean(dim=(0, 1, 2)), torch.zeros(8), rtol=0, atol=1e-5)
    torch.testing.assert_close(y.var(dim=(0, 1, 2), unbiased=False), torch.ones(8),
                               rtol=0, atol=1e-3)
    assert bn.num_batches_tracked.item() == 1
    assert (bn.running_mean - 0.05).abs().max() < 0.05   # 0.1 * (0.5 + noise)
    norm = tl.make_norm("instance")(8)
    assert not list(norm.parameters()) and not list(norm.buffers())
    x = torch.randn(2, 6, 6, 8, generator=torch.Generator().manual_seed(1)) * 3 + 1
    for mode in (True, False):
        y = norm.train(mode)(x)
        torch.testing.assert_close(y.mean(dim=(1, 2)), torch.zeros(2, 8), rtol=0, atol=1e-5)
        torch.testing.assert_close(y.var(dim=(1, 2), unbiased=False), torch.ones(2, 8),
                                   rtol=0, atol=1e-3)
