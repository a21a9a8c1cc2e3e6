"""crop2seg_tpu_torch TimeUNet against the JAX TimeUNet (use_pallas=False) on
the same converted weights and the same numpy inputs, against the
timeunet_small golden, and its two paths against each other.

Sizes as tests/test_ltae_pallas.py:208-214 (widths (16, 16, 32), 4 heads,
d_model 32, B=2, T=7, 16x16, a pad); tolerance 1e-3 as there. The golden
takes 5e-4, as tests/test_ltae_parity.py holds the JAX model to it.
"""
import jax
import numpy as np
import pytest
import torch

from crop2seg_tpu.models import TimeUNet as JTimeUNet
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.utils.convert import timeunet_state_dict_from_flax
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc_seq

KW = dict(input_dim=10, encoder_widths=(16, 16, 32), decoder_widths=(8, 16, 32),
          out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
TOL = dict(rtol=1e-3, atol=1e-3)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def case():
    """One JAX init + apply (tens of seconds on the CPU), shared by the file."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 16, 16, 10)).astype(np.float32)
    pad = np.zeros((2, 7), bool)
    pad[1, 5:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(7) * 9.0).astype(np.float32), (2, 1))
    m = JTimeUNet(**KW)
    v = jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                 train=False))(x)
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": jax.tree_util.tree_map(  # non-trivial BN statistics
             lambda a: np.abs(np.asarray(a) + 0.3 * rng.standard_normal(a.shape)
                              ).astype(np.float32), v["batch_stats"])}
    y = np.asarray(jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad,
                                                train=False))(v, x))
    model = TimeUNet(**KW).eval()
    model.load_state_dict(timeunet_state_dict_from_flax(v))
    return dict(x=x, pad=pad, dates=dates, y=y, model=model)


def _run(case, x=None, fused=False):
    with torch.inference_mode():
        return case["model"](_t(case["x"] if x is None else x),
                             _t(case["dates"]), _t(case["pad"]), fused=fused).numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_matches_jax_timeunet(case, fused):
    """Plain path and deferred-tail kernel path (the kernel's plain version
    on the CPU) both match JAX on converted weights."""
    got = _run(case, fused=fused)
    assert got.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(got, case["y"], **TOL)


def test_deferred_tail_path_equals_temporally_shared_path(case):
    """fused=True called explicitly on the CPU (in_conv defers its GroupNorm,
    pads folded into (sc, sh) as zero rows) equals the temporally_shared
    path. Tolerance 1e-4: the two round the affine in other places."""
    np.testing.assert_allclose(_run(case, fused=True), _run(case, fused=False),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_pad_invariance(case, fused):
    """Garbage in the pad frames must not change the output: the explicit
    mask keeps it out of in_conv's result and the attention. Tolerance 1e-6:
    the same ops run on the same valid frames."""
    noisy = case["x"].copy()
    noisy[case["pad"]] = np.random.default_rng(9).standard_normal(
        noisy[case["pad"]].shape).astype(np.float32) * 50.0
    np.testing.assert_allclose(_run(case, noisy, fused), _run(case, fused=fused),
                               rtol=1e-6, atol=1e-6)


def test_timeunet_golden():
    arrays, sd = load_fixture("timeunet_small")
    m = TimeUNet(input_dim=10, encoder_widths=(16, 16, 32),
                 decoder_widths=(8, 16, 32), out_conv=(8, 5), n_head=4,
                 d_model=32, d_k=4).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        y = m(_t(to_nhwc_seq(arrays["x"])), _t(arrays["dates"])).numpy()
    np.testing.assert_allclose(from_nhwc(y), arrays["y"], rtol=5e-4, atol=5e-4)


def test_factory_defaults_and_seeded_weights():
    cfg = {"model": "timeunet", "use_pallas": True}
    m = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    assert not m.training
    assert m.in_conv.conv.conv[0].weight.shape == (64, 10, 3, 3)
    assert [b.conv2.conv[0].out_channels for b in m.down_blocks] == [64, 64, 128]
    assert [b.conv2.conv[0].out_channels for b in m.up_blocks] == [64, 32, 32]
    assert m.out_conv.conv.conv[3].weight.shape == (15, 32, 3, 3)
    te = m.temporal_encoder
    assert (te.n_head, te.d_model, te.d_k) == (16, 256, 4)
    assert te.attention_head.Q.shape == (16, 1, 4)
    again = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    other = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    sd, sd2, sd3 = m.state_dict(), again.state_dict(), other.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert not torch.equal(sd["in_conv.conv.conv.0.weight"],
                           sd3["in_conv.conv.conv.0.weight"])


@pytest.mark.parametrize("name", ["utae", "wtae", "unet3d"])
def test_factory_other_models_point_at_roadmap(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model({"model": name}, device="cpu")


def test_training_mode_raises_naming_slice_d():
    """Training mode runs (slice D's training step) and is differentiable,
    with the deferred in_conv tail too (ltae_pool_tail, on both the kernel
    wrapper and the plain version); what its L-TAE still lacks raises and
    names ROADMAP.md: the attention output."""
    m = TimeUNet(**KW)                        # a new module trains
    out = m(torch.randn(1, 2, 16, 16, 10), torch.zeros(1, 2))
    assert out.shape == (1, 16, 16, 5) and out.requires_grad
    te, h = m.temporal_encoder, torch.randn(1, 2, 4, 4, 16)
    tail = (torch.ones(1, 2, 16), torch.zeros(1, 2, 16))
    for fused in (True, False):
        out, attn = te(h, torch.zeros(1, 2), need_attn=False, tail_affine=tail,
                       fused=fused)
        assert out.shape == (1, 4, 4, 16) and out.requires_grad and attn is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te(h, torch.zeros(1, 2))


def test_converter_inverts_the_jax_package_import():
    """Reference state dict -> crop2seg_tpu.utils.torch_convert (JAX layout)
    -> timeunet_state_dict_from_flax gives back every tensor exactly."""
    from crop2seg_tpu.utils.torch_convert import convert_timeunet

    _, sd = load_fixture("timeunet_small")
    back = timeunet_state_dict_from_flax(convert_timeunet(sd, n_stages=3))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):   # not carried by flax
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
