"""crop2seg_tpu_torch TimeUNet against the JAX TimeUNet (use_pallas=False) on
the same converted weights and the same numpy inputs, against the
timeunet_small golden, and its two paths against each other.

Sizes as tests/test_ltae_pallas.py:208-214 (widths (16, 16, 32), 4 heads,
d_model 32, B=2, T=7, 16x16, a pad); tolerance 1e-3 as there. The golden
takes 5e-4, as tests/test_ltae_parity.py holds the JAX model to it.
"""
import copy

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
    att = np.asarray(jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad, train=False,
                                                  return_att=True))(v, x)[1])
    maps = jax.jit(lambda v, x: JTimeUNet(**KW, return_maps=True).apply(
        v, x, dates, pad_mask=pad, train=False))(v, x)[1]
    model = TimeUNet(**KW).eval()
    model.load_state_dict(timeunet_state_dict_from_flax(v))
    return dict(x=x, pad=pad, dates=dates, y=y, att=att,
                maps=[np.asarray(a) for a in maps], model=model)


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


@pytest.mark.parametrize("fused", [False, True])
def test_att_maps_and_encoder_outputs_match_jax(case, fused):
    """``return_att`` gives the JAX attention (1e-5) beside the logits,
    ``return_maps`` the JAX maps (1e-3), and ``encoder`` the decoder output
    and the same maps, whose out_conv is the logits; on the kernel route
    the attention comes out of the same deferred-tail call."""
    m = case["model"]
    with torch.inference_mode():
        args = (_t(case["x"]), _t(case["dates"]), _t(case["pad"]))
        logits, att = m(*args, fused=fused, return_att=True)
        try:
            m.return_maps = True
            _, maps = m(*args, fused=fused)
            m.return_maps, m.encoder = False, True
            out, maps2 = m(*args, fused=fused)
        finally:
            m.return_maps = m.encoder = False
        head = m.out_conv(out)
    np.testing.assert_allclose(logits.numpy(), case["y"], **TOL)
    assert att.shape == (2, 16, 16, 4, 7)
    np.testing.assert_allclose(att.numpy(), case["att"], rtol=1e-5, atol=1e-5)
    assert [tuple(a.shape) for a in maps] == [a.shape for a in case["maps"]]
    for g, w in zip(maps, case["maps"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    for a, b in zip(maps, maps2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(head, logits, rtol=0, atol=0)


def test_train_mode_return_att_takes_the_plain_ltae(case):
    """In training ``return_att`` takes the plain L-TAE with the attention
    (the JAX route), so in_conv's tail is not deferred even on the kernel
    route; the attention is the dropped one, finite, and zero at pads."""
    m = copy.deepcopy(case["model"]).train()    # training updates BN statistics
    logits, att = m(_t(case["x"]), _t(case["dates"]), _t(case["pad"]), fused=True,
                    return_att=True, generator=torch.Generator().manual_seed(0))
    assert logits.requires_grad and torch.isfinite(att).all()
    assert att[1, ..., 5:].abs().max().item() == 0.0


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


@pytest.mark.parametrize("cfg", [{"model": "timeunet_v2"},
                                 {"model": "convlstm"}, {"model": "unet3d"}],
                         ids=["timeunet_v2", "convlstm", "unet3d"])
def test_factory_other_models_point_at_roadmap(cfg):
    """The rest of the zoo (TimeUNet_v2, the recurrent and 3D models) builds
    at the factory's defaults, in eval mode, and serves a padded series."""
    m = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not m.training
    x = torch.randn(1, 4, 16, 16, 10)
    pad = torch.tensor([[False, False, False, True]])
    x[pad] = 0.0
    with torch.inference_mode():
        out = m(x, torch.arange(4.0)[None] * 10, pad)
    assert out.shape == (1, 16, 16, 15) and torch.isfinite(out).all()


def test_training_mode_raises_naming_slice_d():
    """Training mode runs (slice D's training step) and is differentiable,
    with the deferred in_conv tail too (ltae_pool_tail, on both the kernel
    wrapper and the plain version). The L-TAE's attention output in training
    takes the plain ops (the JAX route), so the deferred tail, which only the
    kernel paths apply, raises there."""
    m = TimeUNet(**KW)                        # a new module trains
    out = m(torch.randn(1, 2, 16, 16, 10), torch.zeros(1, 2))
    assert out.shape == (1, 16, 16, 5) and out.requires_grad
    te, h = m.temporal_encoder, torch.randn(1, 2, 4, 4, 16)
    tail = (torch.ones(1, 2, 16), torch.zeros(1, 2, 16))
    for fused in (True, False):
        out, attn = te(h, torch.zeros(1, 2), need_attn=False, tail_affine=tail,
                       fused=fused)
        assert out.shape == (1, 4, 4, 16) and out.requires_grad and attn is None
    out, attn = te(h, torch.zeros(1, 2))
    assert attn.shape == (1, 4, 4, 4, 2) and attn.requires_grad
    with pytest.raises(ValueError, match="tail_affine needs a kernel path"):
        te(h, torch.zeros(1, 2), tail_affine=tail)


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
