"""crop2seg_tpu_torch U-TAE against the JAX U-TAE on the same converted
weights and the same numpy inputs (the XLA path, and the Pallas kernel path
in interpret mode), against the utae_small and utae_boundary_absrel goldens,
and its pad invariance.

Size: B=2, T=7, 32x32x10 with a padded sample, widths (16, 16, 128) /
(8, 16, 128), 16 heads, d_model 256: the L-TAE runs at C = 128 with its
attention output, the mode the fused kernel serves in U-TAE. Tolerances:
logits 1e-3, as tests/test_ltae_pallas.py holds the kernel path to the XLA
one; attention 1e-5 (an fp32 softmax of the same scores); the goldens 5e-4,
as tests/test_ltae_parity.py holds the JAX model to them.
"""
import jax
import numpy as np
import pytest
import torch

from crop2seg_tpu.models import UTAE as JUTAE
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.utae import UTAE
from crop2seg_tpu_torch.utils.convert import utae_state_dict_from_flax
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc_seq

KW = dict(input_dim=10, encoder_widths=(16, 16, 128), decoder_widths=(8, 16, 128),
          out_conv=(8, 5), n_head=16, d_model=256, d_k=4)
TOL = dict(rtol=1e-3, atol=1e-3)
UTAE_CFG = dict(input_dim=10, encoder_widths=(16, 16, 128),
                decoder_widths=(8, 16, 128), out_conv=(8, 5),
                n_head=4, d_model=256, d_k=4, pad_value=0.0)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def case():
    """One JAX init and two applies (XLA, and the Pallas kernel in interpret
    mode), shared by the file."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 32, 32, 10)).astype(np.float32)
    pad = np.zeros((2, 7), bool)
    pad[1, 5:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(7) * 9.0 + 4).astype(np.float32), (2, 1))
    m = JUTAE(**KW)
    v = jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                 train=False))(x)
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": jax.tree_util.tree_map(  # non-trivial BN statistics
             lambda a: np.abs(np.asarray(a) + 0.3 * rng.standard_normal(a.shape)
                              ).astype(np.float32), v["batch_stats"])}
    # the query at a quarter of its initial scale: drawn as initialized, the
    # scores over 256 model channels reach tens and the softmax saturates,
    # so a 1e-7 relative rounding difference of the convolved features moves
    # single attention weights by 2e-5
    att_p = v["params"]["temporal_encoder"]["attention"]
    att_p["query"] = att_p["query"] * np.float32(0.25)
    y, att = jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad, train=False,
                                          return_att=True))(v, x)
    mp = JUTAE(**KW, use_pallas=True)
    y_pallas = mp.apply(v, x, dates, pad_mask=pad, train=False)
    model = UTAE(**KW).eval()
    model.load_state_dict(utae_state_dict_from_flax(v))
    return dict(x=x, pad=pad, dates=dates, y=np.asarray(y), att=np.asarray(att),
                y_pallas=np.asarray(y_pallas), model=model)


def _run(case, x=None, fused=False, **kw):
    with torch.inference_mode():
        return case["model"](_t(case["x"] if x is None else x), _t(case["dates"]),
                             _t(case["pad"]), fused=fused, **kw)


@pytest.mark.parametrize("fused", [False, True])
def test_matches_jax_utae(case, fused):
    """Plain L-TAE and the kernel path (its plain version on the CPU) both
    match JAX, logits and attention."""
    got, att = _run(case, fused=fused, return_att=True)
    assert got.shape == (2, 32, 32, 5) and att.shape == (2, 8, 8, 16, 7)
    np.testing.assert_allclose(got.numpy(), case["y"], **TOL)
    np.testing.assert_allclose(att.numpy(), case["att"], rtol=1e-5, atol=1e-5)


def test_matches_jax_utae_pallas_interpret(case):
    """The JAX U-TAE with use_pallas=True (kernel 1 in interpret mode, C=128,
    attention out) against the port's plain path."""
    np.testing.assert_allclose(_run(case).numpy(), case["y_pallas"], **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_pad_invariance(case, fused):
    """Garbage in the pad frames changes nothing: temporally_shared overwrites
    them after every shared block, and the L-TAE and the aggregator mask
    them. Tolerance 1e-6: the same ops on the same valid frames."""
    noisy = case["x"].copy()
    noisy[case["pad"]] = np.random.default_rng(9).standard_normal(
        noisy[case["pad"]].shape).astype(np.float32) * 50.0
    np.testing.assert_allclose(_run(case, noisy, fused).numpy(),
                               _run(case, fused=fused).numpy(), rtol=1e-6, atol=1e-6)


def test_encoder_and_maps_outputs(case):
    """``encoder`` returns the decoder output and its maps, ``return_maps``
    the logits and the same maps; out_conv of the decoder output is the
    logits."""
    m = case["model"]
    logits = _run(case)
    try:
        m.encoder = True
        out, maps = _run(case)
        m.encoder, m.return_maps = False, True
        logits2, maps2 = _run(case)
    finally:
        m.encoder = m.return_maps = False
    assert [tuple(a.shape) for a in maps] == [(2, 8, 8, 128), (2, 16, 16, 16),
                                              (2, 32, 32, 8)]
    torch.testing.assert_close(maps[-1], out, rtol=0, atol=0)
    for a, b in zip(maps, maps2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.inference_mode():
        torch.testing.assert_close(m.out_conv(out), logits, rtol=0, atol=0)
    torch.testing.assert_close(logits2, logits, rtol=0, atol=0)


@pytest.mark.parametrize("name,extra", [
    ("utae_small", {}),
    ("utae_boundary_absrel", {"add_boundary_loss": True, "use_abs_rel_enc": True})])
def test_golden(name, extra):
    arrays, sd = load_fixture(name)
    m = UTAE(**UTAE_CFG, **extra).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        out = m(_t(to_nhwc_seq(arrays["x"])), _t(arrays["dates"]))
    ys = out if extra else (out,)
    for key, y in zip(("y", "y_b"), ys):
        np.testing.assert_allclose(from_nhwc(y.numpy()), arrays[key], rtol=5e-4,
                                   atol=5e-4, err_msg=f"{name}.{key}")


def test_converter_inverts_the_jax_package_import():
    """Reference state dict -> crop2seg_tpu.utils.torch_convert.convert_utae
    -> utae_state_dict_from_flax gives back every tensor exactly, the
    boundary head and the absolute encoder included."""
    from crop2seg_tpu.utils.torch_convert import convert_utae

    _, sd = load_fixture("utae_boundary_absrel")
    v = convert_utae(sd, n_stages=3, use_abs_rel_enc=True, add_boundary=True)
    back = utae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v))
    assert set(back) == set(sd)
    for k, want in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)


def test_factory_builds_utae_at_the_jax_defaults():
    m = get_model({"model": "utae", "use_pallas": True, "remat": True},
                  device="cpu", generator=torch.Generator().manual_seed(5))
    assert isinstance(m, UTAE) and not m.training and m.boundary_conv is None
    te = m.temporal_encoder
    assert te.in_norm.num_channels == 128 and te.mlp[0].weight.shape == (128, 256)
    assert (te.n_head, te.d_model, te.d_k) == (16, 256, 4)
    assert [b.conv2.conv[0].out_channels for b in m.down_blocks] == [64, 64, 128]
    assert [b.conv2.conv[0].out_channels for b in m.up_blocks] == [64, 32, 32]
    assert m.out_conv.conv.conv[3].weight.shape == (15, 32, 3, 3)
    assert get_model({"model": "utae", "add_boundary_loss": True},
                     device="cpu").boundary_conv is not None
    mb = get_model({"model": "utae", "use_mbconv": True, "out_conv": [32, 20]},
                   device="cpu")
    assert type(mb.in_conv).__name__ == "MBConvBlock"
    assert {type(b).__name__ for b in mb.down_blocks} == {"MBDownConvBlock"}
    assert {type(b).__name__ for b in mb.up_blocks} == {"MBUpConvBlock"}
    assert mb.out_conv.conv.conv[1][0][0][0][7].weight.shape == (20, 128, 1, 1)


def test_training_mode_raises_naming_roadmap():
    """U-TAE trains (tests/test_torch_utae_train.py); what its training still
    lacks raises and names ROADMAP.md: the boundary head's loss, so
    make_train_step refuses a model that returns a tuple."""
    from crop2seg_tpu_torch.learning.trainer import StepConfig, make_train_step

    m = UTAE(**UTAE_CFG)                      # a new module trains
    logits = m(torch.randn(1, 2, 16, 16, 10), torch.zeros(1, 2))
    assert logits.shape == (1, 16, 16, 5) and logits.requires_grad
    step = make_train_step(UTAE(**UTAE_CFG, add_boundary_loss=True),
                           StepConfig(num_classes=5), device="cpu")
    batch = {"x": np.ones((1, 2, 16, 16, 10), np.float32),
             "dates": np.zeros((1, 2), np.float32),
             "pad_mask": np.zeros((1, 2), bool), "y": np.zeros((1, 16, 16), np.int64)}
    with pytest.raises(ValueError, match="ROADMAP"):
        step(batch, torch.Generator())
