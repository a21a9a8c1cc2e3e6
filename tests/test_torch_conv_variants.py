"""crop2seg_tpu_torch's conv variants (depthwise-separable convs, the
squeeze-excitation gate, instance norm and the MBConv family) against the
JAX package: block by block, in U-TAE and TimeUNet, and on the utae_mbconv
golden.

Blocks: the JAX module's eval output on the same numpy input with its
weights carried across by crop2seg_tpu_torch/utils/convert.py, at 5e-4, the
goldens' tolerance (tests/test_torch_layers.py). Models: widths (16, 16, 32)
(tests/test_ltae_parity.py's SMALL_CFG), 4 heads, d_model 32, B=2, T=7,
16x16 with a padded sample; the SE gates sit at 16 and 32 channels (hidden
widths 1 and 2). Logits within 1e-3 of the JAX model on the XLA route and
on the Pallas route in interpret mode, as tests/test_torch_timeunet.py holds
the plain TimeUNet; pad invariance at 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from crop2seg_tpu.models import TimeUNet as JTimeUNet
from crop2seg_tpu.models import UTAE as JUTAE
from crop2seg_tpu.nn import layers as jl
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.models.utae import UTAE
from crop2seg_tpu_torch.nn import layers as tl
from crop2seg_tpu_torch.utils import convert
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc_seq

BLOCK_TOL = dict(rtol=5e-4, atol=5e-4)
TOL = dict(rtol=1e-3, atol=1e-3)
SMALL = dict(input_dim=10, encoder_widths=(16, 16, 32), decoder_widths=(8, 16, 32),
             out_conv=(8, 5), n_head=4, d_model=32, d_k=4)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_stats(variables, rng):
    """Non-trivial BatchNorm running statistics, so eval BN is exercised."""
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        variables.get("batch_stats", {}))
    return {"params": variables["params"], "batch_stats": stats}


DWS = "depthwise_separable"
# name -> (JAX block, port block, input channels, skip channels or None,
#          converter)
BLOCKS = {
    "conv_dws": (jl.ConvBlock(nkernels=(10, 8, 8), norm="group", conv_type=DWS),
                 tl.ConvBlock((10, 8, 8), norm="group", conv_type=DWS), 10, None,
                 convert.conv_block_state_dict_from_flax),
    "conv_batch_se": (jl.ConvBlock(nkernels=(10, 32, 32), norm="batch", add_squeeze=True),
                      tl.ConvBlock((10, 32, 32), norm="batch", add_squeeze=True), 10,
                      None, convert.conv_block_state_dict_from_flax),
    # 16 channels: the SE's narrowest hidden width, 1 (below 16 the JAX
    # initializer divides by a zero fan)
    "conv_se_16": (jl.ConvBlock(nkernels=(10, 16), norm="group", add_squeeze=True),
                   tl.ConvBlock((10, 16), norm="group", add_squeeze=True), 10, None,
                   convert.conv_block_state_dict_from_flax),
    "conv_instance": (jl.ConvBlock(nkernels=(10, 8, 8), norm="instance"),
                      tl.ConvBlock((10, 8, 8), norm="instance"), 10, None,
                      lambda v: convert.conv_block_state_dict_from_flax(v, "instance")),
    "down_dws_se": (jl.DownConvBlock(d_out=32, norm="group", conv_type=DWS,
                                     add_squeeze=True),
                    tl.DownConvBlock(16, 32, norm="group", conv_type=DWS,
                                     add_squeeze=True), 16, None,
                    convert.down_block_state_dict_from_flax),
    "down_instance": (jl.DownConvBlock(d_out=16, norm="instance"),
                      tl.DownConvBlock(8, 16, norm="instance"), 8, None,
                      lambda v: convert.down_block_state_dict_from_flax(v, "instance")),
    "up_se": (jl.UpConvBlock(d_out=32, norm="batch", add_squeeze=True),
              tl.UpConvBlock(16, 32, 12, norm="batch", add_squeeze=True), 16, 12,
              convert.up_block_state_dict_from_flax),
    "mb_block_group": (jl.MBConvBlock(nkernels=(16, 16, 20)),
                       tl.MBConvBlock((16, 16, 20)), 16, None,
                       convert.conv_block_state_dict_from_flax),
    "mb_block_instance": (jl.MBConvBlock(nkernels=(8, 16), norm="instance"),
                          tl.MBConvBlock((8, 16), norm="instance"), 8, None,
                          convert.conv_block_state_dict_from_flax),
    "mb_down_batch": (jl.MBDownConvBlock(d_out=32, norm="batch"),
                      tl.MBDownConvBlock(16, 32, norm="batch"), 16, None,
                      convert.down_block_state_dict_from_flax),
    "mb_down_dws_group": (jl.MBDownConvBlock(d_out=16, norm="group", conv_type=DWS),
                          tl.MBDownConvBlock(16, 16, norm="group", conv_type=DWS), 16,
                          None, convert.down_block_state_dict_from_flax),
    "mb_up": (jl.MBUpConvBlock(d_out=16, norm="batch"),
              tl.MBUpConvBlock(32, 16, 16, norm="batch"), 32, 16,
              convert.up_block_state_dict_from_flax),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    """Each block's eval output, with non-trivial BatchNorm statistics."""
    jm, tm, c, c_skip, conv = BLOCKS[name]
    rng = np.random.default_rng(sorted(BLOCKS).index(name))
    hw = 8 if c_skip else 16
    args = [rng.standard_normal((3, hw, hw, c)).astype(np.float32)]
    if c_skip:
        args.append(rng.standard_normal((3, 2 * hw, 2 * hw, c_skip)).astype(np.float32))
    v = _perturb_stats(_np(jax.jit(jm.init)(jax.random.PRNGKey(0), *args)), rng)
    want = np.asarray(jax.jit(jm.apply)(v, *args))
    tm.load_state_dict(convert_and_check(conv, v, tm))
    tm.eval()
    with torch.inference_mode():
        got = tm(*map(_t, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


def convert_and_check(conv, v, module):
    """The converted state dict names exactly the module's entries."""
    sd = conv(v)
    assert set(sd) == set(module.state_dict()), set(sd) ^ set(module.state_dict())
    return sd


def test_utae_mbconv_golden():
    arrays, sd = load_fixture("utae_mbconv")
    m = UTAE(input_dim=10, encoder_widths=(16, 16, 128), decoder_widths=(8, 16, 128),
             out_conv=(8, 20), n_head=4, d_model=256, d_k=4, use_mbconv=True).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        y = m(_t(to_nhwc_seq(arrays["x"])), _t(arrays["dates"])).numpy()
    np.testing.assert_allclose(from_nhwc(y), arrays["y"], rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("name", ["utae_mbconv", "conv_block_dws", "conv_block_batch_se"])
def test_converter_inverts_the_jax_package_import(name):
    """Reference state dict -> crop2seg_tpu.utils.torch_convert -> the
    port's converter gives back every tensor exactly."""
    from crop2seg_tpu.utils import torch_convert as tc

    _, sd = load_fixture(name)
    if name == "utae_mbconv":
        v = tc.convert_utae(sd, n_stages=3, use_mbconv=True)
        back = convert.utae_state_dict_from_flax(_np(v))
    else:
        sub = tc.convert_conv_layer(sd, "conv", 2, "any")
        v = {"params": {"conv": sub["params"]}}
        if "batch_stats" in sub:
            v["batch_stats"] = {"conv": sub["batch_stats"]}
        back = convert.conv_block_state_dict_from_flax(_np(v))
    assert set(back) == set(sd)
    for k, want in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)


MODELS = {
    "utae_mbconv": (JUTAE, UTAE, dict(SMALL, out_conv=(8, 20), use_mbconv=True)),
    "utae_dws_se": (JUTAE, UTAE, dict(SMALL, conv_type=DWS, add_squeeze_excit=True)),
    "timeunet_dws_se": (JTimeUNet, TimeUNet,
                        dict(SMALL, conv_type=DWS, add_squeeze_excit=True)),
    "timeunet_instance": (JTimeUNet, TimeUNet, dict(SMALL, encoder_norm="instance")),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """One JAX init and two applies (XLA, and the Pallas kernel in
    interpret mode) per model."""
    jcls, tcls, kw = MODELS[request.param]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 16, 16, 10)).astype(np.float32)
    pad = np.zeros((2, 7), bool)
    pad[1, 5:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(7) * 9.0 + 4).astype(np.float32), (2, 1))
    m = jcls(**kw)
    v = jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                 train=False))(x)
    v = _perturb_stats(_np(v), rng)
    y = np.asarray(jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad,
                                                train=False))(v, x))
    y_pallas = np.asarray(jcls(**kw, use_pallas=True).apply(v, x, dates, pad_mask=pad,
                                                            train=False))
    model = tcls(**kw).eval()
    model.load_state_dict(convert.utae_state_dict_from_flax(
        v, encoder_norm=kw.get("encoder_norm", "group")))
    return dict(name=request.param, x=x, pad=pad, dates=dates, y=y,
                y_pallas=y_pallas, v=v, model=model)


def _run(case, x=None, fused=False):
    with torch.inference_mode():
        return case["model"](_t(case["x"] if x is None else x), _t(case["dates"]),
                             _t(case["pad"]), fused=fused).numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_model_matches_jax(case, fused):
    """The plain L-TAE and the kernel route (its plain version on the CPU)
    both match the JAX model's XLA route."""
    got = _run(case, fused=fused)
    assert got.shape == case["y"].shape
    np.testing.assert_allclose(got, case["y"], **TOL)


def test_model_matches_jax_pallas_interpret(case):
    """The JAX model with use_pallas=True (kernel 1 in interpret mode:
    untailed at TimeUNet's width, the attention out at U-TAE's) against the
    port's kernel route."""
    np.testing.assert_allclose(_run(case, fused=True), case["y_pallas"], **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_model_pad_invariance(case, fused):
    noisy = case["x"].copy()
    noisy[case["pad"]] = np.random.default_rng(9).standard_normal(
        noisy[case["pad"]].shape).astype(np.float32) * 50.0
    np.testing.assert_allclose(_run(case, noisy, fused), _run(case, fused=fused),
                               rtol=1e-6, atol=1e-6)


def test_flax_param_paths_cover_the_jax_params(case):
    """Every parameter maps to a distinct flax parameter, and every flax
    parameter is reached (what freeze_labels relies on)."""
    paths = convert.flax_param_paths(case["model"])
    flat = {"/".join(str(k.key) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(case["v"]["params"])[0]}
    assert sorted(paths.values()) == sorted(flat)


class _Recorder:
    """Wraps the L-TAE's forward and the pool ops and records what the
    model asks of them."""

    def __init__(self, monkeypatch, model):
        import crop2seg_tpu_torch.nn.ltae as tltae

        self.tails, self.pools = [], []
        te = model.temporal_encoder
        orig = te.forward

        def forward(*a, tail_affine=None, **kw):
            self.tails.append(tail_affine is not None)
            return orig(*a, tail_affine=tail_affine, **kw)
        monkeypatch.setattr(te, "forward", forward)
        for name in ("ltae_pool", "ltae_pool_tail"):
            fn = getattr(tltae, name)

            def pool(*a, _fn=fn, _name=name, **kw):
                self.pools.append(_name)
                return _fn(*a, **kw)
            monkeypatch.setattr(tltae, name, pool)


@pytest.mark.parametrize("name", ["timeunet_dws_se", "timeunet_instance"])
def test_timeunet_variants_keep_the_tail_in_in_conv(name, monkeypatch):
    """The JAX gate (crop2seg_tpu/models/timeunet.py:95-100): with
    depthwise-separable convs, an SE gate or instance norm in in_conv, the
    kernel route takes the L-TAE untailed: in eval (kernel 1) and in
    training (the ltae_pool pair, not ltae_pool_tail)."""
    torch.manual_seed(0)
    model = TimeUNet(**MODELS[name][2]).eval()
    rec = _Recorder(monkeypatch, model)
    assert not model._tail_deferrable
    x, dates = torch.randn(2, 3, 16, 16, 10), torch.zeros(2, 3)
    with torch.inference_mode():
        model(x, dates, fused=True)
    model.train()
    model(x, dates, fused=True, generator=torch.Generator().manual_seed(0)).sum().backward()
    assert rec.tails == [False, False] and rec.pools == ["ltae_pool"]


def test_plain_timeunet_still_defers_its_tail(monkeypatch):
    """The gate leaves the plain TimeUNet's deferral as it was."""
    model = TimeUNet(**SMALL).eval()
    rec = _Recorder(monkeypatch, model)
    with torch.inference_mode():
        model(torch.randn(1, 3, 16, 16, 10), torch.zeros(1, 3), fused=True)
    assert rec.tails == [True]


def test_factory_builds_the_variants():
    """get_model passes conv_type, add_squeeze and use_mbconv on, as the JAX
    factory does."""
    g = torch.Generator().manual_seed(0)
    m = get_model({"model": "utae", "use_mbconv": True, "out_conv": [32, 20]},
                  device="cpu", generator=g)
    assert isinstance(m.in_conv, tl.MBConvBlock)
    assert all(isinstance(b, tl.MBDownConvBlock) for b in m.down_blocks)
    assert all(isinstance(b, tl.MBUpConvBlock) for b in m.up_blocks)
    m = get_model({"model": "timeunet", "conv_type": DWS, "add_squeeze": True},
                  device="cpu", generator=g)
    units = list(m.in_conv.conv.conv)
    assert isinstance(units[0], tl.DepthwiseSeparableConv2d)
    assert isinstance(units[-1], tl.SqueezeAndExcitation)
    assert units[-1].sae[1].weight.shape == (4, 64)
    assert all(b.sae is not None for b in m.down_blocks)
    m = get_model({"model": "timeunet", "encoder_norm": "instance"}, device="cpu")
    assert isinstance(m.in_conv.conv.conv[1], tl.InstanceNorm2d)
    assert not m._tail_deferrable
    with pytest.raises(ValueError, match="conv_type"):
        get_model({"model": "utae", "conv_type": "3d"}, device="cpu")


def test_reflect_conv_in_chunks_equals_one_call(monkeypatch):
    """Frames whose padded size passes CUDA's 32-bit reflection pad are
    padded and convolved in chunks (MBConv's expansion at B = 10 over a
    tile): the result is the one call's, bit for bit."""
    conv = tl.Conv2d(8, 8, 3, padding=1, groups=8, padding_mode="reflect")
    x = torch.randn(7, 12, 12, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = conv(x)
        monkeypatch.setattr(tl, "MAX_PAD_ELEMENTS", 3 * 8 * 14 * 14)
        got = conv(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
