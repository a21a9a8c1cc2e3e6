"""crop2seg_tpu_torch W-TAE and its LTAE4WTAE against the JAX package: the
goldens, eval outputs, training, remat, the tile predictor, serving from
disk and the train CLI, on the CPU.

Size: widths (16, 16, 32) / (8, 16, 32), out_conv (8, 5), 4 heads, d_model
32 (tests/test_ltae_parity.py's SMALL_CFG), B=2, T=7, 32x32 with a padded
sample; the JAX weights carried across by crop2seg_tpu_torch/utils/convert.py.
Tolerances: the goldens 5e-4, as tests/test_ltae_parity.py holds the JAX
modules to them; the attention masks 1e-5 (an fp32 softmax of the same
scores); whole-model outputs 1e-3, as tests/test_torch_utae.py holds U-TAE;
training at tests/test_torch_train.py's bounds.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.nn.ltae as jltae
from crop2seg_tpu.learning import trainer as jtrainer
from crop2seg_tpu.models import WTAE as JWTAE
from crop2seg_tpu_torch.learning.trainer import (
    StepConfig, _metrics, make_train_step)
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.wtae import WTAE
from crop2seg_tpu_torch.nn import layers as tl
from crop2seg_tpu_torch.nn.ltae import LTAE4WTAE
from crop2seg_tpu_torch.utils.convert import (
    flax_param_paths, ltae_state_dict_from_flax, wtae_state_dict_from_flax)
from tests.parity_utils import attn_from_torch, from_nhwc, load_fixture, to_nhwc_seq
from tests.test_torch_train import BF16_LOSS_RTOL, TOL as TRAIN_TOL
from tests.test_torch_train import _assert_model_grads, _np, _stats, _t

SMALL = dict(input_dim=10, encoder_widths=(16, 16, 32), decoder_widths=(8, 16, 32),
             out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
TOL = dict(rtol=1e-3, atol=1e-3)
ATT_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b=2, t=7, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, hw, hw, 10)).astype(np.float32)
    pad = np.zeros((b, t), bool)
    pad[-1, t - 2:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(t) * 9.0 + 4).astype(np.float32), (b, 1))
    return x, pad, dates


# --- the goldens ----------------------------------------------------------

def test_ltae4wtae_golden():
    arrays, sd = load_fixture("ltae4wtae")
    m = LTAE4WTAE(in_channels=32, n_head=8, d_k=4, d_model=64).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        attn = m(_t(to_nhwc_seq(arrays["x"])), _t(arrays["dates"]),
                 _t(arrays["pad_mask"])).numpy()
    np.testing.assert_allclose(attn, attn_from_torch(arrays["attn"]), rtol=5e-4, atol=5e-4)


def test_wtae_golden():
    arrays, sd = load_fixture("wtae_small")
    m = WTAE(**SMALL, add_boundary_loss=True).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        y, y_b = m(_t(to_nhwc_seq(arrays["x"])), _t(arrays["dates"]))
    np.testing.assert_allclose(from_nhwc(y.numpy()), arrays["y"], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(from_nhwc(y_b.numpy()), arrays["y_b"], rtol=5e-4, atol=5e-4)


def test_converter_inverts_the_jax_package_import():
    """Reference state dict -> crop2seg_tpu.utils.torch_convert.convert_wtae
    -> wtae_state_dict_from_flax gives back every tensor exactly."""
    from crop2seg_tpu.utils.torch_convert import convert_wtae

    _, sd = load_fixture("wtae_small")
    v = convert_wtae(sd, n_stages=3, add_boundary=True)
    back = wtae_state_dict_from_flax(_np(v))
    assert set(back) == set(sd)
    for k, want in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)


# --- LTAE4WTAE against the JAX module ---------------------------------------

@pytest.mark.parametrize("enc", ["sinusoid", "doy", "abs_rel", "linear"])
def test_ltae4wtae_matches_jax(enc):
    kw = {"sinusoid": {}, "doy": {"use_doy": True}, "abs_rel": {"use_abs_rel_enc": True},
          "linear": {"add_linear": True}}[enc]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 4, 32)).astype(np.float32)
    pad = np.zeros((2, 9), bool)
    pad[1, 6:] = True
    dates = np.sort(rng.integers(0, 365, (2, 9)), axis=1).astype(np.float32)
    if enc == "abs_rel":
        dates = np.stack([dates, dates + 3.0], -1)
    jm = jltae.LTAE4WTAE(in_channels=32, n_head=8, d_k=4, d_model=64, **kw)
    v = _np(jax.jit(lambda x: jm.init(jax.random.PRNGKey(2), x, dates, pad_mask=pad))(x))
    v["params"]["in_norm_scale"] = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, dates, pad_mask=pad))(v, x))
    m = LTAE4WTAE(in_channels=32, n_head=8, d_k=4, d_model=64, **kw).eval()
    m.load_state_dict(ltae_state_dict_from_flax(v))
    with torch.inference_mode():
        got = m(_t(x), _t(dates), _t(pad)).numpy()
    assert got.shape == (2, 4, 4, 8, 9)
    np.testing.assert_allclose(got, want, **ATT_TOL)
    assert np.abs(got[1, ..., 6:]).max() == 0.0


def test_ltae4wtae_train_mode_drops_attention():
    """Training mode drops attention weights after the softmax (rate 0.1,
    masks from the generator) and rescales the kept ones; eval does not."""
    torch.manual_seed(0)
    m = LTAE4WTAE(in_channels=16, n_head=4, d_k=4, d_model=16)
    x, dates = torch.randn(2, 6, 8, 8, 16), torch.zeros(2, 6)
    with torch.no_grad():
        eval_att = m.eval()(x, dates)
        a = m.train()(x, dates, generator=torch.Generator().manual_seed(1))
        b = m(x, dates, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert 0.85 < kept.float().mean().item() < 0.95
    torch.testing.assert_close(a[kept], eval_att[kept] / 0.9)
    with pytest.raises(ValueError, match="num_queries"):
        WTAE(**SMALL, num_queries=2)


# --- W-TAE against the JAX model --------------------------------------------

VARIANTS = {
    "boundary": dict(SMALL, add_boundary_loss=True),
    "mbconv": dict(SMALL, out_conv=(8, 20), use_mbconv=True),
    "dws_se_instance": dict(SMALL, encoder_widths=(16, 32, 32), conv_type="depthwise_separable",
                            add_squeeze_excit=True, encoder_norm="instance"),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def case(request):
    kw = VARIANTS[request.param]
    x, pad, dates = _inputs()
    m = JWTAE(**kw)
    v = jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                 train=False))(x)
    rng = np.random.default_rng(3)
    v = {"params": _np(v["params"]),
         "batch_stats": jax.tree_util.tree_map(  # non-trivial BN statistics
             lambda a: np.abs(np.asarray(a) + 0.3 * rng.standard_normal(a.shape)
                              ).astype(np.float32), v["batch_stats"])}
    apply = jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad, train=False,
                                         return_att=True))
    out = [np.asarray(a) for a in apply(v, x)]
    maps = jax.jit(lambda v, x: JWTAE(**kw, return_maps=True).apply(
        v, x, dates, pad_mask=pad, train=False))(v, x)[-1]
    model = WTAE(**kw).eval()
    model.load_state_dict(wtae_state_dict_from_flax(v, kw.get("encoder_norm", "group")))
    return dict(name=request.param, kw=kw, x=x, pad=pad, dates=dates, out=out,
                maps=[np.asarray(a) for a in maps], v=v, model=model)


def _run(case, x=None, **kw):
    with torch.inference_mode():
        return case["model"](_t(case["x"] if x is None else x), _t(case["dates"]),
                             _t(case["pad"]), **kw)


def test_wtae_matches_jax(case):
    """Logits (and the boundary head's), and the attention masks of the same
    forward (``return_att``)."""
    got = _run(case, return_att=True)
    assert len(got) == len(case["out"])
    for g, w in zip(got[:-1], case["out"][:-1]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert got[-1].shape == (2, 8, 8, 4, 7)
    np.testing.assert_allclose(got[-1].numpy(), case["out"][-1], **ATT_TOL)


def test_wtae_maps_and_encoder_outputs(case):
    """``return_maps`` gives the JAX maps; ``encoder`` returns the decoder
    output and the same maps; out_conv of it is the logits."""
    m = case["model"]
    logits = _run(case)
    logits = logits[0] if isinstance(logits, tuple) else logits
    try:
        m.return_maps = True
        maps = _run(case)[-1]
        m.return_maps, m.encoder = False, True
        out, maps2 = _run(case)
    finally:
        m.return_maps = m.encoder = False
    assert [tuple(a.shape) for a in maps] == [a.shape for a in case["maps"]]
    for g, w in zip(maps, case["maps"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    for a, b in zip(maps, maps2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.inference_mode():
        torch.testing.assert_close(m.out_conv(out), logits, rtol=0, atol=0)


def test_wtae_pad_invariance(case):
    """Garbage in the pad frames changes nothing: temporally_shared
    overwrites them after in_conv and each reduction block, and the
    attention and the aggregator mask them. Tolerance 1e-6."""
    noisy = case["x"].copy()
    noisy[case["pad"]] = np.random.default_rng(9).standard_normal(
        noisy[case["pad"]].shape).astype(np.float32) * 50.0
    for a, b in zip(_run(case, noisy, return_att=True), _run(case, return_att=True)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_flax_param_paths_cover_the_jax_params(case):
    paths = flax_param_paths(case["model"])
    flat = {"/".join(str(k.key) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(case["v"]["params"])[0]}
    assert sorted(paths.values()) == sorted(flat)


# --- training ----------------------------------------------------------------

TRAIN_KW = dict(SMALL, out_conv=(8, 15), add_boundary_loss=True)
WEIGHTS = (1.0,) * 14 + (0.0,)
N_STEPS = 3


class _NoAttnDropout:
    """The JAX W-TAE with its attention dropout at 0, for the block: the
    name ``LTAE4WTAE`` builds its attention from is swapped."""

    def __enter__(self):
        self.orig = jltae.MaskedLightweightAttention
        jltae.MaskedLightweightAttention = functools.partial(self.orig, attn_dropout=0.0)
        return JWTAE(**TRAIN_KW)

    def __exit__(self, *exc):
        jltae.MaskedLightweightAttention = self.orig


@pytest.fixture(scope="module")
def train_case():
    """The batch, the initial variables, the JAX train-mode loss, gradients
    and statistics of one forward, and three jitted JAX train steps (Adam),
    with the boundary loss."""
    x, pad, _ = _inputs(hw=16)
    rng = np.random.default_rng(0)
    batch = {"x": x, "pad_mask": pad, "y": rng.integers(0, 15, (2, 16, 16)),
             "dates": np.sort(rng.integers(0, 300, (2, 7))).astype(np.float32)}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    cfg = jtrainer.StepConfig(num_classes=15, class_weights=WEIGHTS, add_boundary_loss=True)
    with _NoAttnDropout() as m:
        v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, batch["dates"],
                                         pad_mask=pad, train=False))(x))

        def loss(params):
            val, (stats, _) = jtrainer._loss_and_metrics(
                m, cfg, params, v["batch_stats"], jb, True,
                {"dropout": jax.random.PRNGKey(5)})
            return val, stats

        (val, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        state = jtrainer.create_train_state(m, v, 1e-3)
        step = jax.jit(jtrainer.make_train_step(m, cfg))
        losses = []
        for i in range(N_STEPS):
            state, aux = step(state, jb, jax.random.PRNGKey(i))
            losses.append(float(aux["loss"]))
    return dict(batch=batch, v=v, loss=float(val), grads=_np(grads), stats=_np(stats),
                losses=losses, cm=np.asarray(aux["cm"]), cm_b=np.asarray(aux["cm_b"]),
                after={"params": _np(state.params), "batch_stats": _np(state.batch_stats)})


STEP_CFG = StepConfig(num_classes=15, class_weights=WEIGHTS, add_boundary_loss=True)


def _port_model(c, **kw):
    model = WTAE(**TRAIN_KW, **kw)
    model.load_state_dict(wtae_state_dict_from_flax(c["v"]))
    model.temporal_encoder.attn_dropout = 0.0
    return model


def _loss(model, c, **kw):
    bt = {k: _t(a) for k, a in c["batch"].items()}
    out = model(bt["x"], bt["dates"], bt["pad_mask"], **kw)
    return _metrics(STEP_CFG, out, bt["y"], _t(np.asarray(WEIGHTS, np.float32)))["loss"]


def test_train_mode_matches_jax(train_case):
    """One train-mode forward and backward with the boundary loss: the
    loss, every parameter gradient and the updated running statistics."""
    model = _port_model(train_case).train()
    loss = _loss(model, train_case)
    loss.backward()
    np.testing.assert_allclose(loss.item(), train_case["loss"], **TRAIN_TOL)
    want = wtae_state_dict_from_flax({"params": train_case["grads"],
                                      "batch_stats": train_case["stats"]})
    _assert_model_grads({k: p.grad.numpy() for k, p in model.named_parameters()},
                        {k: want[k].numpy() for k, _ in model.named_parameters()})
    got = model.state_dict()
    for k, w in _stats(want).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **TRAIN_TOL, err_msg=k)


def test_train_steps_match_jax(train_case):
    """make_train_step (Adam, lr 1e-3) over three steps: the losses, the last
    confusion matrices and every parameter and statistic after the last step
    (bounds as tests/test_torch_utae_train.py sets them)."""
    model = _port_model(train_case)
    step = make_train_step(model, STEP_CFG, device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(N_STEPS):
        aux = step(train_case["batch"], gen)
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, train_case["losses"], rtol=1e-5)
    np.testing.assert_array_equal(aux["cm"].numpy(), train_case["cm"])
    np.testing.assert_array_equal(aux["cm_b"].numpy(), train_case["cm_b"])
    want = wtae_state_dict_from_flax(train_case["after"])
    before = wtae_state_dict_from_flax(train_case["v"])
    got = model.state_dict()
    grads = {k: p.grad for k, p in model.named_parameters()}
    top = max(g.abs().max().item() for g in grads.values())
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in grads and grads[k].abs().max().item() <= 1e-6 * top:
            assert (got[k] - before[k]).abs().max().item() <= N_STEPS * 1e-3 * 1.01, k
            continue
        if k.endswith("running_mean"):
            tol = dict(rtol=0, atol=1.2e-3 + 5e-4)
        else:
            tol = TRAIN_TOL if "running_" in k else dict(rtol=0, atol=2e-4)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **tol, err_msg=k)
    assert got["up_blocks.0.up.1.num_batches_tracked"].item() == N_STEPS


def test_bf16_train_step(train_case):
    """make_train_step(dtype=torch.bfloat16) on the CPU (autocast): finite
    losses over two steps, the first within BF16_LOSS_RTOL of JAX's fp32
    one; parameters stay fp32."""
    model = _port_model(train_case)
    step = make_train_step(model, STEP_CFG, device="cpu", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(train_case["batch"], gen)["loss"]) for _ in range(2)]
    assert np.isfinite(losses).all()
    assert abs(losses[0] - train_case["losses"][0]) <= BF16_LOSS_RTOL * train_case["losses"][0]
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("policy", ["conv_out", "full"])
def test_remat_gradients_equal_no_remat(train_case, policy):
    """remat (in_conv, the reduction pyramid and the down blocks
    checkpointed) gives the loss, the gradients and the running statistics
    of the same step without remat, bit for bit on the CPU, attention
    dropout on (the same generator). encoder_norm="batch" puts BatchNorm
    inside every checkpointed block."""
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = WTAE(**TRAIN_KW, encoder_norm="batch", remat=remat,
                     remat_policy=policy).train()
        loss = _loss(model, train_case, generator=torch.Generator().manual_seed(3))
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in model.named_parameters()},
                     {k: v for k, v in model.state_dict().items() if "running_" in k
                      or "num_batches" in k}))
    (l0, g0, s0), (l1, g1, s1) = runs
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0, msg=k)
    assert s1["spatial_reduction.0.down.conv.1.num_batches_tracked"].item() == 1
    assert s1["in_conv.conv.conv.1.num_batches_tracked"].item() == 1


# --- the factory, the reference init ---------------------------------------

def test_factory_builds_wtae_at_the_jax_defaults():
    m = get_model({"model": "wtae", "remat": True}, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    assert isinstance(m, WTAE) and not m.training and m.boundary_conv is None
    assert m.remat and m.remat_policy == "conv_out"
    te = m.temporal_encoder
    assert te.in_norm.num_channels == 128 and te.inconv.weight.shape == (256, 128, 1)
    assert (te.n_head, te.d_model, te.d_k) == (16, 256, 4)
    assert not hasattr(te, "mlp")
    for blk in m.spatial_reduction:
        assert isinstance(blk.down.conv[0], tl.DepthwiseSeparableConv2d)
    assert [b.conv2.conv[0].out_channels for b in m.down_blocks] == [64, 64, 128]
    assert [b.conv2.conv[0].out_channels for b in m.up_blocks] == [64, 32, 32]
    assert m.out_conv.conv.conv[3].weight.shape == (15, 32, 3, 3)
    assert get_model({"model": "wtae", "add_boundary_loss": True},
                     device="cpu").boundary_conv is not None
    mb = get_model({"model": "wtae", "use_mbconv": True, "out_conv": [32, 20]}, device="cpu")
    assert isinstance(mb.spatial_reduction[0], tl.MBDownConvBlock)
    assert isinstance(mb.spatial_reduction[0].down.conv[0], tl.DepthwiseSeparableConv2d)


def test_init_weights_draws_the_new_modules():
    """The seeded models' init (factory.py::init_weights) redraws the
    depthwise and pointwise convs and the bias-free SE Linears with
    PyTorch's default scheme (Kaiming-uniform, bound 1/sqrt(fan_in)), from
    the generator alone."""
    from crop2seg_tpu_torch.models.factory import init_weights

    kw = dict(input_dim=10, encoder_widths=(64, 64), decoder_widths=(64, 64),
              out_conv=(32, 16), add_squeeze_excit=True)
    a, b = WTAE(**kw), WTAE(**kw)
    init_weights(a, torch.Generator().manual_seed(0))
    init_weights(b, torch.Generator().manual_seed(0))
    dws = a.spatial_reduction[0].down.conv[0]
    for name, w in (("depthwise", dws.depthwise.weight), ("pointwise", dws.pointwise.weight),
                    ("se", a.down_blocks[0].sae.sae[1].weight)):
        bound = 1 / np.sqrt(w[0].numel())
        assert w.abs().max().item() <= bound and w.abs().max().item() > 0.9 * bound, name
    for (k, v), (_, v2) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(v, v2, rtol=0, atol=0, msg=k)


def test_reference_init_rules_on_the_new_modules():
    """apply_reference_init on W-TAE with SE and MBConv: depthwise,
    pointwise and SE weights Xavier-normal with no bias, the MBConv
    depthwise bias N(0, 1), inconv N(0, 1) (the JAX rules,
    crop2seg_tpu/learning/weight_init.py)."""
    from crop2seg_tpu_torch.learning.weight_init import apply_reference_init

    m = WTAE(input_dim=10, encoder_widths=(64, 64), decoder_widths=(64, 64),
             out_conv=(32, 16), add_squeeze_excit=True)
    apply_reference_init(m, torch.Generator().manual_seed(0))
    dws = m.spatial_reduction[0].down.conv[0]
    for conv in (dws.depthwise, dws.pointwise):
        assert conv.bias is None
        fan_in = conv.weight[0].numel()
        fan_out = conv.weight.shape[0] * conv.weight[0, 0].numel()
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        assert abs(conv.weight.std().item() / std - 1) < 0.2
    se = m.down_blocks[0].sae.sae[1]
    assert se.bias is None and se.weight.shape == (4, 64)
    assert abs(m.temporal_encoder.inconv.weight.std().item() - 1) < 0.05
    mb = tl.MBConv(32, 32)
    apply_reference_init(mb, torch.Generator().manual_seed(1))
    dw = mb[0][0].block[3]
    assert abs(dw.bias.std().item() - 1) < 0.3 and abs(dw.weight.std().item()
                                                       - np.sqrt(2.0 / (9 + 128 * 9))) < 0.01


# --- serving ------------------------------------------------------------------

TINY = {"model": "wtae", "encoder_widths": [8, 8, 16], "decoder_widths": [8, 8, 16],
        "out_conv": [8, 5], "n_head": 4, "d_model": 16, "d_k": 4}


def test_tile_predictor_matches_jax():
    """make_tile_predictor with W-TAE over a full 1098^2 tile (T = 2)
    against the JAX make_tile_predictor on the same weights: proba within
    1e-3 and classes equal on >= 99.9 % of the pixels (a near tie of two
    classes may flip), proba sums to 1."""
    from crop2seg_tpu.inference.tile import make_tile_predictor as jax_predictor
    from crop2seg_tpu_torch.inference.tile import make_tile_predictor

    tile = np.random.default_rng(0).standard_normal((2, 1098, 1098, 10)).astype(np.float32)
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items() if k != "model"}
    jm = JWTAE(input_dim=10, **cfg)
    v = _np(jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, jnp.zeros((1, 2)),
                                      train=False))(jnp.zeros((1, 2, 128, 128, 10))))
    model = get_model(TINY, device="cpu")
    model.load_state_dict(wtae_state_dict_from_flax(v))
    dates = np.arange(2, dtype=np.float32) * 10.0
    got = make_tile_predictor(model, batch_size=50, device="cpu")(tile, dates, 2)
    want = jax_predictor(jm, batch_size=50)(v, tile, dates, 2)
    assert got["proba"].shape == want["proba"].shape == (1098, 1098, 5)
    np.testing.assert_allclose(got["proba"].sum(-1), 1.0, atol=1e-5)
    err = np.abs(got["proba"] - want["proba"]).max(-1)
    assert (err <= 1e-3).mean() >= 0.999, (err.max(), (err > 1e-3).mean())
    assert (got["classes"] == want["classes"]).mean() >= 0.999


def test_generate_prediction_serves_wtae(tmp_path):
    """generate_prediction builds W-TAE from a model directory whose
    conf.json says "wtae" and serves a 16-patch cell: the map equals the
    stream of the same model's weights bit for bit, and agrees with the JAX
    stream_tile_inference on them within tests/test_torch_webapp.py's
    tolerances."""
    from crop2seg_tpu.models.factory import get_model as jax_get_model
    from crop2seg_tpu.webapp.pipeline import stream_tile_inference as jax_stream
    from crop2seg_tpu_torch.learning import checkpoint as ckpt
    from crop2seg_tpu_torch.webapp.pipeline import generate_prediction, stream_tile_inference
    from tests.test_torch_webapp import (
        CONF, NORM, _datasets, assert_agree, write_cell)

    conf = {**CONF, "model": "wtae"}
    cell = str(tmp_path / "cell")
    write_cell(cell, 16, 32)
    model_dir = tmp_path / "model"
    os.makedirs(model_dir / "Fold_1")
    with open(model_dir / "conf.json", "w") as f:
        json.dump(conf, f)
    with open(model_dir / "NORM_S2_patch.json", "w") as f:
        json.dump({"Fold_1": NORM}, f)
    jm = jax_get_model(conf)
    v = _np(jax.jit(lambda x: jm.init(jax.random.PRNGKey(2), x, jnp.zeros((1, 5)),
                                      train=False))(jnp.zeros((1, 5, 32, 32, 10))))
    model = get_model(conf, device="cpu")
    model.load_state_dict(wtae_state_dict_from_flax(v))
    ckpt.save_state(str(model_dir / "Fold_1"), model, None, 0, 0.0)
    res = generate_prediction(cell, str(model_dir), 2019, str(tmp_path / "cache"), device="cpu")
    ds, jds = _datasets(cell)
    proba, classes = stream_tile_inference(model, ds, batch_size=10, device="cpu")
    np.testing.assert_array_equal(res["proba"], proba)
    want_p, want_c = jax_stream(jm, v, jds, batch_size=10)
    assert_agree(proba, classes, want_p, want_c)


# --- the train CLI --------------------------------------------------------------

def test_cli_trains_resumes_and_tests_wtae_with_boundary_loss(tmp_path):
    """--model wtae --add_boundary_loss on the CPU: two epochs, a resume to
    three (Adam's state restored), then --test of the result; finite
    metrics with the boundary head's."""
    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.data import make_synthetic_dataset

    data = str(tmp_path / "data")
    make_synthetic_dataset(data, n_patches=10, t_range=(5, 12), hw=16)
    base = ["--device", "cpu", "--dataset", "synthetic", "--dataset_folder", data,
            "--model", "wtae", "--add_boundary_loss", "--encoder_widths", "[8,8,16]",
            "--decoder_widths", "[8,8,16]", "--out_conv", "[8,15]", "--n_head", "2",
            "--d_model", "16", "--batch_size", "2", "--t_buckets", "[8,12]",
            "--display_step", "2"]
    res, res2 = str(tmp_path / "res"), str(tmp_path / "res2")
    run = cli.main(cli.parse_config(base + ["--res_dir", res, "--epochs", "2"]))
    with open(os.path.join(res, "Fold_1", "trainlog.json")) as f:
        log = json.load(f)
    assert sorted(map(int, log)) == [1, 2]
    for m in log.values():
        assert {"train_IoU_b", "val_IoU_b", "train_loss"} <= set(m)
        assert all(np.isfinite(x) for x in m.values())
    run2 = cli.main(cli.parse_config(base + ["--res_dir", res2, "--epochs", "3",
                                             "--weight_folder", res]))
    assert run2.start_epoch == 3 and run2.restored_adam_step == run.adam_step
    assert run2.adam_step > run.adam_step
    test = cli.main(cli.parse_config(base + ["--res_dir", str(tmp_path / "res3"),
                                             "--test", "--weight_folder", res2]))
    assert {"test_IoU", "test_IoU_b"} <= set(test.test_metrics)
    assert all(np.isfinite(x) for x in test.test_metrics.values())
