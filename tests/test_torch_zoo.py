"""crop2seg_tpu_torch's baselines (models/unet.py, convlstm.py, convgru.py,
recunet.py, unet3d.py) against the JAX package's: the goldens, eval and
train-mode outputs (logits, loss, every gradient, the BatchNorm statistics)
on the same converted weights and numpy batch, the converters' round trips,
which models are pad invariant (the same ones as in JAX), and the factory
at the JAX factory's defaults (the same parameters, shapes and flax paths).

Size: the goldens' own; against JAX B=2, T=8, 16x16, a padded sample,
hidden width 12, U-Net widths (8, 8, 16) / (4, 8, 16), UNet3D feats 4.
Tolerances: the goldens 5e-4 (UNet3D 1e-3), as tests/test_recurrent_parity.py
and tests/test_mbconv_unet_parity.py hold the JAX models; whole models 1e-3,
gradients as tests/test_torch_train.py's ``_assert_model_grads``; pad
invariance 1e-6. None of these models has dropout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.learning import losses as jlosses
from crop2seg_tpu.models import convgru as jgru
from crop2seg_tpu.models import convlstm as jlstm
from crop2seg_tpu.models import recunet as jrec
from crop2seg_tpu.models import unet as junet
from crop2seg_tpu.models import unet3d as ju3d
from crop2seg_tpu.models.factory import get_model as jax_get_model
from crop2seg_tpu.utils import torch_convert as tc
from crop2seg_tpu_torch.learning import losses as tlosses
from crop2seg_tpu_torch.models import convgru, convlstm, recunet, unet, unet3d
from crop2seg_tpu_torch.models.factory import ZOO, get_model
from crop2seg_tpu_torch.utils import convert
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc_seq
from tests.test_torch_train import TOL as TRAIN_TOL
from tests.test_torch_train import _assert_model_grads, _np, _stats, _t

TOL = dict(rtol=1e-3, atol=1e-3)
B, T, HW, K = 2, 8, 16, 5
UNET_W = dict(encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16))
REC = dict(input_dim=10, **UNET_W, out_conv=(8, K), hidden_dim=12)
# name -> (JAX model, port model, converter, input is a sequence)
CASES = {
    "unet3d": (lambda: ju3d.UNet3D(n_classes=K, feats=4),
               lambda: unet3d.UNet3D(n_classes=K, in_channel=10, feats=4),
               convert.unet3d_state_dict_from_flax, True),
    "convlstm_seg": (lambda: jlstm.ConvLSTMSeg(num_classes=K, hidden_dim=12),
                     lambda: convlstm.ConvLSTMSeg(K, 10, 12),
                     convert.convlstm_seg_state_dict_from_flax, True),
    "bconvlstm_seg": (lambda: jlstm.BConvLSTMSeg(num_classes=K, hidden_dim=12),
                      lambda: convlstm.BConvLSTMSeg(K, 10, 12),
                      convert.convlstm_seg_state_dict_from_flax, True),
    "convgru_seg": (lambda: jgru.ConvGRUSeg(num_classes=K, hidden_dim=12),
                    lambda: convgru.ConvGRUSeg(K, 10, 12),
                    convert.convlstm_seg_state_dict_from_flax, True),
    "recunet_lstm": (lambda: jrec.RecUNet(**REC, temporal="lstm", padding_mode="zeros"),
                     lambda: recunet.RecUNet(**REC, temporal="lstm", padding_mode="zeros"),
                     convert.recunet_state_dict_from_flax, True),
    "recunet_blstm": (lambda: jrec.RecUNet(**REC, temporal="blstm"),
                      lambda: recunet.RecUNet(**REC, temporal="blstm"),
                      convert.recunet_state_dict_from_flax, True),
    "recunet_mean": (lambda: jrec.RecUNet(**REC, temporal="mean"),
                     lambda: recunet.RecUNet(**REC, temporal="mean"),
                     convert.recunet_state_dict_from_flax, True),
    "unet_naive": (lambda: junet.UnetNaive(temporal_length=T, encoder_widths=(4, 4, 8),
                                           decoder_widths=(2, 4, 8), out_conv=(2, K)),
                   lambda: unet.UnetNaive(10, T, encoder_widths=(4, 4, 8),
                                          decoder_widths=(2, 4, 8), out_conv=(2, K)),
                   convert.unet_state_dict_from_flax, True),
    "unet_plain": (lambda: junet.Unet(**UNET_W, out_conv=(4, K)),
                   lambda: unet.Unet(**UNET_W, out_conv=(4, K)),
                   convert.unet_state_dict_from_flax, False),
}
# which models give the same output whatever the pad frames hold, in JAX
# and in the port: the recurrent encoders run over the pad frames (the
# reference's final-state quirk), 3-D convs and U-Net naive's folding mix
# them into the valid ones; RecUNet's shared encoder zeroes them first, so
# its recurrent bottleneck sees zeros there whatever the input held
PAD_INVARIANT = {"unet3d": False, "convlstm_seg": False, "bconvlstm_seg": False,
                 "convgru_seg": False, "recunet_lstm": True, "recunet_blstm": True,
                 "recunet_mean": True, "unet_naive": False}


def _inputs(seq: bool, seed=0):
    rng = np.random.default_rng(seed)
    if not seq:
        return rng.standard_normal((B, HW, HW, 8)).astype(np.float32), None, None
    x = rng.standard_normal((B, T, HW, HW, 10)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[-1, T - 2:] = True
    x[pad] = 0.0
    return x, pad, np.sort(rng.integers(0, 300, (B, T))).astype(np.float32)


def _jax_apply(jm, v, x, pad, dates, **kw):
    if pad is None:
        return jm.apply(v, x, **kw)
    return jm.apply(v, x, dates, pad_mask=pad, **kw)


# --- the goldens ----------------------------------------------------------

GOLDENS = {
    "unet3d": (lambda: unet3d.UNet3D(n_classes=5, in_channel=10, feats=4), 1e-3),
    "convlstm_seg": (lambda: convlstm.ConvLSTMSeg(5, 10, 12), 5e-4),
    "bconvlstm_seg": (lambda: convlstm.BConvLSTMSeg(5, 10, 12), 5e-4),
    "convgru_seg": (lambda: convgru.ConvGRUSeg(5, 10, 12), 5e-4),
    "recunet_lstm": (lambda: recunet.RecUNet(input_dim=10, **UNET_W, out_conv=(8, 5),
                                             temporal="lstm", hidden_dim=12), 5e-4),
    "unet_naive": (lambda: unet.UnetNaive(10, 9, encoder_widths=(4, 4, 8),
                                          decoder_widths=(2, 4, 8), out_conv=(2, 5)), 5e-4),
    "unet_plain": (lambda: unet.Unet(**UNET_W, out_conv=(4, 5)), 5e-4),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden(name):
    """Each reference model's state dict loads as it is and gives its output."""
    make, tol = GOLDENS[name]
    arrays, sd = load_fixture(name)
    m = make().eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    x = arrays["x"]
    x = to_nhwc_seq(x) if x.ndim == 5 else np.transpose(x, (0, 2, 3, 1))
    with torch.inference_mode():
        y = m(_t(x)).numpy()
    np.testing.assert_allclose(from_nhwc(y), arrays["y"], rtol=tol, atol=tol)


def _unet_plain_flax(sd):
    params, stats = {}, {}
    for i in range(2):
        tc._stitch(params, stats, f"down_{i}", tc.convert_down_block(sd, f"down_blocks.{i}"))
        tc._stitch(params, stats, f"up_{i}", tc.convert_up_block(sd, f"up_blocks.{i}"))
    oc = tc.convert_conv_layer(sd, "out_conv.conv", 2, "any")
    params["out_conv"] = {"conv": oc["params"]}
    stats["out_conv"] = {"conv": oc["batch_stats"]}
    return {"params": params, "batch_stats": stats}


ROUND_TRIPS = {
    "unet3d": (tc.convert_unet3d, convert.unet3d_state_dict_from_flax),
    "convlstm_seg": (tc.convert_convlstm_seg, convert.convlstm_seg_state_dict_from_flax),
    "bconvlstm_seg": (tc.convert_bconvlstm_seg, convert.convlstm_seg_state_dict_from_flax),
    "convgru_seg": (tc.convert_convgru_seg, convert.convlstm_seg_state_dict_from_flax),
    "recunet_lstm": (lambda sd: tc.convert_recunet(sd, n_stages=3),
                     convert.recunet_state_dict_from_flax),
    "unet_naive": (lambda sd: tc.convert_unet_naive(sd, n_stages=3),
                   convert.unet_state_dict_from_flax),
    "unet_plain": (_unet_plain_flax, convert.unet_state_dict_from_flax),
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_converter_inverts_the_jax_package_import(name):
    """Reference state dict -> crop2seg_tpu/utils/torch_convert.py -> the
    port's converter gives back every tensor exactly (UNet3D's transposed
    convs flipped back)."""
    to_flax, back_fn = ROUND_TRIPS[name]
    _, sd = load_fixture(name)
    back = back_fn(to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


# --- against the JAX models ------------------------------------------------

@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One model: JAX init (BatchNorm statistics made non-trivial), an eval
    forward, and one train-mode forward and backward: logits, the
    cross-entropy, gradients and updated statistics."""
    name = request.param
    make_jax, _, _, seq = CASES[name]
    x, pad, dates = _inputs(seq)
    y = np.random.default_rng(1).integers(0, K, (B, HW, HW))
    jm = make_jax()
    v = _np(jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, train=False) if pad is None
                    else jm.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                 train=False))(x))
    rng = np.random.default_rng(2)
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        v.get("batch_stats", {}))}
    out = np.asarray(jax.jit(lambda v, x: _jax_apply(jm, v, x, pad, dates, train=False))(v, x))

    def loss(params):
        logits, upd = _jax_apply(jm, {"params": params, "batch_stats": v["batch_stats"]},
                                 x, pad, dates, train=True, mutable=["batch_stats"])
        return jlosses.cross_entropy(logits, jnp.asarray(y)), (logits, upd["batch_stats"])
    (val, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(v["params"])
    return dict(name=name, x=x, pad=pad, dates=dates, y=y, v=v, out=out,
                loss=float(val), logits=np.asarray(logits), grads=_np(grads),
                stats=_np(stats))


def _port(c):
    _, make, to_sd, _ = CASES[c["name"]]
    m = make()
    m.load_state_dict(to_sd(c["v"]))
    return m


def _args(c, x=None):
    x = _t(c["x"] if x is None else x)
    return (x,) if c["pad"] is None else (x, _t(c["dates"]), _t(c["pad"]))


def test_eval_matches_jax(case):
    m = _port(case).eval()
    with torch.inference_mode():
        got = m(*_args(case)).numpy()
    assert got.shape == (B, HW, HW, K)
    np.testing.assert_allclose(got, case["out"], **TOL)


def test_train_mode_matches_jax(case):
    """One train-mode forward and backward: logits, loss, every parameter's
    gradient and the updated running statistics."""
    m = _port(case).train()
    logits = m(*_args(case))
    loss = tlosses.cross_entropy(logits, _t(case["y"]))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), case["logits"], **TOL)
    np.testing.assert_allclose(loss.item(), case["loss"], **TRAIN_TOL)
    want = CASES[case["name"]][2]({"params": case["grads"], "batch_stats": case["stats"]})
    _assert_model_grads({k: p.grad.numpy() for k, p in m.named_parameters()},
                        {k: want[k].numpy() for k, _ in m.named_parameters()})
    got = m.state_dict()
    for k, w in _stats(want).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **TRAIN_TOL, err_msg=k)


def test_pad_invariance_as_in_jax(case):
    """Garbage in the pad frames: the port's output stays within 1e-6 where
    the JAX model's does, and moves where it moves (PAD_INVARIANT)."""
    if case["pad"] is None:      # the time-agnostic U-Net ignores dates and masks
        m = _port(case).eval()
        with torch.inference_mode():
            got = m(_t(case["x"]), torch.ones(B, T), torch.ones(B, T, dtype=torch.bool))
        np.testing.assert_allclose(got.numpy(), case["out"], **TOL)
        return
    noisy = case["x"].copy()
    noisy[case["pad"]] = np.random.default_rng(9).standard_normal(
        noisy[case["pad"]].shape).astype(np.float32) * 50.0
    jm = CASES[case["name"]][0]()
    jout = np.asarray(jax.jit(lambda v, x: _jax_apply(jm, v, x, case["pad"], case["dates"],
                                                      train=False))(case["v"], noisy))
    m = _port(case).eval()
    with torch.inference_mode():
        got = m(*_args(case, noisy)).numpy()
    want = PAD_INVARIANT[case["name"]]
    assert (np.abs(jout - case["out"]).max() <= 1e-6) == want
    with torch.inference_mode():
        clean = m(*_args(case)).numpy()
    moved = np.abs(got - clean).max()
    assert (moved <= 1e-6) == want and (want or moved > 1e-3)


# --- the factory -----------------------------------------------------------

def _flax_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flax_leaves(v, path) if isinstance(v, dict) else {path: v.shape})
    return out


@pytest.mark.parametrize("name", ZOO)
def test_factory_builds_the_jax_factorys_model(name):
    """get_model(name) at the defaults holds the JAX factory model's
    parameters: ``flax_param_paths`` maps each onto a JAX leaf of the same
    size, and every JAX leaf is mapped (shapes traced, nothing compiled)."""
    cfg = {"model": name, "max_temp": 6}
    m = get_model(cfg, device="cpu")
    jm = jax_get_model(cfg)
    x = jnp.zeros((1, 6, 32, 32, 10))
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, jnp.zeros((1, 6)),
                                              pad_mask=jnp.zeros((1, 6), bool),
                                              train=False), x)
    leaves = _flax_leaves(jax.tree_util.tree_map(lambda a: a, shapes["params"]))
    paths = convert.flax_param_paths(m)
    assert set(paths.values()) == set(leaves)
    params = dict(m.named_parameters())
    for k, p in paths.items():
        assert params[k].numel() == int(np.prod(leaves[p])), (k, p)


def test_factory_unet_naive_needs_max_temp():
    with pytest.raises(ValueError, match="max_temp"):
        get_model({"model": "unet_naive"}, device="cpu")
    m = get_model({"model": "unet_naive", "max_temp": 4}, device="cpu")
    with pytest.raises(ValueError, match="temporal_length=4"):
        m(torch.zeros(1, 5, 16, 16, 10))


def test_recunet_refuses_mono():
    with pytest.raises(ValueError, match="mono"):
        recunet.RecUNet(temporal="mono")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_encoder_outputs_match_jax(cell):
    """ConvLSTM and ConvGRU alone: every step's hidden state (the outputs)
    and the final state against the JAX scans, and each sample's last valid
    output (``last_valid_output``)."""
    x, pad, _ = _inputs(True)
    jm = (jlstm.ConvLSTM if cell == "lstm" else jgru.ConvGRU)(hidden_dim=6)
    v = _np(jm.init(jax.random.PRNGKey(3), x))
    outs, final = jm.apply(v, x)
    m = (convlstm.ConvLSTM if cell == "lstm" else convgru.ConvGRU)(10, 6)
    to_sd = {}
    convert._cell(to_sd, "", v["params"])
    m.load_state_dict({k: _t(np.ascontiguousarray(a)) for k, a in to_sd.items()})
    with torch.inference_mode():
        got, got_final = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(outs), **TOL)
    for g, w in zip(got_final if cell == "lstm" else (got_final,),
                    final if cell == "lstm" else (final,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        convlstm.last_valid_output(got, _t(pad)).numpy(),
        np.asarray(jlstm.last_valid_output(outs, jnp.asarray(pad))), **TOL)


def test_last_valid_output_gathers_each_samples_last_step():
    outputs = torch.arange(2 * 4 * 1 * 1 * 1, dtype=torch.float32).reshape(2, 4, 1, 1, 1)
    pad = torch.tensor([[False] * 4, [False, False, True, True]])
    got = convlstm.last_valid_output(outputs, pad)
    assert got.flatten().tolist() == [3.0, 5.0]
    want = np.asarray(jlstm.last_valid_output(jnp.asarray(outputs.numpy()),
                                              jnp.asarray(pad.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
