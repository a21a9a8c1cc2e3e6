"""crop2seg_tpu_torch's L-TAE routes against the JAX package: the port takes
the plain ops where the JAX package takes XLA, and its kernel route where the
JAX package runs its kernel, at any T (past the fast kernels' limits the
general kernels serve it).

- U-TAE trains its L-TAE on plain ops whatever ``fused`` says, as the JAX
  U-TAE (no ``use_pallas_train``) does: with ``agg_mode="mean"`` at its
  bottleneck's C = 128 it takes the plain ops, never the kernel pair.
- LTAE and TimeUNet at T = 70, past the fast kernels' T <= 64: the kernel
  route takes the shape (``LTAE.kernel_takes``, the general kernels; also at
  T = 65, 128, 190, G = 32 and C = 192), ``fused=True`` calls the kernel
  wrapper, and the plain route (the default for a CPU tensor) matches the
  JAX modules.
- TimeUNet with ``pad_value=1.5`` and ``fused=True`` leaves the tail
  undeferred (the deferred tail folds pads in as zeros).

Each is held against the JAX module on the same converted weights and the
same numpy inputs, the JAX package's XLA route, dropout zeroed on both sides
(tests/test_torch_train.py's swap of the ``LTAE`` name). On the CPU the
kernel wrappers run their plain versions, so the tests make the wrappers
raise to show which route was taken. Tolerances: tests/
test_torch_train.py's (5e-4 on values and running statistics, 1e-3 of each
gradient's norm; whole models 1e-3), and 1e-5 on attention weights.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.models.timeunet as jtimeunet
import crop2seg_tpu.models.utae as jutae
from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.models.utae import UTAE
from crop2seg_tpu_torch.nn import ltae as tltae
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.ops import ltae_fused
from crop2seg_tpu_torch.utils import convert
from tests.test_torch_train import TOL, _assert_grads, _assert_model_grads, _np, _stats, _t

MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
T_LONG = 70                      # past the fast kernels' T <= 64
UTAE_KW = dict(input_dim=6, encoder_widths=(8, 128), decoder_widths=(8, 128),
               out_conv=(8, 5), n_head=4, d_model=32, d_k=4, agg_mode="mean")
TIMEUNET_KW = dict(input_dim=6, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
                   out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
LTAE_KW = dict(in_channels=16, n_head=4, d_k=4, mlp=(32, 16), d_model=32)


@pytest.fixture
def no_kernel_route(monkeypatch):
    """Every L-TAE kernel wrapper raises when called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")
    for mod, name in ((ltae_fused, "ltae_fused_forward"), (tltae, "ltae_pool"),
                      (tltae, "ltae_pool_tail")):
        monkeypatch.setattr(mod, name, refuse)


def _batch(b, t, hw, c, pad_from, seed=0):
    rng = np.random.default_rng(seed)
    pad = np.arange(t)[None] >= np.array([t, pad_from])[:, None]
    x = rng.standard_normal((b, t, hw, hw, c)).astype(np.float32)
    x[pad] = 0.0
    dates = np.sort(rng.integers(0, 400, (b, t))).astype(np.float32)
    return x, dates, pad


def _no_dropout(module):
    """The JAX model class of ``module`` (crop2seg_tpu.models.utae or
    .timeunet) with its L-TAE's dropout rates at 0, for the block."""
    class Swap:
        def __enter__(self):
            self.orig = module.LTAE
            module.LTAE = functools.partial(JLTAE, dropout=0.0, attn_dropout=0.0)

        def __exit__(self, *exc):
            module.LTAE = self.orig
    return Swap()


def _jax_train(m, v, x, dates, pad):
    """One JAX train-mode forward and backward of loss = mean(out ** 2):
    out, the loss, every parameter gradient and the updated statistics."""
    def loss(params):
        out, upd = m.apply({"params": params, "batch_stats": v["batch_stats"]},
                           x, dates, pad_mask=pad, train=True, mutable=["batch_stats"])
        out = out[0] if isinstance(out, tuple) else out
        return jnp.mean(out ** 2), (out, upd["batch_stats"])
    (val, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return dict(out=np.asarray(out), loss=float(val), grads=_np(grads), stats=_np(stats))


def _port_train(model, x, dates, pad, fused, **kw):
    """The port's model in training mode, dropout zeroed: out, loss,
    gradients by parameter name, state dict."""
    te = model.temporal_encoder if hasattr(model, "temporal_encoder") else model
    te.attn_dropout = 0.0
    te.mlp[1].p = 0.0
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(_t(x), _t(dates), _t(pad), fused=fused, **kw)
    out = out[0] if isinstance(out, tuple) else out
    loss = (out ** 2).mean()
    loss.backward()
    return dict(out=out.detach(), loss=loss.item(),
                grads={k: p.grad.clone() for k, p in model.named_parameters()},
                sd={k: v.clone() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def utae_case():
    x, dates, pad = _batch(2, 7, 16, 6, 5)
    with _no_dropout(jutae):
        m = jutae.UTAE(**UTAE_KW)
        v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, dates, pad_mask=pad,
                                         train=False))(x))
        want = _jax_train(m, v, x, dates, pad)
    return dict(x=x, dates=dates, pad=pad, v=v, want=want)


def test_utae_mean_aggregation_trains_on_the_plain_pool_at_c128(utae_case,
                                                                no_kernel_route):
    """U-TAE with agg_mode="mean" asks its L-TAE for no attention, so in
    training an L-TAE with ``use_pallas_train`` would take the kernel pair.
    U-TAE builds its L-TAE without it and trains on plain ops, as the JAX
    U-TAE does: with fused=True too (the pair's wrappers raise here); loss,
    gradients and statistics equal fused=False's and match the JAX U-TAE's
    train-mode step."""
    c = utae_case
    runs = {}
    for fused in (True, False):
        model = UTAE(**UTAE_KW)
        model.load_state_dict(convert.utae_state_dict_from_flax(c["v"]))
        runs[fused] = _port_train(model, c["x"], c["dates"], c["pad"], fused)
    got, plain = runs[True], runs[False]
    torch.testing.assert_close(got["out"], plain["out"], rtol=0, atol=0)
    for k, g in got["grads"].items():
        torch.testing.assert_close(g, plain["grads"][k], rtol=0, atol=0, msg=k)
    want = c["want"]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    sd = convert.utae_state_dict_from_flax({"params": want["grads"],
                                            "batch_stats": want["stats"]})
    _assert_model_grads({k: g.numpy() for k, g in got["grads"].items()},
                        {k: sd[k].numpy() for k in got["grads"]})
    for k, w in _stats(sd).items():
        np.testing.assert_allclose(got["sd"][k].numpy(), w.numpy(), **TOL, err_msg=k)


@pytest.fixture(scope="module")
def ltae_case():
    x, dates, pad = _batch(2, T_LONG, 4, LTAE_KW["in_channels"], T_LONG - 9, seed=1)
    m = JLTAE(**LTAE_KW, dropout=0.0, attn_dropout=0.0)
    v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                     train=False))(x))
    out, attn = jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad, train=False))(v, x)
    return dict(x=x, dates=dates, pad=pad, v=v, out=np.asarray(out),
                attn=np.asarray(attn), train=_jax_train(m, v, x, dates, pad))


def _assert_kernel_route_takes_long_t(m):
    """The module's kernel route in its mode takes T = 65, 70, 128 and 190
    on the general kernel (``LTAE.kernel_takes``, ``kernel_route``), as it
    does G = 32 and C = 192, past the fast kernels' G <= 16 and C <= 128."""
    for t in (65, 70, 128, 190):
        assert m.kernel_takes(t, LTAE_KW["in_channels"])
        assert m.kernel_route(t, LTAE_KW["in_channels"]) == "general"
    for kw in (dict(in_channels=64, n_head=32, d_k=4, mlp=(64, 32), d_model=64),
               dict(in_channels=192, n_head=16, d_k=4, mlp=(256, 192), d_model=256)):
        wide = LTAE(**kw).train(m.training)
        assert wide.kernel_takes(61, kw["in_channels"])
        assert wide.kernel_route(61, kw["in_channels"]) == "general"


def test_ltae_past_the_kernels_t_runs_its_plain_ops_in_eval(ltae_case, no_kernel_route):
    """LTAE at T = 70 in eval, past the fast eval kernels' T <= 64: the
    kernel route takes it (the general kernel; fused=True calls the eval
    wrapper, which raises here), and the plain ops (the default on the CPU)
    run with no wrapper called, out and attention matching the JAX L-TAE."""
    c = ltae_case
    m = LTAE(**LTAE_KW).eval()
    m.load_state_dict(convert.ltae_state_dict_from_flax(c["v"]))
    _assert_kernel_route_takes_long_t(m)
    with torch.inference_mode():
        with pytest.raises(AssertionError, match="a kernel wrapper was called"):
            m(_t(c["x"]), _t(c["dates"]), _t(c["pad"]), fused=True)
        out, attn = m(_t(c["x"]), _t(c["dates"]), _t(c["pad"]))
    np.testing.assert_allclose(out.numpy(), c["out"], **MODEL_TOL)
    np.testing.assert_allclose(attn.numpy(), c["attn"], **ATTN_TOL)


def test_ltae_past_the_kernels_t_trains_on_the_plain_pool(ltae_case, no_kernel_route):
    """LTAE at T = 70 in training without the attention output, past the
    fast kernel pair's T <= 64: the kernel route takes it (the general
    pair; fused=True calls the ltae_pool wrapper, which raises here), and
    ltae_pool's plain version (the default on the CPU) runs with no wrapper
    called; out, every gradient and the updated statistics match the JAX
    L-TAE in training mode."""
    c = ltae_case
    m = LTAE(**LTAE_KW)
    m.load_state_dict(convert.ltae_state_dict_from_flax(c["v"]))
    _assert_kernel_route_takes_long_t(m.train())
    with pytest.raises(AssertionError, match="a kernel wrapper was called"):
        _port_train(m, c["x"], c["dates"], c["pad"], True, need_attn=False)
    got = _port_train(m, c["x"], c["dates"], c["pad"], None, need_attn=False)
    want = c["train"]
    np.testing.assert_allclose(got["out"].numpy(), want["out"], **TOL)
    sd = convert.ltae_state_dict_from_flax({"params": want["grads"],
                                            "batch_stats": want["stats"]})
    _assert_grads({k: g.numpy() for k, g in got["grads"].items()},
                  {k: sd[k].numpy() for k in got["grads"]})
    for k, w in _stats(sd).items():
        np.testing.assert_allclose(got["sd"][k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_timeunet_past_the_kernels_t_runs_plain(no_kernel_route):
    """TimeUNet at T = 70 in eval, past the fast kernels' T <= 64: its
    L-TAE's kernel route takes it (fused=True calls the eval wrapper, which
    raises here), and the plain route (the default on the CPU) runs with no
    wrapper called, the logits matching the JAX TimeUNet's."""
    x, dates, pad = _batch(2, T_LONG, 8, 6, T_LONG - 9, seed=2)
    m = jtimeunet.TimeUNet(**TIMEUNET_KW)
    v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, dates, pad_mask=pad,
                                     train=False))(x))
    want = np.asarray(jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad,
                                                   train=False))(v, x))
    model = TimeUNet(**TIMEUNET_KW).eval()
    model.load_state_dict(convert.timeunet_state_dict_from_flax(v))
    assert model.temporal_encoder.kernel_route(T_LONG, TIMEUNET_KW["encoder_widths"][0]) \
        == "general"
    with torch.inference_mode():
        with pytest.raises(AssertionError, match="a kernel wrapper was called"):
            model(_t(x), _t(dates), _t(pad), fused=True)
        got = model(_t(x), _t(dates), _t(pad))
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


@pytest.fixture(scope="module")
def pad_value_case():
    x, dates, pad = _batch(2, 7, 8, 6, 5, seed=3)
    kw = dict(TIMEUNET_KW, pad_value=1.5)
    with _no_dropout(jtimeunet):
        m = jtimeunet.TimeUNet(**kw)
        v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, dates, pad_mask=pad,
                                         train=False))(x))
        want_eval = np.asarray(jax.jit(lambda v, x: m.apply(
            v, x, dates, pad_mask=pad, train=False))(v, x))
        want_train = _jax_train(m, v, x, dates, pad)
    return dict(x=x, dates=dates, pad=pad, v=v, kw=kw, eval=want_eval, train=want_train)


def _timeunet(c, **kw):
    model = TimeUNet(**c["kw"], **kw)
    model.load_state_dict(convert.timeunet_state_dict_from_flax(c["v"]))
    return model


def test_timeunet_pad_value_in_eval_needs_no_deferred_tail(pad_value_case):
    """TimeUNet(pad_value=1.5) in eval, fused=True and fused=False: the
    kernel route leaves in_conv's tail undeferred (the deferred tail would
    fold pads in as zeros); both match each other and the JAX TimeUNet's XLA
    route. An explicit defer_tail=True still raises."""
    c = pad_value_case
    model = _timeunet(c).eval()
    with torch.inference_mode():
        outs = {f: model(_t(c["x"]), _t(c["dates"]), _t(c["pad"]), fused=f).numpy()
                for f in (True, False)}
        with pytest.raises(NotImplementedError, match="pad_value"):
            _timeunet(c, defer_tail=True).eval()(_t(c["x"]), _t(c["dates"]),
                                                 _t(c["pad"]), fused=True)
    np.testing.assert_allclose(outs[True], outs[False], **TOL)
    for f, got in outs.items():
        np.testing.assert_allclose(got, c["eval"], **MODEL_TOL, err_msg=f"fused={f}")


def test_timeunet_pad_value_trains_without_a_deferred_tail(pad_value_case):
    """TimeUNet(pad_value=1.5) in training, fused=True (the untailed pair's
    route, its plain version on the CPU) and fused=False: loss, gradients and
    statistics agree with each other and with the JAX TimeUNet's."""
    c = pad_value_case
    runs = {f: _port_train(_timeunet(c), c["x"], c["dates"], c["pad"], f)
            for f in (True, False)}
    want = c["train"]
    sd = convert.timeunet_state_dict_from_flax({"params": want["grads"],
                                                "batch_stats": want["stats"]})
    np.testing.assert_allclose(runs[True]["loss"], runs[False]["loss"], **TOL)
    for f, got in runs.items():
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL, err_msg=f"fused={f}")
        _assert_model_grads({k: g.numpy() for k, g in got["grads"].items()},
                            {k: sd[k].numpy() for k in got["grads"]})
        for k, w in _stats(sd).items():
            np.testing.assert_allclose(got["sd"][k].numpy(), w.numpy(), **TOL,
                                       err_msg=f"fused={f} {k}")
