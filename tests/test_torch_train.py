"""crop2seg_tpu_torch in training mode against the JAX package: the conv
blocks with train BatchNorm, the L-TAE train path, the loss and metrics,
TimeUNet's train step through the deferred in_conv tail (``ltae_pool_tail``,
the JAX ``--use_pallas_train`` route), three whole training steps of TimeUNet
(make_train_step + Adam) on the same converted weights and the same numpy
batch, on the plain and the tail route, and one bf16 step (autocast, the JAX
``--bf16``).

Dropout is zeroed on both sides wherever the two are compared: JAX draws its
masks from jax.random, the port from a torch.Generator (attention dropout
from a hash, ops/ltae_pool.py), so the streams cannot agree. On the JAX side
the TimeUNet test swaps the ``LTAE`` name that crop2seg_tpu/models/timeunet.py
imports for ``functools.partial(LTAE, dropout=0.0, attn_dropout=0.0)``; on
the port side it sets the modules' rates to 0.

Tolerances: 5e-4 abs/rel on forward values and running statistics, the
goldens' fp32 tolerance (the frameworks sum convolutions and statistics in
other orders); gradients 1e-3 relative with an absolute floor of 1e-5 of the
largest gradient, for the entries that are zero up to rounding. After three
Adam steps (lr 1e-3) parameters agree to 2e-4 absolute, a fifteenth of the
3e-3 that three steps can move a parameter: Adam moves a parameter by about
lr per step whatever its gradient's size, and in training mode the
BatchNorms' backward amplifies rounding differences (a 1e-5 change of the
U-Net's input moves its gradients by ~1e-2 on the card, PERF.md), so the
second and third steps inherit the first step's rounding. Parameters whose
gradient is zero in exact arithmetic, and the running means that include
them, are held to the bounds that Adam's step size sets (see the test).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX trainer's optimizer)
import pytest
import torch

import crop2seg_tpu.models.timeunet as jtimeunet
from crop2seg_tpu.learning import losses as jlosses
from crop2seg_tpu.learning import metrics as jmetrics
from crop2seg_tpu.learning import trainer as jtrainer
from crop2seg_tpu.nn import layers as jl
from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu_torch.learning import losses as tlosses
from crop2seg_tpu_torch.learning import metrics as tmetrics
from crop2seg_tpu_torch.learning.trainer import StepConfig, make_eval_step, make_train_step
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.nn import layers as tl
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.utils import convert

TOL = dict(rtol=5e-4, atol=5e-4)
# a bf16 step's loss against fp32 and against JAX in bf16: the two frameworks
# round activations to bf16 at other places (ops/ltae_pool.py keeps its folds
# fp32; flax rounds each Dense's output), a few 1e-3 of the loss at most
BF16_LOSS_RTOL = 2e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _stats(sd):
    return {k: v for k, v in sd.items() if "running_" in k}


def _assert_grads(got: dict, want: dict):
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-5 * top, err_msg=k)


def _assert_model_grads(got: dict, want: dict):
    """Whole-model gradients in training mode: 1e-3 relative, as
    ``_assert_grads``, but per parameter in the 2-norm. The train-mode
    BatchNorms' backward amplifies the frameworks' rounding differences, so
    single small entries of the in_conv and L-TAE gradients differ by up to
    ~1e-2 of themselves while each parameter's gradient agrees to ~3e-4 of its
    norm. Gradients that are zero in exact arithmetic (below 1e-5 of the
    largest on the JAX side: biases feeding a train-mode BatchNorm, the key
    bias under the softmax) are held to that floor."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        if np.abs(w).max() <= 1e-5 * top:
            assert np.abs(got[k]).max() <= 1e-5 * top, k
        else:
            assert np.linalg.norm(got[k] - w) <= 1e-3 * np.linalg.norm(w), k


@pytest.mark.parametrize("block", ["conv", "up"])
def test_conv_blocks_with_train_batchnorm_match_jax(block):
    """Output and updated running statistics at N*H*W = 32 rows per channel,
    where the unbiased variance would be 3 % off the biased one flax uses."""
    rng = np.random.default_rng(0)
    if block == "conv":
        x = (rng.standard_normal((2, 4, 4, 10)) + 1.0).astype(np.float32)
        jm, args = jl.ConvBlock(nkernels=(10, 8, 8), norm="batch"), (x,)
        tm, to_sd = tl.ConvBlock((10, 8, 8), norm="batch"), convert.conv_block_state_dict_from_flax
    else:
        x = rng.standard_normal((2, 2, 2, 16)).astype(np.float32)
        skip = rng.standard_normal((2, 4, 4, 12)).astype(np.float32)
        jm, args = jl.UpConvBlock(d_out=8, norm="batch"), (x, skip)
        tm, to_sd = tl.UpConvBlock(16, 8, 12, norm="batch"), convert.up_block_state_dict_from_flax
    v = _np(jm.init(jax.random.PRNGKey(0), *args))
    want, upd = jm.apply(v, *args, train=True, mutable=["batch_stats"])
    tm.load_state_dict(to_sd(v))
    tm.train()
    got = tm(*(_t(a) for a in args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    want_sd = to_sd({"params": v["params"], "batch_stats": _np(upd["batch_stats"])})
    got_sd = tm.state_dict()
    for k, w in _stats(want_sd).items():
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), **TOL, err_msg=k)
        assert not torch.allclose(got_sd[k], to_sd(v)[k]), k   # it moved


B, T, H, W, C = 2, 9, 4, 4, 16
N_HEAD, D_MODEL, D_OUT = 4, 32, 16


@pytest.fixture(scope="module")
def ltae_case():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[1, T - 3:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(T) * 7.0 + 20).astype(np.float32), (B, 1))
    m = JLTAE(in_channels=C, n_head=N_HEAD, d_k=4, mlp=(D_MODEL, D_OUT),
              d_model=D_MODEL, dropout=0.0, attn_dropout=0.0)
    v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                     train=False))(x))

    def loss(params):
        (out, _), upd = m.apply({"params": params, "batch_stats": v["batch_stats"]},
                                x, dates, pad_mask=pad, train=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.mean(out ** 2), (out, upd["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return dict(x=x, pad=pad, dates=dates, v=v, out=np.asarray(out),
                stats=_np(stats), grads=_np(grads))


@pytest.mark.parametrize("fused", [False, True])
def test_ltae_train_path_matches_jax(ltae_case, fused):
    """Output, updated mlp BatchNorm statistics and every parameter gradient
    of the port's LTAE in training mode (ltae_pool's plain version on the
    CPU, called directly or through the kernel wrapper) against the JAX LTAE
    in training mode, dropout off."""
    c = ltae_case
    m = LTAE(in_channels=C, n_head=N_HEAD, d_k=4, mlp=(D_MODEL, D_OUT),
             d_model=D_MODEL, dropout=0.0, attn_dropout=0.0)
    m.load_state_dict(convert.ltae_state_dict_from_flax(c["v"]))
    m.train()
    out, attn = m(_t(c["x"]), _t(c["dates"]), _t(c["pad"]), need_attn=False,
                  fused=fused)
    assert attn is None and out.shape == (B, H, W, D_OUT)
    (out ** 2).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), c["out"], **TOL)
    want = convert.ltae_state_dict_from_flax({"params": c["grads"],
                                              "batch_stats": c["stats"]})
    _assert_grads({k: p.grad.numpy() for k, p in m.named_parameters()},
                  {k: want[k].numpy() for k, _ in m.named_parameters()})
    got_sd = m.state_dict()
    for k, w in _stats(want).items():
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_ltae_train_dropout_follows_the_generator(ltae_case):
    """Attention and MLP dropout (rates 0.1 / 0.2) come from the generator
    passed in: the same seed gives the same output, another seed another."""
    c = ltae_case
    m = LTAE(in_channels=C, n_head=N_HEAD, d_k=4, mlp=(D_MODEL, D_OUT),
             d_model=D_MODEL).train()
    args = (_t(c["x"]), _t(c["dates"]), _t(c["pad"]))

    def run(seed):
        with torch.no_grad():
            return m(*args, need_attn=False,
                     generator=torch.Generator().manual_seed(seed))[0]
    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert (run(5) - run(6)).abs().max() > 1e-3


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    y = rng.integers(0, 6, (2, 8, 8))
    weight = np.array([1.0, 0.5, 2.0, 1.0, 1.5, 0.0], np.float32)
    for w in (None, weight):
        for ls in (0.0, 0.1):
            want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                         weight=None if w is None else jnp.asarray(w),
                                         label_smoothing=ls)
            got = tlosses.cross_entropy(_t(logits), _t(y),
                                        weight=None if w is None else _t(w),
                                        label_smoothing=ls)
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_confusion_matrix_and_top2_match_jax():
    """Out-of-range labels (-1, K) are dropped on both sides."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    y = rng.integers(-1, 6, (2, 8, 8))
    pred = logits.argmax(-1)
    want = jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(y), 5)
    got = tmetrics.confusion_matrix(_t(pred), _t(y), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tmetrics.top2_prediction(_t(logits), _t(y)).numpy(),
        np.asarray(jmetrics.top2_prediction(jnp.asarray(logits), jnp.asarray(y))))


KW = dict(input_dim=6, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
          out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
N_STEPS = 3


@pytest.fixture(scope="module")
def slice_case():
    """Three JAX training steps (jitted make_train_step, optax Adam) of a
    small TimeUNet, dropout zeroed by the LTAE swap."""
    rng = np.random.default_rng(0)
    b, t, hw = 2, 7, 8
    pad = np.arange(t)[None] >= np.array([t, t - 2])[:, None]
    x = rng.standard_normal((b, t, hw, hw, 6)).astype(np.float32)
    x[pad] = 0.0
    batch = {"x": x, "pad_mask": pad, "y": rng.integers(0, 5, (b, hw, hw)),
             "dates": np.sort(rng.integers(0, 300, (b, t))).astype(np.float32)}
    weights = (1.0, 1.0, 1.0, 1.0, 0.0)
    orig = jtimeunet.LTAE
    jtimeunet.LTAE = functools.partial(JLTAE, dropout=0.0, attn_dropout=0.0)
    try:
        m = jtimeunet.TimeUNet(**KW)
        v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, batch["dates"],
                                         pad_mask=pad, train=False))(x))
        state = jtrainer.create_train_state(m, v, 1e-3)
        step = jax.jit(jtrainer.make_train_step(
            m, jtrainer.StepConfig(num_classes=5, class_weights=weights)))
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        losses = []
        for i in range(N_STEPS):
            state, aux = step(state, jb, jax.random.PRNGKey(i))
            losses.append(float(aux["loss"]))
    finally:
        jtimeunet.LTAE = orig
    return dict(batch=batch, v=v, weights=weights, losses=losses,
                cm=np.asarray(aux["cm"]),
                after={"params": _np(state.params),
                       "batch_stats": _np(state.batch_stats)})


def _port_model(c, defer_tail=None):
    """The port's TimeUNet on the case's converted weights, dropout zeroed."""
    model = TimeUNet(**KW, defer_tail=defer_tail)
    model.load_state_dict(convert.timeunet_state_dict_from_flax(c["v"]))
    model.temporal_encoder.attn_dropout = 0.0
    model.temporal_encoder.mlp[1].p = 0.0
    return model


@pytest.fixture(scope="module")
def jax_grads(slice_case):
    """One JAX train-mode forward of the case's model (dropout zeroed): loss,
    every parameter gradient and the updated BatchNorm statistics."""
    c = slice_case
    b = {k: jnp.asarray(a) for k, a in c["batch"].items()}
    orig = jtimeunet.LTAE
    jtimeunet.LTAE = functools.partial(JLTAE, dropout=0.0, attn_dropout=0.0)
    try:
        m = jtimeunet.TimeUNet(**KW)

        def loss(params):
            logits, upd = m.apply({"params": params, "batch_stats": c["v"]["batch_stats"]},
                                  b["x"], b["dates"], pad_mask=b["pad_mask"],
                                  train=True, mutable=["batch_stats"])
            return jlosses.cross_entropy(logits, b["y"], weight=jnp.asarray(
                c["weights"])), upd["batch_stats"]

        (val, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            c["v"]["params"])
    finally:
        jtimeunet.LTAE = orig
    return dict(loss=float(val), grads=_np(grads), stats=_np(stats))


@pytest.mark.parametrize("fused", [False, True])
def test_tail_route_train_step_matches_jax(slice_case, jax_grads, fused):
    """TimeUNet in training mode through the deferred in_conv tail (the
    raw in_conv output and its per-frame GroupNorm affine into
    ltae_pool_tail, pads folded into the affine as zero rows), by the plain
    version and by the kernel wrapper on the CPU, against the JAX TimeUNet's
    train path on the same weights and batch: the loss, every parameter
    gradient and the updated running statistics."""
    c, j = slice_case, jax_grads
    model = _port_model(c, defer_tail=True).train()
    bt = {k: _t(a) for k, a in c["batch"].items()}
    logits = model(bt["x"], bt["dates"], bt["pad_mask"], fused=fused)
    loss = tlosses.cross_entropy(logits, bt["y"], weight=_t(np.asarray(
        c["weights"], np.float32)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), j["loss"], **TOL)
    want = convert.timeunet_state_dict_from_flax({"params": j["grads"],
                                                  "batch_stats": j["stats"]})
    _assert_model_grads({k: p.grad.numpy() for k, p in model.named_parameters()},
                        {k: want[k].numpy() for k, _ in model.named_parameters()})
    got_sd = model.state_dict()
    for k, w in _stats(want).items():
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("route", ["plain", "tail"])
def test_train_steps_match_jax(slice_case, route):
    """The port's make_train_step (Adam, lr 1e-3) over the same three steps:
    the loss sequence, the last step's confusion matrix, and every parameter
    and BatchNorm statistic after the last step; through temporally_shared
    and the untailed pool (plain) or through the deferred in_conv tail."""
    c = slice_case
    model = _port_model(c, defer_tail=True if route == "tail" else None)
    step = make_train_step(model, StepConfig(num_classes=5, class_weights=c["weights"]),
                           device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(N_STEPS):
        aux = step(c["batch"], gen)
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, c["losses"], rtol=1e-5)
    np.testing.assert_array_equal(aux["cm"].numpy(), c["cm"])
    want = convert.timeunet_state_dict_from_flax(c["after"])
    before = convert.timeunet_state_dict_from_flax(c["v"])
    got = model.state_dict()
    grads = {k: p.grad for k, p in model.named_parameters()}
    top = max(g.abs().max().item() for g in grads.values())
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in grads and grads[k].abs().max().item() <= 1e-6 * top:
            # zero gradient in exact arithmetic (a bias feeding a train-mode
            # BatchNorm, the key bias under the softmax): Adam moves it by
            # rounding noise, at most lr per step on either side
            assert (got[k] - before[k]).abs().max().item() <= N_STEPS * 1e-3 * 1.01, k
            continue
        if k.endswith("running_mean"):
            # a BatchNorm's running mean includes the bias in front of it,
            # which drifts as above: momentum 0.1 x (1 + 2 + 3) steps x lr,
            # on either side, is 1.2e-3
            tol = dict(rtol=0, atol=1.2e-3 + 5e-4)
        else:
            tol = TOL if "running_" in k else dict(rtol=0, atol=2e-4)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **tol, err_msg=k)
    assert got["up_blocks.0.up.1.num_batches_tracked"].item() == N_STEPS


@pytest.fixture(scope="module")
def jax_bf16_loss(slice_case):
    """The first train-mode loss of the JAX TimeUNet(dtype=bfloat16) (the
    train CLI's --bf16: bf16 compute, fp32 parameters) on the case."""
    c = slice_case
    b = {k: jnp.asarray(a) for k, a in c["batch"].items()}
    orig = jtimeunet.LTAE
    jtimeunet.LTAE = functools.partial(JLTAE, dropout=0.0, attn_dropout=0.0)
    try:
        m = jtimeunet.TimeUNet(dtype=jnp.bfloat16, **KW)
        logits, _ = jax.jit(lambda v: m.apply(
            v, b["x"], b["dates"], pad_mask=b["pad_mask"], train=True,
            mutable=["batch_stats"]))(c["v"])
    finally:
        jtimeunet.LTAE = orig
    return float(jlosses.cross_entropy(logits.astype(jnp.float32), b["y"],
                                       weight=jnp.asarray(c["weights"])))


@pytest.mark.parametrize("route", ["plain", "tail"])
def test_bf16_train_step_matches_fp32_and_jax_bf16(slice_case, jax_bf16_loss, route):
    """make_train_step(dtype=torch.bfloat16) on the CPU (autocast): finite
    losses over two steps; the first within BF16_LOSS_RTOL of the port's fp32
    step (which matches JAX's to 1e-5, test above) and of the JAX bf16 model's
    on the same weights; parameters and Adam's state stay fp32."""
    c = slice_case
    model = _port_model(c, defer_tail=True if route == "tail" else None)
    step = make_train_step(model, StepConfig(num_classes=5, class_weights=c["weights"]),
                           device="cpu", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(c["batch"], gen)["loss"]) for _ in range(2)]
    assert np.isfinite(losses).all()
    for want in (c["losses"][0], jax_bf16_loss):
        assert abs(losses[0] - want) <= BF16_LOSS_RTOL * abs(want), (losses[0], want)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    states = [v for st in step.optimizer.state.values() for v in st.values()
              if torch.is_tensor(v) and v.is_floating_point()]
    assert states and all(v.dtype == torch.float32 for v in states)


def test_eval_step_runs_the_served_path(slice_case):
    """make_eval_step in eval mode: loss and confusion matrices of the
    forward that serves (the fused path's plain version on the CPU), and
    the model's running statistics stay as they are."""
    c = slice_case
    model = TimeUNet(**KW)
    model.load_state_dict(convert.timeunet_state_dict_from_flax(c["v"]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = StepConfig(num_classes=5, class_weights=c["weights"])
    aux = make_eval_step(model, cfg, device="cpu")(c["batch"])
    assert not model.training
    assert aux["cm"].sum().item() == c["batch"]["y"].size
    assert np.isfinite(aux["loss"].item())
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
