"""crop2seg_tpu_torch U-TAE in training mode against the JAX U-TAE, and its
activation checkpointing (remat).

Size: __graft_entry__._flagship(small=True)'s widths (in 10, encoder (8, 8,
16), decoder (4, 8, 16), out_conv (8, 15), 4 heads, d_model 32), B=2, T=7,
16x16 with a padded sample. The L-TAE takes its plain path with the attention
out in training (the JAX route), and the skips aggregate that attention.
Dropout is zeroed on both sides, as tests/test_torch_train.py does for
TimeUNet: on the JAX side by swapping the ``LTAE`` name that
crop2seg_tpu/models/utae.py imports, on the port side by setting the rates.
Tolerances are tests/test_torch_train.py's, for the same reasons.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.models.utae as jutae
from crop2seg_tpu.learning import losses as jlosses
from crop2seg_tpu.learning import trainer as jtrainer
from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu_torch.learning import losses as tlosses
from crop2seg_tpu_torch.learning.trainer import StepConfig, make_train_step
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.utae import UTAE
from crop2seg_tpu_torch.utils.convert import utae_state_dict_from_flax
from tests.test_torch_train import BF16_LOSS_RTOL, TOL, _assert_model_grads, _np, _stats, _t

KW = dict(input_dim=10, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
          out_conv=(8, 15), n_head=4, d_model=32, d_k=4)
WEIGHTS = (1.0,) * 14 + (0.0,)
N_STEPS = 3


class _NoDropout:
    """The JAX U-TAE with its L-TAE's dropout rates at 0, for the block."""

    def __enter__(self):
        self.orig = jutae.LTAE
        jutae.LTAE = functools.partial(JLTAE, dropout=0.0, attn_dropout=0.0)
        return jutae.UTAE(**KW)

    def __exit__(self, *exc):
        jutae.LTAE = self.orig


@pytest.fixture(scope="module")
def case():
    """The batch, the initial variables, the JAX train-mode loss, gradients
    and statistics of one forward, and three jitted JAX train steps (Adam)."""
    rng = np.random.default_rng(0)
    b, t, hw = 2, 7, 16
    pad = np.arange(t)[None] >= np.array([t, t - 2])[:, None]
    x = rng.standard_normal((b, t, hw, hw, 10)).astype(np.float32)
    x[pad] = 0.0
    batch = {"x": x, "pad_mask": pad, "y": rng.integers(0, 15, (b, hw, hw)),
             "dates": np.sort(rng.integers(0, 300, (b, t))).astype(np.float32)}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    with _NoDropout() as m:
        v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, batch["dates"],
                                         pad_mask=pad, train=False))(x))

        def loss(params):
            logits, upd = m.apply({"params": params, "batch_stats": v["batch_stats"]},
                                  jb["x"], jb["dates"], pad_mask=jb["pad_mask"],
                                  train=True, mutable=["batch_stats"])
            return jlosses.cross_entropy(logits, jb["y"], weight=jnp.asarray(
                WEIGHTS)), upd["batch_stats"]

        (val, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        state = jtrainer.create_train_state(m, v, 1e-3)
        step = jax.jit(jtrainer.make_train_step(
            m, jtrainer.StepConfig(num_classes=15, class_weights=WEIGHTS)))
        losses = []
        for i in range(N_STEPS):
            state, aux = step(state, jb, jax.random.PRNGKey(i))
            losses.append(float(aux["loss"]))
    return dict(batch=batch, v=v, loss=float(val), grads=_np(grads), stats=_np(stats),
                losses=losses, cm=np.asarray(aux["cm"]),
                after={"params": _np(state.params), "batch_stats": _np(state.batch_stats)})


def _port_model(c, **kw):
    """The port's U-TAE on the case's converted weights, dropout zeroed."""
    model = UTAE(**KW, **kw)
    model.load_state_dict(utae_state_dict_from_flax(c["v"]))
    model.temporal_encoder.attn_dropout = 0.0
    model.temporal_encoder.mlp[1].p = 0.0
    return model


def _loss(model, c, **kw):
    bt = {k: _t(a) for k, a in c["batch"].items()}
    logits = model(bt["x"], bt["dates"], bt["pad_mask"], **kw)
    return tlosses.cross_entropy(logits, bt["y"], weight=_t(np.asarray(WEIGHTS, np.float32)))


def test_train_mode_matches_jax(case):
    """One train-mode forward and backward: the loss, every parameter
    gradient (the L-TAE's and the attention-weighted skips' included) and
    the updated running statistics."""
    model = _port_model(case).train()
    loss = _loss(model, case)
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["loss"], **TOL)
    want = utae_state_dict_from_flax({"params": case["grads"],
                                      "batch_stats": case["stats"]})
    _assert_model_grads({k: p.grad.numpy() for k, p in model.named_parameters()},
                        {k: want[k].numpy() for k, _ in model.named_parameters()})
    got = model.state_dict()
    for k, w in _stats(want).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_train_steps_match_jax(case):
    """make_train_step (Adam, lr 1e-3) over three steps: the loss sequence,
    the last confusion matrix and every parameter and running statistic
    after the last step (bounds as tests/test_torch_train.py sets them)."""
    model = _port_model(case)
    step = make_train_step(model, StepConfig(num_classes=15, class_weights=WEIGHTS),
                           device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(N_STEPS):
        aux = step(case["batch"], gen)
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, case["losses"], rtol=1e-5)
    np.testing.assert_array_equal(aux["cm"].numpy(), case["cm"])
    want = utae_state_dict_from_flax(case["after"])
    before = utae_state_dict_from_flax(case["v"])
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
            tol = TOL if "running_" in k else dict(rtol=0, atol=2e-4)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **tol, err_msg=k)
    assert got["up_blocks.0.up.1.num_batches_tracked"].item() == N_STEPS


def test_bf16_train_step(case):
    """make_train_step(dtype=torch.bfloat16) on the CPU (autocast): finite
    losses over two steps, the first within BF16_LOSS_RTOL of the fp32 one
    (which matches JAX, above); parameters stay fp32."""
    model = _port_model(case)
    step = make_train_step(model, StepConfig(num_classes=15, class_weights=WEIGHTS),
                           device="cpu", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(case["batch"], gen)["loss"]) for _ in range(2)]
    assert np.isfinite(losses).all()
    assert abs(losses[0] - case["losses"][0]) <= BF16_LOSS_RTOL * case["losses"][0]
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("policy", ["conv_out", "full"])
def test_remat_gradients_equal_no_remat(case, policy):
    """remat (in_conv, the down blocks, the up blocks and the head all
    checkpointed) gives the gradients, the loss and the running statistics
    of the same step without remat, bit for bit on the CPU: ``conv_out``
    reuses each convolution's saved output, ``full`` recomputes it, and the
    recompute does not update BatchNorm's running statistics a second time.
    encoder_norm="batch" puts BatchNorm inside every checkpointed block."""
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = UTAE(**KW, encoder_norm="batch", remat=remat, remat_policy=policy).train()
        gen = torch.Generator().manual_seed(3)
        loss = _loss(model, case, generator=gen)
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
    assert s1["up_blocks.0.up.1.num_batches_tracked"].item() == 1
    assert s1["in_conv.conv.conv.1.num_batches_tracked"].item() == 1


def test_remat_policy_is_validated():
    """The factory's remat_policy: "conv_out" by default, "full" accepted,
    anything else raises, as the JAX factory does."""
    cfg = {"model": "utae", "encoder_widths": [8, 16], "decoder_widths": [8, 16],
           "out_conv": [8, 3], "n_head": 4, "d_model": 16, "remat": True}
    assert get_model(cfg, device="cpu").remat_policy == "conv_out"
    assert get_model(dict(cfg, remat_policy="full"), device="cpu").remat_policy == "full"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        get_model(dict(cfg, remat_policy="conv"), device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        UTAE(**KW, remat_policy="everything")
