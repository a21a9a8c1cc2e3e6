"""crop2seg_tpu_torch's train and eval steps with the boundary loss, region
masking, ``return_pred``, ``run_epoch``, frozen layers and TimeUNet's remat,
against the JAX package on the same converted weights and numpy batches.

Size: the small U-TAE of tests/test_torch_utae_train.py (in 10, encoder (8,
8, 16), decoder (4, 8, 16), out_conv (8, 15), 4 heads, d_model 32) with the
boundary head, B=2, T=7, 16x16, one padded sample; dropout zeroed on both
sides as there. Tolerances: the losses 5e-4 relative and every parameter's
gradient 5e-4 of its 2-norm (train-mode BatchNorm amplifies the frameworks'
rounding differences in single entries, tests/test_torch_train.py); the
confusion matrices equal; ``run_epoch``'s metrics 1e-5 (its epoch time
aside).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.models.utae as jutae
from crop2seg_tpu.learning import trainer as jtrainer
from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu_torch.learning import trainer as ttrainer
from crop2seg_tpu_torch.learning.trainer import (
    StepConfig, create_train_state, freeze_labels, make_eval_step,
    make_train_step, run_epoch)
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.models.utae import UTAE
from crop2seg_tpu_torch.utils.convert import utae_state_dict_from_flax

KW = dict(input_dim=10, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
          out_conv=(8, 15), n_head=4, d_model=32, d_k=4)
WEIGHTS = (1.0,) * 14 + (0.0,)
TOL = 5e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, b=2, t=7, hw=16):
    rng = np.random.default_rng(seed)
    pad = np.arange(t)[None] >= np.array([t, t - 2] * (b // 2))[:, None]
    x = rng.standard_normal((b, t, hw, hw, 10)).astype(np.float32)
    x[pad] = 0.0
    # blobs of classes, so that boundaries and interiors both exist
    y = np.repeat(np.repeat(rng.integers(0, 15, (b, hw // 4, hw // 4)), 4, 1), 4, 2)
    return {"x": x, "pad_mask": pad, "y": y.astype(np.int32),
            "dates": np.sort(rng.integers(0, 300, (b, t))).astype(np.float32)}


class _NoDropout:
    """The JAX U-TAE with its L-TAE's dropout rates at 0, for the block."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.orig = jutae.LTAE
        jutae.LTAE = functools.partial(JLTAE, dropout=0.0, attn_dropout=0.0)
        return jutae.UTAE(**KW, **self.kw)

    def __exit__(self, *exc):
        jutae.LTAE = self.orig


def _cfg(**kw):
    return jtrainer.StepConfig(num_classes=15, class_weights=WEIGHTS,
                               add_boundary_loss=True, **kw)


@pytest.fixture(scope="module")
def case():
    """The JAX U-TAE with the boundary head: its variables (BatchNorm
    statistics made non-trivial), the train-mode loss, aux and gradients of
    one batch, and its eval step's aux by region with the predictions."""
    batch = _batch(0)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    with _NoDropout(add_boundary_loss=True) as m:
        v = _np(jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, batch["dates"],
                                         pad_mask=batch["pad_mask"], train=False))(
            batch["x"]))
        rng = np.random.default_rng(5)
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32),
            v["batch_stats"])

        def loss(params):
            lv, (_, aux) = jtrainer._loss_and_metrics(
                m, _cfg(), params, v["batch_stats"], jb, True,
                rngs={"dropout": jax.random.PRNGKey(1)})
            return lv, aux

        (_, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        state = jtrainer.create_train_state(m, v, 1e-3)
        evals, steps = {}, {}
        for region in ("all", "boundary", "interior"):
            steps[region] = jax.jit(jtrainer.make_eval_step(
                m, _cfg(test_region=region), return_pred=True))
            evals[region] = _np(steps[region](state, jb))
        batches = [_batch(s) for s in (1, 2, 3)]
        epochs = {}
        for homog in (False, True):   # run_epoch reads "pred" only to homogenize
            _, metrics, cms = jtrainer.run_epoch(
                steps["all"], state, batches, _cfg(), mode="val", display_step=2,
                log_fn=lambda s: None, homogenizer=_homogenizer if homog else None)
            epochs[homog] = (metrics, cms)
    return dict(batch=batch, v=v, aux=_np(aux), grads=_np(grads), evals=evals,
                batches=batches, epochs=epochs)


def _homogenizer(pred, batch):
    """A deterministic stand-in for the LPIS homogenizer: each 4x4 block
    takes its top-left prediction."""
    p = np.asarray(pred)
    return np.repeat(np.repeat(p[:, ::4, ::4], 4, 1), 4, 2)


def _port(c, **kw):
    model = UTAE(**KW, add_boundary_loss=True, **kw)
    model.load_state_dict(utae_state_dict_from_flax(c["v"]))
    model.temporal_encoder.attn_dropout = 0.0
    model.temporal_encoder.mlp[1].p = 0.0
    return model


def _tcfg(**kw):
    return StepConfig(num_classes=15, class_weights=WEIGHTS, add_boundary_loss=True, **kw)


def test_boundary_loss_step_matches_jax(case):
    """One make_train_step on the CPU: loss, loss_b, cm, cm_b and cm_top2,
    and every parameter's gradient (as left by the step)."""
    model = _port(case)
    step = make_train_step(model, _tcfg(), device="cpu")
    aux = step(case["batch"], torch.Generator().manual_seed(0))
    want = case["aux"]
    np.testing.assert_allclose(aux["loss"].item(), want["loss"], rtol=TOL)
    np.testing.assert_allclose(aux["loss_b"].item(), want["loss_b"], rtol=TOL)
    assert 0 < aux["loss_b"].item() < aux["loss"].item()
    for k in ("cm", "cm_b", "cm_top2"):
        np.testing.assert_array_equal(aux[k].numpy(), want[k], err_msg=k)
    assert aux["cm_b"].shape == (2, 2) and aux["cm_b"][1].sum() > 0
    grads = utae_state_dict_from_flax({"params": case["grads"],
                                       "batch_stats": case["v"]["batch_stats"]})
    top = max(g.abs().max().item() for g in grads.values())
    for k, p in model.named_parameters():
        w = grads[k]
        if w.abs().max().item() <= 1e-5 * top:
            assert p.grad.abs().max().item() <= 1e-5 * top, k
        else:
            assert (p.grad - w).norm() <= TOL * w.norm(), k


@pytest.mark.parametrize("region", ["all", "boundary", "interior"])
def test_eval_step_regions_and_pred_match_jax(case, region):
    """make_eval_step(return_pred=True) with test_region: the region's
    confusion matrices, the boundary head's, and the predictions."""
    aux = make_eval_step(_port(case), _tcfg(test_region=region), device="cpu",
                         return_pred=True)(case["batch"])
    want = case["evals"][region]
    for k in ("cm", "cm_top2", "cm_b", "pred"):
        np.testing.assert_array_equal(aux[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(aux["loss"].item(), want["loss"], rtol=TOL)
    if region != "all":   # the pixels outside the region go to the ignore class
        assert aux["cm"][14].sum() > case["evals"]["all"]["cm"][14].sum()
    assert "pred" not in make_eval_step(_port(case), _tcfg(), device="cpu")(case["batch"])


@pytest.mark.parametrize("homogenize", [False, True])
def test_run_epoch_val_matches_jax(case, homogenize):
    """run_epoch in val mode over three fixed batches (a flush after two),
    with and without a deterministic homogenizer: every metric within 1e-5,
    the epoch time aside, and the confusion matrices equal."""
    model = _port(case)
    step = make_eval_step(model, _tcfg(), device="cpu", return_pred=homogenize)
    logs = []
    metrics, cms = run_epoch(step, case["batches"], _tcfg(), mode="val",
                             display_step=2, log_fn=logs.append,
                             homogenizer=_homogenizer if homogenize else None)
    want_m, want_cms = case["epochs"][homogenize]
    assert metrics.keys() == want_m.keys() and len(logs) == 1
    for k, w in want_m.items():
        if not k.endswith("epoch_time"):
            np.testing.assert_allclose(metrics[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    assert cms.keys() == want_cms.keys() == {"top1", "top2", "boundary"}
    for k in cms:
        assert cms[k].dtype == np.int64
        np.testing.assert_array_equal(cms[k], want_cms[k], err_msg=k)


def test_run_epoch_train_accumulates_on_the_device(monkeypatch):
    """In train mode the generator reaches every step, and the loss and the
    matrices are read on the host only at the flushes: no per-step read."""
    reads = []
    orig = ttrainer.IoUMeter.add_cm

    def add_cm(self, cm):
        reads.append(1)
        return orig(self, cm)
    monkeypatch.setattr(ttrainer.IoUMeter, "add_cm", add_cm)
    gens = []

    def step(batch, generator):
        gens.append(generator)
        return {"loss": torch.tensor(1.5), "cm": torch.eye(15, dtype=torch.int64),
                "cm_top2": torch.eye(15, dtype=torch.int64)}
    gen = torch.Generator()
    metrics, cms = run_epoch(step, range(7), StepConfig(), mode="train",
                             generator=gen, display_step=3, log_fn=lambda s: None)
    assert gens == [gen] * 7 and len(reads) == 3 * 2   # two matrices, three flushes
    assert metrics["train_loss"] == 1.5 and cms["top1"].trace() == 7 * 15


def _flax_frozen(v, prefixes):
    """The JAX freeze_labels on the JAX variables -> the set of port
    parameter names of the frozen leaves (through the weight converter)."""
    from flax import traverse_util

    labels = traverse_util.flatten_dict(jtrainer.freeze_labels(v["params"], prefixes))
    flat = traverse_util.flatten_dict(v["params"])
    marks = traverse_util.unflatten_dict(
        {k: np.full(np.shape(a), 1.0 if labels[k] == "frozen" else 0.0, np.float32)
         for k, a in flat.items()})
    sd = utae_state_dict_from_flax({"params": marks, "batch_stats": v["batch_stats"]})
    return {k for k, a in sd.items() if "running" not in k and "num_batches" not in k
            and a.numel() and a.min() == 1.0}


@pytest.mark.parametrize("prefixes", [("in_conv", "down"), ("temporal_encoder/attention",),
                                      ("up_0/up_norm", "out_conv", "boundary_conv"),
                                      ("down_1/conv1/conv0", "temporal_encoder/mlp")])
def test_freeze_prefixes_select_the_jax_frozen_set(case, prefixes):
    labels = freeze_labels(_port(case), prefixes)
    frozen = {k for k, v in labels.items() if v == "frozen"}
    assert frozen and frozen == _flax_frozen(case["v"], prefixes)
    assert set(labels) == {k for k, _ in _port(case).named_parameters()}


def test_frozen_parameters_stay_put():
    """Two steps with in_conv and the down blocks frozen (batch norms in the
    encoder): frozen parameters bit for bit unchanged and without Adam
    state, the others moved, BatchNorm statistics updated everywhere."""
    torch.manual_seed(0)
    model = UTAE(**KW, encoder_norm="batch")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = create_train_state(model, 1e-3, frozen_prefixes=("in_conv", "down"))
    step = make_train_step(model, StepConfig(num_classes=15, class_weights=WEIGHTS),
                           opt, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for seed in (0, 1):
        step(_batch(seed), gen)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    after = model.state_dict()
    for k, p in model.named_parameters():
        frozen = k.startswith(("in_conv.", "down_blocks."))
        assert (id(p) in in_opt) != frozen, k
        if frozen:
            assert torch.equal(p, before[k]) and p not in opt.state, k
        elif not k.endswith("bias"):   # biases under a train-mode BatchNorm get ~0
            assert not torch.equal(p, before[k]), k
    for k in ("in_conv.conv.conv.1.running_mean", "down_blocks.0.conv1.conv.1.running_var",
              "up_blocks.0.up.1.running_mean"):
        assert not torch.equal(after[k], before[k]), k
    assert after["in_conv.conv.conv.1.num_batches_tracked"].item() == 2


@pytest.mark.parametrize("defer_tail", [False, True])
def test_timeunet_remat_gradients_equal_no_remat(defer_tail):
    """TimeUNet's remat (the down and up blocks and out_conv recomputed
    whole; in_conv and the L-TAE outside) gives the loss, the gradients and
    the running statistics of the same step without remat, bit for bit on
    the CPU, on the plain route and with in_conv's tail deferred
    (ltae_pool_tail's plain version)."""
    from crop2seg_tpu_torch.learning.losses import cross_entropy

    b = _batch(4)
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = TimeUNet(**KW, remat=remat, defer_tail=defer_tail).train()
        logits = model(torch.tensor(b["x"]), torch.tensor(b["dates"]),
                       torch.tensor(b["pad_mask"]),
                       generator=torch.Generator().manual_seed(3))
        loss = cross_entropy(logits, torch.tensor(b["y"]),
                             weight=torch.tensor(WEIGHTS))
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


def test_timeunet_remat_recomputes_the_blocks_but_not_in_conv():
    """With remat a training step runs each down block, up block and
    out_conv forward twice (the recompute in the backward pass) and in_conv
    once; without remat every block runs once."""
    from crop2seg_tpu_torch.learning.losses import cross_entropy

    b = _batch(2)
    for remat in (False, True):
        torch.manual_seed(0)
        model = TimeUNet(**KW, remat=remat).train()
        calls = {}
        blocks = {"in_conv": model.in_conv, "out_conv": model.out_conv,
                  **{f"down.{i}": m for i, m in enumerate(model.down_blocks)},
                  **{f"up.{i}": m for i, m in enumerate(model.up_blocks)}}
        for name, mod in blocks.items():
            # counted in forward itself: the recompute calls no module hook
            def counted(*args, name=name, forward=mod.forward):
                calls[name] = calls.get(name, 0) + 1
                return forward(*args)
            mod.forward = counted
        logits = model(torch.tensor(b["x"]), torch.tensor(b["dates"]),
                       torch.tensor(b["pad_mask"]),
                       generator=torch.Generator().manual_seed(3))
        cross_entropy(logits, torch.tensor(b["y"]), weight=torch.tensor(WEIGHTS)).backward()
        want = {k: 1 if k == "in_conv" or not remat else 2 for k in blocks}
        assert calls == want, (remat, calls)


def test_factory_passes_timeunet_remat_and_refuses_seq_chunk():
    from crop2seg_tpu_torch.models.factory import get_model

    cfg = {"model": "timeunet", "encoder_widths": [8, 8], "decoder_widths": [8, 8],
           "out_conv": [8, 3], "n_head": 2, "d_model": 16}
    assert get_model(dict(cfg, remat=True), device="cpu").remat
    assert not get_model(cfg, device="cpu").remat
    assert get_model(dict(cfg, seq_chunk=8), device="cpu").temporal_encoder.seq_chunk == 8
    assert get_model(cfg, device="cpu").temporal_encoder.seq_chunk is None
