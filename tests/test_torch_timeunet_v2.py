"""crop2seg_tpu_torch's TimeUNet_v2 (models/timeunet_v2.py) against the JAX
package's: the golden, eval and training with dropout off (logits, loss,
every gradient, the BatchNorm statistics) on the same converted weights and
numpy batch, the converter's round trip, its chunk plan (chunked against
one chunk, checkpointed against plain with dropout on), pad invariance, the
factory, the train CLI (train, resume, --test) and generate_prediction from
a "timeunet_v2" model directory.

Size: the JAX test's small config for the golden (widths (4, 4, 8), 4
heads, d_model 16); widths (8, 8, 16) / (4, 8, 16), out_conv (8, 5), 4
heads, d_model 32 against JAX, B=2, T=7, 16x16, a padded sample.
Tolerances: the golden 5e-4, as tests/test_experimental_models.py holds the
JAX model; whole-model outputs 1e-3, as tests/test_torch_timeunet.py;
gradients as tests/test_torch_train.py's ``_assert_model_grads``; chunked
against one chunk 1e-6; checkpointed against plain bit for bit; pad
invariance 1e-6; serving as tests/test_torch_webapp.py.
"""
import contextlib
import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.models.timeunet_v2 as jtv2
import crop2seg_tpu.nn.tae2d as jtae2d
from crop2seg_tpu.learning import losses as jlosses
from crop2seg_tpu.utils.torch_convert import convert_timeunet_v2
from crop2seg_tpu_torch.learning import losses as tlosses
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.timeunet_v2 import TimeUNetV2
from crop2seg_tpu_torch.utils.convert import flax_param_paths, timeunet_v2_state_dict_from_flax
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc_seq
from tests.test_torch_train import TOL as TRAIN_TOL
from tests.test_torch_train import _assert_model_grads, _np, _stats, _t

SMALL = dict(input_dim=10, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
             out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
TOL = dict(rtol=1e-3, atol=1e-3)


def _inputs(b=2, t=7, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, hw, hw, 10)).astype(np.float32)
    pad = np.zeros((b, t), bool)
    pad[-1, t - 2:] = True
    x[pad] = 0.0
    dates = np.sort(rng.integers(0, 300, (b, t))).astype(np.float32)
    y = rng.integers(0, 5, (b, hw, hw))
    return x, pad, dates, y


@contextlib.contextmanager
def _no_dropout():
    """The JAX TimeUNet_v2 with every dropout rate at 0, for the block: the
    names its TAE2d and the attention are built from are swapped."""
    orig = (jtv2.TAE2d, jtae2d.ClassicalMultiHeadAttention,
            jtae2d.MaskedLightweightAttention)
    jtv2.TAE2d = functools.partial(orig[0], dropout=0.0)
    jtae2d.ClassicalMultiHeadAttention = functools.partial(orig[1], dropout=0.0)
    jtae2d.MaskedLightweightAttention = functools.partial(orig[2], attn_dropout=0.0)
    try:
        yield
    finally:
        (jtv2.TAE2d, jtae2d.ClassicalMultiHeadAttention,
         jtae2d.MaskedLightweightAttention) = orig


def _zero_dropout(model):
    for tae in (model.temporal_encoder_full_resolution,
                model.temporal_encoder_low_resolution):
        tae.dropout = tae.attn_dropout = 0.0
        for st in tae.attention_heads:
            if hasattr(st, "dropout"):
                st.dropout = 0.0


def test_timeunet_v2_golden():
    """The patched reference TimeUNet_v2 (scripts/make_golden.py), its state
    dict loaded as it is."""
    arrays, sd = load_fixture("timeunet_v2_patched")
    m = TimeUNetV2(input_dim=10, encoder_widths=(4, 4, 8), decoder_widths=(2, 4, 8),
                   out_conv=(2, 5), n_head=4, d_model=16, d_k=4).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        y = m(_t(to_nhwc_seq(arrays["x"])), _t(arrays["dates"])).numpy()
    np.testing.assert_allclose(from_nhwc(y), arrays["y"], rtol=5e-4, atol=5e-4)


def test_converter_inverts_the_jax_package_import():
    _, sd = load_fixture("timeunet_v2_patched")
    back = timeunet_v2_state_dict_from_flax(convert_timeunet_v2(sd, n_stages=3))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def case():
    """JAX init (BatchNorm statistics made non-trivial), an eval forward, and
    one train-mode forward and backward with dropout off: logits, the
    weighted cross-entropy, gradients and updated statistics."""
    x, pad, dates, y = _inputs()
    weights = np.ones(5, np.float32)
    weights[4] = 0.0
    jm = jtv2.TimeUNetV2(**SMALL)
    v = _np(jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                      train=False))(x))
    rng = np.random.default_rng(2)
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        v["batch_stats"])}
    out = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, dates, pad_mask=pad,
                                                   train=False))(v, x))
    with _no_dropout():
        jm = jtv2.TimeUNetV2(**SMALL)

        def loss(params):
            logits, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                   x, dates, pad_mask=pad, train=True,
                                   mutable=["batch_stats"])
            val = jlosses.cross_entropy(logits, jnp.asarray(y), weight=jnp.asarray(weights))
            return val, (logits, upd["batch_stats"])
        (val, (logits, stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(v["params"])
    return dict(x=x, pad=pad, dates=dates, y=y, weights=weights, v=v, out=out,
                loss=float(val), logits=np.asarray(logits), grads=_np(grads),
                stats=_np(stats))


def _port(c):
    m = TimeUNetV2(**SMALL)
    m.load_state_dict(timeunet_v2_state_dict_from_flax(c["v"]))
    return m


def _args(c, x=None):
    return _t(c["x"] if x is None else x), _t(c["dates"]), _t(c["pad"])


def test_eval_matches_jax(case):
    m = _port(case).eval()
    with torch.inference_mode():
        got = m(*_args(case)).numpy()
    assert got.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(got, case["out"], **TOL)


def test_train_mode_matches_jax(case):
    """One train-mode forward and backward, dropout off: logits, loss, every
    parameter's gradient and the updated running statistics."""
    m = _port(case).train()
    _zero_dropout(m)
    logits = m(*_args(case))
    loss = tlosses.cross_entropy(logits, _t(case["y"]), weight=_t(case["weights"]))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), case["logits"], **TOL)
    np.testing.assert_allclose(loss.item(), case["loss"], **TRAIN_TOL)
    want = timeunet_v2_state_dict_from_flax({"params": case["grads"],
                                             "batch_stats": case["stats"]})
    _assert_model_grads({k: p.grad.numpy() for k, p in m.named_parameters()},
                        {k: want[k].numpy() for k, _ in m.named_parameters()})
    got = m.state_dict()
    for k, w in _stats(want).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **TRAIN_TOL, err_msg=k)


def test_chunked_classical_attention_equals_one_chunk(case):
    """The full-resolution TAE2d in chunks of 7 pixel rows (74 chunks of the
    2 * 16 * 16 rows, edges inside and across batch items) against one
    chunk, in eval: logits within 1e-6."""
    m = _port(case).eval()
    with torch.inference_mode():
        want = m(*_args(case))
        m.temporal_encoder_full_resolution.chunk_rows = 7
        got = m(*_args(case))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def _grads(m, c, ckpt: bool, seed: int = 0):
    m.zero_grad(set_to_none=True)
    m.temporal_encoder_full_resolution.checkpoint_chunks = ckpt
    logits = m(*_args(c), generator=torch.Generator().manual_seed(seed))
    tlosses.cross_entropy(logits, _t(c["y"]), weight=_t(c["weights"])).backward()
    return logits.detach(), {k: p.grad.clone() for k, p in m.named_parameters()}


def test_checkpointed_chunks_give_the_same_gradients_bit_for_bit(case):
    """Training with every dropout on, chunks of 100 rows: checkpointed and
    plain chunks give the same logits and gradients bit for bit (the
    recompute draws the chunk's masks again from its seed)."""
    m = _port(case).train()
    m.temporal_encoder_full_resolution.chunk_rows = 100
    state = copy.deepcopy(m.state_dict())
    logits, plain = _grads(m, case, False)
    m.load_state_dict(state)                       # the same BatchNorm statistics
    logits_c, ckpt = _grads(m, case, True)
    torch.testing.assert_close(logits_c, logits, rtol=0, atol=0)
    for k in plain:
        torch.testing.assert_close(ckpt[k], plain[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_pad_invariance(case, train):
    """Garbage in the pad frames changes nothing: in_conv's output holds 0
    there, the attention masks the pad keys and every shared block resets
    them. In training (dropout on, the same generator seed) too."""
    m = _port(case).train(train)
    noisy = case["x"].copy()
    noisy[case["pad"]] = np.random.default_rng(9).standard_normal(
        noisy[case["pad"]].shape).astype(np.float32) * 50.0
    state = copy.deepcopy(m.state_dict())
    outs = []
    for x in (case["x"], noisy):
        m.load_state_dict(state)
        with torch.no_grad():
            outs.append(m(*_args(case, x), generator=torch.Generator().manual_seed(3)))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=1e-6, atol=1e-6)


def test_factory_defaults_and_seeded_weights():
    """get_model builds TimeUNet_v2 at the JAX factory's defaults; the keys
    that the JAX ``common_v2`` drops are ignored; seeded weights repeat."""
    cfg = {"model": "timeunet_v2", "num_queries": 3, "use_doy": True, "add_linear": True}
    m = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    assert not m.training
    full, low = m.temporal_encoder_full_resolution, m.temporal_encoder_low_resolution
    st = full.attention_heads[0]
    assert (st.fc_v.weight.shape, st.fc_out.weight.shape) == ((4096, 256), (256, 4096))
    assert full.inconv.weight.shape == (256, 64, 1) and full.mlp[0].weight.shape == (64, 256)
    assert low.attention_heads[0].Q.shape == (16, 1, 4) and low.mlp[0].weight.shape == (128, 256)
    assert full.positional_encoder.fc is None                   # no add_linear
    assert m.out_conv.conv.conv[3].weight.shape == (15, 32, 3, 3)
    again = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 again.state_dict().values()))
    paths = flax_param_paths(m)
    assert paths["temporal_encoder_full_resolution.attention_heads.0.fc_v.weight"] == \
        "temporal_encoder_full_resolution/attention_0/fc_v/kernel"
    assert paths["temporal_encoder_low_resolution.attention_heads.0.Q"] == \
        "temporal_encoder_low_resolution/attention/query"


def test_cli_trains_resumes_and_tests(tmp_path):
    """--model timeunet_v2 on the CPU: two epochs, a resume to three (Adam's
    state restored), then --test of the first run, which repeats its own
    test metrics."""
    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.data import make_synthetic_dataset

    data = str(tmp_path / "data")
    make_synthetic_dataset(data, n_patches=10, t_range=(5, 12), hw=16)
    base = ["--device", "cpu", "--dataset", "synthetic", "--dataset_folder", data,
            "--model", "timeunet_v2", "--encoder_widths", "[8,8,16]",
            "--decoder_widths", "[8,8,16]", "--out_conv", "[8,15]", "--n_head", "2",
            "--d_model", "16", "--batch_size", "2", "--t_buckets", "[8,12]",
            "--display_step", "2"]
    res, res2 = str(tmp_path / "res"), str(tmp_path / "res2")
    run = cli.main(cli.parse_config(base + ["--res_dir", res, "--epochs", "2"]))
    with open(os.path.join(res, "Fold_1", "trainlog.json")) as f:
        log = json.load(f)
    assert sorted(map(int, log)) == [1, 2]
    assert all(np.isfinite(x) for m in log.values() for x in m.values())
    run2 = cli.main(cli.parse_config(base + ["--res_dir", res2, "--epochs", "3",
                                             "--weight_folder", res]))
    assert run2.start_epoch == 3 and run2.restored_adam_step == run.adam_step
    assert run2.adam_step > run.adam_step
    test = cli.main(cli.parse_config(base + ["--res_dir", str(tmp_path / "res3"),
                                             "--test", "--weight_folder", res]))
    for k, v in run.test_metrics.items():
        if not k.endswith("epoch_time"):
            np.testing.assert_allclose(test.test_metrics[k], v, rtol=1e-5, err_msg=k)


def test_generate_prediction_serves_timeunet_v2(tmp_path):
    """generate_prediction builds TimeUNet_v2 from a model directory whose
    conf.json says "timeunet_v2" and serves a 16-patch cell: the map equals
    the stream of the same model's weights bit for bit, and agrees with the
    JAX stream_tile_inference on them within tests/test_torch_webapp.py's
    tolerances."""
    from crop2seg_tpu.models.factory import get_model as jax_get_model
    from crop2seg_tpu.webapp.pipeline import stream_tile_inference as jax_stream
    from crop2seg_tpu_torch.learning import checkpoint as ckpt
    from crop2seg_tpu_torch.webapp.pipeline import generate_prediction, stream_tile_inference
    from tests.test_torch_webapp import CONF, NORM, _datasets, assert_agree, write_cell

    conf = {**CONF, "model": "timeunet_v2"}
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
    model.load_state_dict(timeunet_v2_state_dict_from_flax(v))
    ckpt.save_state(str(model_dir / "Fold_1"), model, None, 0, 0.0)
    res = generate_prediction(cell, str(model_dir), 2019, str(tmp_path / "cache"), device="cpu")
    ds, jds = _datasets(cell)
    proba, classes = stream_tile_inference(model, ds, batch_size=10, device="cpu")
    np.testing.assert_array_equal(res["proba"], proba)
    want_p, want_c = jax_stream(jm, v, jds, batch_size=10)
    assert_agree(proba, classes, want_p, want_c)
