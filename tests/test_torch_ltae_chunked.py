"""crop2seg_tpu_torch's L-TAE streamed over T (``LTAE._chunked``,
``seq_chunk``) on the CPU: against the JAX ``_chunked`` and the JAX plain
path at the JAX tests' own sizes and tolerances (tests/test_ltae_chunked.py:
B=2, T=13, 8x8, C=32, 8 heads, d_model 64, d_out 16: the out GroupNorm's
groups of two channels amplify fp32 noise, so rtol 1e-3 / atol 2e-4); the
port's chunked path against its plain path in float64, forward and every
gradient, near 1e-10; BatchNorm's running statistics against JAX; a
checkpointed chunk's recompute draws the dropout it drew; the routing order
(eval kernel, kernel pair, seq_chunk, plain); TimeUNet with seq_chunk
against the JAX TimeUNet; and the factory and the train CLI with
``--seq_chunk``."""
import copy

import jax
import numpy as np
import pytest
import torch

from crop2seg_tpu.models import TimeUNet as JTimeUNet
from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu_torch import train as cli
from crop2seg_tpu_torch.data import make_synthetic_dataset
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.nn import ltae as ltae_mod
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.utils.convert import (
    ltae_state_dict_from_flax, timeunet_state_dict_from_flax)

B, T, H, W, C = 2, 13, 8, 8, 32
DM = 64
JAX_TOL = dict(rtol=1e-3, atol=2e-4)


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H, W, C)).astype(dtype)
    dates = np.sort(rng.integers(0, 300, (B, T))).astype(dtype)
    mask = np.zeros((B, T), bool)
    mask[1, T - 4:] = True
    return x, dates, mask


def _jltae(seq_chunk=None):
    return JLTAE(in_channels=C, d_model=DM, mlp=(DM, 16), n_head=8, d_k=4,
                 dropout=0.0, attn_dropout=0.0, seq_chunk=seq_chunk)


def _ltae(seq_chunk=None, attn_dropout=0.0):
    """The port's twin of ``_jltae``: both kernel flags off, as the JAX
    module's defaults have them."""
    return LTAE(in_channels=C, d_model=DM, mlp=(DM, 16), n_head=8, d_k=4, dropout=0.0,
                attn_dropout=attn_dropout, seq_chunk=seq_chunk, use_pallas=False,
                use_pallas_train=False)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def jax_case():
    x, dates, mask = _inputs()
    v = _jltae().init(jax.random.PRNGKey(0), x, dates, pad_mask=mask, train=False)
    rng = np.random.default_rng(3)
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": jax.tree_util.tree_map(  # non-trivial BN statistics
             lambda a: np.abs(np.asarray(a) + 0.3 * rng.standard_normal(a.shape)
                              ).astype(np.float32), v["batch_stats"])}
    plain = np.asarray(_jltae().apply(v, x, dates, pad_mask=mask, train=False,
                                      need_attn=True)[0])
    return dict(x=x, dates=dates, mask=mask, v=v, plain=plain)


@pytest.mark.parametrize("seq_chunk", [4, 5, 13])
def test_chunked_forward_matches_jax(jax_case, seq_chunk):
    c = jax_case
    want, attn = _jltae(seq_chunk).apply(c["v"], c["x"], c["dates"], pad_mask=c["mask"],
                                         train=False, need_attn=False)
    assert attn is None
    m = _ltae(seq_chunk).eval()
    m.load_state_dict(ltae_state_dict_from_flax(c["v"]))
    calls = []
    chunked = m._chunked
    m._chunked = lambda *a, **k: calls.append(1) or chunked(*a, **k)
    with torch.no_grad():
        got, att = m(_t(c["x"]), _t(c["dates"]), _t(c["mask"]), need_attn=False, fused=False)
    assert att is None and calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    np.testing.assert_allclose(got.numpy(), c["plain"], **JAX_TOL)


def test_chunked_matches_plain_in_float64():
    """Forward in eval and training, and every gradient of a train-mode
    call (a non-trivial cotangent), float64: the online softmax is exact up
    to the order of sums."""
    x, dates, mask = _inputs(1, np.float64)
    torch.manual_seed(0)
    plain = _ltae().double()
    fast = copy.deepcopy(plain)
    fast.seq_chunk = 4
    args = (_t(dates), _t(mask))
    with torch.no_grad():
        want, _ = plain.eval()(_t(x), *args, need_attn=True, fused=False)
        got, _ = fast.eval()(_t(x), *args, need_attn=False, fused=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-10)
    grads = {}
    for name, m, need_attn in (("plain", plain, True), ("fast", fast, False)):
        xr = _t(x).requires_grad_()
        out, _ = m.train()(xr, *args, need_attn=need_attn, fused=False)
        torch.sin(out).sum().backward()
        grads[name] = {"x": xr.grad, **{k: p.grad for k, p in m.named_parameters()}}
    assert grads["plain"].keys() == grads["fast"].keys()
    for k, g in grads["plain"].items():
        np.testing.assert_allclose(grads["fast"][k].numpy(), g.numpy(), rtol=1e-7,
                                   atol=1e-10, err_msg=k)


def test_chunked_batchnorm_stats_match_jax(jax_case):
    """BatchNorm sees every pixel row in the chunked path too: the running
    statistics after one train-mode call are the JAX chunked path's."""
    c = jax_case
    _, upd = _jltae(5).apply(c["v"], c["x"], c["dates"], pad_mask=c["mask"], train=True,
                             need_attn=False, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(1)})
    m = _ltae(5).train()
    m.load_state_dict(ltae_state_dict_from_flax(c["v"]))
    with torch.no_grad():
        m(_t(c["x"]), _t(c["dates"]), _t(c["mask"]), need_attn=False, fused=False)
    bn = upd["batch_stats"]["mlp_bn"]
    np.testing.assert_allclose(m.mlp[2].running_mean.numpy(), bn["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.mlp[2].running_var.numpy(), bn["var"], rtol=1e-5, atol=1e-6)


def test_checkpointed_chunks_recompute_their_dropout(monkeypatch):
    """With attention dropout the backward recomputes each chunk and must
    draw the masks the forward drew: its gradients equal those of the same
    forward kept whole (checkpointing off), bit for bit, and two forwards
    with one generator seed agree."""
    x, dates, mask = _inputs(2)
    torch.manual_seed(1)
    base = _ltae(4, attn_dropout=0.3)

    def grads(no_recompute):
        if no_recompute:
            monkeypatch.setattr(ltae_mod, "checkpoint", lambda fn, *a, **k: fn(*a))
        m = copy.deepcopy(base).train()
        out, _ = m(_t(x), _t(dates), _t(mask), need_attn=False, fused=False,
                   generator=torch.Generator().manual_seed(5))
        torch.sin(out).sum().backward()
        monkeypatch.undo()
        return out, {k: p.grad for k, p in m.named_parameters()}

    out_a, ga = grads(False)
    out_b, gb = grads(True)
    assert torch.equal(out_a, out_b)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k
    outs = {}
    for seed in (5, 6):
        with torch.no_grad():
            outs[seed], _ = copy.deepcopy(base).train()(
                _t(x), _t(dates), _t(mask), need_attn=False, fused=False,
                generator=torch.Generator().manual_seed(seed))
    assert torch.equal(outs[5], out_a) and not torch.equal(outs[6], out_a)


def test_routing_follows_the_jax_order(monkeypatch):
    """The flags' gate order (crop2seg_tpu/nn/ltae.py:471-485): the eval
    kernel (``use_pallas``, eval), then the kernel pair (``use_pallas_train``,
    one query, no attention output, in eval too), then seq_chunk (one query,
    no attention output), then the plain ops; on the CPU ``fused=True``
    reaches the kernel wrappers (their plain versions), and the eval kernel's
    route without it runs the plain ops."""
    x, dates, mask = _inputs(3)
    m = _ltae(4)
    seen = []
    for name in ("_fused", "_train", "_chunked", "_plain"):
        fn = getattr(m, name)
        monkeypatch.setattr(m, name, lambda *a, _n=name, _f=fn, **k: seen.append(_n) or _f(*a, **k))
    args = (_t(x), _t(dates), _t(mask))
    # (use_pallas, use_pallas_train, training, fused, need_attn, want)
    cases = [(True, True, False, True, False, "_fused"),
             (True, True, True, True, False, "_train"),
             (False, True, False, True, False, "_train"),
             (True, True, False, False, False, "_plain"),
             (True, True, True, False, False, "_train"),
             (False, False, False, True, False, "_chunked"),
             (True, False, True, True, False, "_chunked"),
             (False, False, True, False, False, "_chunked"),
             (False, True, False, True, True, "_plain"),
             (True, True, True, True, True, "_plain")]
    for use_pallas, use_pallas_train, training, fused, need_attn, want in cases:
        seen.clear()
        m.use_pallas, m.use_pallas_train = use_pallas, use_pallas_train
        m.train(training)
        with torch.no_grad():
            m(*args, need_attn=need_attn, fused=fused)
        assert seen == [want], (use_pallas, use_pallas_train, training, fused, need_attn, seen)
    # a deferred tail keeps the pair's plain version; seq_chunk and the plain
    # ops take no tail
    seen.clear()
    m.train()
    m.use_pallas_train = True
    tail = (torch.ones(B, T, C), torch.zeros(B, T, C))
    with torch.no_grad():
        m(*args, need_attn=False, fused=False, tail_affine=tail)
    assert seen == ["_train"]
    m.use_pallas_train = False
    with pytest.raises(ValueError), torch.no_grad():
        m(*args, need_attn=False, fused=False, tail_affine=tail)


@pytest.fixture(scope="module")
def timeunet_case():
    kw = dict(input_dim=10, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
              out_conv=(8, 15), n_head=4, d_model=32, d_k=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 16, 16, 10)).astype(np.float32)
    pad = np.zeros((2, 9), bool)
    pad[1, 7:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(9) * 5.0).astype(np.float32), (2, 1))
    jm = JTimeUNet(seq_chunk=4, **kw)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(2), x, dates, pad_mask=pad,
                                  train=False))(x)
    v = jax.tree_util.tree_map(np.asarray, v)
    y = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, dates, pad_mask=pad,
                                                 train=False))(v, x))
    return dict(kw=kw, x=x, pad=pad, dates=dates, v=v, y=y)


def test_timeunet_with_seq_chunk_matches_jax(timeunet_case, monkeypatch):
    """TimeUNet(seq_chunk=4) with both kernel flags off (the JAX TimeUNet's
    defaults) streams its L-TAE (``_chunked``) in eval and training, and gives the JAX TimeUNet's logits (1e-3, whole model); a train-mode
    step from it is finite."""
    c = timeunet_case
    m = TimeUNet(seq_chunk=4, use_pallas=False, use_pallas_train=False, **c["kw"]).eval()
    m.load_state_dict(timeunet_state_dict_from_flax(c["v"]))
    calls = []
    chunked = m.temporal_encoder._chunked
    monkeypatch.setattr(m.temporal_encoder, "_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    with torch.no_grad():
        got = m(_t(c["x"]), _t(c["dates"]), _t(c["pad"]))
    np.testing.assert_allclose(got.numpy(), c["y"], rtol=1e-3, atol=1e-3)
    m.train()
    logits = m(_t(c["x"]), _t(c["dates"]), _t(c["pad"]),
               generator=torch.Generator().manual_seed(0))
    logits.square().mean().backward()
    assert calls == [1, 1] and torch.isfinite(logits).all()
    assert all(torch.isfinite(p.grad).all() for p in m.parameters() if p.grad is not None)


def test_factory_and_cli_accept_seq_chunk(tmp_path, monkeypatch):
    cfg = {"model": "timeunet", "encoder_widths": [8, 8], "decoder_widths": [8, 8],
           "out_conv": [8, 15], "n_head": 2, "d_model": 16, "seq_chunk": 4}
    assert get_model(cfg, device="cpu").temporal_encoder.seq_chunk == 4
    data = tmp_path / "data"
    make_synthetic_dataset(str(data), n_patches=10, t_range=(5, 12), hw=16)
    calls = []
    chunked = LTAE._chunked
    monkeypatch.setattr(LTAE, "_chunked",
                        lambda self, *a, **k: calls.append(self.training) or chunked(self, *a, **k))
    run = cli.main(cli.parse_config([
        "--device", "cpu", "--dataset", "synthetic", "--dataset_folder", str(data),
        "--res_dir", str(tmp_path / "res"), "--model", "timeunet", "--encoder_widths", "[8,8]",
        "--decoder_widths", "[8,8]", "--out_conv", "[8,15]", "--n_head", "2", "--d_model", "16",
        "--batch_size", "2", "--t_buckets", "[12]", "--epochs", "1", "--seq_chunk", "4"]))
    assert np.isfinite(run.test_metrics["test_loss"])
    assert True in calls and False in calls          # training and eval both streamed
