"""crop2seg_tpu_torch's TAE2d (nn/tae2d.py) against the JAX package's: the
four classical goldens, the JAX module in eval and in training with dropout
off (outputs, every gradient, the BatchNorm statistics) for both attention
types and every reduction, the converter's round trip, and the memory plan:
chunks of pixel rows against one chunk, checkpointed chunks against plain
ones with dropout on.

Size: B=2, T=7, 4x4 pixels, C=16, 4 heads, d_k 4, d_model 32, MLP (32, 16),
a padded sample; the goldens' own (T=9, 8x8, C=32, 8 heads, d_model 64).
Tolerances: the goldens 5e-4, as tests/test_mbconv_unet_parity.py holds the
JAX module to them; the module against JAX 5e-4 (the goldens' fp32
tolerance: the frameworks sum in other orders), gradients as
tests/test_torch_train.py holds them; chunked against unchunked 1e-6 and
checkpointed against plain bit for bit (the same ops on the same rows).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.nn.tae2d as jtae2d
from crop2seg_tpu.utils.torch_convert import convert_tae2d
from crop2seg_tpu_torch.nn import tae2d as tt
from crop2seg_tpu_torch.nn.tae2d import TAE2d
from crop2seg_tpu_torch.utils.convert import tae2d_state_dict_from_flax
from tests.parity_utils import attn_from_torch, from_nhwc, load_fixture, to_nhwc_seq
from tests.test_torch_train import TOL, _assert_grads, _np, _stats, _t

B, T, H, W, C = 2, 7, 4, 4, 16
KW = dict(in_channels=C, n_head=4, d_k=4, d_model=32, mlp=(32, 16))
# (attention type, embedding reduction, attention reduction, cls tokens)
CONFIGS = {
    "classical_sequence": ("classical", None, None, 1),
    "classical_mean": ("classical", "mean", "mean", 1),
    "classical_cls2_linear": ("classical", "cls", "linear", 2),
    "classical_linear_cls1": ("classical", "linear", "cls", 1),
    "lightweight": ("lightweight", "mean", "mean", 1),
}


def _inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, t, H, W, C)).astype(np.float32)
    pad = np.zeros((B, t), bool)
    pad[1, t - 2:] = True
    x[pad] = 0.0
    dates = np.sort(rng.integers(0, 300, (B, t))).astype(np.float32)
    return x, pad, dates


def _kw(name, **extra):
    att, emb, red, nct = CONFIGS[name]
    return dict(KW, attention_type=att, embedding_reduction=emb,
                attention_mask_reduction=red, num_cls_tokens=nct, **extra)


@contextlib.contextmanager
def _no_dropout():
    """The JAX TAE2d with its attention dropouts at 0, for the block: the
    names that crop2seg_tpu/nn/tae2d.py builds its attention from are
    swapped."""
    orig = jtae2d.ClassicalMultiHeadAttention, jtae2d.MaskedLightweightAttention
    jtae2d.ClassicalMultiHeadAttention = functools.partial(orig[0], dropout=0.0)
    jtae2d.MaskedLightweightAttention = functools.partial(orig[1], attn_dropout=0.0)
    try:
        yield
    finally:
        jtae2d.ClassicalMultiHeadAttention, jtae2d.MaskedLightweightAttention = orig


def _port(name, v, **extra):
    m = TAE2d(**_kw(name, cls_hw=(H, W)), **extra)
    m.load_state_dict(tae2d_state_dict_from_flax(v))
    return m


def _zero_dropout(m):
    m.dropout = m.attn_dropout = 0.0
    for st in m.attention_heads:
        if hasattr(st, "dropout"):
            st.dropout = 0.0


# --- the goldens ----------------------------------------------------------

GOLDENS = {"tae2d_classical_mean": ("mean", "mean", 1),
           "tae2d_classical_cls1": ("cls", "cls", 1),
           "tae2d_classical_cls3": ("cls", "cls", 3),
           "tae2d_classical_linear": ("linear", "linear", 1)}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_tae2d_golden(name):
    """The classical TAE2d goldens (unpadded: the reference scrambles pad
    masks in its classical attention, scripts/make_golden.py), the
    reference's state dict loaded as it is, cls buffers included."""
    emb, red, nct = GOLDENS[name]
    arrays, sd = load_fixture(name)
    m = TAE2d(attention_type="classical", embedding_reduction=emb,
              attention_mask_reduction=red, num_cls_tokens=nct, in_channels=32,
              d_model=64, n_head=8, d_k=4, mlp=(64, 16), cls_hw=(8, 8)).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    x = _t(to_nhwc_seq(arrays["x"]))
    pad = None if name == "tae2d_classical_mean" else torch.zeros(x.shape[:2], dtype=torch.bool)
    with torch.inference_mode():
        out, attn = m(x, _t(arrays["dates"]), pad)
    np.testing.assert_allclose(from_nhwc(out.numpy()), arrays["y"], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(attn.numpy(), attn_from_torch(arrays["attn"]),
                               rtol=5e-4, atol=5e-4)


# --- against the JAX module ----------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """One config: JAX init, an eval forward, and a train-mode forward's
    output, gradients of sum(out * r) and updated statistics, dropout off."""
    name = request.param
    x, pad, dates = _inputs()
    jm = jtae2d.TAE2d(**_kw(name))
    v = _np(jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                      train=False))(x))
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: (np.abs(a) + 0.5).astype(np.float32), v["batch_stats"])}
    out, attn = jax.jit(lambda v, x: jm.apply(v, x, dates, pad_mask=pad, train=False))(v, x)
    with _no_dropout():
        jm = jtae2d.TAE2d(**_kw(name), dropout=0.0)
        shape = jax.eval_shape(lambda v: jm.apply(v, x, dates, pad_mask=pad, train=False),
                               v)[0].shape
        r = np.random.default_rng(3).standard_normal(shape).astype(np.float32)

        def loss(params):
            (o, _), upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                   x, dates, pad_mask=pad, train=True,
                                   mutable=["batch_stats"])
            return jnp.sum(o * r), (o, upd["batch_stats"])
        (_, (train_out, stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(v["params"])
    return dict(name=name, x=x, pad=pad, dates=dates, v=v, out=np.asarray(out),
                attn=np.asarray(attn), r=r, train_out=np.asarray(train_out),
                grads=_np(grads), stats=_np(stats))


def test_eval_matches_jax(case):
    m = _port(case["name"], case["v"]).eval()
    with torch.inference_mode():
        out, attn = m(_t(case["x"]), _t(case["dates"]), _t(case["pad"]))
    np.testing.assert_allclose(out.numpy(), case["out"], **TOL)
    np.testing.assert_allclose(attn.numpy(), case["attn"], **TOL)


def test_train_mode_matches_jax(case):
    """Training with dropout off: the output, every parameter's gradient
    and the BatchNorm's updated statistics."""
    m = _port(case["name"], case["v"]).train()
    _zero_dropout(m)
    out, _ = m(_t(case["x"]), _t(case["dates"]), _t(case["pad"]))
    (out * _t(case["r"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), case["train_out"], **TOL)
    want = tae2d_state_dict_from_flax({"params": case["grads"],
                                       "batch_stats": case["stats"]})
    # the attention reduction's parameters do not reach the output: no
    # gradient on the port's side, zeros on JAX's
    _assert_grads({k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                   for k, p in m.named_parameters()},
                  {k: want[k].numpy() for k, _ in m.named_parameters()})
    got = m.state_dict()
    for k, w in _stats(want).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_need_attn_false_gives_the_same_embedding(case):
    """Without the attention the classical encoder returns None for it and
    the same output bit for bit."""
    m = _port(case["name"], case["v"]).eval()
    args = (_t(case["x"]), _t(case["dates"]), _t(case["pad"]))
    with torch.inference_mode():
        out, _ = m(*args)
        out2, attn2 = m(*args, need_attn=False)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    assert (attn2 is None) == (m.attention_type == "classical")


def test_pad_keys_get_no_attention(case):
    m = _port(case["name"], case["v"]).eval()
    with torch.inference_mode():
        _, attn = m(_t(case["x"]), _t(case["dates"]), _t(case["pad"]))
    assert attn[1, ..., T - 2:].abs().max().item() == 0.0


def test_positionwise_feed_forward_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 5, 16)).astype(np.float32)
    jm = jtae2d.PositionwiseFeedForward(d_hid=24)
    v = _np(jm.init(jax.random.PRNGKey(0), x))["params"]
    m = tt.PositionwiseFeedForward(16, 24).eval()
    m.load_state_dict({"w_1.weight": _t(v["w_1"]["kernel"].T), "w_1.bias": _t(v["w_1"]["bias"]),
                       "w_2.weight": _t(v["w_2"]["kernel"].T), "w_2.bias": _t(v["w_2"]["bias"]),
                       "layer_norm.weight": _t(v["LayerNorm_0"]["scale"]),
                       "layer_norm.bias": _t(v["LayerNorm_0"]["bias"])})
    with torch.inference_mode():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": v}, x)), **TOL)


@pytest.mark.parametrize("name", list(GOLDENS))
def test_converter_inverts_the_jax_package_import(name):
    """Reference state dict -> crop2seg_tpu's convert_tae2d -> the port's
    tae2d_state_dict_from_flax gives back every tensor exactly (the cls
    buffers as the reference holds them)."""
    _, sd = load_fixture(name)
    back = tae2d_state_dict_from_flax(convert_tae2d(sd, classical=True))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):   # not carried by flax
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


# --- the memory plan -------------------------------------------------------

@pytest.mark.parametrize("name", ["classical_sequence", "classical_cls2_linear"])
def test_chunks_equal_one_chunk(name):
    """Chunks of 3 pixel rows (11 chunks, the last one short, chunk edges
    inside a batch item and across two) against one chunk, in eval: output
    and attention within 1e-6."""
    x, pad, dates = _inputs(seed=5)
    torch.manual_seed(0)
    m = TAE2d(**_kw(name, cls_hw=(H, W))).eval()
    args = (_t(x), _t(dates), _t(pad))
    with torch.inference_mode():
        out, attn = m(*args)
        m.chunk_rows = 3
        out3, attn3 = m(*args)
    np.testing.assert_allclose(out3.numpy(), out.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(attn3.numpy(), attn.numpy(), rtol=1e-6, atol=1e-6)


def _train_grads(m, args, chunk, ckpt, seed=0):
    m.zero_grad(set_to_none=True)
    m.chunk_rows, m.checkpoint_chunks = chunk, ckpt
    out, _ = m(*args, generator=torch.Generator().manual_seed(seed))
    (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in m.named_parameters()}


def test_checkpointed_chunks_give_the_same_gradients_bit_for_bit():
    """Training with dropout on (rates 0.1 and 0.2): the chunks run under
    torch.utils.checkpoint and recompute in the backward pass with the same
    dropout masks (each chunk's generator seeded from one draw a forward),
    so outputs and every gradient equal the plain chunks' bit for bit; the
    masks follow the generator (another seed, other outputs)."""
    x, pad, dates = _inputs(seed=6)
    torch.manual_seed(0)
    m = TAE2d(**_kw("classical_sequence", cls_hw=(H, W)), num_attention_stages=2).train()
    args = (_t(x), _t(dates), _t(pad))
    out, plain = _train_grads(m, args, 5, False)
    out_c, ckpt = _train_grads(m, args, 5, True)
    torch.testing.assert_close(out_c, out, rtol=0, atol=0)
    for k in plain:
        torch.testing.assert_close(ckpt[k], plain[k], rtol=0, atol=0, msg=k)
    out_other, _ = _train_grads(m, args, 5, True, seed=1)
    assert not torch.equal(out_other, out)


def test_chunk_rows_keeps_the_limits():
    """At TimeUNet_v2's full width (T = 61, 16 heads, d_model 256): the
    values tensor of a chunk stays under 2**31 elements and the chunk's
    counted bytes under CHUNK_BYTES, in fp32 and bf16; past T = 2000 the
    element limit binds alone (one row a chunk at the extreme)."""
    for itemsize in (4, 2):
        rows = tt.chunk_rows(61, 256, 16, 4, itemsize)
        assert rows * 61 * 16 * 256 <= tt.MAX_CHUNK_ELEMENTS
        per_row = itemsize * (4 * 61 * 16 * 256 + 2 * 61 * 16 * 4) + 4 * 6 * 16 * 61 * 61
        assert rows * per_row <= tt.CHUNK_BYTES < (rows + 1) * per_row
    assert tt.chunk_rows(61, 256, 16, 4, 2) > tt.chunk_rows(61, 256, 16, 4, 4) > 100
    assert tt.chunk_rows(20000, 256, 16, 4, 4) == 1
