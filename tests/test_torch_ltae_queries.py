"""crop2seg_tpu_torch L-TAE with num_queries > 1, and the attention output in
training mode.

- The fused kernel's plain version against the JAX Pallas kernel in
  interpret mode: nq = 3 at tests/test_ltae_pallas.py's shape (B=2, T=9, 8x8,
  C=32, G=8, D=64, d_out=16, pads), with and without the tail affine, and
  nq = 2 at U-TAE's width (C = d_out = 128, G = 16, D = 256, 4x4).
- The port's LTAE(num_queries=3) against the JAX module, in eval mode (plain
  and fused routes; JAX with use_pallas off and on) and in training mode at
  dropout 0 (output, attention and every parameter gradient), and the
  one-query attention-out training path the same way.
- The dropped attention that the training path returns is the one that
  weighed the values.

Tolerances as tests/test_torch_ltae.py: out rtol 1e-3 / atol 5e-4 (the
out-GroupNorm's small groups amplify accumulation-order noise), attention
1e-5; training-mode gradients 1e-3 relative with an absolute floor of 1e-5
of the largest (tests/test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.ops import ltae_pallas as jk
from crop2seg_tpu_torch.nn.ltae import LTAE, MaskedLightweightAttention
from crop2seg_tpu_torch.ops import ltae_fused as tk
from crop2seg_tpu_torch.utils.convert import ltae_state_dict_from_flax
from tests.test_torch_ltae import ATTN_TOL, B, D_K, OUT_TOL, T, WIDE, _make_case

SMALL = dict(c=32, n_head=8, d_model=64, d_out=16, h=8, w=8)
CASES = {"nq3": dict(SMALL, num_queries=3), "nq2_wide": dict(WIDE, num_queries=2)}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name):
    if name not in cases:
        cases[name] = _make_case(**CASES[name])
    return cases[name]


def _port_ltae(case, spec, **kw):
    m = LTAE(in_channels=spec["c"], n_head=spec["n_head"], d_k=D_K,
             mlp=(spec["d_model"], spec["d_out"]), d_model=spec["d_model"],
             num_queries=spec["num_queries"], **kw)
    m.load_state_dict(ltae_state_dict_from_flax(case["variables"]))
    return m


@pytest.mark.parametrize("name,tail", [("nq3", False), ("nq3", True),
                                       ("nq2_wide", False)])
def test_reference_matches_jax_kernel(cases, name, tail):
    """Out (B, N, nq, d_out) and attn (B, N, G, nq, T) of the plain version
    against the Pallas kernel (interpret mode) on the same arguments."""
    case, spec = _case(cases, name), CASES[name]
    n, c, g, nq = spec["h"] * spec["w"], spec["c"], spec["n_head"], spec["num_queries"]
    rows = case["x"].reshape(B, T, n, c)
    want, want_attn = jk.ltae_fused_forward(
        jnp.asarray(rows), jnp.asarray(case["pe"]), jnp.asarray(case["pad"]),
        case["jparams"], n_head=g, d_k=D_K, row_block=16, interpret=True,
        tail_affine=tuple(jnp.asarray(a) for a in case["tail"]) if tail else None)
    got, got_attn = tk.ltae_fused_forward_reference(
        _t(rows), _t(case["pe"]), _t(case["pad"]),
        {k: _t(v) for k, v in case["jparams"].items()}, n_head=g, d_k=D_K,
        tail_affine=tuple(_t(a) for a in case["tail"]) if tail else None)
    assert got.shape == (B, n, nq, spec["d_out"]) and got_attn.shape == (B, n, g, nq, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), **ATTN_TOL)


def test_wrapper_on_cpu_and_the_query_limit(cases):
    """On a CPU tensor the wrapper returns the plain version's result and
    counts no launch; nq past MAX_QUERIES goes to the general kernel (on the
    CPU the plain version), no longer refused."""
    case, spec = _case(cases, "nq3"), CASES["nq3"]
    params = {k: _t(v) for k, v in case["jparams"].items()}
    args = (_t(case["x"].reshape(B, T, -1, spec["c"])), _t(case["pe"]), _t(case["pad"]))
    before = tk.ltae_fused_forward.launches
    got, attn = tk.ltae_fused_forward(*args, params, n_head=8, d_k=D_K)
    want, want_attn = tk.ltae_fused_forward_reference(*args, params, n_head=8, d_k=D_K)
    assert tk.ltae_fused_forward.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(attn, want_attn, rtol=0, atol=0)
    many = dict(params, q=torch.randn(8, tk.MAX_QUERIES + 1, D_K,
                                     generator=torch.Generator().manual_seed(0)))
    nq = tk.MAX_QUERIES + 1
    assert tk.kernel_route(T, spec["c"], spec["d_model"], 8, spec["d_out"], nq) == "general"
    got, attn = tk.ltae_fused_forward(*args, many, n_head=8, d_k=D_K)
    want, want_attn = tk.ltae_fused_forward_reference(*args, many, n_head=8, d_k=D_K)
    assert got.shape == (B, args[0].shape[2], nq, spec["d_out"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(attn, want_attn, rtol=0, atol=0)


def test_params_from_state_dict_match_jax(cases):
    """The converter carries the (G, nq, d_k) query across; the kernel's
    parameter dict from the port's state dict equals the JAX one."""
    case = _case(cases, "nq3")
    sd = ltae_state_dict_from_flax(case["variables"])
    assert sd["attention_head.Q"].shape == (8, 3, D_K)
    np.testing.assert_array_equal(sd["attention_head.Q"].numpy(),
                                  case["variables"]["params"]["attention"]["query"])
    got = tk.params_from_ltae_variables(sd)
    for k, want in case["jparams"].items():
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def jax_eval(cases):
    """The JAX LTAE(num_queries=3) in eval mode, XLA and Pallas (interpret)."""
    case = _case(cases, "nq3")
    args = (jnp.asarray(case["x"]), jnp.asarray(case["dates"]))
    out = {}
    for use_pallas in (False, True):
        m = case["module"].clone(use_pallas=use_pallas)
        out[use_pallas] = m.apply(case["variables"], *args,
                                  pad_mask=jnp.asarray(case["pad"]), train=False)
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_module_eval_matches_jax_module(cases, jax_eval, fused, use_pallas):
    """Out (B, nq, H, W, d_out) and attn (B, H, W, G, nq, T), the JAX ranks,
    on the plain route and the fused one (its plain version on the CPU)."""
    case, spec = _case(cases, "nq3"), CASES["nq3"]
    want, want_attn = jax_eval[use_pallas]
    with torch.inference_mode():
        got, attn = _port_ltae(case, spec).eval()(
            _t(case["x"]), _t(case["dates"]), _t(case["pad"]), fused=fused)
    assert got.shape == (B, 3, 8, 8, 16) and attn.shape == (B, 8, 8, 8, 3, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), **ATTN_TOL)


def _jax_train(case, weight):
    """JAX train-mode output, attention, parameter gradients and updated
    statistics of loss = mean(out^2) + sum(attn * weight), dropout 0."""
    m = case["module"].clone(dropout=0.0, attn_dropout=0.0)
    v = case["variables"]

    def loss(params):
        (out, attn), upd = m.apply({"params": params, "batch_stats": v["batch_stats"]},
                                   jnp.asarray(case["x"]), jnp.asarray(case["dates"]),
                                   pad_mask=jnp.asarray(case["pad"]), train=True,
                                   mutable=["batch_stats"])
        return jnp.mean(out ** 2) + jnp.sum(attn * weight), (out, attn, upd["batch_stats"])

    (_, (out, attn, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    tree = jax.tree_util.tree_map(np.asarray, {"params": grads, "batch_stats": stats})
    return np.asarray(out), np.asarray(attn), ltae_state_dict_from_flax(tree)


@pytest.mark.parametrize("nq", [1, 3])
def test_train_mode_with_attention_matches_jax(cases, nq):
    """The training path with the attention out (plain ops, the JAX route;
    nq = 1 with need_attn, and nq = 3) at dropout 0 against the JAX module in
    training mode: output, attention, the mlp BatchNorm's updated running
    statistics and every parameter gradient, through a loss that reads the
    attention too."""
    spec = dict(SMALL, num_queries=nq)
    case = _case(cases, "nq3") if nq == 3 else _make_case(**SMALL)
    shape = (B, 8, 8, 8, nq, T) if nq > 1 else (B, 8, 8, 8, T)
    weight = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want_out, want_attn, want = _jax_train(case, weight)
    m = _port_ltae(case, spec, dropout=0.0, attn_dropout=0.0).train()
    out, attn = m(_t(case["x"]), _t(case["dates"]), _t(case["pad"]), need_attn=True)
    ((out ** 2).mean() + (attn * _t(weight)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, **OUT_TOL)
    np.testing.assert_allclose(attn.detach().numpy(), want_attn, **ATTN_TOL)
    grads = {k: p.grad.numpy() for k, p in m.named_parameters()}
    top = max(want[k].abs().max().item() for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-3, atol=1e-5 * top,
                                   err_msg=k)
    for k in ("mlp.2.running_mean", "mlp.2.running_var"):
        np.testing.assert_allclose(m.state_dict()[k].numpy(), want[k].numpy(),
                                   **OUT_TOL, err_msg=k)


def test_returned_attention_is_the_dropped_one():
    """With attention dropout 0.5 in training the returned attention holds
    the kept softmax weights scaled by 2 and zeros elsewhere, it is exactly
    what weighed the values, and its masks follow the generator."""
    rng = np.random.default_rng(3)
    head = MaskedLightweightAttention(n_head=4, d_k=4, d_model=16, num_queries=2)
    h = _t(rng.standard_normal((2, 6, 3, 3, 16)).astype(np.float32))
    pad = torch.zeros(2, 6, dtype=torch.bool)
    pad[1, 4:] = True
    with torch.no_grad():
        clean, soft = head(h, pad)
        out, attn = head(h, pad, 0.5, torch.Generator().manual_seed(1))
        again, attn2 = head(h, pad, 0.5, torch.Generator().manual_seed(1))
        _, other = head(h, pad, 0.5, torch.Generator().manual_seed(2))
    assert attn.shape == (2, 3, 3, 4, 2, 6) and out.shape == (2, 3, 3, 2, 16)
    kept = attn != 0
    live = soft > 1e-6
    assert 0.3 < kept[live].float().mean().item() < 0.7
    torch.testing.assert_close(attn[kept], 2 * soft[kept], rtol=0, atol=0)
    v = h.reshape(2, 6, 3, 3, 4, 4)
    weighed = torch.einsum("bxygqt,btxygd->bxyqgd", attn, v).reshape(out.shape)
    torch.testing.assert_close(out, weighed, rtol=0, atol=0)
    assert not torch.allclose(out, clean)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    torch.testing.assert_close(attn2, attn, rtol=0, atol=0)
    assert not torch.equal(other, attn)
