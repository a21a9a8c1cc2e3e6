"""crop2seg_tpu_torch's L-TAE plain versions past the fast kernels' T <= 64,
against the JAX Pallas kernels in interpret mode (the JAX package runs its
kernels at any T; the port's general CUDA kernels take these shapes on the
card and are held against the same plain versions there,
tests/test_torch_package.py's ``cuda`` tests and chip_smoke.py).

- ``ltae_fused_forward_reference`` against ``crop2seg_tpu/ops/ltae_pallas.py
  ::ltae_fused_forward`` at T = 70 and 128: one query with and without the
  tail affine (attention out), three queries with the tail.
- ``ltae_pool_reference`` and ``ltae_pool_tail_reference``, o and every
  gradient through torch autograd, against ``ltae_pallas_train.py::ltae_pool``
  and ``::ltae_pool_tail`` under ``jax.value_and_grad`` at T = 70 and 128,
  drop_p 0 (the interpret mode draws its dropout bits from jax.random).

Inputs from a seeded numpy generator: B = 3 with lengths T, T - 5 and 1
(pads at the end, and a row with one valid step), 4x4 = 16 pixel rows, C =
16, G = 4, D = 32, d_out = 16 (out-GroupNorm groups of 4 channels). fp32
tolerances: 5e-4 (rtol and atol) for the eval outputs, 1e-5 for attention,
rtol 5e-4 / atol 2e-5 for the pool's o and gradients (tests/
test_torch_ltae_pool.py's atol at T = 9, with the rtol of the eval outputs:
sums over up to 128 steps in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.ops import ltae_pallas as jk
from crop2seg_tpu.ops.ltae_pallas_train import ltae_pool as jltae_pool
from crop2seg_tpu.ops.ltae_pallas_train import ltae_pool_tail as jltae_pool_tail
from crop2seg_tpu_torch.ops import ltae_fused as tk
from crop2seg_tpu_torch.ops import ltae_pool as lp

B, N, C, G, D, D_OUT, D_K = 3, 16, 16, 4, 32, 16, 4
OUT_TOL = dict(rtol=5e-4, atol=5e-4)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_TOL = dict(rtol=5e-4, atol=2e-5)


def _pad(t):
    """Lengths T, T - 5 and 1: pads at the end, one row of a single step."""
    return np.arange(t)[None, :] >= np.array([t, t - 5, 1])[:, None]


def _eval_inputs(t, nq, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    params = {"in_scale": 1 + r(C, scale=0.1), "in_bias": r(C, scale=0.1),
              "win": r(C, D, scale=C ** -0.5), "bin": r(D, scale=0.1),
              "wk": r(D, G * D_K, scale=0.5), "bk": r(G * D_K, scale=0.1),
              "q": r(G, nq, D_K) if nq > 1 else r(G, D_K),
              "wm_folded": r(D, D_OUT, scale=D ** -0.5), "bm_folded": r(D_OUT, scale=0.1),
              "out_scale": 1 + r(D_OUT, scale=0.1), "out_bias": r(D_OUT, scale=0.1)}
    pad = _pad(t)
    x = r(B, t, N, C)
    x[pad] = 0.0
    valid = (~pad).astype(np.float32)[:, :, None]
    tail = ((1 + r(B, t, C, scale=0.2)) * valid, r(B, t, C, scale=0.1) * valid)
    return x, r(B, t, D), pad, params, tail


@pytest.mark.parametrize("t", [70, 128])
@pytest.mark.parametrize("nq,use_tail", [(1, True), (1, False), (3, True)],
                         ids=["nq1-tail", "nq1", "nq3-tail"])
def test_eval_plain_version_matches_jax_kernel_past_t64(t, nq, use_tail):
    """Out and attention of ``ltae_fused_forward_reference`` against the
    Pallas kernel (interpret mode) on the same arguments, past T = 64; the
    port routes these shapes to its general kernel."""
    x, pe, pad, params, tail = _eval_inputs(t, nq, seed=t + nq)
    assert tk.kernel_route(t, C, D, G, D_OUT, nq) == "general"
    ts = tail if use_tail else None
    want, want_attn = jk.ltae_fused_forward(
        jnp.asarray(x), jnp.asarray(pe), jnp.asarray(pad),
        {k: jnp.asarray(v) for k, v in params.items()}, n_head=G, d_k=D_K,
        row_block=N, interpret=True,
        tail_affine=tuple(jnp.asarray(a) for a in ts) if ts else None)
    got, got_attn = tk.ltae_fused_forward_reference(
        torch.tensor(x), torch.tensor(pe), torch.tensor(pad),
        {k: torch.tensor(v) for k, v in params.items()}, n_head=G, d_k=D_K,
        tail_affine=tuple(torch.tensor(a) for a in ts) if ts else None)
    shape = (B, N, nq, D_OUT) if nq > 1 else (B, N, D_OUT)
    assert got.shape == shape and np.asarray(want).shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), **ATTN_TOL)


def _pool_inputs(t, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    pad = _pad(t)
    valid = (~pad).astype(np.float32)[:, :, None]
    z = r(B, t, N, C)
    tsc = (1 + r(B, t, C, scale=0.2)) * valid
    tsh = r(B, t, C, scale=0.1) * valid
    return dict(z=z, tsc=tsc, tsh=tsh, pe=r(B, t, D), pad=pad,
                win=r(C, D, scale=0.3), bin=r(D, scale=0.1), u=r(D, G, scale=0.2),
                cs=r(1, G, scale=0.1), tgt=r(B, N, D))


@pytest.mark.parametrize("t", [70, 128])
@pytest.mark.parametrize("tail", [False, True], ids=["untailed", "tail"])
def test_pool_plain_version_matches_jax_kernel_past_t64(t, tail):
    """o and every gradient of ``ltae_pool_reference`` (and in tail mode of
    ``ltae_pool_tail_reference``, dz, dtsc and dtsh too) against the JAX
    kernel pair (interpret mode) past T = 64, where the port runs its
    general training pair on the card."""
    a = _pool_inputs(t, seed=2 * t + tail)
    assert not lp.kernel_takes(t, C, D, G)
    mask, seed0 = jnp.asarray(a["pad"]), jnp.zeros((1,), jnp.int32)
    names = (("z", "tsc", "tsh") if tail else ("z",)) + ("pe", "win", "bin", "u", "cs")

    def loss(*args):
        kw = dict(zip(names, args))
        if tail:
            o = jltae_pool_tail(kw["z"], kw["tsc"], kw["tsh"], kw["pe"], mask, kw["win"],
                                kw["bin"], kw["u"], kw["cs"], seed0, n_head=G)
        else:
            o = jltae_pool(kw["z"], kw["pe"], mask, kw["win"], kw["bin"], kw["u"], kw["cs"],
                           seed0, n_head=G)
        return jnp.sum((o - a["tgt"]) ** 2) / o.size, o

    (_, want_o), want = jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(a[k]) for k in names))
    leaves = {k: torch.tensor(a[k], requires_grad=True) for k in names}
    pad = torch.tensor(a["pad"])
    rest = (leaves["pe"], pad, leaves["win"], leaves["bin"], leaves["u"], leaves["cs"])
    o = (lp.ltae_pool_tail_reference(leaves["z"], leaves["tsc"], leaves["tsh"], *rest,
                                     n_head=G) if tail
         else lp.ltae_pool_reference(leaves["z"], *rest, n_head=G))
    loss_t = ((o - torch.tensor(a["tgt"])) ** 2).sum() / o.numel()
    got = torch.autograd.grad(loss_t, [leaves[k] for k in names])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), **POOL_TOL)
    for name, g_, w_ in zip(names, got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **POOL_TOL, err_msg=name)
