"""crop2seg_tpu_torch ``ltae_pool`` and ``ltae_pool_tail`` (ops/ltae_pool.py):
their plain versions on the CPU against the JAX ``ltae_pool`` and
``ltae_pool_tail`` (Pallas interpret mode, as tests/test_ltae_pallas_train.py
runs them), the C-space backward formulas that the CUDA backward kernel
implements (the tail mode's too) against autograd, pads, autocast, and the
hash dropout mask. The CUDA kernels themselves are held against the plain version
on the card (tests/test_torch_package.py's ``cuda`` tests, chip_smoke.py).

Shape as tests/test_ltae_pallas_train.py:16-17: B=2, T=9, N=32, C=16, G=4,
D=32, sample 1 padded from T-3; the tail affine as its ``_tail_inputs``
(1 + 0.2 N(0, 1) and 0.1 N(0, 1), zeroed at pads). Tolerance rtol 2e-4 / atol 2e-5, as that
file holds the Pallas gradients to jax.grad (fp32 sums in another order).
The JAX interpret mode draws its dropout bits from jax.random, so the
comparison with JAX runs at drop_p = 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.ops.ltae_pallas_train import ltae_pool as jltae_pool
from crop2seg_tpu.ops.ltae_pallas_train import ltae_pool_tail as jltae_pool_tail
from crop2seg_tpu_torch.ops import ltae_pool as lp

B, T, N, C, G, D = 2, 9, 32, 16, 4, 32
TOL = dict(rtol=2e-4, atol=2e-5)
NAMES = ("dx", "dpe", "dwin_f", "dbin_f", "du", "dcs")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, N, C)).astype(np.float32)
    pe = rng.standard_normal((B, T, D)).astype(np.float32)
    pad = np.arange(T)[None, :] >= np.array([T, T - 3])[:, None]
    win = (rng.standard_normal((C, D)) * 0.3).astype(np.float32)
    bin_ = (rng.standard_normal(D) * 0.1).astype(np.float32)
    u = (rng.standard_normal((D, G)) * 0.2).astype(np.float32)
    cs = (rng.standard_normal((1, G)) * 0.1).astype(np.float32)
    tgt = np.random.default_rng(seed + 1).standard_normal((B, N, D)).astype(np.float32)
    return x, pe, pad, win, bin_, u, cs, tgt


def _tail_inputs(seed=3):
    x, pe, pad, win, bin_, u, cs, tgt = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    valid = (~pad).astype(np.float32)[:, :, None]
    tsc = ((1.0 + 0.2 * rng.standard_normal((B, T, C))) * valid).astype(np.float32)
    tsh = (0.1 * rng.standard_normal((B, T, C)) * valid).astype(np.float32)
    return x, tsc, tsh, pe, pad, win, bin_, u, cs, tgt


def _port_tail(z, tsc, tsh, pe, pad, win, bin_, u, cs, tgt, *, seed=0,
               drop_p=0.0, fn=lp.ltae_pool_tail, amp=False):
    """o and the eight gradients of mean((o - tgt)^2) through torch autograd;
    ``amp``: the forward under torch.autocast(bfloat16), as a train step runs
    it (the backward outside)."""
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (z, tsc, tsh, pe, win, bin_, u, cs)]
    zz, sc, sh, pp, ww, bb, uu, cc = leaves
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=amp):
        o = fn(zz, sc, sh, pp, torch.tensor(pad), ww, bb, uu, cc, seed, n_head=G,
               drop_p=drop_p)
    loss = ((o - torch.tensor(tgt)) ** 2).sum() / o.numel()
    return [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _port(x, pe, pad, win, bin_, u, cs, tgt, *, seed=0, drop_p=0.0,
          fn=lp.ltae_pool, amp=False):
    """o and the six gradients of mean((o - tgt)^2) through torch autograd
    (``amp`` as in ``_port_tail``)."""
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, pe, win, bin_, u, cs)]
    xx, pp, ww, bb, uu, cc = leaves
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=amp):
        o = fn(xx, pp, torch.tensor(pad), ww, bb, uu, cc, seed, n_head=G,
               drop_p=drop_p)
    loss = ((o - torch.tensor(tgt)) ** 2).sum() / o.numel()
    return [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def test_plain_version_matches_jax_kernel():
    """o and all six gradients against the JAX kernel pair (interpret mode)."""
    x, pe, pad, win, bin_, u, cs, tgt = _inputs()
    mask = jnp.asarray(pad)
    seed0 = jnp.zeros((1,), jnp.int32)

    def loss(x, pe, win, bin_, u, cs):
        o = jltae_pool(x, pe, mask, win, bin_, u, cs, seed0, n_head=G)
        return jnp.sum((o - tgt) ** 2) / o.size, o

    (_, want_o), want = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(a) for a in (x, pe, win, bin_, u, cs)))
    got = _port(x, pe, pad, win, bin_, u, cs, tgt)
    assert got[0].shape == (B, N, D)
    np.testing.assert_allclose(got[0], np.asarray(want_o), **TOL)
    for name, a, w in zip(NAMES, got[1:], want):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("fn", [lp.ltae_pool_tail_reference, lp.ltae_pool_tail],
                         ids=["plain", "wrapper"])
def test_tail_plain_version_matches_jax_kernel(fn):
    """o and all eight gradients (dz, dtsc, dtsh and the six of ltae_pool)
    of the tail mode against the JAX ltae_pool_tail (interpret mode), through
    the plain version and through the wrapper on a CPU tensor."""
    z, tsc, tsh, pe, pad, win, bin_, u, cs, tgt = _tail_inputs()
    mask = jnp.asarray(pad)
    seed0 = jnp.zeros((1,), jnp.int32)

    def loss(z, tsc, tsh, pe, win, bin_, u, cs):
        o = jltae_pool_tail(z, tsc, tsh, pe, mask, win, bin_, u, cs, seed0,
                            n_head=G)
        return jnp.sum((o - tgt) ** 2) / o.size, o

    (_, want_o), want = jax.value_and_grad(loss, argnums=tuple(range(8)), has_aux=True)(
        *(jnp.asarray(a) for a in (z, tsc, tsh, pe, win, bin_, u, cs)))
    got = _port_tail(z, tsc, tsh, pe, pad, win, bin_, u, cs, tgt, fn=fn)
    assert got[0].shape == (B, N, D)
    np.testing.assert_allclose(got[0], np.asarray(want_o), **TOL)
    for name, a, w in zip(("dz", "dtsc", "dtsh") + NAMES[1:], got[1:], want):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("n,b,sm_count", [(16384, 4, 132), (5003, 4, 132), (100, 1, 132),
                                          (7, 2, 132), (301, 200, 132), (1, 1, 1)],
                         ids=["main-path", "n-not-multiple", "n-below-s", "tiny",
                              "b-above-sms", "one"])
def test_backward_row_ranges_cover_every_row_once(n, b, sm_count):
    """The backward kernel's S persistent blocks per batch item
    (``blocks_per_item``) form one wave when B <= the SM count, and their row
    ranges (``row_ranges``, the kernel's split) are contiguous, in order, and
    hold every row of [0, N) exactly once, with empty ranges when N < S."""
    s = lp.blocks_per_item(b, sm_count)
    assert s >= 1 and (b * s <= sm_count if b <= sm_count else s == 1)
    ranges = lp.row_ranges(n, s)
    assert len(ranges) == s and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(lo <= hi for lo, hi in ranges)
    assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
    rows = [i for lo, hi in ranges for i in range(lo, hi)]
    assert rows == list(range(n))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("b,sm_count,s", [(1, 132, 132), (4, 132, 33), (10, 132, 13),
                                          (140, 132, 1), (1, 114, 114), (4, 114, 28),
                                          (10, 114, 11), (140, 114, 1)])
def test_fwd_launch_shape_gives_one_wave_of_blocks(b, sm_count, s):
    """The forward kernel's persistent blocks per batch item: S = SMs // B,
    one wave of B * S <= SMs blocks (132 SMs on an H100 SXM, 114 on an H100
    PCIe), and 1 when B exceeds the SM count; at the widest shape it takes."""
    assert lp.fwd_launch_shape(b, 64, 64, 256, 16, sm_count) == s
    assert lp.fwd_launch_shape(b, 61, 64, 256, 16, sm_count) == lp.blocks_per_item(b, sm_count)


@pytest.mark.parametrize("t,c,d,g", [(65, 64, 256, 16), (61, 72, 256, 16), (61, 12, 48, 4),
                                     (61, 64, 256, 32), (61, 64, 272, 16), (61, 24, 256, 16),
                                     (61, 64, 100, 8)],
                         ids=["t-65", "c-72", "c-not-multiple-of-8", "g-32", "d-272",
                              "g-not-dividing-c", "g-not-dividing-d"])
def test_fwd_launch_shape_raises_past_each_limit(t, c, d, g):
    """Past each of the fast forward kernel's limits (T <= 64, C <= 64 with C
    % 8 == 0, G <= 16 dividing C and D, D <= 256) ``fwd_launch_shape``
    raises before any launch and ``kernel_takes`` says no. The wrapper then
    takes the general pair where the L-TAE is defined (on a CPU tensor the
    plain version, equal to ``ltae_pool_reference``), and raises only where
    G does not divide C or D."""
    with pytest.raises(ValueError, match="unsupported shape"):
        lp.fwd_launch_shape(4, t, c, d, g, 132)
    assert not lp.kernel_takes(t, c, d, g)
    gen = torch.Generator().manual_seed(0)
    args = (torch.randn(1, t, 2, c, generator=gen), torch.randn(1, t, d, generator=gen),
            torch.zeros(1, t, dtype=torch.bool), torch.randn(c, d, generator=gen),
            torch.randn(d, generator=gen), torch.randn(d, g, generator=gen),
            torch.randn(1, g, generator=gen))
    if c % g or d % g:
        with pytest.raises(ValueError, match="unsupported shape"):
            lp.ltae_pool(*args, n_head=g)
    else:
        torch.testing.assert_close(lp.ltae_pool(*args, n_head=g),
                                   lp.ltae_pool_reference(*args, n_head=g),
                                   rtol=0, atol=0)


def test_kernel_tail_backward_formulas_match_autograd():
    """The tail mode of csrc/ltae_pool.cu's backward, written out in float64
    torch ops: from dxf, the gradient at the normalized input, ``live = dxf
    1[z tsc + tsh > 0]``, ``dz = live tsc``, ``dtsc = sum_rows live z`` and
    ``dtsh = sum_rows live``, equal autograd of ltae_pool_tail_reference,
    dropout on. dxf comes from autograd of the untailed plain version, whose
    own kernel formulas the test below holds. Tolerance 1e-10: float64."""
    z, tsc, tsh, pe, pad, win, bin_, u, cs, _ = (
        torch.tensor(a).double() if a.dtype != bool else torch.tensor(a)
        for a in _tail_inputs(4))
    seed, p = 21, 0.3
    go = torch.randn(B, N, D, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    leaves = [a.clone().requires_grad_(True) for a in (z, tsc, tsh)]
    o = lp.ltae_pool_tail_reference(*leaves, pe, pad, win, bin_, u, cs, seed,
                                    n_head=G, drop_p=p)
    want = torch.autograd.grad(o, leaves, go)

    pre = z * tsc[:, :, None] + tsh[:, :, None]
    xf = torch.where(pre > 0, pre, torch.zeros_like(pre)).requires_grad_(True)
    o2 = lp.ltae_pool_reference(xf, pe, pad, win, bin_, u, cs, seed, n_head=G,
                                drop_p=p)
    (dxf,) = torch.autograd.grad(o2, [xf], go)
    live = dxf * (pre > 0)
    got = (live * tsc[:, :, None], (live * z).sum(2), live.sum(2))
    for name, g_, w_ in zip(("dz", "dtsc", "dtsh"), got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-10, atol=1e-10, msg=name)


def test_kernel_backward_formulas_match_autograd():
    """The C-space backward of csrc/ltae_pool.cu, written out in float64
    torch ops (Z, q, p1, ds, P, dxhat, the GroupNorm backward and the four
    grid sums A, F, Dsum, E, summed per block's row range and then across
    ranges, S = 5 blocks per batch item with N = 32 rows), then
    ops/ltae_pool.py::_finish_backward, equals autograd of the plain version,
    dropout on. Tolerance 1e-10: float64."""
    x, pe, pad, win, bin_, u, cs, tgt = (torch.tensor(a).double()
                                         if a.dtype != bool else torch.tensor(a)
                                         for a in _inputs(3))
    seed, p, dv = 77, 0.3, D // G
    go = torch.randn(B, N, D, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    leaves = [a.clone().requires_grad_(True) for a in (x, pe, win, bin_, u, cs)]
    o = lp.ltae_pool_reference(leaves[0], leaves[1], pad, *leaves[2:], seed,
                               n_head=G, drop_p=p)
    want = torch.autograd.grad(o, leaves, go)

    xg = x.reshape(B, T, N, G, C // G)
    mean = xg.mean((1, 4), keepdim=True)
    inv = torch.rsqrt((xg - mean).square().mean((1, 4), keepdim=True) + 1e-5)
    xh = ((xg - mean) * inv).reshape(B, T, N, C)
    ws, bpe = win @ u, bin_ + pe
    s = torch.einsum("btnc,cg->btng", xh, ws) + (bpe @ u + cs)[:, :, None]
    a = torch.softmax(s.masked_fill(pad[:, :, None, None], -1e6), dim=1)
    ad = a * lp.keep_mask(seed, B, T, N, G, p).double() / (1 - p)
    gog = go.reshape(B, N, G, dv)
    z = torch.einsum("cgj,bngj->bngc", win.reshape(C, G, dv), gog)
    p1 = (torch.einsum("btgj,bngj->btng", bpe.reshape(B, T, G, dv), gog)
          + torch.einsum("btnc,bngc->btng", xh, z))
    ds = ad * p1 - a * (ad * p1).sum(1, keepdim=True)
    pool = torch.einsum("btng,btnc->bngc", ad, xh)
    dxh = (torch.einsum("btng,cg->btnc", ds, ws)
           + torch.einsum("btng,bngc->btnc", ad, z)).reshape(B, T, N, G, C // G)
    xhg = xh.reshape(B, T, N, G, C // G)
    dx = (inv * (dxh - dxh.mean((1, 4), keepdim=True)
                 - xhg * (dxh * xhg).mean((1, 4), keepdim=True))).reshape(x.shape)
    # the four sums as the kernel forms them: over each block's contiguous
    # range of rows, then the ranges' partial sums in block order
    parts = []
    for bb in range(B):
        for lo, hi in lp.row_ranges(N, 5):
            r, xs = slice(lo, hi), xh[bb, :, lo:hi]
            parts.append((bb, torch.einsum("tnc,tng->cg", xs, ds[bb, :, r]),
                          torch.einsum("ngc,ngj->cgj", pool[bb, r], gog[bb, r]).reshape(C, D),
                          ds[bb, :, r].sum(1),
                          torch.einsum("tng,ngj->tgj", ad[bb, :, r], gog[bb, r]).reshape(T, D)))
    acc_a = sum(p[1] for p in parts)
    acc_f = sum(p[2] for p in parts)
    dsum = torch.stack([sum(p[3] for p in parts if p[0] == bb) for bb in range(B)])
    acc_e = torch.stack([sum(p[4] for p in parts if p[0] == bb) for bb in range(B)])
    got = (dx,) + lp._finish_backward(acc_a, acc_f, dsum, acc_e, win, u, bpe)
    for name, g_, w_ in zip(NAMES, got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-10, atol=1e-10, msg=name)


def test_pads_change_nothing_but_the_groupnorm_statistics():
    """Garbage in the pad frames' PE leaves o and dx unchanged and gets a zero
    gradient; garbage in the pad frames' x moves only the GroupNorm
    statistics (the reference's GroupNorm counts pad frames), and everything
    stays finite. Equal to 1e-6: the masked scores underflow to exactly 0."""
    x, pe, pad, win, bin_, u, cs, tgt = _inputs(5)
    rng = np.random.default_rng(9)
    base = _port(x, pe, pad, win, bin_, u, cs, tgt, seed=3, drop_p=0.1)
    dirty_pe = pe.copy()
    dirty_pe[pad] = 50.0 * rng.standard_normal(dirty_pe[pad].shape)
    got = _port(x, dirty_pe, pad, win, bin_, u, cs, tgt, seed=3, drop_p=0.1)
    for i in (0, 1):                                # o, dx
        np.testing.assert_allclose(got[i], base[i], rtol=1e-6, atol=1e-6)
    assert np.all(got[2][pad] == 0.0) and np.all(base[2][pad] == 0.0)
    dirty_x = x.copy()
    dirty_x[pad] = 77.0
    got = _port(dirty_x, pe, pad, win, bin_, u, cs, tgt, seed=3, drop_p=0.1)
    assert all(np.isfinite(a).all() for a in got)
    assert np.all(got[2][pad] == 0.0)


def test_hash_mask_is_the_same_when_drawn_twice():
    """The keep mask is a function of (seed, b, t, n, g): drawn twice it is
    the same, so the forward and the backward see one mask; another seed
    draws another; the kept share is 1 - p up to sampling noise (B*T*N*G =
    2304 draws: 0.03 is five standard deviations)."""
    m1 = lp.keep_mask(11, B, T, N, G, 0.1)
    assert torch.equal(m1, lp.keep_mask(11, B, T, N, G, 0.1))
    assert not torch.equal(m1, lp.keep_mask(12, B, T, N, G, 0.1))
    assert abs(m1.float().mean().item() - 0.9) < 0.03
    assert lp.keep_mask(11, B, T, N, G, 0.0).all()
    args = _inputs(7)
    first = _port(*args, seed=11, drop_p=0.1)
    again = _port(*args, seed=11, drop_p=0.1)
    other = _port(*args, seed=12, drop_p=0.1)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert np.abs(first[0] - other[0]).max() > 1e-3


def test_mix32_matches_uint32_arithmetic():
    """The int64 emulation of the kernels' uint32 hash, against numpy uint32
    arithmetic (which wraps as the CUDA code does)."""
    vals = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789], np.uint64)
    x = vals.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x21F0AAAD)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x735A2D97)
        x = x ^ (x >> np.uint32(15))
    got = lp._mix32(torch.tensor(vals.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64))
    assert [lp._mix32(int(v)) for v in vals] == x.astype(np.int64).tolist()


def test_wrapper_on_cpu_counts_no_launch_and_checks_shapes():
    x, pe, pad, win, bin_, u, cs, tgt = (torch.tensor(a) for a in _inputs())
    before = (lp.ltae_pool.launches_fwd, lp.ltae_pool.launches_bwd)
    o = lp.ltae_pool(x.requires_grad_(True), pe, pad, win, bin_, u, cs, n_head=G)
    o.sum().backward()
    assert (lp.ltae_pool.launches_fwd, lp.ltae_pool.launches_bwd) == before
    torch.testing.assert_close(
        o, lp.ltae_pool_reference(x, pe, pad, win, bin_, u, cs, n_head=G),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported shape"):
        lp.ltae_pool(x[..., :10], pe, pad, win[:10], bin_, u, cs, n_head=G)
    with pytest.raises(ValueError, match="expected"):
        lp.ltae_pool(x, pe, pad, win, bin_, u, cs[0], n_head=G)
    with pytest.raises(ValueError, match="drop_p"):
        lp.ltae_pool(x, pe, pad, win, bin_, u, cs, n_head=G, drop_p=1.0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        lp.ltae_pool(*(a.to("meta") for a in (x, pe, pad, win, bin_, u, cs)),
                     n_head=G)


def test_plain_versions_ignore_autocast():
    """Under torch.autocast(bfloat16) the plain versions still compute in
    fp32 (their products would otherwise run in bf16): bit for bit the same o
    and gradients as without autocast, in both modes."""
    args = _inputs(8)
    targs = _tail_inputs(8)
    want = _port(*args), _port_tail(*targs)
    got = _port(*args, amp=True), _port_tail(*targs, amp=True)
    for g_, w_ in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g_, w_)


def test_bf16_input_on_cpu_returns_bf16():
    """A bf16 x gives o (and dx) in bf16, the rest of the gradients in fp32,
    and o equals the fp32 plain version on the same bf16-rounded input up to
    one bf16 rounding (2**-8 of the largest output)."""
    x, tsc, tsh, pe, pad, win, bin_, u, cs, _ = (torch.tensor(a) for a in _tail_inputs(6))
    zb = x.bfloat16().requires_grad_(True)
    sc = tsc.clone().requires_grad_(True)
    o = lp.ltae_pool_tail(zb, sc, tsh, pe, pad, win, bin_, u, cs, n_head=G)
    assert o.dtype == torch.bfloat16
    dz, dsc = torch.autograd.grad(o.float().sum(), [zb, sc])
    assert dz.dtype == torch.bfloat16 and dsc.dtype == torch.float32
    want = lp.ltae_pool_tail_reference(zb.detach().float(), tsc, tsh, pe, pad, win,
                                       bin_, u, cs, n_head=G)
    assert (o.float() - want).abs().max() <= 2 ** -8 * want.abs().max()


def test_tail_wrapper_checks_the_affine_shape():
    x, tsc, tsh, pe, pad, win, bin_, u, cs, _ = (torch.tensor(a) for a in _tail_inputs())
    with pytest.raises(ValueError, match="tsc is"):
        lp.ltae_pool_tail(x, tsc[:, :, :8], tsh, pe, pad, win, bin_, u, cs, n_head=G)
    with pytest.raises(ValueError, match="cuda or cpu"):
        lp.ltae_pool_tail(*(a.to("meta") for a in (x, tsc, tsh, pe, pad, win,
                                                   bin_, u, cs)), n_head=G)
