"""crop2seg_tpu_torch L-TAE: the fused kernel's plain version against the JAX
Pallas kernel (interpret mode), the LTAE module against the JAX module, and
the ltae.npz golden. The CUDA kernel itself is held against the plain version
on the card (tests/test_torch_package.py's ``cuda`` test, and chip_smoke.py).

Shape: B=2, T=9, 8x8 pixels, C=32, G=8, D=64, d_out=16, fp32, with pads;
and U-TAE's width, 4x4 pixels, C=128, G=16, D=256, d_out=128, attention out.
Tolerance: rtol 1e-3 / atol 5e-4 on out, as tests/test_ltae_pallas.py holds
the Pallas kernel to the XLA module. This config's out-GroupNorm has
2-channel groups whose variance is ~0 for some rows, which amplifies
accumulation-order noise (tests/test_ltae_pallas.py:99-104); the paths that
also differ in where the tail affine rounds take 5e-3 as that file does.
Attention weights have no such degeneracy: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu.ops import ltae_pallas as jk
from crop2seg_tpu_torch.nn.ltae import LTAE
from crop2seg_tpu_torch.ops import ltae_fused as tk
from crop2seg_tpu_torch.ops import ltae_pool as lp
from crop2seg_tpu_torch.utils.convert import ltae_state_dict_from_flax
from tests.parity_utils import attn_from_torch, from_nhwc, load_fixture, to_nhwc_seq

B, T, H, W, C = 2, 9, 8, 8, 32
N_HEAD, D_K, D_MODEL, D_OUT = 8, 4, 64, 16
OUT_TOL = dict(rtol=1e-3, atol=5e-4)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


# U-TAE's bottleneck width: C = d_out = 128, 16 heads, d_model 256
WIDE = dict(c=128, n_head=16, d_model=256, d_out=128, h=4, w=4)


def _make_case(c=C, n_head=N_HEAD, d_model=D_MODEL, d_out=D_OUT, h=H, w=W,
               num_queries=1):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, h, w, c)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[0, T - 2:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(T) * 7.0 + 20).astype(np.float32), (B, 1))
    m = JLTAE(in_channels=c, n_head=n_head, d_k=D_K, mlp=(d_model, d_out),
              d_model=d_model, num_queries=num_queries)
    v = jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                 train=False))(x)
    bs = jax.tree_util.tree_map(  # non-trivial BN statistics
        lambda a: np.abs(np.asarray(a) + 0.3 * rng.standard_normal(a.shape)
                         ).astype(np.float32), v["batch_stats"])
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": bs}
    pe = np.asarray(m.apply(v, jnp.asarray(dates),
                            method=lambda mod, d: mod._pe(d)))
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jk.params_from_ltae_variables(v, n_head))
    sc = (1.0 + 0.2 * rng.standard_normal((B, T, c))).astype(np.float32)
    sh = (0.1 * rng.standard_normal((B, T, c))).astype(np.float32)
    valid = (~pad).astype(np.float32)[:, :, None]
    return dict(module=m, variables=v, x=x, pad=pad, dates=dates, pe=pe,
                jparams=jparams, tail=(sc * valid, sh * valid))


@pytest.fixture(scope="module")
def case():
    return _make_case()


@pytest.fixture(scope="module")
def wide_case():
    return _make_case(**WIDE)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _tparams(jparams):
    return {k: _t(v) for k, v in jparams.items()}


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("need_attn", [True, False])
def test_reference_matches_jax_kernel(case, tail, need_attn):
    rows = case["x"].reshape(B, T, H * W, C)
    tail_j = tuple(jnp.asarray(a) for a in case["tail"]) if tail else None
    want, want_attn = jk.ltae_fused_forward(
        jnp.asarray(rows), jnp.asarray(case["pe"]), jnp.asarray(case["pad"]),
        case["jparams"], n_head=N_HEAD, d_k=D_K, row_block=32, interpret=True,
        need_attn=need_attn, tail_affine=tail_j)
    got, got_attn = tk.ltae_fused_forward_reference(
        _t(rows), _t(case["pe"]), _t(case["pad"]), _tparams(case["jparams"]),
        n_head=N_HEAD, d_k=D_K, need_attn=need_attn,
        tail_affine=tuple(_t(a) for a in case["tail"]) if tail else None)
    assert got.shape == (B, H * W, D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **OUT_TOL)
    if need_attn:
        assert got_attn.shape == (B, H * W, N_HEAD, T)
        np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), **ATTN_TOL)
    else:
        assert got_attn is None and want_attn is None


def test_params_from_state_dict_match_jax(case):
    sd = ltae_state_dict_from_flax(case["variables"])
    got = tk.params_from_ltae_variables(sd)
    assert set(got) == set(case["jparams"])
    for k, want in case["jparams"].items():
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def _port_ltae(case):
    m = LTAE(in_channels=C, n_head=N_HEAD, d_k=D_K, mlp=(D_MODEL, D_OUT),
             d_model=D_MODEL).eval()
    m.load_state_dict(ltae_state_dict_from_flax(case["variables"]))
    return m


@pytest.mark.parametrize("fused", [False, True])
def test_module_matches_jax_module(case, fused):
    """Plain path and fused path (the wrapper's plain version on the CPU)
    against JAX LTAE with use_pallas=False."""
    want, want_attn = case["module"].apply(
        case["variables"], jnp.asarray(case["x"]), jnp.asarray(case["dates"]),
        pad_mask=jnp.asarray(case["pad"]), train=False)
    with torch.inference_mode():
        got, attn = _port_ltae(case)(_t(case["x"]), _t(case["dates"]),
                                     _t(case["pad"]), fused=fused)
    assert got.shape == (B, H, W, D_OUT) and attn.shape == (B, H, W, N_HEAD, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), **ATTN_TOL)


def test_module_tail_affine_equals_preapplied(case):
    """tail_affine applied on load equals applying max(x*sc+sh, 0) first."""
    m = _port_ltae(case)
    sc, sh = (_t(a) for a in case["tail"])
    x = _t(case["x"])
    pre = torch.relu(x * sc[:, :, None, None, :] + sh[:, :, None, None, :])
    with torch.inference_mode():
        want, _ = m(pre, _t(case["dates"]), _t(case["pad"]), fused=False)
        got, _ = m(x, _t(case["dates"]), _t(case["pad"]), tail_affine=(sc, sh),
                   need_attn=False, fused=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3, atol=5e-3)


def test_ltae_golden():
    arrays, sd = load_fixture("ltae")
    m = LTAE(in_channels=32, n_head=8, d_k=4, mlp=(64, 16), d_model=64).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.inference_mode():
        y, attn = m(_t(to_nhwc_seq(arrays["x"])), _t(arrays["dates"]),
                    _t(arrays["pad_mask"]))
    np.testing.assert_allclose(from_nhwc(y.numpy()), arrays["y"], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(attn.numpy(), attn_from_torch(arrays["attn"]),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("model", ["utae", "timeunet"])
def test_models_with_num_queries_above_one_raise(model):
    """The LTAE module takes num_queries > 1 (tests/test_torch_ltae_queries.py);
    U-TAE and TimeUNet raise at construction, as the JAX models have no path
    for it either (their forward fails on the query axis)."""
    from crop2seg_tpu_torch.models.factory import get_model

    cfg = {"model": model, "encoder_widths": [8, 16], "decoder_widths": [8, 16],
           "out_conv": [8, 3], "n_head": 4, "d_model": 16, "num_queries": 2}
    with pytest.raises(ValueError, match="num_queries=1 only"):
        get_model(cfg, device="cpu")
    m = LTAE(in_channels=16, n_head=4, d_model=16, mlp=(16, 8), num_queries=3)
    assert m.attention_head.Q.shape == (4, 3, 4)


def test_wrapper_on_cpu_runs_the_plain_version(case):
    rows = _t(case["x"].reshape(B, T, H * W, C))
    args = (rows, _t(case["pe"]), _t(case["pad"]), _tparams(case["jparams"]))
    before = tk.ltae_fused_forward.launches
    got, _ = tk.ltae_fused_forward(*args, n_head=N_HEAD, d_k=D_K)
    want, _ = tk.ltae_fused_forward_reference(*args, n_head=N_HEAD, d_k=D_K)
    assert tk.ltae_fused_forward.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wide_reference_matches_jax_kernel(wide_case):
    """C = 128, d_out = 128, G = 16 with the attention output (U-TAE's L-TAE):
    the plain version against the JAX Pallas kernel in interpret mode."""
    case, g, n = wide_case, WIDE["n_head"], WIDE["h"] * WIDE["w"]
    rows = case["x"].reshape(B, T, n, WIDE["c"])
    want, want_attn = jk.ltae_fused_forward(
        jnp.asarray(rows), jnp.asarray(case["pe"]), jnp.asarray(case["pad"]),
        case["jparams"], n_head=g, d_k=D_K, row_block=16, interpret=True)
    got, got_attn = tk.ltae_fused_forward_reference(
        _t(rows), _t(case["pe"]), _t(case["pad"]), _tparams(case["jparams"]),
        n_head=g, d_k=D_K)
    assert got.shape == (B, n, WIDE["d_out"]) and got_attn.shape == (B, n, g, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), **ATTN_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_wide_module_matches_jax_module(wide_case, fused):
    """The port's LTAE(in_channels=128, mlp=(256, 128)) against the JAX
    module, both paths, attention as (B, H, W, G, T)."""
    case = wide_case
    want, want_attn = case["module"].apply(
        case["variables"], jnp.asarray(case["x"]), jnp.asarray(case["dates"]),
        pad_mask=jnp.asarray(case["pad"]), train=False)
    m = LTAE(in_channels=WIDE["c"], n_head=WIDE["n_head"], d_k=D_K,
             mlp=(WIDE["d_model"], WIDE["d_out"]), d_model=WIDE["d_model"]).eval()
    m.load_state_dict(ltae_state_dict_from_flax(case["variables"]))
    with torch.inference_mode():
        got, attn = m(_t(case["x"]), _t(case["dates"]), _t(case["pad"]), fused=fused)
    assert got.shape == (B, WIDE["h"], WIDE["w"], WIDE["d_out"])
    assert attn.shape == (B, WIDE["h"], WIDE["w"], WIDE["n_head"], T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), **ATTN_TOL)


@pytest.mark.parametrize("b,n,sm_count", [(10, 16384, 132), (1, 5, 132), (3, 4099, 132),
                                          (140, 3, 132), (2, 9, 1)],
                         ids=["main-path", "n-below-blocks", "n-not-multiple",
                              "b-above-sms", "one-sm"])
def test_group_kernel_rows_fall_in_exactly_one_block(b, n, sm_count):
    """At C <= 64 with one query the kernel runs S = ``launch_shape`` blocks
    per batch item (one wave when B <= the SM count, else S = 1), block i
    walking ``row_ranges(N, S)[i]`` in groups of 8 rows: every row of [0, N)
    falls in exactly one block and one group, with blocks left empty when
    N < S."""
    s = tk.launch_shape(b, 61, 64, 256, 16, 64, 1, sm_count)
    assert s == lp.blocks_per_item(b, sm_count)
    assert b * s <= sm_count if b <= sm_count else s == 1
    ranges = lp.row_ranges(n, s)
    assert len(ranges) == s
    rows = [i for lo, hi in ranges for m0 in range(lo, hi, 8)
            for i in range(m0, min(m0 + 8, hi))]
    assert rows == list(range(n))


@pytest.mark.parametrize("d,d_out", [(272, 64), (256, 272)])
def test_group_kernel_limits_raise_before_any_launch(d, d_out):
    """Past D = 256 or d_out = 256 the row-group kernels (one query or nq >
    1, C <= 64 or 128) have no room: ``launch_shape`` raises, ``kernel_takes``
    says no, and the router sends the shape to the general kernel before any
    launch; so does T = 65."""
    for c, nq in ((64, 1), (128, 1), (64, 3), (128, 3)):
        with pytest.raises(ValueError, match="D<=256, d_out<=256"):
            tk.launch_shape(1, 61, c, d, 16, d_out, nq, 132)
        assert not tk.kernel_takes(61, c, d, 16, d_out, nq)
        assert tk.kernel_route(61, c, d, 16, d_out, nq) == "general"
    with pytest.raises(ValueError, match="unsupported shape"):
        tk.launch_shape(1, 65, 64, 256, 16, 64, 1, 132)
    assert tk.kernel_route(65, 64, 256, 16, 64, 1) == "general"


@pytest.mark.parametrize("b", [1, 10])
@pytest.mark.parametrize("n", [256, 258])
def test_wide_kernel_rows_fall_in_exactly_one_block(b, n):
    """At C = 128 with one query (U-TAE's bottleneck) the wide row-group
    kernel runs S = ``launch_shape`` blocks per batch item, one wave, block
    i walking ``row_ranges(N, S)[i]`` in groups of 4 rows: every row of
    [0, N) falls in exactly one block and one group, at the entry forward's
    B = 1 (most blocks get 1 or 2 rows) and the tile's B = 10, with N = 258
    ending in a partial group. With nq > 1 the queries kernel runs on the
    same blocks and ranges, in groups of 2 rows at this C."""
    s = tk.launch_shape(b, 61, 128, 256, 16, 128, 1, 132)
    assert s == lp.blocks_per_item(b, 132) and b * s <= 132
    assert tk.kernel_route(61, 128, 256, 16, 128, 1) == "wide"
    assert tk.launch_shape(b, 61, 128, 256, 16, 128, 3, 132) == s
    assert tk.kernel_route(61, 128, 256, 16, 128, 3) == "queries"
    for r in (4, 2):                        # rows per group at C = 128: one query, nq > 1
        ranges = lp.row_ranges(n, s)
        assert len(ranges) == s
        rows = [i for lo, hi in ranges for m0 in range(lo, hi, r)
                for i in range(m0, min(m0 + r, hi))]
        assert rows == list(range(n))


@pytest.mark.parametrize("t,c,d,g,d_out,nq", [(61, 64, 256, 16, 64, 1), (61, 128, 256, 16, 128, 1),
                                              (70, 64, 256, 16, 64, 1), (61, 160, 256, 16, 128, 1),
                                              (61, 128, 256, 16, 128, 9), (61, 128, 272, 16, 128, 3),
                                              (61, 128, 272, 16, 128, 1), (61, 64, 272, 16, 64, 1),
                                              (61, 72, 64, 8, 16, 1), (61, 20, 64, 4, 16, 1),
                                              (61, 64, 256, 32, 64, 1)])
def test_kernel_takes_is_the_wrappers_own_limits(t, c, d, g, d_out, nq):
    """``kernel_takes`` of both wrappers (their fast kernels, the general ones
    serving the rest) says yes exactly where their launch checks pass
    (``launch_shape``, ``_check_limits``) and ``kernel_route`` picks a
    row-group kernel, and ``LTAE.kernel_route`` asks the right one for the
    mode: the eval kernels in eval, the training pair in training. The
    module's kernel route takes each of these shapes (``LTAE.kernel_takes``)."""
    def passes(check, *args):
        try:
            check(*args)
        except ValueError:
            return False
        return True
    takes = tk.kernel_takes(t, c, d, g, d_out, nq)
    assert takes == passes(tk.launch_shape, 1, t, c, d, g, d_out, nq, 132)
    assert takes == (tk.kernel_route(t, c, d, g, d_out, nq) != "general")
    assert lp.kernel_takes(t, c, d, g) == passes(lp._check_limits, t, c, d, g)
    m = LTAE(in_channels=c, n_head=g, d_k=4, mlp=(d, d_out), d_model=d, num_queries=nq)
    assert m.eval().kernel_route(t, c) == tk.kernel_route(t, c, d, g, d_out, nq)
    assert (m.train().kernel_route(t, c) == "pair") == lp.kernel_takes(t, c, d, g)
    assert m.eval().kernel_takes(t, c) and m.train().kernel_takes(t, c)
