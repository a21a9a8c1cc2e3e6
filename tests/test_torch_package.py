"""crop2seg_tpu_torch as a package: no JAX inside it, the card by default,
kernel launches counted only where the kernel runs, and the kernel build
set up for Hopper (nothing is compiled here)."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from crop2seg_tpu_torch.ops import _build
from crop2seg_tpu_torch.ops import ltae_fused as tk
from crop2seg_tpu_torch.ops import ltae_pool as lp
from crop2seg_tpu_torch.ops import ltae_stages as ls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "crop2seg_tpu")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import crop2seg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'crop2seg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
        "print(len([k for k in sys.modules if k.startswith('crop2seg_tpu_torch')]))\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15   # every module was imported


@pytest.mark.parametrize("path", ["chip_smoke.py", "crop2seg_tpu_torch"])
def test_no_jax_import_statements(path):
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs if f.endswith(".py")]
    for f in files:
        for node in ast.walk(ast.parse(open(f).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (f, n)


def _tiny_model():
    from crop2seg_tpu_torch.models.factory import get_model
    return get_model({"model": "timeunet", "encoder_widths": [8, 8],
                      "decoder_widths": [8, 8], "out_conv": [8, 3],
                      "n_head": 4, "d_model": 16}, device="cpu")


def test_entry_points_default_to_the_card_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from crop2seg_tpu_torch.inference.tile import make_tile_predictor
    from crop2seg_tpu_torch.models.factory import get_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_tile_predictor(_tiny_model())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model({"model": "timeunet"})


def test_wrapper_counts_no_launch_on_cpu():
    g = 4
    x = torch.randn(1, 3, 8, 16)
    params = {"in_scale": torch.ones(16), "in_bias": torch.zeros(16),
              "win": torch.randn(16, 32), "bin": torch.zeros(32),
              "wk": torch.randn(32, g * 4), "bk": torch.zeros(g * 4),
              "q": torch.randn(g, 1, 4), "wm_folded": torch.randn(32, 8),
              "bm_folded": torch.zeros(8), "out_scale": torch.ones(8),
              "out_bias": torch.zeros(8)}
    before = tk.ltae_fused_forward.launches
    out, attn = tk.ltae_fused_forward(x, torch.randn(1, 3, 32),
                                      torch.zeros(1, 3, dtype=torch.bool),
                                      params, n_head=g, d_k=4)
    assert out.shape == (1, 8, 8) and attn.shape == (1, 8, g, 3)
    assert tk.ltae_fused_forward.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.ltae_fused_forward(x.to("meta"), torch.randn(1, 3, 32),
                              torch.zeros(1, 3, dtype=torch.bool), params,
                              n_head=g, d_k=4)


def test_build_targets_hopper_into_an_ignored_directory():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    rel = os.path.relpath(_build.BUILD_DIR, REPO).replace(os.sep, "/")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert rel + "/" in ignored or rel in ignored
    replaces = {"ltae_fused_fwd": "crop2seg_tpu/ops/ltae_pallas.py::ltae_fused_forward",
                "ltae_pool": "crop2seg_tpu/ops/ltae_pallas_train.py::ltae_pool",
                "ltae_stages": "scripts/debug_ltae_stages.py::_kernel"}
    for name, tpu_kernel in replaces.items():
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
        assert tpu_kernel in open(_build.CSRC_DIR / f"{name}.cu").read()


def _random_params(c, d, g, d_out, gen):
    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen)
    return {"in_scale": 1 + r(c, scale=0.1), "in_bias": r(c, scale=0.1),
            "win": r(c, d, scale=c ** -0.5), "bin": r(d, scale=0.1),
            "wk": r(d, g * 4, scale=0.5), "bk": r(g * 4, scale=0.1),
            "q": r(g, 1, 4), "wm_folded": r(d, d_out, scale=d ** -0.5),
            "bm_folded": r(d_out, scale=0.1), "out_scale": 1 + r(d_out, scale=0.1),
            "out_bias": r(d_out, scale=0.1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n,c,d,g,d_out", [(2, 9, 64, 32, 64, 8, 16),
                                               (1, 61, 300, 64, 256, 16, 64),
                                               (2, 61, 258, 128, 256, 16, 128)])
def test_cuda_kernel_matches_plain_version(dtype, b, t, n, c, d, g, d_out):
    """The CUDA kernel against its plain version on the card, with pads, the
    tail affine and the attention output, N not a multiple of the block's
    rows, at TimeUNet's C = 64 and U-TAE's C = 128 (the kernel's two
    instantiations). This file imports no JAX, so it runs where JAX is absent:
    ``python -m pytest --noconftest -m cuda tests/test_torch_package.py``.
    Tolerance: fp32 5e-3 (sums in another order; out-GroupNorm groups of 2
    or 4 channels amplify that noise); bf16 3e-2 (one bf16 rounding of the
    O(1) normalized outputs), against the plain version in fp32 on the same
    bf16-rounded input; attention 1e-4 (fp32 softmax either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(dev) for k, v in _random_params(c, d, g, d_out, gen).items()}
    x = torch.randn(b, t, n, c, generator=gen).to(dev, dtype)
    pe = torch.randn(b, t, d, generator=gen).to(dev)
    pad = torch.zeros(b, t, dtype=torch.bool)
    pad[0, t - 3:] = True
    pad = pad.to(dev)
    valid = (~pad).float()[:, :, None]
    tail = ((1 + 0.2 * torch.randn(b, t, c, generator=gen)).to(dev) * valid,
            (0.1 * torch.randn(b, t, c, generator=gen)).to(dev) * valid)
    before = tk.ltae_fused_forward.launches
    got, attn = tk.ltae_fused_forward(x, pe, pad, params, n_head=g, d_k=4,
                                      tail_affine=tail)
    assert tk.ltae_fused_forward.launches == before + 1
    want, want_attn = tk.ltae_fused_forward_reference(
        x.float(), pe, pad, params, n_head=g, d_k=4, tail_affine=tail)
    torch.cuda.synchronize()
    tol = 5e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(attn, want_attn, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tail", [False, True], ids=["untailed", "tail"])
@pytest.mark.parametrize("b,t,n,c,d,g,d_out,nq", [(2, 9, 64, 32, 64, 8, 16, 3),
                                                  (1, 61, 300, 64, 256, 16, 64, 3),
                                                  (2, 61, 258, 128, 256, 16, 128, 2),
                                                  (1, 20, 77, 128, 256, 16, 128, 8)])
def test_cuda_kernel_num_queries_matches_plain_version(dtype, tail, b, t, n, c, d, g,
                                                       d_out, nq):
    """The kernel's nq > 1 mode against its plain version on the card: out
    (B, N, nq, d_out), attention (B, N, G, nq, T), with pads, N not a
    multiple of the block's rows, up to MAX_QUERIES = 8 queries. Tolerances
    as the one-query test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    params = _random_params(c, d, g, d_out, gen)
    params["q"] = torch.randn(g, nq, 4, generator=gen)
    params = {k: v.to(dev) for k, v in params.items()}
    x = torch.randn(b, t, n, c, generator=gen).to(dev, dtype)
    pe = torch.randn(b, t, d, generator=gen).to(dev)
    pad = torch.zeros(b, t, dtype=torch.bool)
    pad[0, t - 3:] = True
    pad = pad.to(dev)
    valid = (~pad).float()[:, :, None]
    ts = ((1 + 0.2 * torch.randn(b, t, c, generator=gen)).to(dev) * valid,
          (0.1 * torch.randn(b, t, c, generator=gen)).to(dev) * valid) if tail else None
    before = tk.ltae_fused_forward.launches
    got, attn = tk.ltae_fused_forward(x, pe, pad, params, n_head=g, d_k=4, tail_affine=ts)
    assert tk.ltae_fused_forward.launches == before + 1
    want, want_attn = tk.ltae_fused_forward_reference(
        x.float(), pe, pad, params, n_head=g, d_k=4, tail_affine=ts)
    torch.cuda.synchronize()
    assert got.shape == (b, n, nq, d_out) and attn.shape == (b, n, g, nq, t)
    tol = 5e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(attn, want_attn, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported_widths():
    """C = 160 (past the kernel's 128) raises on the card; it is not sent to
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(dev) for k, v in _random_params(160, 64, 16, 16, gen).items()}
    x = torch.zeros(1, 5, 8, 160, device=dev)
    before = tk.ltae_fused_forward.launches
    with pytest.raises(ValueError, match="unsupported shape"):
        tk.ltae_fused_forward(x, torch.zeros(1, 5, 64, device=dev),
                              torch.zeros(1, 5, dtype=torch.bool, device=dev),
                              params, n_head=16)
    with pytest.raises(ValueError, match="unsupported shape"):
        ls.ltae_stages(x, torch.zeros(1, 5, 64, device=dev),
                       torch.zeros(1, 1, 5, device=dev), torch.zeros(160, 64, device=dev),
                       torch.zeros(64, device=dev), torch.zeros(64, 16, device=dev),
                       torch.zeros(1, 16, device=dev), n_head=16)
    assert tk.ltae_fused_forward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,n,c", [(1, 61, 256, 64), (2, 20, 77, 128)])
def test_cuda_ltae_stages_matches_plain_version(b, t, n, c):
    """The stage kernel against its plain version on the card, each stage,
    with pads, N not a multiple of the block's rows: 1e-4 of each stage's
    largest |value| (fp32 sums in another order), attention 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    d, g = 256, 16

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    mask = torch.zeros(b, 1, t, device=dev)
    mask[0, :, t - 6:] = 1.0
    args = (r(b, t, n, c), r(b, t, d), mask, r(c, d, scale=0.1), r(d, scale=0.1),
            r(d, g, scale=0.1), r(1, g, scale=0.1))
    before = ls.ltae_stages.launches
    got = ls.ltae_stages(*args, n_head=g)
    assert ls.ltae_stages.launches == before + 1
    want = ls.ltae_stages_reference(*args, n_head=g)
    torch.cuda.synchronize()
    for name, a, w in zip(("h0", "scores", "attn", "o"), got, want):
        tol = 1e-5 if name == "attn" else 1e-4 * w.abs().max().item()
        assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
        assert (a - w).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [False, True], ids=["untailed", "tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("b,t,n,c,d,g", [(2, 9, 301, 32, 64, 8),
                                         (1, 61, 300, 64, 256, 16),
                                         (4, 61, 5003, 64, 256, 16),
                                         (1, 61, 100, 64, 256, 16),
                                         (1, 12, 200, 32, 256, 8)])
def test_cuda_ltae_pool_kernels_match_plain_version(drop_p, b, t, n, c, d, g,
                                                    dtype, tail):
    """The ltae_pool forward and backward kernels, in each variant (x fp32
    or bf16, untailed or tail mode), against the plain version under
    autograd on the card, with pads (tsc = tsh = 0 there), dropout on and off
    (the same hash mask on both sides), N not a multiple of the blocks' rows.
    The backward's persistent blocks (S per batch item) meet several rows
    each with N not a multiple of S (N = 5003), fewer rows than blocks, so
    that some blocks have none (N = 100), G < 16 (idle warps), and heads of
    dv = 32 > 16 channels (two passes over the rows, the last shape). o and
    all gradients (dtsc and dtsh too in tail mode), as max |err| / max
    |plain|. fp32 1e-4 (fp32 sums in another order, the grid-wide ones per
    block and then across blocks); bf16 1e-2 against the fp32 plain version
    on the same bf16-rounded input and upstream gradient (o and dx are stored
    in bf16, a rounding of at most 2**-8 of each). dcs is zero in exact
    arithmetic, so it is held against the scale of du (the same ds, weighted
    by h)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    x, pe = r(b, t, n, c).to(dtype), r(b, t, d)
    go = r(b, n, d).to(dtype).float()                # exact in x's dtype
    params = (r(c, d, scale=c ** -0.5), r(d, scale=0.1), r(d, g, scale=0.2),
              r(1, g, scale=0.1))
    pad = torch.zeros(b, t, dtype=torch.bool, device=dev)
    pad[0, t - 3:] = True
    valid = (~pad).float()[:, :, None]
    ts = (((1 + r(b, t, c, scale=0.2)) * valid, r(b, t, c, scale=0.1) * valid)
          if tail else ())
    kernel = lp.ltae_pool_tail if tail else lp.ltae_pool
    plain = lp.ltae_pool_tail_reference if tail else lp.ltae_pool_reference
    res = []
    for fn, xin in ((kernel, x), (plain, x.float())):
        leaves = [a.clone().requires_grad_(True) for a in (xin,) + ts + (pe,) + params]
        before = dict(lp.ltae_pool.launches)
        o = fn(*leaves[:1 + len(ts)], leaves[1 + len(ts)], pad, *leaves[2 + len(ts):],
               7, n_head=g, drop_p=drop_p)
        res.append([o.float()] + [a.float() for a in
                                  torch.autograd.grad(o, leaves, go.to(o.dtype))])
        launched = {k: v - before.get(k, 0) for k, v in lp.ltae_pool.launches.items()
                    if v != before.get(k, 0)}
        names = [lp.variant(tail, dtype, k) for k in ("fwd", "bwd")]
        assert launched == ({k: 1 for k in names} if fn is kernel else {})
    torch.cuda.synchronize()
    got, want = res
    names = (("o", "dx") + (("dtsc", "dtsh") if tail else ())
             + ("dpe", "dwin_f", "dbin_f", "du", "dcs"))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for i, name in enumerate(names):
        scale = want[names.index("du" if name == "dcs" else name)].abs().max().item()
        err = (got[i] - want[i]).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [False, True], ids=["untailed", "tail"])
def test_cuda_ltae_pool_backward_is_reproducible(tail):
    """The backward kernel adds its blocks' partial sums in a fixed order, so
    two backward calls on the same inputs give the same gradients bit for
    bit, the weight gradients too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    b, t, n, c, d, g = 2, 61, 3000, 64, 256, 16

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    ts = (1 + r(b, t, c, scale=0.2), r(b, t, c, scale=0.1)) if tail else ()
    leaves = [a.requires_grad_(True) for a in (r(b, t, n, c),) + ts + (
        r(b, t, d), r(c, d, scale=c ** -0.5), r(d, scale=0.1), r(d, g, scale=0.2),
        r(1, g, scale=0.1))]
    pad = torch.zeros(b, t, dtype=torch.bool, device=dev)
    fn = lp.ltae_pool_tail if tail else lp.ltae_pool
    o = fn(*leaves[:1 + len(ts)], leaves[1 + len(ts)], pad, *leaves[2 + len(ts):], 3,
           n_head=g, drop_p=0.1)
    go = r(b, n, d)
    first = torch.autograd.grad(o, leaves, go, retain_graph=True)
    again = torch.autograd.grad(o, leaves, go)
    for a, w in zip(first, again):
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_cuda_ltae_pool_rejects_other_dtypes():
    """fp16 and fp64 x have no kernel: a CUDA tensor of either raises, it is
    not sent to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    c, d, g = 16, 32, 4
    pe, pad = torch.zeros(1, 3, d, device=dev), torch.zeros(1, 3, dtype=torch.bool, device=dev)
    params = (torch.zeros(c, d, device=dev), torch.zeros(d, device=dev),
              torch.zeros(d, g, device=dev), torch.zeros(1, g, device=dev))
    ts = (torch.ones(1, 3, c, device=dev), torch.zeros(1, 3, c, device=dev))
    for dtype in (torch.float16, torch.float64):
        x = torch.zeros(1, 3, 8, c, dtype=dtype, device=dev)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            lp.ltae_pool(x, pe, pad, *params, n_head=g)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            lp.ltae_pool_tail(x, *ts, pe, pad, *params, n_head=g)


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py prints no result and exits non-zero without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr
