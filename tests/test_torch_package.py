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
    # webapp/app.py imports streamlit, which is optional: a stand-in where
    # it is missing, so that the app's own imports are scanned too
    code = (
        "import importlib, importlib.util, pkgutil, sys, types\n"
        "if importlib.util.find_spec('streamlit') is None:\n"
        "    sys.modules['streamlit'] = types.ModuleType('streamlit')\n"
        "import crop2seg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'crop2seg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
        "print(sorted(k for k in sys.modules if k.startswith('crop2seg_tpu_torch')))\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    imported = ast.literal_eval(res.stdout.splitlines()[-1])
    assert len(imported) >= 45   # every module was imported
    for name in ("native", "config", "gis.dataset_creator", "gis.geo", "gis.postprocess",
                 "gis.raster", "gis.raster_prep", "gis.safe_legacy", "gis.sentinel",
                 "gis.vectorize", "utils.profiling", "utils.visualize", "webapp.app",
                 "webapp.map_picker", "webapp.pipeline"):
        assert f"crop2seg_tpu_torch.{name}" in imported, name


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
                                               (2, 61, 258, 128, 256, 16, 128),
                                               (2, 61, 90, 128, 272, 16, 128),
                                               (1, 61, 5, 64, 256, 16, 64),
                                               (3, 61, 4099, 64, 256, 16, 64),
                                               (2, 64, 300, 64, 256, 16, 64),
                                               (2, 1, 300, 64, 256, 16, 64),
                                               (140, 4, 3, 16, 32, 4, 8)],
                         ids=["small", "timeunet", "utae", "utae-d-272", "n-below-blocks",
                              "n-not-multiple", "t-64", "t-1", "b-above-sms"])
def test_cuda_kernel_matches_plain_version(dtype, b, t, n, c, d, g, d_out):
    """The CUDA kernel against its plain version on the card, with pads, the
    tail affine and the attention output, at TimeUNet's C = 64 (the row-group
    kernel: fewer rows than blocks per item, N not a multiple of the row
    group or of the blocks, T at its limit of 64 and at 1, more batch items
    than SMs) and U-TAE's C = 128 (the wide row-group kernel, N not a
    multiple of its 4-row group or of the blocks; at D = 272 the general
    kernel). This file imports no JAX, so it runs where JAX is
    absent:
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
                                                  (1, 20, 77, 128, 256, 16, 128, 8),
                                                  (3, 61, 4099, 64, 256, 16, 64, 3),
                                                  (1, 64, 300, 128, 256, 16, 256, 8),
                                                  (140, 4, 3, 24, 48, 3, 6, 2)])
def test_cuda_kernel_num_queries_matches_plain_version(dtype, tail, b, t, n, c, d, g,
                                                       d_out, nq):
    """The queries row-group kernel (nq > 1) against its plain version on
    the card: out (B, N, nq, d_out), attention (B, N, G, nq, T), with pads,
    N not a multiple of the row groups (4 rows at C <= 64, 2 above) or of
    the blocks, up to MAX_QUERIES = 8 queries at T = 64 and d_out = 256 (its
    shared-memory limits), three heads (idle warps and a partial head pair),
    more batch items than SMs. Tolerances as the one-query test above."""
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
    assert tk.kernel_route(t, c, d, g, d_out, nq) == "queries"
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
@pytest.mark.parametrize("need_attn", [False, True], ids=["no-attn", "attn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n", [(2, 61, 258), (1, 20, 77), (1, 61, 256)],
                         ids=["partial-group", "short-t", "entry-forward"])
def test_cuda_wide_kernel_matches_plain_version(b, t, n, dtype, need_attn):
    """The wide row-group kernel (64 < C <= 128, one query: U-TAE's
    bottleneck, C = d_out = 128, D = 256, G = 16) against its plain version
    on the card, with pads: N = 258 ends in a partial 4-row group; at B = 1
    most of the 132 blocks get one or two rows (N = 256, the entry
    forward's shape) or none (N = 77). Tolerances as
    ``test_cuda_kernel_matches_plain_version``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    c, d, g, d_out = 128, 256, 16, 128
    params = {k: v.to(dev) for k, v in _random_params(c, d, g, d_out, gen).items()}
    x = torch.randn(b, t, n, c, generator=gen).to(dev, dtype)
    pe = torch.randn(b, t, d, generator=gen).to(dev)
    pad = torch.zeros(b, t, dtype=torch.bool)
    pad[0, t - 3:] = True
    pad = pad.to(dev)
    before = tk.ltae_fused_forward.launches
    got, attn = tk.ltae_fused_forward(x, pe, pad, params, n_head=g, d_k=4,
                                      need_attn=need_attn)
    assert tk.ltae_fused_forward.launches == before + 1
    want, want_attn = tk.ltae_fused_forward_reference(x.float(), pe, pad, params,
                                                      n_head=g, d_k=4)
    torch.cuda.synchronize()
    tol = 5e-3 if dtype == torch.float32 else 3e-2
    assert got.shape == (b, n, d_out)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if need_attn:
        torch.testing.assert_close(attn, want_attn, rtol=1e-4, atol=1e-4)
    else:
        assert attn is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n,c,d,g,d_out,nq,tail,attn,path", [
    (2, 70, 300, 64, 256, 16, 64, 1, True, False, None),
    (2, 128, 77, 64, 256, 16, 64, 1, True, True, None),
    (1, 190, 40, 64, 256, 16, 64, 1, False, True, None),
    (2, 70, 258, 128, 256, 16, 128, 1, False, True, None),
    (2, 128, 100, 128, 256, 16, 128, 3, True, True, None),
    (2, 61, 90, 128, 272, 16, 128, 1, False, True, None),
    (1, 61, 50, 64, 256, 32, 64, 1, True, True, None),
    (1, 20, 30, 192, 256, 16, 192, 1, True, True, None),
    (2, 33, 40, 12, 48, 4, 8, 2, True, True, None),
    (1, 12, 20, 32, 64, 8, 16, 9, False, True, None),
    (1, 40, 3, 256, 64, 32, 32, 8, True, True, "scratch"),
    (140, 66, 3, 16, 32, 4, 8, 1, True, True, None),
    (2, 65, 300, 64, 256, 16, 64, 1, True, True, None),
    (2, 97, 301, 64, 256, 16, 64, 1, True, False, None),
    (1, 600, 7, 64, 256, 16, 64, 1, True, True, "r-1"),
    (1, 1200, 5, 64, 256, 16, 64, 1, True, False, "streamed fp32")],
    ids=["timeunet-t70", "t128", "t190", "utae-t70", "nq3-t128", "d-272", "g-32",
         "c-192", "c-12", "nq-9", "scratch", "b-above-sms", "t65-n300", "t97-n301",
         "r-1", "streamed"])
def test_cuda_general_kernel_matches_plain_version(dtype, b, t, n, c, d, g, d_out, nq,
                                                   tail, attn, path):
    """The general eval kernel (every shape the row-group kernels do not
    take) against its plain version on the card, with pads: T past 64 (65,
    70, 97, 128, 190: chunks of 32 steps with a partial last one), U-TAE's
    width, three queries, D = 272, G = 32, C = 192 and C = 12 (not a multiple
    of 8), nine queries, more batch items than SMs, N not a multiple of the
    rows a group (300, 301), and the plan's edges, asserted through the C
    entries (``general_plan`` and the scratch buffer's floats): groups of one row (T = 600), x streamed in chunks
    rather than resident (T = 1200 in fp32), a workspace past shared memory
    (its scratch buffer in device memory). One launch of the general route
    each. Tolerances as ``test_cuda_kernel_matches_plain_version``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
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
    assert tk.kernel_route(t, c, d, g, d_out, nq) == "general"
    rows, resident = tk.general_plan(t, c, d, g, d_out, nq, dtype, attn)[:2]
    scratch = tk._kernel()[1](t, c, d, g, d_out, nq, int(dtype == torch.bfloat16), int(attn))
    if path == "scratch":
        assert scratch > 0
    elif path == "r-1":
        assert rows == 1 and resident and scratch == 0
    elif path == "streamed fp32" and dtype == torch.float32:
        assert not resident and scratch == 0
    before = tk.ltae_fused_forward.route_launches["general"]
    got, got_attn = tk.ltae_fused_forward(x, pe, pad, params, n_head=g, d_k=4,
                                          need_attn=attn, tail_affine=ts)
    assert tk.ltae_fused_forward.route_launches["general"] == before + 1
    want, want_attn = tk.ltae_fused_forward_reference(
        x.float(), pe, pad, params, n_head=g, d_k=4, tail_affine=ts)
    torch.cuda.synchronize()
    tol = 5e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if attn:
        torch.testing.assert_close(got_attn, want_attn, rtol=1e-4, atol=1e-4)
    else:
        assert got_attn is None


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cuda_ltae_past_the_kernels_limits_raises_on_the_card(train, monkeypatch):
    """LTAE at T = 70 (past the fast kernels' T <= 64) on the card, in eval
    and in training without the attention output: the kernel route (the
    default for a CUDA tensor) no longer raises, as the JAX L-TAE runs its
    Pallas kernel there: it launches the general kernel once (eval) or the
    general pair (training, forward and backward) and agrees with the plain
    route on the card, and the plain route (fused=False) agrees with the
    same module on the CPU (TF32 off); both within 1e-3, the module
    tolerance of ``chip_smoke.py`` at this width: the out GroupNorm's groups
    of 4 channels amplify the orders of sums (3.1e-4 measured in eval)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from crop2seg_tpu_torch.nn.ltae import LTAE
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    m = LTAE(in_channels=64, n_head=16, d_k=4, mlp=(256, 64), d_model=256).to(dev)
    m.attn_dropout, m.mlp[1].p = 0.0, 0.0
    m.train(train)
    x = torch.randn(2, 70, 8, 8, 64, generator=gen).to(dev)
    dates = (torch.arange(70.0) * 5)[None].expand(2, -1).to(dev)
    pad = torch.zeros(2, 70, dtype=torch.bool, device=dev)
    pad[1, 60:] = True
    before = (tk.ltae_fused_forward.route_launches["general"],
              dict(lp.ltae_pool.launches))
    x.requires_grad_(train)
    got, _ = m(x, dates, pad, need_attn=not train)
    if train:
        got.square().sum().backward()
    launched = {k: v - before[1].get(k, 0) for k, v in lp.ltae_pool.launches.items()
                if v != before[1].get(k, 0)}
    if train:
        assert launched == {lp.variant(False, torch.float32, k, general=True): 1
                            for k in ("fwd", "bwd")}
    else:
        assert tk.ltae_fused_forward.route_launches["general"] == before[0] + 1
    with torch.no_grad():
        out, _ = m(x, dates, pad, need_attn=not train, fused=False)
        want, _ = m.cpu()(x.cpu(), dates.cpu(), pad.cpu(), need_attn=not train)
    assert out.is_cuda
    torch.testing.assert_close(got.detach(), out, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train-forward"])
def test_cuda_timeunet_pad_value_keeps_the_tail_on_the_card(train):
    """TimeUNet(pad_value=1.5) on the card: the kernel route leaves in_conv's
    tail undeferred and launches the eval kernel (eval) or the untailed
    training forward (a train-mode forward) once; its logits are within 1e-3
    of the plain L-TAE's (fused=False)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from crop2seg_tpu_torch.models.timeunet import TimeUNet
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    m = TimeUNet(input_dim=6, encoder_widths=(16, 16, 32), decoder_widths=(8, 16, 32),
                 out_conv=(8, 5), n_head=4, d_model=32, pad_value=1.5).to(dev)
    m.temporal_encoder.attn_dropout, m.temporal_encoder.mlp[1].p = 0.0, 0.0
    m.train(train)
    x = torch.randn(2, 9, 16, 16, 6, generator=gen).to(dev)
    dates = (torch.arange(9.0) * 5)[None].expand(2, -1).to(dev)
    pad = torch.zeros(2, 9, dtype=torch.bool, device=dev)
    pad[1, 6:] = True
    before = (tk.ltae_fused_forward.launches, lp.ltae_pool.launches_fwd)
    with torch.no_grad():
        got = m(x, dates, pad)
        after = (tk.ltae_fused_forward.launches, lp.ltae_pool.launches_fwd)
        want = m(x, dates, pad, fused=False)
    assert after == (before[0] + (not train), before[1] + train)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported_widths():
    """C = 160 (past the row-group kernels' 128) and D = 272 (past their
    256) go to the general kernel on the card, not to the plain version;
    the C entry refuses D = 272 on the row-group route, and a shape where G
    does not divide C raises before any launch. The stage kernel still
    refuses C = 160."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(dev) for k, v in _random_params(160, 64, 16, 16, gen).items()}
    x = torch.zeros(1, 5, 8, 160, device=dev)
    before = tk.ltae_fused_forward.route_launches["general"]
    tk.ltae_fused_forward(x, torch.zeros(1, 5, 64, device=dev),
                          torch.zeros(1, 5, dtype=torch.bool, device=dev), params, n_head=16)
    assert tk.ltae_fused_forward.route_launches["general"] == before + 1
    before, before_general = (tk.ltae_fused_forward.launches,
                              tk.ltae_fused_forward.route_launches["general"])
    with pytest.raises(ValueError, match="G must divide"):
        tk.ltae_fused_forward(x[..., :150].contiguous(), torch.zeros(1, 5, 64, device=dev),
                              torch.zeros(1, 5, dtype=torch.bool, device=dev),
                              {**params, "win": params["win"][:150],
                               "in_scale": params["in_scale"][:150],
                               "in_bias": params["in_bias"][:150]}, n_head=16)
    with pytest.raises(ValueError, match="unsupported shape"):
        ls.ltae_stages(x, torch.zeros(1, 5, 64, device=dev),
                       torch.zeros(1, 1, 5, device=dev), torch.zeros(160, 64, device=dev),
                       torch.zeros(64, device=dev), torch.zeros(64, 16, device=dev),
                       torch.zeros(1, 16, device=dev), n_head=16)
    params = {k: v.to(dev) for k, v in _random_params(64, 272, 16, 64, gen).items()}
    x = torch.zeros(1, 5, 8, 64, device=dev)
    with pytest.raises(ValueError, match="D<=256"):
        tk.launch_shape(1, 5, 64, 272, 16, 64, 1, 132)
    out = torch.empty(1, 8, 64, device=dev)
    big = torch.zeros(272 * 272, device=dev)
    rc = tk._kernel()[0](x.data_ptr(), 0, *[big.data_ptr()] * 9, None, None,
                         out.data_ptr(), None, 1, 5, 8, 64, 272, 16, 64, 1,
                         tk.ROUTES.index("group"), 1, None, 1e-5,
                         torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    assert tk.ltae_fused_forward.launches == before
    tk.ltae_fused_forward(x, torch.zeros(1, 5, 272, device=dev),
                          torch.zeros(1, 5, dtype=torch.bool, device=dev), params, n_head=16)
    assert tk.ltae_fused_forward.route_launches["general"] == before_general + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,n,c", [(1, 61, 256, 64), (2, 20, 77, 128), (1, 64, 37, 128),
                                     (3, 64, 5, 64)])
def test_cuda_ltae_stages_matches_plain_version(b, t, n, c):
    """The stage kernel against its plain version on the card, each stage,
    with pads, at its limits (T = 64, C = 128, D = 256: W_in in two chunks
    of 64 channels) and at odd N (its blocks take one row each, so every N
    fills them; more batch items than one): 1e-4 of each stage's largest
    |value| (fp32 sums in another order), attention 1e-5."""
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
                                         (1, 12, 200, 32, 256, 8),
                                         (1, 61, 5, 64, 256, 16),
                                         (140, 4, 3, 16, 32, 4),
                                         (2, 64, 300, 64, 256, 16),
                                         (2, 5, 77, 64, 256, 16)])
def test_cuda_ltae_pool_kernels_match_plain_version(drop_p, b, t, n, c, d, g,
                                                    dtype, tail):
    """The ltae_pool forward and backward kernels, in each variant (x fp32
    or bf16, untailed or tail mode), against the plain version under
    autograd on the card, with pads (tsc = tsh = 0 there), dropout on and off
    (the same hash mask on both sides), N not a multiple of the blocks' rows.
    Both kernels' persistent blocks (S per batch item) meet several rows
    each with N not a multiple of S or of the forward's 8-row group (N =
    5003), fewer rows than blocks, so that some blocks have none (N = 100
    and N = 5), more batch items than SMs (B = 140, S = 1), G < 16 (idle
    warps), heads of dv = 32 > 16 channels (two passes over the rows in the
    backward), T at its limit of 64 and T = 5 (one quarter of the forward's
    GroupNorm threads holds data, one pad step in the forward's tiles). o and
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("b,t,n,c,d,g,path,fwd", [
    (2, 70, 301, 64, 256, 16, None, "resident"),
    (1, 128, 100, 64, 256, 16, None, "resident"),
    (2, 35, 40, 72, 64, 8, None, "resident"),
    (1, 20, 33, 64, 256, 32, None, "resident"),
    (2, 61, 30, 64, 272, 16, None, "resident"),
    (1, 9, 50, 12, 24, 4, None, "resident"),
    (1, 2000, 3, 16, 32, 16, "scratch", "resident"),
    (140, 66, 3, 16, 32, 4, None, "resident"),
    (2, 65, 301, 64, 256, 16, None, "resident"),
    (2, 97, 45, 64, 256, 16, None, "resident"),
    (1, 1200, 3, 16, 32, 16, "r-1", "resident"),
    (1, 1200, 9, 64, 256, 16, "streamed", None),
    (1, 2000, 5, 64, 256, 16, None, "streamed"),
    (2, 33, 7, 384, 384, 16, None, "r-1"),
    (1, 33, 5, 640, 64, 16, None, "scratch"),
    (2, 128, 303, 64, 256, 16, None, "resident")],
    ids=["timeunet-t70", "t128", "c-72", "g-32", "d-272", "c-12", "scratch", "b-above-sms",
         "t65-n301", "t97", "r-1", "streamed", "fwd-streamed", "fwd-r-1", "fwd-scratch",
         "t128-n303"])
def test_cuda_ltae_pool_general_kernels_match_plain_version(drop_p, b, t, n, c, d, g,
                                                            path, fwd, dtype, tail):
    """The general training pair (every shape the fast pair does not take)
    against the plain version under autograd on the card, as
    ``test_cuda_ltae_pool_kernels_match_plain_version`` holds the fast pair:
    T past 64 (65, 70, 97, 128: chunks of 32 steps with a partial last one),
    C = 72 and C = 12, G = 32, D = 272, more batch items than SMs, N not a
    multiple of either kernel's rows a group (301, 303: blocks of 4 and 5
    rows in groups of 4), and the plans' edges, asserted through the C
    entries (``general_fwd_plan``, ``general_bwd_plan`` and the scratch
    buffer's floats). The backward (``path``): groups of one row (T = 1200),
    x streamed in chunks rather than resident (T = 1200 at C = 64), a
    workspace past shared memory (T = 2000: its scratch buffer in device
    memory). The forward (``fwd``): the group's x resident, streamed (T =
    2000 at C = 64), groups of one row (C = D = 384), a workspace past
    shared memory (C = 640). One general forward and one general backward
    launch; o and every gradient within the same tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)

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
    assert not lp.kernel_takes(t, c, d, g)
    rows, resident = lp.general_bwd_plan(t, c, d, g, dtype)[:2]
    scratch = lp._kernels()[5](t, c, d, g, 1, int(dtype == torch.bfloat16))
    if path == "scratch":
        assert scratch > 0
    elif path == "r-1":
        assert rows == 1 and scratch == 0
    elif path == "streamed":
        assert not resident and scratch == 0
    f_rows, f_resident = lp.general_fwd_plan(t, c, d, g, dtype)[:2]
    f_scratch = lp._kernels()[5](t, c, d, g, 0, int(dtype == torch.bfloat16))
    if fwd == "resident":
        assert f_resident and f_scratch == 0
    elif fwd == "streamed":
        assert not f_resident and f_scratch == 0
    elif fwd == "r-1":
        assert f_rows == 1 and f_scratch == 0
    elif fwd == "scratch":
        assert f_scratch > 0
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
        names = [lp.variant(tail, dtype, k, general=True) for k in ("fwd", "bwd")]
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
def test_cuda_ltae_pool_rejects_unsupported_widths():
    """D = 272 at C = 64 (past the fast forward kernel's 256, a thread per
    (d, half) of its projection) goes to the general pair, not to the plain
    version; the fast C entry refuses it, and a G that does not divide C
    raises in the wrapper before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    b, t, n, c, d, g = 1, 5, 8, 64, 272, 16
    x = torch.zeros(b, t, n, c, device=dev)
    pe, pad = torch.zeros(b, t, d, device=dev), torch.zeros(b, t, dtype=torch.bool, device=dev)
    params = (torch.zeros(c, d, device=dev), torch.zeros(d, device=dev),
              torch.zeros(d, g, device=dev), torch.zeros(1, g, device=dev))
    ts = (torch.ones(b, t, c, device=dev), torch.zeros(b, t, c, device=dev))
    before = dict(lp.ltae_pool.launches)
    lp.ltae_pool(x, pe, pad, *params, n_head=g)
    lp.ltae_pool_tail(x, *ts, pe, pad, *params, n_head=g)
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in lp.ltae_pool.launches.items()
                if v != before.get(k, 0)}
    assert launched == {lp.variant(tail, torch.float32, "fwd", general=True): 1
                        for tail in (False, True)}
    before = dict(lp.ltae_pool.launches)
    with pytest.raises(ValueError, match="unsupported shape"):
        lp.ltae_pool(x[..., :60].contiguous(), pe, pad, params[0][:60], *params[1:], n_head=g)
    o = torch.empty(b, n, d, device=dev)
    big = torch.zeros(t * d + c * d, device=dev)
    for tsc, tsh in ((None, None), (ts[0].data_ptr(), ts[1].data_ptr())):
        # x, x_is_bf16, tsc, tsh, bpe, win, ws, pes, o, S, B, T, N, C, D, G, ...
        rc = lp._kernels()[0](x.data_ptr(), 0, tsc, tsh, *[big.data_ptr()] * 4,
                              o.data_ptr(), 1, b, t, n, c, d, g, 0, 0, 1.0, 1e-5,
                              torch.cuda.current_stream().cuda_stream)
        assert rc != 0
    torch.cuda.synchronize()
    assert dict(lp.ltae_pool.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("t", [61, 70], ids=["fast", "general"])
@pytest.mark.parametrize("tail", [False, True], ids=["untailed", "tail"])
def test_cuda_ltae_pool_backward_is_reproducible(tail, t):
    """The backward kernels (the fast one at T = 61, the general one at T =
    70) add their blocks' partial sums in a fixed order, so two backward
    calls on the same inputs give the same gradients bit for bit, the
    weight gradients too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    b, n, c, d, g = 2, 3000, 64, 256, 16

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
