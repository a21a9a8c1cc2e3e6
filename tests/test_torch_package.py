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
    assert (_build.CSRC_DIR / "ltae_fused_fwd.cu").exists()
    lib = _build.library_path("ltae_fused_fwd")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    rel = os.path.relpath(_build.BUILD_DIR, REPO).replace(os.sep, "/")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert rel + "/" in ignored or rel in ignored
    src = open(_build.CSRC_DIR / "ltae_fused_fwd.cu").read()
    assert "crop2seg_tpu/ops/ltae_pallas.py::ltae_fused_forward" in src


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
                                               (1, 61, 300, 64, 256, 16, 64)])
def test_cuda_kernel_matches_plain_version(dtype, b, t, n, c, d, g, d_out):
    """The CUDA kernel against its plain version on the card, with pads, the
    tail affine and the attention output, N not a multiple of the block's
    rows. This file imports no JAX, so it runs where JAX is absent:
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


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py prints no result and exits non-zero without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr
