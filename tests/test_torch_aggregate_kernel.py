"""The temporal aggregator's kernel pair (crop2seg_tpu_torch/csrc/
temporal_aggregate.cu through ops/aggregate.py) against its plain version,
the loop of per-date ops.

On the CPU: a CPU tensor takes the loop (no launch, the counter
``aggregate.kernel`` stays 0), the wrapper refuses K not dividing C before
any launch, the route table, the mean mode's weights. On the card (``cuda``
marker; ``python -m pytest --noconftest -m cuda
tests/test_torch_aggregate_kernel.py``): every mode with and without pads at
T = 7, 61 and 73, C/K = 1, 4 and 8 (and 3, the general route), the attention
upsampled, at the skip's size and downsampled, the mean's stride-0 weights:
the output and dx bit for bit, dw within 1e-6 of its products' magnitudes
and in bf16 one rounding besides; the span, the counter, a run-to-run identical backward,
and a lower peak than the loop's at U-TAE's level-0 shape. This file imports
no JAX."""
from __future__ import annotations

import pytest
import torch

from crop2seg_tpu_torch.nn import aggregator
from crop2seg_tpu_torch.nn.aggregator import temporal_aggregate
from crop2seg_tpu_torch.ops import aggregate as ag
from crop2seg_tpu_torch.utils.profiling import collect


def _inputs(b, t, size, c, heads, dtype, device, pads, seed=0, attn_size=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, size, size, c, generator=g)
    logits = torch.randn(b, attn_size, attn_size, heads, t, generator=g)
    pad = torch.zeros(b, t, dtype=torch.bool)
    if pads:
        pad[0, t // 2:] = True
        pad[-1, 1] = True
    return (x.to(device, dtype), torch.softmax(logits, -1).to(device, dtype),
            pad.to(device) if pads else None)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------- the CPU


def test_cpu_takes_the_loop_and_counts_no_launch():
    x, attn, pad = _inputs(2, 7, 8, 16, 4, torch.float32, "cpu", True)
    x.requires_grad_(True)
    with collect() as table:
        out = temporal_aggregate(x, attn=attn, pad_mask=pad)
        out.sum().backward()
    assert table["counters"].get("aggregate.kernel", 0) == 0
    assert table["spans"]["aggregate"]["calls"] == 1
    assert "aggregate.bwd" not in table["spans"]
    assert out.dtype == torch.float32 and x.grad is not None


@pytest.mark.parametrize("c,k", [(8, 3), (12, 8), (16, 5)])
def test_k_not_dividing_c_raises_before_any_launch(c, k):
    x = torch.zeros(1, 3, 4, 4, c)
    with collect() as table:
        with pytest.raises(ValueError, match="must divide"):
            ag.weighted_sum(x, torch.zeros(1, 3, k, 4, 4))
        with pytest.raises(ValueError, match="must divide"):
            temporal_aggregate(x, attn=torch.full((1, 2, 2, k, 3), 1 / 3))
    assert table["counters"].get("aggregate.kernel", 0) == 0


def test_wrapper_checks_shapes():
    x = torch.zeros(2, 3, 4, 4, 8)
    with pytest.raises(ValueError, match="expected"):
        ag.weighted_sum(x, torch.zeros(2, 3, 2, 4, 5))
    with pytest.raises(ValueError, match="pad_mask"):
        ag.weighted_sum(x, torch.zeros(2, 3, 2, 4, 4), torch.zeros(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="den"):
        ag.weighted_sum(x, torch.zeros(2, 3, 2, 4, 4), None, torch.ones(3))


@pytest.mark.parametrize("c,k,dtype,route", [
    (64, 16, torch.bfloat16, 4),     # U-TAE: C/K = 4 within an 8-value vector
    (64, 16, torch.float32, 4),
    (64, 64, torch.bfloat16, 1),
    (64, 8, torch.bfloat16, 8),
    (64, 4, torch.bfloat16, 8),      # C/K = 16: two vectors a head, shuffled
    (64, 1, torch.float32, 4),       # C/K = 64: sixteen vectors
    (256, 1, torch.bfloat16, 8),     # thirty-two vectors
    (512, 1, torch.bfloat16, 0),     # past a warp: general
    (24, 8, torch.bfloat16, 0),      # C/K = 3: general
    (12, 4, torch.float32, 0),       # C not a multiple of the vector
])
def test_kernel_route(c, k, dtype, route):
    assert ag.kernel_route(c, k, dtype) == route


def test_mean_weights_are_the_masked_mean():
    x, _, pad = _inputs(2, 6, 4, 8, 1, torch.float32, "cpu", True)
    got = temporal_aggregate(x, pad_mask=pad, mode="mean")
    keep = (~pad).float()[:, :, None, None, None]
    want = (x * keep).sum(dim=1) / keep.sum(dim=1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the card

SIZES = {"up": 32, "same": 8, "down": 4}


def _both(monkeypatch, x, attn, pad, mode, dout):
    """The aggregator's output and gradients (x, attn) by the kernel, then by
    the loop (``weighted_sum`` swapped for its plain version)."""
    results = []
    for fn in (ag.weighted_sum, ag.weighted_sum_reference):
        monkeypatch.setattr(aggregator, "weighted_sum", fn)
        xi = x.detach().clone().requires_grad_(True)
        ai = None if attn is None else attn.detach().clone().requires_grad_(True)
        out = temporal_aggregate(xi, attn=ai, pad_mask=pad, mode=mode)
        grads = torch.autograd.grad(out, [xi] + ([ai] if ai is not None else []), dout)
        results.append((out, *grads))
    return results


def _dw_check(x, w, pad, dout):
    """dw by the kernel against the loop's, w a leaf. Each is a head's sum of
    C/K products taken in another order, so they differ by up to 1e-6 of the
    sum of the products' magnitudes (the loop's dw of |x| and |dout|, in
    fp32), and in bf16 by one rounding (2^-7 of the value) besides."""
    got = []
    for fn, xi, di in ((ag.weighted_sum, x, dout), (ag.weighted_sum_reference, x, dout),
                       (ag.weighted_sum_reference, x.float().abs(), dout.float().abs())):
        wi = w.detach().clone().to(xi.dtype).requires_grad_(True)
        got.append(torch.autograd.grad(fn(xi, wi, pad), wi, di)[0].float())
    kernel, loop, magnitude = got
    bound = magnitude * 1e-6 + 1e-12
    if x.dtype == torch.bfloat16:
        bound = bound + loop.abs() * 2.0 ** -7
    assert bool(((kernel - loop).abs() <= bound).all())


def _cases_match(monkeypatch, dtype, mode, pads, t, cases, dev):
    """Each (size, C/K) case by the kernel against the loop: the output and
    dx bit for bit, dw as ``_dw_check`` holds it."""
    for seed, (size_name, cpk) in enumerate(cases):
        size, heads = SIZES[size_name], 4
        c = heads * cpk
        x, attn, pad = _inputs(2, t, size, c, heads, dtype, dev, pads, seed=seed)
        g = torch.Generator().manual_seed(100 + seed)
        dout = torch.randn(2, size, size, c, generator=g).to(dev, dtype)
        got, want = _both(monkeypatch, x, None if mode == "mean" else attn, pad, mode, dout)
        case = (size_name, cpk)
        assert got[0].dtype == dtype and got[0].shape == want[0].shape, case
        assert torch.equal(got[0], want[0]), case              # bit for bit
        assert torch.equal(got[1], want[1]), case              # dx
        if mode != "mean":
            monkeypatch.setattr(aggregator, "weighted_sum", ag.weighted_sum)
            w = aggregator._resample_attn(
                attn.permute(0, 4, 3, 1, 2).reshape(2 * t, heads, 8, 8), size, size)
            w = w.reshape(2, t, heads, size, size)
            if mode == "att_mean":
                w = w.mean(dim=2, keepdim=True)
            _dw_check(x, w, pad, dout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["att_group", "att_mean", "mean"])
@pytest.mark.parametrize("pads", [True, False], ids=["pads", "nopads"])
@pytest.mark.parametrize("t", [7, 61, 73])
def test_cuda_kernel_matches_the_loop(monkeypatch, dtype, mode, pads, t):
    dev = _card()
    if mode == "mean" and not pads:             # x.mean: no weighted sum
        x, _, _ = _inputs(2, t, 8, 16, 1, dtype, dev, False)
        with collect() as table:
            assert torch.equal(temporal_aggregate(x, mode="mean"), x.mean(dim=1))
        assert table["counters"].get("aggregate.kernel", 0) == 0
        return
    cases = [(s, q) for s in SIZES for q in (1, 4, 8, 3)]
    routes = {ag.kernel_route(4 * q, 1 if mode != "att_group" else 4, dtype) for _, q in cases}
    assert 0 in routes and len(routes) > 1      # the general route and the vector route
    with collect() as table:
        _cases_match(monkeypatch, dtype, mode, pads, t, cases, dev)
    assert table["counters"]["aggregate.kernel"] == len(cases) * (1 if mode == "mean" else 2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("cpk", [4, 16, 64])
def test_cuda_strided_and_stride0_weights(dtype, cpk):
    """The attention as a permuted view (read by its strides), and a
    stride-0 weight broadcast over the heads and pixels, against the loop;
    C/K = 16 and 64 shuffle a head's sum over 2-16 threads."""
    dev = _card()
    b, t, h, k = 2, 61, 12, 4
    c = k * cpk
    g = torch.Generator().manual_seed(cpk)
    x = torch.randn(b, t, h, h, c, generator=g).to(dev, dtype)
    pad = torch.zeros(b, t, dtype=torch.bool, device=dev)
    pad[1, 40:] = True
    dout = torch.randn(b, h, h, c, generator=g).to(dev, dtype)
    views = [torch.rand(b, h, h, k, t, generator=g).to(dev, dtype).permute(0, 4, 3, 1, 2),
             torch.rand(b, t, generator=g).to(dev, dtype)[:, :, None, None, None]
             .expand(b, t, k, h, h)]
    for w in views:
        outs, dxs = [], []
        for fn in (ag.weighted_sum, ag.weighted_sum_reference):
            xi = x.detach().clone().requires_grad_(True)
            out = fn(xi, w, pad)
            outs.append(out)
            dxs.append(torch.autograd.grad(out, xi, dout)[0])
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(dxs[0], dxs[1])
        _dw_check(x, w, pad, dout)
        assert bool((dxs[0][pad] == 0).all())


@pytest.mark.cuda
def test_cuda_span_counter_and_reproducible_backward():
    """One forward on the kernel route counts one ``aggregate.kernel``, its
    backward is one ``aggregate.bwd``; the pair's dx and dw are the same
    bits from run to run (the attention's own gradient is not: the
    upsample's backward adds with atomics)."""
    dev = _card()
    x, attn, pad = _inputs(2, 61, 32, 64, 16, torch.bfloat16, dev, True)
    x.requires_grad_(True)
    attn.requires_grad_(True)
    dout = torch.randn(2, 32, 32, 64, device=dev).bfloat16()
    with collect() as table:
        out = temporal_aggregate(x, attn=attn, pad_mask=pad)
        torch.autograd.grad(out, [x, attn], dout)
    assert table["counters"]["aggregate.kernel"] == 1
    assert table["spans"]["aggregate"]["calls"] == 1
    assert table["spans"]["aggregate.bwd"]["calls"] == 1
    w = torch.rand(2, 61, 16, 32, 32, device=dev).bfloat16().requires_grad_(True)
    grads = [torch.autograd.grad(ag.weighted_sum(x, w, pad), [x, w], dout) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_peak_below_the_loops(monkeypatch):
    """Forward plus backward at U-TAE's level-0 skip (B = 16, T = 61, 128^2,
    C = 64, K = 16, bf16, attention from 16^2): the kernel pair's peak is
    below the loop's."""
    dev = _card()
    x, attn, pad = _inputs(16, 61, 128, 64, 16, torch.bfloat16, dev, True, attn_size=16)
    dout = torch.randn(16, 128, 128, 64, device=dev).bfloat16()
    peaks = []
    for fn in (ag.weighted_sum, ag.weighted_sum_reference):
        monkeypatch.setattr(aggregator, "weighted_sum", fn)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        xi = x.detach().requires_grad_(True)
        ai = attn.detach().requires_grad_(True)
        out = temporal_aggregate(xi, attn=ai, pad_mask=pad)
        torch.autograd.grad(out, [xi, ai], dout)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del out
    assert peaks[0] < peaks[1], peaks
