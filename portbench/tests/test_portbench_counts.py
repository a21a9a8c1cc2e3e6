"""The yardstick's counts: the frozen copy of the L-TAE kernels' operations
and bytes gives the bounds of PERF.md's kernel table at its shapes (kernel
1 at B = 10, T = 61, G = 16, D = 256, TimeUNet's N = 16384, C = 64 with the
tail and U-TAE's N = 256, C = 128 with attention; kernels 2-3 at B = 4,
N = 16384, C = 64), and the model FLOPs counted on the reference are the
convolutions and products of one patch's forward and one sample's step."""
from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import reference  # noqa: E402
from portbench.harness import common, counts  # noqa: E402

BF16, FP32 = torch.bfloat16, torch.float32
KERNEL1 = dict(b=10, t=61, n=16384, c=64, d=256, g=16, d_out=64, tail=True, need_attn=False)
KERNEL1U = dict(KERNEL1, n=256, c=128, d_out=128, tail=False, need_attn=True)
POOL = dict(b=4, t=61, n=16384, c=64, d=256, g=16)


@pytest.mark.parametrize("shape, dtype, ms", [
    (KERNEL1, BF16, 0.388), (KERNEL1, FP32, 0.945),
    (KERNEL1U, BF16, 0.015), (KERNEL1U, FP32, 0.028),
])
def test_eval_kernel_bounds(shape, dtype, ms):
    assert round(counts.ltae_eval_bound_s(shape, dtype) * 1e3, 3) == ms


@pytest.mark.parametrize("tail, dtype, backward, ms", [
    (False, FP32, False, 0.334), (False, BF16, False, 0.163),
    (True, FP32, False, 0.345), (True, BF16, False, 0.163),
    (False, FP32, True, 0.920), (False, BF16, True, 0.316),
    (True, FP32, True, 0.951), (True, BF16, True, 0.316),
])
def test_pool_kernel_bounds(tail, dtype, backward, ms):
    shape = dict(POOL, tail=tail)
    assert round(counts.ltae_pool_bound_s(shape, dtype, backward) * 1e3, 3) == ms


@pytest.mark.parametrize("config, fwd, step", [
    ("timeunet_v1", 156.07, 456.70), ("utae", 185.50, 544.98)])
def test_model_flops(config, fwd, step):
    """GFLOP of a 61 x 128^2 x 10 sample, counted on the meta device."""
    cfg = common.load_json(common.BENCH, "configs", f"{config}.json")
    shape = (1, 61, 128, 128, 10)
    assert counts.model_flops(reference.build(cfg), shape, train=False) / 1e9 == pytest.approx(fwd, abs=0.01)
    assert counts.model_flops(reference.build(cfg), shape, train=True) / 1e9 == pytest.approx(step, abs=0.01)
