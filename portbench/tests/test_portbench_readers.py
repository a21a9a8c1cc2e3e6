"""The metric readers on a made-up trace summary: each per-layer metric of
BENCHMARK.json reads its number from the operations it names, and a reader
with nothing to read leaves its metric out (None, never 0)."""
from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import common, counts  # noqa: E402

BENCH = common.load_json(ROOT, "BENCHMARK.json")
SHAPE = dict(b=10, t=61, n=16384, c=64, d=256, g=16, d_out=64, tail=True, need_attn=False)
TRACE = {
    "window_s": 2.0, "busy_s": 1.5,
    "device_ops": [
        ["elementwise_kernel<128, 4, direct_copy_kernel_cuda>", 0.2, 40],
        ["cudnn::engines_precompiled::nchwToNhwcKernel<bf16>", 0.1, 10],
        ["Memcpy DtoH ", 0.05, 2],
        ["ltae_fused_group_kernel<__nv_bfloat16>", 0.01, 2],
        ["ltae_pool_fwd_group_kernel<__nv_bfloat16, true>", 0.004, 2],
        ["ltae_pool_bwd_kernel<__nv_bfloat16, true>", 0.02, 2],
        ["ltae_pool_bwd_reduce", 0.001, 2],
    ],
    "host_ops": {"aten::convolution": 0.3, "aten::convolution_backward": 0.5},
}


def _readings(trace):
    return common.Readings(cfg={}, mix={}, dtype=torch.bfloat16, setup_s=10.0, window_s=20.0,
                           units=30, work=3000, peak_bytes=2 ** 30, flops_per_work=1.5e11,
                           ltae_shape=SHAPE, trace=trace, traced_work=200)


def _run(metric):
    return common.Run(cell={}, cfg={}, mix={}, limits={}, metrics=[metric], seed=0, seconds=1.0,
                      trace=True, device=torch.device("cpu"), t_start=time.time(), out_dir="",
                      program=None)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_reads_the_trace(metric):
    got = common.read_metrics(_run(metric), _readings(TRACE))
    assert got[metric["name"]]["value"] > 0
    assert got[metric["name"]]["unit"] == metric["unit"]
    assert common.read_metrics(_run(metric), _readings(None)) == {}


def test_reader_numbers():
    def value(name):
        metric = next(m for m in BENCH["per_layer"] if m["name"] == name)
        return common.read_metrics(_run(metric), _readings(TRACE))[name]["value"]
    assert value("device_idle.serve") == pytest.approx(25.0)
    assert value("copies.device_ms.train") == pytest.approx(1e3 * 0.3 / 200)
    assert value("conv.device_ms.serve") == pytest.approx(1e3 * 0.3 / 200)
    assert value("conv.device_ms.train") == pytest.approx(1e3 * 0.8 / 200)
    assert value("mfu.train") == pytest.approx(100 * 1.5e11 * 200 / 2.0 / counts.PEAK_FLOP_PER_S[
        torch.bfloat16])
    assert value("ltae_fused_roofline") == pytest.approx(
        100 * 2 * counts.ltae_eval_bound_s(SHAPE, torch.bfloat16) / 0.01)
