"""The readers of the program's own spans and counters
(``harness/spans.py``) on made-up readings and a made-up span table: each
reads its number per unit of the program's counter, and each leaves its
metric out (None) where the program has no table, no such span or counter,
or the trace holds no device operation."""
from __future__ import annotations

import os
import sys
import time
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import common, spans  # noqa: E402

BENCH = common.load_json(ROOT, "BENCHMARK.json")
NEW = {"tile.host_ms.serve", "ltae.host_ms.serve", "aggregate.device_ms.serve",
       "step.host_ms.train", "ltae.host_ms.train", "forward.device_ms.train"}
TRACE = {"window_s": 2.0, "busy_s": 1.5, "device_ops": [],
         "host_ops": {"aggregate": 0.12, "step.forward": 0.6, "aten::convolution": 0.3}}


def _row(calls, host_s, self_s):
    return {"calls": calls, "host_s": host_s, "self_s": self_s}


TABLE = {
    "spans": {"tile.predict": _row(2, 1.2, 0.1), "tile.fetch": _row(2, 0.4, 0.4),
              "ltae.eval": _row(20, 0.05, 0.04),
              "step": _row(3, 0.9, 0.2), "ltae.pool.fwd": _row(3, 0.03, 0.03),
              "ltae.pool.bwd": _row(3, 0.02, 0.015)},
    "counters": {"tile.patches": 200, "step.samples": 48},
}


def _readings(trace, traced_work=200):
    return common.Readings(cfg={}, mix={}, dtype=torch.bfloat16, setup_s=10.0, window_s=20.0,
                           units=30, work=3000, peak_bytes=2 ** 30, flops_per_work=1.5e11,
                           ltae_shape={}, trace=trace, traced_work=traced_work)


def _read(name, readings):
    metric = next(m for m in BENCH["per_layer"] if m["name"] == name)
    run = common.Run(cell={}, cfg={}, mix={}, limits={}, metrics=[metric], seed=0, seconds=1.0,
                     trace=True, device=torch.device("cpu"), t_start=time.time(), out_dir="",
                     program=None)
    return common.read_metrics(run, readings).get(name, {}).get("value")


@pytest.fixture
def program(monkeypatch):
    """A loaded program module whose span table is ``TABLE``."""
    module = types.ModuleType(spans.MODULE)
    module.span_table = lambda: TABLE
    monkeypatch.setitem(sys.modules, spans.MODULE, module)
    return module


def test_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert set(entries) == NEW
    for name, m in entries.items():
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["moves"] == ("serve_patches_per_s" if name.endswith(".serve")
                              else "train_samples_per_s")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{name}.py"))


def test_numbers(program):
    r = _readings(TRACE)
    assert _read("tile.host_ms.serve", r) == pytest.approx(1e3 * (1.2 - 0.4) / 200)
    assert _read("ltae.host_ms.serve", r) == pytest.approx(1e3 * 0.04 / 200)
    assert _read("step.host_ms.train", r) == pytest.approx(1e3 * 0.9 / 48)
    assert _read("ltae.host_ms.train", r) == pytest.approx(1e3 * (0.03 + 0.015) / 48)
    # device time of the spans' kernels over the program's counter, not the harness's count
    assert _read("aggregate.device_ms.serve", _readings(TRACE, 7)) == pytest.approx(
        1e3 * 0.12 / 200)
    assert _read("forward.device_ms.train", _readings(TRACE, 7)) == pytest.approx(
        1e3 * 0.6 / 48)


@pytest.mark.parametrize("name", sorted(NEW))
def test_nothing_to_read(name, program, monkeypatch):
    assert _read(name, _readings(None)) is None
    assert _read(name, _readings(dict(TRACE, busy_s=0.0, host_ops={}))) is None
    program.span_table = lambda: {"spans": {}, "counters": {}}
    assert _read(name, _readings(TRACE)) is None
    del program.span_table                 # a program without spans
    assert _read(name, _readings(TRACE)) is None
    monkeypatch.delitem(sys.modules, spans.MODULE)    # the program not loaded
    assert _read(name, _readings(TRACE)) is None


def test_reads_the_programs_table(monkeypatch):
    """``spans.table()`` is the loaded program's ``span_table()``."""
    from crop2seg_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_table", {"spans": {}, "counters": {}})
    with profiling.collect():
        with profiling.span("step"):
            profiling.count("step.samples", 16)
    got = spans.table()
    assert got["counters"] == {"step.samples": 16} and got["spans"]["step"]["calls"] == 1
