"""The port's spans and counters (crop2seg_tpu_torch/utils/profiling.py) on
the CPU: off they record nothing and open no profiler range; under
torch.profiler a train step's stages record once each, in the profiler's
trace too, with self time its total less its children's; spans on other
threads keep their own time; ``collect()`` records without a profiler; a
tile's stages and patches."""
from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from crop2seg_tpu_torch.inference.tile import make_tile_predictor
from crop2seg_tpu_torch.learning.trainer import StepConfig, make_train_step
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.utils import profiling
from crop2seg_tpu_torch.utils.profiling import collect, count, reset_spans, span, span_table

STEP_SPANS = ("step", "step.forward", "step.loss", "step.backward", "step.optimizer")


@pytest.fixture(autouse=True)
def _clean_table():
    reset_spans()
    yield
    reset_spans()


def _train_step():
    b, t, hw = 2, 4, 32
    torch.manual_seed(0)
    model = TimeUNet(input_dim=10, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
                     out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
    step = make_train_step(model, StepConfig(num_classes=5, class_weights=(1.0,) * 5),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn(b, t, hw, hw, 10, generator=g),
             "dates": torch.arange(t, dtype=torch.float32)[None].expand(b, t) * 10,
             "pad_mask": torch.zeros(b, t, dtype=torch.bool),
             "y": torch.randint(0, 5, (b, hw, hw), generator=g)}
    return step, batch


def test_spans_off_record_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    with span("a"):
        with span("a.b"):
            count("a.n", 3)
    assert span_table() == {"spans": {}, "counters": {}}
    assert opened == []


def test_train_step_spans_under_profiler():
    step, batch = _train_step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(batch, torch.Generator().manual_seed(2))
    table = span_table()
    spans = table["spans"]
    for name in STEP_SPANS:
        assert spans[name]["calls"] == 1, name
    assert "step.grad_sum" not in spans            # no data-parallel group
    assert table["counters"] == {"step.samples": 2}
    keys = {e.key for e in prof.key_averages()}
    assert set(STEP_SPANS) <= keys
    children = sum(spans[n]["host_s"] for n in STEP_SPANS[1:])
    assert spans["step"]["self_s"] == pytest.approx(spans["step"]["host_s"] - children,
                                                    abs=1e-9)
    assert 0 < spans["step"]["self_s"] < spans["step"]["host_s"]
    for name in STEP_SPANS[1:]:
        assert spans[name]["host_s"] > 0


def test_span_on_another_thread_keeps_its_own_time():
    def work():
        with span("worker"):
            time.sleep(0.05)

    with collect() as table:
        with span("main"):
            thread = threading.Thread(target=work)
            thread.start()
            thread.join(timeout=10)
    assert not thread.is_alive()
    spans = table["spans"]
    assert spans["worker"]["calls"] == 1 and spans["worker"]["host_s"] >= 0.05
    assert spans["main"]["host_s"] >= spans["worker"]["host_s"]
    assert spans["main"]["self_s"] == spans["main"]["host_s"]     # the worker is no child


def test_spans_from_many_threads_lose_no_update():
    threads, each = 16, 200

    def work():
        for _ in range(each):
            with span("outer"):
                with span("inner"):
                    count("n")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with collect() as table:
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    spans = table["spans"]
    assert spans["outer"]["calls"] == spans["inner"]["calls"] == threads * each
    assert table["counters"]["n"] == threads * each
    assert spans["outer"]["self_s"] == pytest.approx(
        spans["outer"]["host_s"] - spans["inner"]["host_s"], rel=1e-6)


def test_collect_records_without_profiler():
    assert not torch.autograd._profiler_enabled()
    with span("before"):
        pass
    with collect() as outer:
        with span("a"):
            count("n", 2)
        with collect() as inner:
            with span("b"):
                pass
    with span("after"):
        pass
    assert set(outer["spans"]) == {"a", "b"} and outer["counters"] == {"n": 2}
    assert set(inner["spans"]) == {"b"} and inner["counters"] == {}
    assert set(span_table()["spans"]) == {"a", "b"}
    assert not profiling._scopes


def test_tile_spans_and_patches():
    model = get_model({"model": "timeunet", "encoder_widths": [8, 8, 16],
                       "decoder_widths": [8, 8, 16], "out_conv": [8, 5], "n_head": 4,
                       "d_model": 16, "d_k": 4},
                      device="cpu", generator=torch.Generator().manual_seed(0))
    tile = np.random.default_rng(0).standard_normal((2, 1098, 1098, 10), np.float32)
    predict = make_tile_predictor(model, batch_size=50, device="cpu")
    with collect() as table:
        predict(tile, np.arange(2, dtype=np.float32) * 10.0, 2)
    spans = table["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {
        "tile.predict": 1, "tile.patchify": 1, "tile.forward": 2, "tile.stitch": 1,
        "tile.fetch": 1}
    assert table["counters"] == {"tile.patches": 100}
    inner = sum(spans[k]["host_s"] for k in spans if k != "tile.predict")
    assert inner <= spans["tile.predict"]["host_s"]
