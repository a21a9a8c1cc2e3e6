"""The harness driven end to end on the CPU at a tiny size (the card's look
skipped): a sound program comes out correct, and each fault that a cell can
have, planted in the timed path, comes out not correct."""
from __future__ import annotations

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import program, serve, train  # noqa: E402
from portbench.tests.tiny import tiny_run  # noqa: E402


class _Broken:
    """The program with one fault planted under its entry points."""

    def __init__(self, fault: str):
        self.fault = fault

    def tile_predictor(self, cfg, state, mix, device):
        predict = program.tile_predictor(cfg, state, mix, device)

        def altered(tile, dates, length):
            out = predict(tile, dates, length)
            return {"proba": out["proba"], "classes": (out["classes"] + 1) % cfg["out_conv"][-1]}
        return altered

    def train_step(self, cfg, state, mix, device):
        step, model = program.train_step(cfg, state, mix, device)
        if self.fault == "unchanged":
            def frozen(batch, generator):
                with torch.no_grad():
                    out = model(batch["x"], batch["dates"], batch["pad_mask"])
                return {"loss": torch.nn.functional.cross_entropy(
                    out.flatten(0, 2), batch["y"].flatten())}
            frozen.optimizer = step.optimizer
            return frozen, model

        return train.half_batch(step, mix["ignore_class"]), model


@pytest.mark.parametrize("config", ["timeunet_v1", "utae"])
def test_train_cell_sound(config):
    result = train.run_cell(tiny_run(config, "train"))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("config", ["timeunet_v1", "utae"])
def test_train_cell_faults(config, fault):
    result = train.run_cell(tiny_run(config, "train", prog=_Broken(fault)))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("config", ["timeunet_v1", "utae"])
def test_tile_cell_sound_and_altered(config):
    result = serve.run_cell(tiny_run(config, "tile"))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"serve_patches_per_s", "setup_s"}
    broken = serve.run_cell(tiny_run(config, "tile", prog=_Broken("altered")))
    assert not broken["correct"], broken["checks"]
    assert json.dumps(broken["checks"])


def test_window_traces_on_cpu():
    """The traced stretch runs and reduces on the CPU (no device ops: the
    device readers find nothing and leave their metrics out)."""
    result = train.run_cell(tiny_run("utae", "train", trace=True))
    assert result["trace"]["window_s"] > 0
    assert result["trace"]["busy_s"] == 0
    assert result["metrics"] == {}
