"""The control of every cell's comparison: the plain reference put in the
program's place, computed in float8 (the precision below the cells'
bfloat16), has to come out not correct under the cell's limits. Here at a
size a test run holds on the CPU; on the card (``cuda`` marker) every cell
runs end to end at its own size with a short window and comes out correct.

On the card: ``python -m pytest -m cuda portbench/tests``."""
from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import reference  # noqa: E402
from portbench.harness import common, inputs, program, serve, train  # noqa: E402
from portbench.tests.tiny import tiny_run  # noqa: E402


@pytest.mark.parametrize("config", ["timeunet_v1", "utae"])
def test_control_fails_training(config):
    run = tiny_run(config, "train")
    state = inputs.seeded_state(reference.build(run.cfg), run.seed, run.device)
    batches = inputs.make_batches(run.mix, run.cfg["input_dim"], run.seed, run.device)
    want = train.reference_steps(run, state, batches, run.seed)
    got = train.reference_steps(run, state, batches, run.seed, "fp8")
    assert not common.judge(train.gaps(got, want), run.limits)[0]


@pytest.mark.parametrize("config", ["timeunet_v1", "utae"])
def test_control_fails_tile(config):
    run = tiny_run(config, "tile")
    state, tiles = serve._setup(run, run.seed)
    want = serve.reference_proba(serve._reference_model(run, state, "fp32"), tiles[0], run.mix,
                                 run.device)
    got = serve.reference_proba(serve._reference_model(run, state, "fp8"), tiles[0], run.mix,
                                run.device)
    assert not common.judge(serve.gaps(got, got.argmax(-1), want), run.limits)[0]


CELLS = ["timeunet_v1.tile_t61", "utae.train_b16", "timeunet_v1.train_b16", "utae.tile_t61"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    run = common.make_run(cell, 2 ** 32 + 7, 2.0, False, "cuda:0", time.time(), program)
    driver = serve if run.mix["kind"] == "tile" else train
    result = driver.run_cell(run)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
