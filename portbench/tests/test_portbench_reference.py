"""The plain reference against the port's plain route on the CPU, at a
small size: the forward in eval, one training step with dropout live (the
reference works the masks out again from the same generator), the tile
geometry and the kernel pair's dropout hash."""
from __future__ import annotations

import os
import statistics
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from crop2seg_tpu_torch.learning.trainer import StepConfig, make_train_step  # noqa: E402
from crop2seg_tpu_torch.models.factory import get_model  # noqa: E402
from crop2seg_tpu_torch.ops import ltae_pool  # noqa: E402
from crop2seg_tpu_torch.ops.patchify import patchify_grid, unpatchify_grid  # noqa: E402

from portbench import reference  # noqa: E402
from portbench.harness import common, inputs  # noqa: E402
from portbench.reference import ops  # noqa: E402

SMALL = dict(input_dim=3, encoder_widths=[8, 8, 8, 16], decoder_widths=[8, 8, 8, 16],
             out_conv=[8, 5], n_head=2, d_model=16)
B, T, SIDE = 2, 6, 32


def _pair(config: str, seed: int):
    cfg = common.load_json(common.BENCH, "configs", f"{config}.json")
    cfg.update(SMALL)
    ref = reference.build(cfg)
    prog = get_model(cfg, device="cpu")
    state = inputs.seeded_state(ref, seed, "cpu")
    ref.load_state_dict(state)
    prog.load_state_dict(state)
    return cfg, ref, prog


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, SIDE, SIDE, 3, generator=g)
    pad = torch.arange(T)[None] >= torch.tensor([4, 6])[:, None]
    x[pad] = 0.0
    dates = torch.stack([torch.as_tensor(inputs.day_offsets(T, [5, 10], seed, f"d{i}"))
                         for i in range(B)])
    y = torch.randint(0, 5, (B, SIDE, SIDE), generator=g)
    return {"x": x, "dates": dates, "pad_mask": pad, "y": y}


@pytest.mark.parametrize("config", ["timeunet_v1", "utae"])
def test_eval_forward_matches_port(config):
    _, ref, prog = _pair(config, 3)
    b = _batch(4)
    with torch.no_grad():
        want = ref(b["x"], b["dates"], b["pad_mask"])
        got = prog(b["x"], b["dates"], b["pad_mask"])
    assert got.shape == want.shape == (B, SIDE, SIDE, 5)
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("config", ["timeunet_v1", "utae"])
def test_train_step_matches_port(config):
    """One step in float64 with dropout live: the same loss, every leaf's
    gradient within 1e-3 of the larger of its norm and the median leaf's
    (the loss itself is taken in float32 on the port's side), the same
    BatchNorm statistics. In float32 the L-TAE's GroupNorm of four channels
    a group and the training-mode BatchNorms at this size amplify rounding
    to a few percent of a gradient."""
    _, ref, prog = _pair(config, 5)
    ref.double()
    prog.double()
    b = {k: (v.double() if v.is_floating_point() else v) for k, v in _batch(6).items()}
    weight = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
    step = make_train_step(prog, StepConfig(num_classes=5, ignore_index=4,
                                            class_weights=tuple(weight.tolist())),
                           device="cpu")
    aux = step(b, torch.Generator().manual_seed(7))
    ref.train()
    loss = ops.weighted_cross_entropy(
        ref(b["x"], b["dates"], b["pad_mask"], generator=torch.Generator().manual_seed(7)),
        b["y"], weight)
    loss.backward()
    assert abs(aux["loss"].item() - loss.item()) <= 1e-6 * loss.item()
    state = step.optimizer.state
    got = dict(prog.named_parameters())
    norms = {k: p.grad.norm().item() for k, p in ref.named_parameters()}
    med = statistics.median(norms.values())
    for k, p in ref.named_parameters():
        g = state[got[k]]["exp_avg"] / 0.1
        assert (g - p.grad).norm().item() <= 1e-3 * max(norms[k], med), k
    buffers = dict(prog.named_buffers())
    for k, v in ref.named_buffers():
        if "running_" in k:
            assert torch.allclose(buffers[k], v, atol=1e-6, rtol=1e-6), k


def test_patchify_and_stitch_match_port():
    tile = torch.randn(3, 40, 40, 2)
    got = ops.patchify(tile, 3, 16)
    want = patchify_grid(torch.nn.functional.pad(tile, (0, 0, 0, 8, 0, 8)), 16)
    assert torch.equal(got, want)
    maps = torch.randn(9, 16, 16, 4)
    assert torch.equal(ops.stitch(maps, 40), unpatchify_grid(maps, 3, 3)[:40, :40])


def test_hash_keep_matches_port():
    b, t, n, g = 2, 5, 37, 4
    want = ltae_pool.keep_mask(123456789, b, t, n, g, 0.1)
    got = torch.cat([ops.hash_keep(123456789, b, t, n, g, n0, min(n, n0 + 10), 0.1, "cpu")
                     for n0 in range(0, n, 10)], dim=2)
    assert torch.equal(got, want)


def test_float8_control_rounds_coarser():
    x = torch.randn(1000)
    err8 = (ops.Precision("fp8")(x) - x).abs().max().item()
    assert ops.Precision("fp32")(x) is x
    assert 1e-3 < err8 <= x.abs().max().item() / 16
