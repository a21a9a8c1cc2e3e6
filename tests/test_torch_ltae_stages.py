"""crop2seg_tpu_torch L-TAE stage dump: the plain version of the stage kernel
against the JAX stage kernel of scripts/debug_ltae_stages.py, run in
interpret mode on the same seeded inputs (B=1, T=61, N=256, C=64, D=256,
G=16, fp32, pads from t=55). The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_package.py's ``cuda`` test, and
chip_smoke.py).

Tolerance: 1e-4 of each stage's largest |value| (fp32 sums of 64-256 terms
in another order; the one-pass variance cancels), attention 1e-5.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from crop2seg_tpu_torch.ops import ltae_stages as ls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("h[t=0]", "scores", "attn", "o")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def case():
    """The JAX stage kernel's outputs (interpret mode) and the same inputs,
    rebuilt by the card-side twin script in the JAX script's draw order."""
    twin = _load("debug_ltae_stages_torch")
    want = _load("debug_ltae_stages").run(True)
    return twin, want, [torch.tensor(a) for a in twin.script_inputs()]


def test_twin_script_runs_on_the_cpu(case, capsys):
    """scripts/debug_ltae_stages_torch.py on the CPU: the plain version on
    both sides, every stage printed, finite and exact."""
    res = case[0].run("cpu")
    out = capsys.readouterr().out
    assert [r[0] for r in res] == list(STAGES)
    assert all(err == 0.0 and finite for _, err, _, finite in res)
    assert all(f"{name}: max err" in out for name in STAGES)


@pytest.mark.parametrize("stage", range(4), ids=STAGES)
def test_reference_matches_jax_stage_kernel(case, stage):
    twin, want, args = case
    got = ls.ltae_stages_reference(*args, n_head=twin.N_HEAD)[stage].numpy()
    assert got.shape == want[stage].shape and np.isfinite(got).all()
    tol = 1e-5 if STAGES[stage] == "attn" else 1e-4 * np.abs(want[stage]).max()
    np.testing.assert_allclose(got, want[stage], rtol=0, atol=tol,
                               err_msg=STAGES[stage])


def test_scores_are_written_before_the_mask(case):
    twin, _, args = case
    _, scores, attn, _ = ls.ltae_stages_reference(*args, n_head=twin.N_HEAD)
    assert np.abs(scores[..., 55:].numpy()).max() < 10.0      # unmasked values
    assert attn[..., 55:].abs().max().item() == 0.0


def test_wrapper_on_cpu_runs_the_plain_version(case):
    twin, _, args = case
    before = ls.ltae_stages.launches
    got = ls.ltae_stages(*args, n_head=twin.N_HEAD)
    want = ls.ltae_stages_reference(*args, n_head=twin.N_HEAD)
    assert ls.ltae_stages.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
