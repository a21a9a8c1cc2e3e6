#!/usr/bin/env python
"""Check the L-TAE eval arithmetic stage by stage on one CUDA card: run the
stage-dump kernel (csrc/ltae_stages.cu) and its plain PyTorch version on the
seeded inputs of scripts/debug_ltae_stages.py, and print, per stage, the
largest difference and whether the kernel's output is finite.

    python3 scripts/debug_ltae_stages_torch.py [--device cuda|cpu]

Shape B=1, T=61, N=256, C=64, D=256, G=16, fp32, pads from t=55; the inputs
are drawn from numpy's default_rng(0) in that script's order. Stages:
h[t=0] (the first step's embedding), the scores before the mask, the
attention, and the head-grouped weighted sum o. On the CPU the wrapper runs
the plain version, so every difference is 0.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.device import resolve_device  # noqa: E402
from crop2seg_tpu_torch.ops.ltae_stages import (  # noqa: E402
    ltae_stages, ltae_stages_reference)

B, T, N, C = 1, 61, 256, 64
N_HEAD, D_MODEL = 16, 256
LENGTH = 55
STAGES = ("h[t=0]", "scores", "attn", "o")


def script_inputs():
    """x, pe, mask, win, bin, u, cs as numpy fp32, drawn from default_rng(0)
    in the order of scripts/debug_ltae_stages.py::run."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, N, C))
    pe = rng.standard_normal((B, T, D_MODEL))
    mask = np.zeros((B, 1, T))
    mask[:, :, LENGTH:] = 1.0
    win = rng.standard_normal((C, D_MODEL)) * 0.1
    bin_ = rng.standard_normal((D_MODEL,)) * 0.1
    u = rng.standard_normal((D_MODEL, N_HEAD)) * 0.1
    cs = rng.standard_normal((1, N_HEAD)) * 0.1
    return [a.astype(np.float32) for a in (x, pe, mask, win, bin_, u, cs)]


def run(device=None):
    """Runs the kernel (on a CUDA device) and the plain version once each;
    prints and returns ``[(stage, max_abs_err, max_abs_plain, finite)]``."""
    dev = resolve_device(device)
    args = [torch.tensor(a, device=dev) for a in script_inputs()]
    got = ltae_stages(*args, n_head=N_HEAD)
    want = ltae_stages_reference(*args, n_head=N_HEAD)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res = []
    for name, g, w in zip(STAGES, got, want):
        err = (g - w).abs().max().item()
        finite = bool(torch.isfinite(g).all())
        print(f"{name}: max err {err:.3e}  finite={finite}", flush=True)
        res.append((name, err, w.abs().max().item(), finite))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    res = run(ap.parse_args().device)
    return 0 if all(finite for *_, finite in res) else 1


if __name__ == "__main__":
    sys.exit(main())
