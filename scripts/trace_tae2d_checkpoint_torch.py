"""TimeUNet_v2's checkpointed classical-attention chunks against the same
chunks not checkpointed, on the card: where their gradients part.

    python3 scripts/trace_tae2d_checkpoint_torch.py [--device cuda]

``chip_smoke.py`` phase 15 (``timeunet_v2_train``) holds one B = 1 step's
gradients with the full-resolution TAE2d's chunks checkpointed
(``nn/tae2d.py``: each chunk's forward runs again in the backward pass)
against the same step without checkpoints, dropout on, within 4x the spread
that a 1e-5 perturbation of the TAE2d's output causes. This script takes
that step (factory defaults, weights from seed 0, phase 15's sample, TF32
off) in four modes:

- "dropout on": the factory's rates, every run's masks from one generator
  seed (the recompute draws its masks again from the chunk's seed);
- "dropout 0": every rate 0, so no mask is drawn;
- "dropout 0, deterministic": also ``torch.use_deterministic_algorithms``
  (cuBLAS with a fixed workspace, ``CUBLAS_WORKSPACE_CONFIG``, set before the
  card is touched; cuDNN deterministic, no benchmark), so that the kernels
  that have a deterministic version sum in one order from run to run;
  ``warn_only``: the bilinear upsample's backward (the aggregator's) has
  none and warns;
- "dropout on, deterministic": the masks again, with those kernels.

In each mode it runs the step not checkpointed twice and checkpointed
twice, and prints for each pair of runs the largest |diff| / |ref| over the
parameters (2-norms) and whether every gradient is equal bit for bit:
checkpointed against not (the gap phase 15 measures), and each against its
own repeat (run-to-run). A gap that vanishes at dropout 0 comes from the
recompute's masks; one that stays at the size of the repeats' comes from
the kernels' order of sums, and vanishes with deterministic kernels; with
them and dropout on, checkpointed and not agree bit for bit only if the
recompute draws the first forward's masks. The unchecked runs hold ~49 GiB
at the peak.
Its last line is a JSON object of the numbers, with the card's name and
power limit. ``--device cpu`` runs the same at 16^2 and small widths.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch.learning.losses import cross_entropy  # noqa: E402
from crop2seg_tpu_torch.models.factory import get_model  # noqa: E402
from crop2seg_tpu_torch.nn.tae2d import TAE2d  # noqa: E402

T, LENGTH, N_CLASSES = 61, 55, 15
GRAD_ZERO = 1e-5                    # chip_smoke.py's
SMALL = {"encoder_widths": [8, 8, 16], "decoder_widths": [4, 8, 16], "out_conv": [8, 15],
         "n_head": 4, "d_model": 32}


def sample(dev, hw: int):
    """One sample of T frames, 10 bands, padded from LENGTH; labels and the
    class weights phase 15 uses (the last class ignored)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(1, T, hw, hw, 10, generator=gen, device=dev)
    pad = torch.arange(T, device=dev)[None] >= LENGTH
    x[pad] = 0.0
    dates = (torch.arange(T, dtype=torch.float32, device=dev) * 5 + 3)[None]
    y = torch.randint(0, N_CLASSES, (1, hw, hw), generator=gen, device=dev)
    weight = torch.tensor((1.0,) * (N_CLASSES - 1) + (0.0,), device=dev)
    return x, dates, pad, y, weight


def grads(state, cfg, dev, batch, checkpointed: bool, dropout: bool) -> dict:
    """One train-mode forward and cross-entropy backward: every gradient."""
    model = get_model(cfg, device=dev)
    model.load_state_dict(state)
    model.train()
    te = model.temporal_encoder_full_resolution
    te.checkpoint_chunks = checkpointed
    if not dropout:
        for m in model.modules():
            if isinstance(m, TAE2d):
                m.dropout = m.attn_dropout = 0.0
                for stage in m.attention_heads:
                    if hasattr(stage, "dropout"):
                        stage.dropout = 0.0
    x, dates, pad, y, weight = batch
    logits = model(x, dates, pad, generator=torch.Generator(device=dev).manual_seed(11))
    cross_entropy(logits, y, weight=weight).backward()
    out = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    del model, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(a: dict, b: dict) -> dict:
    """The largest |a - b| / |b| over the parameters (2-norms) and whether
    every gradient is equal bit for bit. As phase 15's check, the gradients
    that are zero in exact arithmetic (at most GRAD_ZERO of the largest on
    the ``b`` side: biases feeding a train-mode BatchNorm) are rounding
    noise, left out of the ratio and counted apart."""
    top = max(g.abs().max().item() for g in b.values())
    live = [k for k in b if b[k].abs().max().item() > GRAD_ZERO * top]
    rel = {k: ((a[k] - b[k]).norm() / b[k].norm()).item() for k in live}
    worst = max(rel, key=rel.get)
    return {"max_rel": rel[worst], "worst": worst, "zero_up_to_rounding": len(b) - len(live),
            "bit_for_bit": all(torch.equal(a[k], b[k]) for k in b)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"model": "timeunet_v2"} if dev.type == "cuda" else dict(SMALL, model="timeunet_v2")
    state = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    batch = sample(dev, 128 if dev.type == "cuda" else 16)
    out = {"card": card}
    for mode, dropout, deterministic in (("dropout on", True, False),
                                         ("dropout 0", False, False),
                                         ("dropout 0, deterministic", False, True),
                                         ("dropout on, deterministic", True, True)):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = False
        runs = {(ckpt, i): grads(state, cfg, dev, batch, ckpt, dropout)
                for ckpt in (False, True) for i in (0, 1)}
        res = {"checkpointed vs not": compare(runs[True, 0], runs[False, 0]),
               "not checkpointed, again": compare(runs[False, 1], runs[False, 0]),
               "checkpointed, again": compare(runs[True, 1], runs[True, 0])}
        for pair, r in res.items():
            print(f"{mode}: {pair}: max |diff|/|ref| {r['max_rel']:.3e} ({r['worst']}), "
                  f"bit for bit {r['bit_for_bit']}", flush=True)
        out[mode] = res
        del runs
    torch.use_deterministic_algorithms(False)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
