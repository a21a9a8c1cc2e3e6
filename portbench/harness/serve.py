"""Tile cells (mix kind "tile"): a closed loop of whole tiles through the
webapp's entry ``make_tile_predictor(...)(tile, dates, length)``, one at a
time, the mix's distinct tiles resident on the card and taken in turn.

Correctness: once the window has closed and the program is freed, the
plain reference maps each distinct tile once (float32, TF32 off) and every
pair of maps the window returned is held against it. ``gaps`` reads, for
each served tile:

- ``proba_median_err``: per pixel the largest |proba - reference proba|
  over the classes, its median over the tile's pixels;
- ``class_flip_share``: the share of pixels whose served class is not the
  reference's best;
- ``class_gap_max``: the largest amount by which the reference's
  probability of the served class lies below its best class's;
- ``proba_max_err``: the largest per-pixel gap of the first.

A cell's limits file names the numbers it holds to a limit, each the
worst over the served tiles; PERF.md gives the readings behind each limit
and why the others are read but not held (a few pixels, whose L-TAE output
GroupNorm of four channels a group or saturated attention amplifies any
rounding, set the largest gaps).
"""
from __future__ import annotations

import json
import time

import torch

from portbench import reference
from portbench.harness import common, counts, inputs

TRACED_UNITS = 2


def _reference_model(run: common.Run, state: dict, precision: str):
    ref = reference.build(run.cfg, precision).to(run.device)
    ref.load_state_dict(state)
    return ref.eval()


@torch.no_grad()
def reference_proba(ref, tile: dict, mix: dict, device) -> torch.Tensor:
    """The reference's (side, side, K) probabilities of one tile: patches
    in the mix's batches, softmax over the logits, stitched."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from portbench.reference import ops

    patches = ops.patchify(tile["tile"], mix["grid"], mix["patch"])
    t = patches.shape[1]
    bs = mix["batch_size"]
    dates = torch.as_tensor(tile["dates"], device=device)
    pad = torch.arange(t, device=device) >= tile["length"]
    probs = []
    for s in range(0, patches.shape[0], bs):
        xb = patches[s:s + bs]
        b = xb.shape[0]
        logits = ref(xb, dates[None].expand(b, t), pad[None].expand(b, t))
        probs.append(torch.softmax(logits.float(), dim=-1))
    return ops.stitch(torch.cat(probs), mix["side"])


def gaps(proba: torch.Tensor, classes: torch.Tensor, ref: torch.Tensor) -> dict:
    """The compared numbers of one served tile against the reference's
    probabilities."""
    served = ref.gather(-1, classes.long()[..., None])[..., 0]
    best = ref.max(dim=-1)
    return dict(proba_gaps(proba, ref),
                class_gap_max=(best.values - served).max().item(),
                class_flip_share=(classes.long() != best.indices).float().mean().item())


def proba_gaps(proba: torch.Tensor, ref: torch.Tensor) -> dict:
    """Per pixel, the largest |probability - reference probability| over
    the classes: its median over the pixels (``proba_median_err``) and its
    largest (``proba_max_err``); a map of another shape reads inf."""
    if proba.shape != ref.shape:
        return {"proba_median_err": float("inf"), "proba_max_err": float("inf")}
    err = (proba.float() - ref).abs().amax(dim=-1).flatten()
    return {"proba_median_err": err.median().item(), "proba_max_err": err.max().item()}


def _worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def _setup(run: common.Run, seed: int):
    template = reference.build(run.cfg)
    state = inputs.seeded_state(template, seed, run.device)
    tiles = inputs.make_tiles(run.mix, run.cfg["input_dim"], seed, run.device)
    return state, tiles


def run_cell(run: common.Run) -> dict:
    run.mark("imports")
    state, tiles = _setup(run, run.seed)
    run.mark("weights and tiles")
    predict = run.program.tile_predictor(run.cfg, state, run.mix, run.device)
    run.mark("program built")
    mix = run.mix
    n_patches = mix["grid"] ** 2
    first = tiles[0]
    predict(first["tile"], first["dates"], first["length"])           # warm-up
    common.sync(run.device)
    run.mark("warm-up tile")
    setup_peak = common.peak_bytes(run.device)
    common.reset_peak(run.device)
    setup_s = time.time() - run.t_start

    served = []

    def unit(i):
        tile = tiles[i % len(tiles)]
        served.append((i % len(tiles), predict(tile["tile"], tile["dates"], tile["length"])))
        return n_patches

    units, work, window_s, tracer, traced_work = common.window(run, unit, TRACED_UNITS)
    window_peak = common.peak_bytes(run.device)
    del predict
    common.free(run.device)

    ref = _reference_model(run, state, "fp32")
    readings, failed = [], 0
    for k, tile in enumerate(tiles):
        want = reference_proba(ref, tile, mix, run.device)
        for idx, out in served:
            if idx != k:
                continue
            r = gaps(torch.from_numpy(out["proba"]).to(run.device),
                     torch.from_numpy(out["classes"]).to(run.device), want)
            failed += not common.judge(r, run.limits)[0]
            readings.append(r)
        del want
    correct, checks = common.judge(_worst(readings), run.limits)
    trace = flops = None
    if tracer is not None:
        trace = tracer.summary()
        flops = counts.model_flops(reference.build(run.cfg), (1, mix["t"], mix["patch"],
                                                              mix["patch"], run.cfg["input_dim"]),
                                   train=False)
    shape = reference.build(run.cfg).ltae_launch(mix["batch_size"], mix["t"], mix["patch"])
    r = common.Readings(cfg=run.cfg, mix=mix, dtype=run.dtype, setup_s=setup_s,
                        window_s=window_s, units=units, work=work, peak_bytes=window_peak,
                        flops_per_work=flops, ltae_shape=shape, trace=trace,
                        traced_work=traced_work)
    return {"correct": correct, "attempted": units, "failed": failed,
            "metrics": common.read_metrics(run, r),
            "device": common.device_info(run, max(setup_peak, window_peak), trace),
            "trace": trace, "checks": checks}


def calibrate(run: common.Run, seeds: list) -> None:
    """The readings that the limits are set from, one JSON line a seed: the
    program's worst over its tiles ("program"), and on the first CONTROLS
    seeds the control's (the reference in float8, "control")
    and a served map altered where it is produced ("altered": every class
    moved to the next)."""
    for i, seed in enumerate(seeds):
        state, tiles = _setup(run, seed)
        predict = run.program.tile_predictor(run.cfg, state, run.mix, run.device)
        outs = [predict(t["tile"], t["dates"], t["length"]) for t in tiles]
        del predict
        common.free(run.device)
        line = {"seed": seed, "program": [], "control": [], "altered": []}
        ref = _reference_model(run, state, "fp32")
        ctl = _reference_model(run, state, "fp8") if i < common.CONTROLS else None
        k_classes = run.cfg["out_conv"][-1]
        for tile, out in zip(tiles, outs):
            want = reference_proba(ref, tile, run.mix, run.device)
            proba = torch.from_numpy(out["proba"]).to(run.device)
            classes = torch.from_numpy(out["classes"]).to(run.device)
            line["program"].append(gaps(proba, classes, want))
            if ctl is not None:
                cp = reference_proba(ctl, tile, run.mix, run.device)
                line["control"].append(gaps(cp, cp.argmax(-1), want))
                line["altered"].append(gaps(proba, (classes.long() + 1) % k_classes, want))
        line = {k: (_worst(v) if isinstance(v, list) and v else v) for k, v in line.items()}
        print(json.dumps(line), flush=True)
        del ref, ctl, state, tiles, outs
        common.free(run.device)
