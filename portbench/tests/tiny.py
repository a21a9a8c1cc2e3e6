"""A cell's run at a size the CPU holds: the cell's own limits, metrics
and code paths, tiny widths, a handful of dates and pixels."""
from __future__ import annotations

import time

import torch

from portbench.harness import common, program

TINY = dict(input_dim=2, encoder_widths=[8, 8, 8, 16], decoder_widths=[8, 8, 8, 16],
            out_conv=[8, 5], n_head=2, d_model=8, d_k=2, dtype="float32")


def tiny_run(config: str, kind: str, trace: bool = False, prog=program) -> common.Run:
    cfg = common.load_json(common.BENCH, "configs", f"{config}.json")
    cfg.update(TINY)
    mix = common.load_json(common.BENCH, "traffic",
                           "tile_t61.json" if kind == "tile" else "train_b16.json")
    mix.update(t=4, lengths=[2, 4])
    if kind == "train":
        mix.update(batch=4, pool=4, side=32, classes=5, ignore_class=4)
    name = f"{config}.{'tile_t61' if kind == 'tile' else 'train_b16'}"
    limits = common.load_json(common.BENCH, "limits", f"{name}.json")
    bench = common.load_json(common.ROOT, "BENCHMARK.json")
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    return common.Run(cell=cell, cfg=cfg, mix=mix, limits=limits,
                      metrics=metrics, seed=2 ** 31 + 11, seconds=0.05, trace=trace,
                      device=torch.device("cpu"), t_start=time.time(), out_dir="",
                      program=prog)
