"""Synthetic S2TSCzCrop-layout dataset generator (port of
crop2seg_tpu/data/synthetic.py::make_synthetic_dataset; it writes the same
bytes for the same arguments).

Writes a miniature dataset in the S2TSCzCrop release layout: DATA_S2/S2_<id>.npy
(T, 10, H, W) float32 series, ANNOTATIONS/TARGET_<id>.npy (H, W) uint8 label
maps with blob-shaped classes, metadata.json (ID_PATCH, set, Status, dates-S2,
affine, ...) and NORM_S2_patch.json. The train CLI's ``--dataset synthetic``
trains on it. The PASTIS generator comes with the PASTIS reader (ROADMAP.md
M5).
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np


def make_synthetic_dataset(folder: str, n_patches: int = 12,
                           t_range: Sequence[int] = (27, 61),
                           hw: int = 128, n_classes: int = 15,
                           seed: int = 0, year: int = 2019) -> str:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(folder, "DATA_S2"), exist_ok=True)
    os.makedirs(os.path.join(folder, "ANNOTATIONS"), exist_ok=True)

    records = []
    sets = (["train"] * max(1, int(n_patches * 0.7))
            + ["val"] * max(1, int(n_patches * 0.15)))
    sets += ["test"] * (n_patches - len(sets))
    mean_acc = np.zeros(10)
    sq_acc = np.zeros(10)
    count = 0
    for i in range(n_patches):
        t = int(rng.integers(t_range[0], t_range[1] + 1))
        # blobby class structure so IoU is non-degenerate
        yy, xx = np.mgrid[0:hw, 0:hw]
        target = np.zeros((hw, hw), np.int64)
        for c in range(1, n_classes - 1):
            r_hi = max(hw // 3, 4)
            cx, cy, r = rng.integers(0, hw, 2).tolist() + \
                [rng.integers(min(3, r_hi - 1), r_hi)]
            target[(yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2] = c
        base = rng.normal(500, 200, (1, 10, 1, 1))
        sig = np.zeros((t, 10, hw, hw), np.float32)
        for c in range(n_classes):
            m = target == c
            season = np.sin(np.linspace(0, np.pi, t) + c)[:, None]
            sig[:, :, m] = (base[0, :, 0, 0][None, :, None]
                            + 100 * season[:, :, None] * (c + 1) / n_classes
                            + rng.normal(0, 30, (t, 10, int(m.sum())))
                            ).astype(np.float32)
        np.save(os.path.join(folder, "DATA_S2", f"S2_{i}.npy"), sig)
        np.save(os.path.join(folder, "ANNOTATIONS", f"TARGET_{i}.npy"),
                target.astype(np.uint8))
        mean_acc += sig.mean(axis=(0, 2, 3))
        sq_acc += (sig ** 2).mean(axis=(0, 2, 3))
        count += 1

        # valid ascending dates from a fixed season start
        dates = {}
        start = np.datetime64(f"{year - 1}-09-05")
        for j, d in enumerate(np.sort(rng.choice(np.arange(0, 360), t, replace=False))):
            day = start + np.timedelta64(int(d), "D")
            s = str(day).replace("-", "")
            dates[str(j)] = int(s)
        records.append({
            "ID_PATCH": i, "ID_WITHIN_TILE": i, "TILE": "T33UVR",
            "Background_Cover": float((target == 0).mean()),
            "time-series_length": t, "crs": 32633, "Fold": int(i % 5) + 1,
            "Status": "OK", "set": sets[i], "dates-S2": dates,
            "affine": [10.0, 0.0, 500000.0, 0.0, -10.0, 5500000.0],
        })

    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump(records, f)

    mean = mean_acc / count
    var = sq_acc / count - mean ** 2
    norm = {"Fold_1": {"mean": mean.tolist(),
                       "std": np.sqrt(np.maximum(var, 1e-6)).tolist()}}
    with open(os.path.join(folder, "NORM_S2_patch.json"), "w") as f:
        json.dump(norm, f)
    return folder
