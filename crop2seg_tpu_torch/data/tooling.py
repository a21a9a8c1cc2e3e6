"""Offline dataset curation, numpy and scipy only (port of
crop2seg_tpu/data/tooling.py; metadata read and written with ``json``, not
pandas, as the port's readers do):

- ``calc_cover_statistics``: per-class pixel counts of every patch, written
  to metadata_and_stats.json;
- ``split_tile_grid`` / ``create_train_test_split``: the connected-component,
  class-balanced 70/15/15 split over each tile's 82x82 patch grid:
  minority-class patches seed the components, a corridor every 10 patches
  separates them, components on the grid's border go to train, the others
  fill the set ratios in turn, smallest first;
- ``compute_sample_weights``: minority-class presence weights of the train
  patches for weighted resampling, written into metadata.json ("weight");
- ``compute_norm_vals``: the train set's channel mean and std in .SAFE band
  order, written to NORM_S2_patch.json.

A record's missing or NaN value is written as ``null``.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, List, Sequence

import numpy as np
from scipy import ndimage

# cover columns in class-code order 1..14
COVER_COLUMNS = (
    "Grassland_Cover", "Fruit_vegetable_Cover", "Summer_cereals_Cover",
    "Winter_cereals_Cover", "Rapeseed_Cover", "Maize_Cover",
    "Annual_forage_Cover", "Sugar_beat_Cover", "Flax_Hemp_Cover",
    "Permanent_fruit_Cover", "Hopyards_Cover", "Vineyards_Cover",
    "Other_crops_Cover", "Not_classified_Cover",
)
MINORITY_COLUMNS = ("Flax_Hemp_Cover", "Hopyards_Cover", "Sugar_beat_Cover",
                    "Permanent_fruit_Cover", "Vineyards_Cover")
# presence weight of each cover column, in the stats file's column order
SAMPLE_WEIGHTS = np.array([0, 1, 1, 0, 0, 0, 0, 5, 0, 14, 8, 4, 4, 0, 0])


def _num(v) -> float:
    """A record's value as a float, NaN where it is missing (None)."""
    return math.nan if v is None else float(v)


def _get(row: dict, col: str, default: float) -> float:
    """``row[col]`` as a float (NaN where null), ``default`` where the
    records have no such column."""
    return _num(row[col]) if col in row else default


def _columns(records: List[dict]) -> List[str]:
    """The records' keys in order of first appearance."""
    cols: Dict[str, None] = {}
    for r in records:
        cols.update(dict.fromkeys(r))
    return list(cols)


def _read_records(path: str, sort: bool = True) -> List[dict]:
    """A JSON list of records, each with every column of the file (None
    where it lacks one), sorted by ID_PATCH unless ``sort`` is False."""
    with open(path) as f:
        records = json.load(f)
    cols = _columns(records)
    records = [{c: r.get(c) for c in cols} for r in records]
    return sorted(records, key=lambda r: int(r["ID_PATCH"])) if sort else records


def _write_records(path: str, records: List[dict]) -> None:
    """``records`` as an indented JSON list, NaN written as null."""
    def clean(v):
        return None if isinstance(v, float) and math.isnan(v) else v
    with open(path, "w") as f:
        json.dump([{k: clean(v) for k, v in r.items()} for r in records], f, indent=4)


def calc_cover_statistics(folder: str, grid: int = 82) -> List[dict]:
    """Add each class's pixel count (``COVER_COLUMNS``; NaN for a REMOVED
    patch) to the metadata records, write them to metadata_and_stats.json and
    return them."""
    from crop2seg_tpu_torch.data.s2tsczcrop import _load_array

    records = _read_records(os.path.join(folder, "metadata.json"))
    for r in records:
        if r.get("Status") == "REMOVED":
            r.update(dict.fromkeys(COVER_COLUMNS, math.nan))
            continue
        t = _load_array(folder, "ANNOTATIONS", f"TARGET_{int(r['ID_PATCH'])}")
        for i, k in enumerate(COVER_COLUMNS):
            r[k] = int(np.count_nonzero(t == i + 1))
    _write_records(os.path.join(folder, "metadata_and_stats.json"), records)
    return records


def split_tile_grid(minority_mask: np.ndarray, flax_mask: np.ndarray,
                    rng: np.random.Generator,
                    ratios=(0.7, 0.15, 0.15)) -> np.ndarray:
    """The split of one tile's patch grid. minority/flax masks: (G, G)
    booleans marking the patches that seed split components. Returns the
    (G, G) int grid, 1 = train, 2 = val, 3 = test, 0 = unused."""
    g = minority_mask.shape[0]
    grid = minority_mask.astype(int).copy()
    grid[0:-1:10] = 0           # corridor rows/cols every 10 patches
    grid[:, 0:-1:10] = 0
    grid[flax_mask] = 1          # flax patches are always kept

    labeled, _ = ndimage.label(grid, np.ones((3, 3)))
    border = np.unique(np.concatenate(
        [labeled[:, [0, g - 1]].ravel(), labeled[[0, g - 1]].ravel()]))
    border = [int(i) for i in border if i != 0]
    others = [int(i) for i in np.unique(labeled) if i != 0 and i not in border]
    others = list(rng.permutation(others))

    sizes = {int(i): int((labeled == i).sum()) for i in border + others}
    total = max(sum(sizes.values()), 1)
    sums = [sum(sizes[i] for i in border) / total, 0.0, 0.0]
    assign = {i: 0 for i in border}  # 0=train,1=val,2=test
    for comp in sorted(others, key=lambda i: sizes[i]):
        w = np.array([max(1 - s / r, 0.0) for s, r in zip(sums, ratios)])
        w = w / w.sum() if w.sum() > 0 else np.ones(3) / 3
        choice = int(rng.choice(3, p=w))
        assign[comp] = choice
        sums[choice] += sizes[comp] / total

    out = np.zeros((g, g), int)
    for comp, choice in assign.items():
        out[labeled == comp] = choice + 1
    return out


def create_train_test_split(folder: str, tiles: Sequence[str] | None = None,
                            grid: int = 82, seed: int = 42) -> List[dict]:
    """Assign each patch's "set" (train, val, test, or "" for an unused
    patch) tile by tile with ``split_tile_grid``, write it into metadata.json
    and metadata_and_stats.json (computed first where missing), save each
    tile's grid as patches_distribution_<tile>.npy and return the metadata
    records."""
    stats_path = os.path.join(folder, "metadata_and_stats.json")
    if not os.path.isfile(stats_path):
        logging.info("calculating cover statistics")
        calc_cover_statistics(folder, grid)
    m = _read_records(stats_path)
    tiles = tiles if tiles is not None else sorted({r["TILE"] for r in m})
    rng = np.random.default_rng(seed)
    per_tile = grid * grid

    def cell(r):
        local = int(r["ID_PATCH"]) % per_tile
        return local // grid, local % grid

    set_col = [""] * len(m)
    for tile in tiles:
        sub = [i for i, r in enumerate(m) if r["TILE"] == tile]
        minority_mask = np.zeros((grid, grid), bool)
        flax_mask = np.zeros((grid, grid), bool)
        for i in sub:
            row = m[i]
            # a seed: any minority class present, or all three majority
            # classes below their caps; the Cover columns hold pixel
            # counts, so the caps mean zero pixels of each majority class
            low_majority = (_get(row, "Background_Cover", np.inf) < 0.2
                            and _get(row, "Grassland_Cover", np.inf) < 0.3
                            and _get(row, "Winter_cereals_Cover", np.inf) < 0.3)
            if low_majority or any(_get(row, col, 0) > 0 for col in MINORITY_COLUMNS):
                minority_mask[cell(row)] = True
            if _get(row, "Flax_Hemp_Cover", 0) > 0:
                flax_mask[cell(row)] = True
        final = split_tile_grid(minority_mask, flax_mask, rng)
        np.save(os.path.join(folder, f"patches_distribution_{tile}.npy"), final)
        names = {1: "train", 2: "val", 3: "test"}
        for i in sub:
            code = int(final[cell(m[i])])
            if code:
                set_col[i] = names[code]
    meta = _read_records(os.path.join(folder, "metadata.json"))
    for records in (meta, m):
        for r, s in zip(records, set_col):
            r["set"] = s
    _write_records(os.path.join(folder, "metadata.json"), meta)
    _write_records(stats_path, m)
    return meta


def compute_sample_weights(folder: str) -> np.ndarray:
    """Minority-presence weights of the OK train patches (the sum of
    ``SAMPLE_WEIGHTS`` over the cover columns present, 1 where none is),
    in ID_PATCH order; also written into metadata.json as "weight" (null for
    the other patches)."""
    stats = _read_records(os.path.join(folder, "metadata_and_stats.json"), sort=False)
    meta_path = os.path.join(folder, "metadata.json")
    m = _read_records(meta_path)
    cols = [c for c in _columns(stats) if "Cover" in c
            and c not in ("Nodata_Cover", "Snow_Cloud_Cover")]
    stats = sorted((r for r in stats if r.get("Status") == "OK" and r.get("set") == "train"),
                   key=lambda r: int(r["ID_PATCH"]))
    weights = SAMPLE_WEIGHTS[:len(cols)]
    values = np.array([[_num(r[c]) for c in cols] for r in stats],
                      np.float64).reshape(len(stats), len(cols))
    w = ((values > 0).astype(int) * weights[None, :]).sum(axis=1)
    w[w == 0] = 1
    by_id = {int(r["ID_PATCH"]): float(v) for r, v in zip(stats, w)}
    for r in m:
        r["weight"] = by_id.get(int(r["ID_PATCH"]), r.get("weight"))
    _write_records(meta_path, m)
    return w


def compute_norm_vals(folder: str):
    """The train set's channel mean and std in .SAFE band order (each
    patch's statistics averaged), written to NORM_S2_patch.json as
    {"train": {"mean", "std"}} and returned."""
    from crop2seg_tpu_torch.data.s2tsczcrop import S2TSCZCropDataset

    dt = S2TSCZCropDataset(folder=folder, norm=False, set_type="train",
                           channels_like_pastis=False)
    means, stds = [], []
    for i in range(len(dt)):
        x = dt[i]["x"]  # (T, H, W, C)
        flat = x.reshape(-1, x.shape[-1])
        means.append(flat.mean(axis=0))
        stds.append(flat.std(axis=0))
    out = {"train": {"mean": np.stack(means).mean(0).tolist(),
                     "std": np.stack(stds).mean(0).tolist()}}
    with open(os.path.join(folder, "NORM_S2_patch.json"), "w") as f:
        json.dump(out, f, indent=4)
    return out
