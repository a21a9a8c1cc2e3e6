"""PASTIS benchmark dataset reader on the host, in numpy (port of
crop2seg_tpu/data/pastis.py; the same items for the same seed).

- reads ``DATA_S2/S2_<id>.npy`` (T, 10, H, W) series, already in the PASTIS
  band order, and ``ANNOTATIONS/TARGET_<id>.npy`` (3, H, W), whose channel 0
  is the semantic target;
- ``target="instance"``: the seven-channel panoptic stack from
  ``INSTANCE_ANNOTATIONS`` (heatmap, instance ids, voronoi zones, the
  parcel's height and width, object and pixel semantics);
- reads ``metadata.geojson`` with ``json`` (only the features' properties
  are needed): the patches of ``folds`` (1-5), sorted by ``ID_PATCH``;
- appends the NDVI channel (B08-B04)/(B08+B04) after standardization, with
  B08 at index 3 and B04 at index 0 of the PASTIS band order, 0 where
  undefined or outside [-1, 1];
- gives dates as days from ``reference_date`` and/or the day of the year;
- augments training items (``transform``, semantic target only) and drops
  frames at random (``temporal_dropout``).

PASTIS has no native batch plan: the ``BatchLoader`` collates its items in
Python. ``compute_norm_vals`` writes the per-fold channel statistics.
"""
from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, Optional, Sequence

import numpy as np

from crop2seg_tpu_torch.data.s2tsczcrop import _load_array


class PASTISDataset:
    """Yields dict samples: x (T, H, W, C), dates (T,) or (T, 2), y (H, W)
    int32 (semantic) or (H, W, 7) float32 (instance), length, id.
    ``meta_patch`` maps each ID_PATCH to its geojson properties."""

    def __init__(self, folder: str, norm: bool = True,
                 norm_values: Optional[Dict] = None, target: str = "semantic",
                 folds: Optional[Sequence[int]] = None,
                 reference_date: str = "2018-09-01", class_mapping=None,
                 mono_date=None, use_doy: bool = False,
                 use_abs_rel_enc: bool = False, transform=None,
                 add_ndvi: bool = False, set_type: str = "train",
                 temporal_dropout: float = 0.0, cache: bool = False,
                 seed: int = 0, **_):
        self.folder = folder
        self.target = target
        self.reference_date = datetime(*map(int, reference_date.split("-")))
        self.use_abs_rel_enc = use_abs_rel_enc
        self.use_doy = False if use_abs_rel_enc else use_doy
        self.transform = transform
        self.add_ndvi = add_ndvi
        self.set_type = set_type
        self.temporal_dropout = temporal_dropout
        self.class_mapping = class_mapping
        self.mono_date = mono_date
        self.cache = cache
        self._memory: Dict[int, tuple] = {}
        self._rng = np.random.default_rng(seed)

        with open(os.path.join(folder, "metadata.geojson")) as f:
            meta = json.load(f)
        props = [feat["properties"] for feat in meta["features"]]
        if folds is not None:
            props = [p for p in props if p.get("Fold") in set(folds)]
        props.sort(key=lambda p: int(p["ID_PATCH"]))
        self.meta_patch = {int(p["ID_PATCH"]): p for p in props}
        self.id_patches = sorted(self.meta_patch)

        if norm:
            if not isinstance(norm_values, dict):
                raise ValueError("norm=True requires norm_values dict")
            self.norm = (np.asarray(norm_values["mean"], np.float32),
                         np.asarray(norm_values["std"], np.float32))
        else:
            self.norm = None

    def __len__(self):
        return len(self.id_patches)

    def _dates(self, id_patch: int, absolute: bool) -> np.ndarray:
        """Days from the reference date, or (``absolute``) days of the year."""
        d = self.meta_patch[id_patch]["dates-S2"]
        out = []
        for key in sorted(d, key=lambda s: int(s)):
            s = str(d[key])
            dt = datetime(int(s[:4]), int(s[4:6]), int(s[6:]))
            out.append(dt.timetuple().tm_yday if absolute
                       else (dt - self.reference_date).days)
        return np.asarray(out, np.float32)

    def _map_classes(self, sem: np.ndarray) -> np.ndarray:
        if self.class_mapping is None:
            return sem
        return np.vectorize(lambda v: self.class_mapping[v])(sem)

    def _instance_target(self, id_patch: int) -> np.ndarray:
        """(H, W, 7): heatmap, instance ids, zones, the parcel's (h, w)
        written over its zone, the parcel's class over its zone, the pixel
        classes."""
        heatmap = _load_array(self.folder, "INSTANCE_ANNOTATIONS",
                              f"HEATMAP_{id_patch}.npy")
        instance_ids = _load_array(self.folder, "INSTANCE_ANNOTATIONS",
                                   f"INSTANCES_{id_patch}.npy")
        zones = _load_array(self.folder, "INSTANCE_ANNOTATIONS",
                            f"ZONES_{id_patch}.npy")
        sem = self._map_classes(_load_array(self.folder, "ANNOTATIONS",
                                            f"TARGET_{id_patch}.npy")[0])
        size = np.zeros((*instance_ids.shape, 2))
        obj_sem = np.zeros(instance_ids.shape)
        for iid in np.unique(instance_ids):
            if iid == 0:
                continue
            h = (instance_ids == iid).any(axis=-1).sum()
            w = (instance_ids == iid).any(axis=-2).sum()
            size[zones == iid] = (h, w)
            obj_sem[zones == iid] = sem[instance_ids == iid][0]
        return np.concatenate([
            heatmap[:, :, None], instance_ids[:, :, None], zones[:, :, None],
            size, obj_sem[:, :, None], sem[:, :, None]], axis=-1
        ).astype(np.float32)

    def _load_raw(self, id_patch: int):
        data = _load_array(self.folder, "DATA_S2",
                           f"S2_{id_patch}.npy").astype(np.float32)
        if self.add_ndvi:
            nir, red = data[:, 3], data[:, 0]         # B08, B04 in PASTIS order
            denom = nir + red
            ndvi = np.where(denom == 0, 0.0,
                            (nir - red) / np.where(denom == 0, 1, denom))
            ndvi = np.where((ndvi < -1) | (ndvi > 1), 0.0, ndvi)
        if self.norm is not None:
            mean, std = self.norm
            data = (data - mean[None, :, None, None]) / std[None, :, None, None]
        if self.add_ndvi:
            data = np.concatenate([data, ndvi[:, None]], axis=1)
        if self.target == "semantic":
            target = self._map_classes(_load_array(
                self.folder, "ANNOTATIONS", f"TARGET_{id_patch}.npy")[0].astype(np.int32))
        else:
            target = self._instance_target(id_patch)
        return data, target

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        id_patch = self.id_patches[item]
        if self.cache and item in self._memory:
            data, target = self._memory[item]
        else:
            data, target = self._load_raw(id_patch)
            if self.cache:
                self._memory[item] = (data, target)

        dates = self._dates(id_patch, absolute=self.use_doy)
        dates2 = (self._dates(id_patch, absolute=not self.use_doy)
                  if self.use_abs_rel_enc else None)

        if self.mono_date is not None:
            if isinstance(self.mono_date, int):
                idx = self.mono_date
            else:
                mono_dt = datetime(*map(int, self.mono_date.split("-")))
                idx = int(np.argmin(np.abs(
                    dates - (mono_dt - self.reference_date).days)))
            data, dates = data[idx:idx + 1], dates[idx:idx + 1]
            if dates2 is not None:
                dates2 = dates2[idx:idx + 1]

        if (self.transform is not None and self.set_type == "train"
                and self.target == "semantic"):
            data, target = self.transform(data, target, self._rng)

        if self.set_type == "train" and self.temporal_dropout > 0.0:
            keep = self._rng.random(data.shape[0]) > self.temporal_dropout
            keep[0] = keep[0] or not keep.any()      # never drop everything
            data, dates = data[keep], dates[keep]
            if dates2 is not None:
                dates2 = dates2[keep]

        x = np.transpose(data, (0, 2, 3, 1))          # channels-last
        d = dates if dates2 is None else np.stack([dates, dates2], axis=-1)
        return {"x": x, "dates": d.astype(np.float32), "length": x.shape[0],
                "id": id_patch, "y": target}


def compute_norm_vals(folder: str, out_name: str = "NORM_S2_patch.json"):
    """Per-fold channel mean and std ({"Fold_k": {"mean", "std"}}, the
    patches' own statistics averaged over the fold), written to
    ``folder/out_name`` and returned."""
    norm = {}
    for fold in range(1, 6):
        ds = PASTISDataset(folder, norm=False, folds=[fold])
        means, stds = [], []
        for i in range(len(ds)):
            x = ds[i]["x"]  # (T, H, W, C)
            means.append(x.mean(axis=(0, 1, 2)))
            stds.append(x.std(axis=(0, 1, 2)))
        norm[f"Fold_{fold}"] = {
            "mean": np.stack(means).mean(0).tolist(),
            "std": np.stack(stds).mean(0).tolist()}
    with open(os.path.join(folder, out_name), "w") as f:
        json.dump(norm, f, indent=4)
    return norm
