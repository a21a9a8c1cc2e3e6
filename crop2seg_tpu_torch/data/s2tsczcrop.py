"""S2TSCzCrop dataset reader on the host, in numpy (port of
crop2seg_tpu/data/s2tsczcrop.py; the same items for the same seed).

- reads ``DATA_S2/S2_<id>`` (T, 10, 128, 128) float series and
  ``ANNOTATIONS/TARGET_<id>`` (H, W) labels, and ``metadata.json`` with
  ``json`` (no pandas): records filtered by ``Status == "OK"`` and ``set ==
  set_type``, indexed and sorted by ``ID_PATCH``;
- reorders the channels to the PASTIS band order [2,1,0,4,5,6,3,7,8,9];
- appends the NDVI channel (B08-B04)/(B08+B04) after standardization,
  0 where undefined or outside [-1, 1];
- standardizes per channel with precomputed mean and std;
- gives dates as days from ``reference_date`` and/or the day of the year;
- augments training items (``Transform``) and drops frames at random
  (``temporal_dropout``);
- ``native_batch_plan``: what the native C++ loader needs to assemble the
  batches itself, where no per-item Python work is needed.

Items are channels-last with their true length T; the T buckets and pad
masks are the batcher's (``data/batcher.py``).
"""
from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

# the PASTIS band order, applied to the .SAFE order of the 10-band stack
PASTIS_CHANNEL_ORDER = (2, 1, 0, 4, 5, 6, 3, 7, 8, 9)

# the 15-class nomenclature
LABELS = (
    "Background", "Permanent grassland", "Annual fruit and vegetable",
    "Summer cereals", "Winter cereals", "Rapeseed", "Maize", "Annual forage crops",
    "Sugar beet", "Flax and Hemp", "Permanent fruit", "Hops", "Vineyards",
    "Other crops", "Not classified",
)


def _load_array(folder: str, sub: str, name: str) -> np.ndarray:
    """np.load of ``name`` or, where that is absent, ``name.npy``."""
    path = os.path.join(folder, sub, name)
    if not os.path.exists(path) and os.path.exists(path + ".npy"):
        path = path + ".npy"
    return np.load(path)


def load_norm_values(path: str, folds=None,
                     reorder: bool = True) -> Dict[str, np.ndarray]:
    """NORM_S2_patch.json -> {"mean", "std"} float32 in the channel order the
    dataset serves:

    - ``{"train": {...}}``, the S2TSCzCrop release format: stats in .SAFE
      band order, reordered here by ``PASTIS_CHANNEL_ORDER`` (the dataset
      standardizes after reordering its data);
    - ``{"Fold_k": {...}}``, the PASTIS format: already in PASTIS order,
      averaged over ``folds`` (all folds when None);
    - flat ``{"mean", "std"}``: already in served order, returned as is.

    ``reorder=False`` keeps "train"-keyed stats in .SAFE order (for a dataset
    built with ``channels_like_pastis=False``)."""
    with open(path) as f:
        blob = json.load(f)
    if "mean" in blob:
        return {"mean": np.asarray(blob["mean"], np.float32),
                "std": np.asarray(blob["std"], np.float32)}
    keys = [f"Fold_{f}" for f in folds] if folds is not None else list(blob)
    means = [np.asarray(blob[k]["mean"], np.float32) for k in keys]
    stds = [np.asarray(blob[k]["std"], np.float32) for k in keys]
    mean, std = np.stack(means).mean(0), np.stack(stds).mean(0)
    if reorder and any(k.startswith("train") for k in keys):
        order = list(PASTIS_CHANNEL_ORDER)
        mean, std = mean[order], std[order]
    return {"mean": mean, "std": std}


def read_metadata(path: str, set_type: Optional[str] = None) -> Dict[int, dict]:
    """metadata.json (a list of records) -> {ID_PATCH: record}, sorted by
    ID_PATCH; with ``set_type`` only the records with ``Status == "OK"``
    and ``set == set_type``."""
    with open(path) as f:
        records: List[dict] = json.load(f)
    if set_type is not None:
        records = [r for r in records
                   if r.get("Status") == "OK" and r.get("set") == set_type]
    return {int(r["ID_PATCH"]): r
            for r in sorted(records, key=lambda r: int(r["ID_PATCH"]))}


class S2TSCZCropDataset:
    """Yields dict samples with their true (unpadded) length T.

    Keys: x (T, H, W, C) float32, dates (T,) or (T, 2), y (H, W) int32
    (absent when for_inference), length (int), id (int), affine (6,) when
    get_affine. ``meta_patch`` maps each ID_PATCH to its metadata record.
    """

    def __init__(self, folder: str, norm: bool = True,
                 norm_values: Optional[Dict] = None, folds=None,
                 set_type: str = "train", reference_date: str = "2018-09-01",
                 class_mapping=None, mono_date=None,
                 channels_like_pastis: bool = True, use_doy: bool = False,
                 use_abs_rel_enc: bool = False, transform=None,
                 add_ndvi: bool = False, temporal_dropout: float = 0.0,
                 get_affine: bool = False, for_inference: bool = False,
                 cache: bool = False, seed: int = 0):
        self.folder = folder
        self.set_type = set_type
        self.reference_date = datetime(*map(int, reference_date.split("-")))
        self.use_abs_rel_enc = use_abs_rel_enc
        self.use_doy = False if use_abs_rel_enc else use_doy
        self.transform = transform
        self.add_ndvi = add_ndvi
        self.temporal_dropout = temporal_dropout
        self.get_affine = get_affine
        self.for_inference = for_inference
        self.channels_order = list(PASTIS_CHANNEL_ORDER) if channels_like_pastis \
            else list(range(10))
        self.class_mapping = class_mapping
        self.mono_date = mono_date
        self.cache = cache
        self._memory: Dict[int, tuple] = {}
        self._rng = np.random.default_rng(seed)

        self.meta_patch = read_metadata(os.path.join(folder, "metadata.json"),
                                        None if for_inference else set_type)
        self.id_patches = list(self.meta_patch)

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

    def _affine(self, id_patch: int) -> np.ndarray:
        return np.asarray(self.meta_patch[id_patch]["affine"], np.float32)

    def _target(self, id_patch: int) -> np.ndarray:
        target = _load_array(self.folder, "ANNOTATIONS",
                             f"TARGET_{id_patch}").astype(np.int32)
        if self.class_mapping is not None:
            target = np.vectorize(lambda v: self.class_mapping[v])(target)
        return target

    def _load_raw(self, id_patch: int):
        data = _load_array(self.folder, "DATA_S2", f"S2_{id_patch}"
                           ).astype(np.float32)
        data = data[:, self.channels_order]
        if self.add_ndvi:
            # B08 / B04 sit at 6 / 2 in PASTIS order, at 3 / 0 in .SAFE order
            i_nir, i_red = (6, 2) if self.channels_order[0] == 2 else (3, 0)
            nir, red = data[:, i_nir], data[:, i_red]
            denom = nir + red
            ndvi = np.where(denom == 0, 0.0, (nir - red) / np.where(denom == 0, 1, denom))
            ndvi = np.where((ndvi < -1) | (ndvi > 1), 0.0, ndvi).astype(np.float32)
        if self.norm is not None:
            mean, std = self.norm
            data = (data - mean[None, :, None, None]) / std[None, :, None, None]
        if self.add_ndvi:
            data = np.concatenate([data, ndvi[:, None]], axis=1)
        target = None if self.for_inference else self._target(id_patch)
        return data, target

    def native_batch_plan(self):
        """The channel reorder and standardization for the native batch
        assembler (``crop2seg_tpu_torch/native``), or None where per-item
        Python work (NDVI, mono-date, the RAM cache, noise or crop
        augmentation, a custom transform) rules it out. Flip+rotate and
        temporal dropout run natively: the draws stay in Python
        (``aug_item``) and the loader applies the gather maps."""
        if self.add_ndvi or self.mono_date is not None or self.cache:
            return None
        augment = (self.set_type == "train"
                   and (self.transform is not None
                        or self.temporal_dropout > 0.0))
        if augment and self.transform is not None and (
                not hasattr(self.transform, "index_map")
                or getattr(self.transform, "add_noise", True)
                or getattr(self.transform, "crop", True)):
            return None
        mean, std = self.norm if self.norm is not None else (None, None)
        return {"reorder": list(self.channels_order), "mean": mean,
                "std": std, "augment": augment}

    def aug_item(self, item: int) -> Dict[str, np.ndarray]:
        """``light_item`` plus the item's augmentation plan, drawn from the
        dataset's generator in the order ``__getitem__`` draws (the
        transform's geometry, then the temporal dropout): "frame_idx"
        (t',) int32, the source frames kept, and "gather" (H*W,) int32, the
        pixel permutation or None; y, dates and length come transformed."""
        s = self.light_item(item)
        t = s["length"]
        s["gather"] = None
        if (not self.for_inference and self.transform is not None
                and self.set_type == "train"):
            deg, flip = self.transform.sample_geometry(self._rng)
            y = s["y"]
            gather = self.transform.index_map(*y.shape[-2:], deg, flip)
            s["y"] = self.transform.apply_map(y, gather)
            s["gather"] = gather
        frame_idx = np.arange(t)
        if (not self.for_inference and self.set_type == "train"
                and self.temporal_dropout > 0.0):
            keep = self._rng.random(t) > self.temporal_dropout
            keep[0] = keep[0] or not keep.any()  # never drop everything
            frame_idx = np.nonzero(keep)[0]
        s["frame_idx"] = frame_idx.astype(np.int32)
        s["dates"] = s["dates"][frame_idx]
        s["length"] = int(len(frame_idx))
        return s

    def data_path(self, id_patch: int) -> str:
        p = os.path.join(self.folder, "DATA_S2", f"S2_{id_patch}")
        return p if os.path.exists(p) else p + ".npy"

    def light_item(self, item: int) -> Dict[str, np.ndarray]:
        """Everything ``__getitem__`` yields but x: dates, y, id, length,
        affine, and the series' path."""
        id_patch = self.id_patches[item]
        dates = self._dates(id_patch, self.use_doy)
        if self.use_abs_rel_enc:
            d = np.stack([dates, self._dates(id_patch, not self.use_doy)], axis=-1)
        else:
            d = dates
        sample = {"dates": d.astype(np.float32), "id": id_patch,
                  "length": int(dates.shape[0]),
                  "path": self.data_path(id_patch)}
        if not self.for_inference:
            sample["y"] = self._target(id_patch)
        if self.get_affine:
            sample["affine"] = self._affine(id_patch)
        return sample

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        id_patch = self.id_patches[item]
        if self.cache and item in self._memory:
            data, target = self._memory[item]
        else:
            data, target = self._load_raw(id_patch)
            if self.cache:
                self._memory[item] = (data, target)

        dates = self._dates(id_patch, self.use_doy)
        dates2 = None
        if self.use_abs_rel_enc:
            dates2 = self._dates(id_patch, not self.use_doy)

        if self.mono_date is not None:
            if isinstance(self.mono_date, int):
                idx = self.mono_date
            else:
                mono_dt = datetime(*map(int, self.mono_date.split("-")))
                delta = (mono_dt - self.reference_date).days
                idx = int(np.argmin(np.abs(dates - delta)))
            data = data[idx:idx + 1]
            dates = dates[idx:idx + 1]
            if dates2 is not None:
                dates2 = dates2[idx:idx + 1]

        assert data.shape[0] == dates.shape[0]

        if not self.for_inference and self.transform is not None and \
                self.set_type == "train":
            data, target = self.transform(data, target, self._rng)

        if (not self.for_inference and self.set_type == "train"
                and self.temporal_dropout > 0.0):
            keep = self._rng.random(data.shape[0]) > self.temporal_dropout
            keep[0] = keep[0] or not keep.any()  # never drop everything
            data, dates = data[keep], dates[keep]
            if dates2 is not None:
                dates2 = dates2[keep]

        x = np.transpose(data, (0, 2, 3, 1))  # channels-last
        d = dates if dates2 is None else np.stack([dates, dates2], axis=-1)
        sample = {"x": x, "dates": d.astype(np.float32),
                  "length": x.shape[0], "id": id_patch}
        if target is not None:
            sample["y"] = target
        if self.get_affine:
            sample["affine"] = self._affine(id_patch)
        return sample
