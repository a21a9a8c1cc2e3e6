"""DatasetCreator: Sentinel-2 tile time series -> S2TSCzCrop patch dataset.

Re-design of reference src/helpers/dataset_creator.py:45-729 as a
composable pipeline over in-memory numpy stacks:

    download (CopernicusClient) -> load 10 m stacks -> drop B01/B09
    -> [training] rasterized LPIS segmentation -> patchify 82x82 grid
       (10980^2 -> crop offset 484 -> 10496^2 -> 6724 patches of 128^2)
       -> QA covers from SCL -> reject >70% background -> save + metadata
    -> [inference] pad 1098^2 crop -> 100 patches of 128^2 -> save + metadata

The array plumbing is dependency-free; .SAFE raster decoding and LPIS
shapefile rasterization are injected callables so the pipeline is testable
(and so GDAL-based loaders can plug in where available).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from crop2seg_tpu_torch.gis.raster import Affine
from crop2seg_tpu_torch.gis.raster_prep import cover_fractions

TRAIN_GRID = 82
TRAIN_OFFSET = 484
PATCH = 128
INFER_GRID = 10
INFER_TILE = 1098
INFER_PADDED = 1280


def patchify_array(arr: np.ndarray, patch: int = PATCH) -> np.ndarray:
    """(..., H, W) with H=W=n*patch -> (n*n, ..., patch, patch), row-major
    (reference _patchify rearrange, dataset_creator.py:347-388)."""
    *lead, h, w = arr.shape
    nh, nw = h // patch, w // patch
    x = arr.reshape(*lead, nh, patch, nw, patch)
    nl = len(lead)
    perm = (nl, nl + 2) + tuple(range(nl)) + (nl + 1, nl + 3)
    return x.transpose(perm).reshape((nh * nw,) + tuple(lead) + (patch, patch))


def patch_affines(base: Affine, n_grid: int, patch: int = PATCH,
                  offset: int = 0) -> List[Tuple[float, ...]]:
    """Per-patch affine transforms for the row-major patch grid."""
    out = []
    for r in range(n_grid):
        for c in range(n_grid):
            x0, y0 = base.pixel_to_world(offset + r * patch, offset + c * patch)
            out.append((base.a, base.b, float(x0), base.d, base.e, float(y0)))
    return out


class DatasetCreator:
    """Pipeline driver.

    loader(tile_name, bounds) must return
    (time_series (T, 13, H, W) incl. SCL last, affine: Affine, crs: int,
     dates: list[int YYYYMMDD]); rasterize_labels(shape, affine) -> (H, W)
    int labels. Both are injectable; defaults raise with instructions when
    the GDAL stack is unavailable.
    """

    def __init__(self, output_path: str,
                 loader: Optional[Callable] = None,
                 rasterize_labels: Optional[Callable] = None,
                 for_inference: bool = False,
                 download: bool = False, client=None,
                 max_background: float = 0.7):
        self.out_path = output_path
        self.loader = loader
        self.rasterize_labels = rasterize_labels
        self.for_inference = for_inference
        self.download = download
        self.client = client
        self.max_background = max_background
        self.data_s2_path = os.path.join(output_path, "DATA_S2")
        self.segmentation_path = os.path.join(output_path, "ANNOTATIONS")
        os.makedirs(self.data_s2_path, exist_ok=True)
        os.makedirs(self.segmentation_path, exist_ok=True)
        self.metadata: List[Dict] = []
        meta_file = os.path.join(output_path, "metadata.json")
        if os.path.exists(meta_file):
            with open(meta_file) as f:
                self.metadata = json.load(f)

    # --- steps --------------------------------------------------------------

    @staticmethod
    def preprocess(ts: np.ndarray) -> np.ndarray:
        """Drop B01/B09 (60 m bands) -> 10 spectral bands + SCL
        (reference _preprocess :515-538)."""
        if ts.shape[1] == 13:
            keep = list(range(10)) + [12]
            return ts[:, keep]
        return ts

    def patchify_training(self, ts: np.ndarray, affine: Affine):
        """Crop 10980^2 -> offset 484 -> 10496^2 -> 6724 patches
        (reference _patchify :347-385)."""
        o, size = TRAIN_OFFSET, TRAIN_GRID * PATCH
        cropped = ts[..., o:o + size, o:o + size]
        patches = patchify_array(cropped, PATCH)
        affines = patch_affines(affine, TRAIN_GRID, PATCH, o)
        return patches, affines

    @staticmethod
    def patchify_inference(ts: np.ndarray) -> np.ndarray:
        """Pad a 1098^2 crop to 1280^2 and split into 100 patches
        (reference :386-388)."""
        h, w = ts.shape[-2:]
        pad = [(0, 0)] * (ts.ndim - 2) + [(0, INFER_PADDED - h),
                                          (0, INFER_PADDED - w)]
        return patchify_array(np.pad(ts, pad), PATCH)

    @staticmethod
    def qa_covers(patches_scl: np.ndarray) -> List[Dict[str, float]]:
        """Per-patch nodata + snow/cloud covers from the SCL layer across the
        series (reference _postprocess_s2 :540-566)."""
        return [cover_fractions(p) for p in patches_scl]

    def reject_background(self, patch_targets: np.ndarray):
        """Valid = background fraction <= max_background
        (reference _postprocess_segmentation :568-590)."""
        bg = (patch_targets == 0).mean(axis=(-2, -1))
        return bg <= self.max_background, bg

    # --- orchestration --------------------------------------------------------

    def run_tile(self, tile_name: str, tile_index: int = 0,
                 bounds=None) -> int:
        if self.loader is None:
            raise RuntimeError(
                "DatasetCreator needs a loader(tile_name, bounds) callable; "
                "see crop2seg_tpu_torch.gis.raster_prep.read_safe_bands/stack_bands "
                "for building one from .SAFE products")
        if self.download:
            if self.client is None:
                raise RuntimeError("download=True requires a CopernicusClient")
            self.client.fetch_time_series(
                tile_name, os.path.join(self.out_path, "tiles"))
        ts, affine, crs, dates = self.loader(tile_name, bounds)
        ts = self.preprocess(ts)

        if self.for_inference:
            patches = self.patchify_inference(ts[:, :-1])
            valid = np.ones((patches.shape[0],), bool)
            n = self._save(patches, None, valid, tile_name, tile_index, dates,
                           crs, None, None, None)
            return n

        labels = self.rasterize_labels(ts.shape[-2:], affine) \
            if self.rasterize_labels else np.zeros(ts.shape[-2:], np.uint8)
        patch_targets, affines = self.patchify_training(labels, affine)
        patches, _ = self.patchify_training(ts, affine)
        covers = self.qa_covers(patches[:, :, -1])
        valid, bg = self.reject_background(patch_targets)
        return self._save(patches[:, :, :-1], patch_targets, valid, tile_name,
                          tile_index, dates, crs, affines, covers, bg)

    def _save(self, patches, patch_targets, valid, tile_name, tile_index,
              dates, crs, affines, covers, bg) -> int:
        per_tile = patches.shape[0]
        n_saved = 0
        for i in range(per_tile):
            pid = tile_index * (TRAIN_GRID * TRAIN_GRID
                                if not self.for_inference else per_tile) + i
            status = "OK" if valid[i] else "REMOVED"
            if valid[i]:
                np.save(os.path.join(self.data_s2_path, f"S2_{pid}.npy"),
                        patches[i].astype(np.float32))
                if patch_targets is not None:
                    np.save(os.path.join(self.segmentation_path,
                                         f"TARGET_{pid}.npy"),
                            patch_targets[i].astype(np.uint8))
                n_saved += 1
            rec = {
                "ID_PATCH": int(pid), "ID_WITHIN_TILE": int(i),
                "TILE": tile_name, "Status": status,
                "time-series_length": int(patches.shape[1]), "crs": int(crs),
                "Fold": int(i % 5) + 1, "set": "",
                "dates-S2": {str(j): int(d) for j, d in enumerate(dates)},
            }
            if affines is not None:
                rec["affine"] = list(affines[i])
            if covers is not None:
                rec.update(covers[i])
            if bg is not None:
                rec["Background_Cover"] = float(bg[i])
            self.metadata.append(rec)
        with open(os.path.join(self.out_path, "metadata.json"), "w") as f:
            json.dump(self.metadata, f)
        return n_saved
