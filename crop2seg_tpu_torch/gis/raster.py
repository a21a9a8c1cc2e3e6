"""Minimal raster/georeferencing primitives (no GDAL dependency).

Covers what the reference uses from rasterio for the prediction tail
(reference src/helpers/postprocess.py:21-83 ``prediction2raster`` and
the affine bookkeeping in dataset_creator.py): a 6-term affine transform,
pixel<->world mapping, windowed reads of in-memory arrays, and prediction
export. GeoTIFF encoding itself is gated on rasterio; the portable format is
a .npz sidecar carrying the array + affine + CRS, which every consumer in
this package reads.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Affine:
    """GDAL-style affine: x = a*col + b*row + c ; y = d*col + e*row + f.

    Stored in the rasterio order (a, b, c, d, e, f) that the reference passes
    around as plain tuples (dataset_creator metadata 'affine')."""

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    @classmethod
    def from_origin(cls, west: float, north: float, xres: float, yres: float):
        return cls(xres, 0.0, west, 0.0, -yres, north)

    def pixel_to_world(self, row, col) -> Tuple[np.ndarray, np.ndarray]:
        x = self.a * np.asarray(col) + self.b * np.asarray(row) + self.c
        y = self.d * np.asarray(col) + self.e * np.asarray(row) + self.f
        return x, y

    def world_to_pixel(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        det = self.a * self.e - self.b * self.d
        col = (self.e * (np.asarray(x) - self.c) - self.b * (np.asarray(y) - self.f)) / det
        row = (-self.d * (np.asarray(x) - self.c) + self.a * (np.asarray(y) - self.f)) / det
        return row, col

    def to_tuple(self):
        return (self.a, self.b, self.c, self.d, self.e, self.f)


@dataclasses.dataclass
class GeoRef:
    affine: Affine
    crs: int = 32633  # UTM 33N, the Czech S2 tiles' CRS

    def window(self, arr: np.ndarray, bounds: Tuple[float, float, float, float]
               ) -> Tuple[np.ndarray, "GeoRef"]:
        """Windowed read by world bounds (left, bottom, right, top) —
        replaces rasterio windowed reads (sentinel2raster.py:320-329)."""
        left, bottom, right, top = bounds
        r0, c0 = self.affine.world_to_pixel(left, top)
        r1, c1 = self.affine.world_to_pixel(right, bottom)
        r0, c0 = int(np.floor(r0)), int(np.floor(c0))
        r1, c1 = int(np.ceil(r1)), int(np.ceil(c1))
        # clamp to the raster: bounds a fraction of a pixel outside the
        # tile (e.g. ~1 m reprojection rounding on an edge cell) must read
        # the overlap, not wrap via negative indexing into an empty window
        r0, c0 = max(r0, 0), max(c0, 0)
        r1, c1 = min(r1, arr.shape[-2]), min(c1, arr.shape[-1])
        sub = arr[..., r0:r1, c0:c1]
        x0, y0 = self.affine.pixel_to_world(r0, c0)
        new = Affine(self.affine.a, self.affine.b, float(x0),
                     self.affine.d, self.affine.e, float(y0))
        return sub, GeoRef(new, self.crs)


def save_prediction_raster(path: str, classes: np.ndarray,
                           proba: Optional[np.ndarray] = None,
                           affine: Optional[Affine] = None,
                           crs: int = 32633, nodata: int = 0) -> str:
    """Export a crop map (reference prediction2raster, postprocess.py:21-83):
    band 0 = argmax classes, bands 1..K = per-class probabilities.

    Writes GeoTIFF when rasterio is importable, else a .npz sidecar with the
    same content. Returns the written path.
    """
    bands = [classes.astype(np.float32)]
    if proba is not None:
        bands += [proba[..., k].astype(np.float32)
                  for k in range(proba.shape[-1])]
    stack = np.stack(bands)
    try:
        import rasterio
        from rasterio.transform import Affine as RioAffine
        tr = RioAffine(*(affine.to_tuple() if affine else (1, 0, 0, 0, -1, 0)))
        with rasterio.open(
                path, "w", driver="GTiff", height=stack.shape[1],
                width=stack.shape[2], count=stack.shape[0],
                dtype="float32", crs=f"EPSG:{crs}", transform=tr,
                nodata=nodata) as dst:
            dst.write(stack)
        return path
    except ImportError:
        alt = os.path.splitext(path)[0] + ".npz"
        np.savez_compressed(
            alt, data=stack, crs=crs, nodata=nodata,
            affine=np.asarray(affine.to_tuple() if affine else
                              (1, 0, 0, 0, -1, 0)))
        return alt


def load_prediction_raster(path: str):
    """Read back either format written by save_prediction_raster."""
    if path.endswith(".npz"):
        blob = np.load(path)
        return (blob["data"], Affine(*blob["affine"].tolist()),
                int(blob["crs"]))
    import rasterio
    with rasterio.open(path) as src:
        tr = src.transform
        return (src.read(), Affine(tr.a, tr.b, tr.c, tr.d, tr.e, tr.f),
                int(src.crs.to_epsg()))
