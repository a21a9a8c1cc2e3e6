"""Sentinel-2 .SAFE -> analysis-ready 10 m raster utilities.

Re-design of reference src/helpers/sentinel2raster.py:108-731. The
array-space operations are numpy/scipy and fully tested:

- ``upsample_to_10m``: cubic upsampling of 20 m (x2) and 60 m (x6) bands,
  nearest for the SCL classification layer (reference __2raster :308-414)
- ``stack_bands``: the 13-band 10 m stack in the reference band order
  [B04,B03,B02,B08,B05,B06,B07,B8A,B11,B12,(B01,B09),SCL] (reference :113-114)
- ``normalized_difference_index`` (reference :505-591)
- ``tile_coordinates`` + ``fast_tiling``: stride-tricks patchify
  (reference :616-676)

Reading JP2000 band files out of a .SAFE archive requires rasterio/GDAL
(optional packages) — ``read_safe_bands`` degrades with a clear error and
accepts pre-extracted .npy band files as a portable alternative.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# 10 m output band order (reference sentinel2raster.py:113-114).
BAND_ORDER_10M = ("B04", "B03", "B02", "B08")
BAND_ORDER_20M = ("B05", "B06", "B07", "B8A", "B11", "B12")
BAND_ORDER_60M = ("B01", "B09")
FULL_BAND_ORDER = BAND_ORDER_10M + BAND_ORDER_20M + BAND_ORDER_60M + ("SCL",)

# Scene Classification Layer codes (reference sentinel.py:609-617).
SCL_CODES = {
    0: "NO_DATA", 1: "SATURATED_OR_DEFECTIVE", 2: "DARK_AREA_PIXELS",
    3: "CLOUD_SHADOWS", 4: "VEGETATION", 5: "NOT_VEGETATED", 6: "WATER",
    7: "UNCLASSIFIED", 8: "CLOUD_MEDIUM_PROBABILITY",
    9: "CLOUD_HIGH_PROBABILITY", 10: "THIN_CIRRUS", 11: "SNOW",
}
SCL_CLOUD_SNOW = (3, 8, 9, 10, 11)


def _keys_kernel(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic-convolution kernel (a=-0.5, what GDAL's Resampling.cubic
    evaluates; NOT scipy's B-spline)."""
    t = np.abs(t)
    near = (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0
    far = a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a
    return np.where(t <= 1.0, near, np.where(t < 2.0, far, 0.0))


def _cubic_upsample_last_axis(arr: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor cubic-convolution upsample of the last axis with
    GDAL's pixel-center mapping src = (dst + 0.5)/factor - 0.5 and
    edge-clamped taps."""
    n = arr.shape[-1]
    j = np.arange(n * factor)
    x = (j + 0.5) / factor - 0.5
    base = np.floor(x).astype(np.int64)
    s = x - base
    weights = np.stack([_keys_kernel(1.0 + s), _keys_kernel(s),
                        _keys_kernel(1.0 - s), _keys_kernel(2.0 - s)])
    idx = np.clip(base[None, :] + np.arange(-1, 3)[:, None], 0, n - 1)
    out = np.zeros(arr.shape[:-1] + (n * factor,), np.float64)
    for k in range(4):
        out += arr[..., idx[k]] * weights[k]
    return out


def cubic_upsample(band: np.ndarray, factor: int) -> np.ndarray:
    """GDAL-compatible (Keys a=-0.5) separable cubic-convolution upsample by
    an integer factor — the resampling rasterio performs for the 20 m (x2)
    and 60 m (x6) bands at reference src/helpers/sentinel2raster.py:
    327-352 (``read(out_shape=..., resampling=Resampling.cubic)``)."""
    out = _cubic_upsample_last_axis(np.asarray(band, np.float64), factor)
    out = _cubic_upsample_last_axis(np.moveaxis(out, -2, -1), factor)
    return np.moveaxis(out, -1, -2).astype(np.float32)


def nearest_upsample(band: np.ndarray, factor: int) -> np.ndarray:
    """Nearest-neighbour integer upsample with GDAL's center mapping (what
    rasterio does for the SCL layer, sentinel2raster.py:356-368). For
    integer factors this is an exact pixel replication."""
    return np.repeat(np.repeat(band, factor, axis=-2), factor, axis=-1)


def upsample_to_10m(band: np.ndarray, factor: int,
                    categorical: bool = False) -> np.ndarray:
    """Resample a 20 m (factor=2) or 60 m (factor=6) band to 10 m.

    Continuous bands use GDAL-semantics cubic convolution, categorical
    layers (SCL) nearest neighbour (reference __2raster :308-414).
    """
    if factor == 1:
        return band
    if categorical:
        return nearest_upsample(band, factor)
    return cubic_upsample(band, factor)


def stack_bands(bands: Dict[str, np.ndarray],
                include_60m: bool = True) -> np.ndarray:
    """Band dict (native resolutions) -> (C, H, W) 10 m stack in the
    reference order; missing 60 m bands may be skipped."""
    order = BAND_ORDER_10M + BAND_ORDER_20M \
        + (BAND_ORDER_60M if include_60m else ()) + ("SCL",)
    target = bands[BAND_ORDER_10M[0]].shape
    out = []
    for name in order:
        b = bands[name]
        factor = target[0] // b.shape[0]
        out.append(upsample_to_10m(b, factor, categorical=(name == "SCL")))
    return np.stack(out).astype(np.float32)


def band_factor(name: str) -> int:
    """10 m pixels per native pixel of ``name`` (10 m -> 1, 20 m -> 2,
    60 m -> 6)."""
    if name in BAND_ORDER_10M:
        return 1
    if name in BAND_ORDER_60M:
        return 6
    return 2  # 20 m bands + SCL


def window_from_bounds(affine, bounds) -> Tuple[int, int, int, int]:
    """World bounds (left, bottom, right, top) -> 10 m pixel window
    (row0, row1, col0, col1) on the tile grid described by ``affine``
    (the reference computes the same via rasterio.windows.from_bounds at
    sentinel2raster.py:320-329)."""
    left, bottom, right, top = bounds
    r0, c0 = affine.world_to_pixel(left, top)
    r1, c1 = affine.world_to_pixel(right, bottom)
    # clamp at 0: bounds marginally outside the tile (reprojection rounding
    # on edge cells) must clip to the overlap, not produce negative indices
    # that wrap the later numpy slices into empty windows
    return (max(0, int(np.floor(min(r0, r1)))),
            max(0, int(np.ceil(max(r0, r1)))),
            max(0, int(np.floor(min(c0, c1)))),
            max(0, int(np.ceil(max(c0, c1)))))


def read_safe_bands(safe_dir: str,
                    window: Optional[Tuple[int, int, int, int]] = None
                    ) -> Dict[str, np.ndarray]:
    """Read band arrays from a .SAFE product directory.

    Prefers pre-extracted ``<BAND>.npy`` files (portable path); falls back to
    rasterio JP2000 reads when available.

    ``window`` is a 10 m-grid (row0, row1, col0, col1): only that window is
    read — npy files are memory-mapped and sliced, rasterio reads use a
    Window — so extracting one 1098^2 cell never decodes the full 10980^2
    tile (reference windowed read: sentinel2raster.py:320-329). The window
    is scaled per band resolution (20 m -> /2, 60 m -> /6), and indices must
    be multiples of the coarsest factor present for exact alignment.
    """

    def _npy_window(path, name):
        arr = np.load(path, mmap_mode="r" if window is not None else None)
        if window is None:
            return np.asarray(arr)
        f = band_factor(name)
        r0, r1, c0, c1 = (max(0, v) // f for v in window)
        return np.ascontiguousarray(
            arr[..., r0:min(r1, arr.shape[-2]), c0:min(c1, arr.shape[-1])])

    npys = {os.path.splitext(os.path.basename(p))[0]: p
            for p in glob.glob(os.path.join(safe_dir, "**", "*.npy"),
                               recursive=True)}
    if npys:
        return {name: _npy_window(path, name)
                for name, path in npys.items() if name in FULL_BAND_ORDER}
    try:
        import rasterio
    except ImportError as err:
        raise RuntimeError(
            f"no .npy bands under {safe_dir} and rasterio is unavailable; "
            "extract bands to <BAND>.npy or install rasterio") from err
    # One file per band at its NATIVE resolution: an L2A product duplicates
    # every band across IMG_DATA/R10m|R20m|R60m, and the window scaling via
    # band_factor below assumes the native grid — globbing everything and
    # letting the last match win would leave e.g. B04 as the 1830^2 R60m
    # copy (6x mis-scale / zero-size upsample downstream). L1C files carry
    # no Rxxm path segment and are native by definition.
    import re

    chosen: Dict[str, Tuple[int, str]] = {}
    for path in glob.glob(os.path.join(safe_dir, "GRANULE", "*", "IMG_DATA",
                                       "**", "*.jp2"), recursive=True):
        stem = os.path.basename(path)
        for name in FULL_BAND_ORDER:
            if f"_{name}_" in stem or stem.endswith(f"{name}.jp2"):
                m = re.search(r"[/\\]R(\d+)m[/\\]", path)
                native = band_factor(name) * 10
                penalty = (0 if m is None or int(m.group(1)) == native
                           else abs(int(m.group(1)) - native))
                if name not in chosen or penalty < chosen[name][0]:
                    chosen[name] = (penalty, path)
    bands = {}
    for name, (_, path) in chosen.items():
        with rasterio.open(path) as src:
            if window is None:
                bands[name] = src.read(1)
            else:
                from rasterio.windows import Window
                f = band_factor(name)
                r0, r1, c0, c1 = (max(0, v) // f for v in window)
                bands[name] = src.read(1, window=Window(
                    c0, r0, c1 - c0, r1 - r0))
    return bands


def normalized_difference_index(a: np.ndarray, b: np.ndarray,
                                clip: bool = True) -> np.ndarray:
    """(a - b) / (a + b) with 0 where undefined (reference :505-591)."""
    denom = a + b
    out = np.where(denom == 0, 0.0, (a - b) / np.where(denom == 0, 1, denom))
    if clip:
        out = np.where((out < -1) | (out > 1), 0.0, out)
    return out.astype(np.float32)


def cover_fractions(scl: np.ndarray) -> Dict[str, float]:
    """Nodata + snow/cloud fractions from the SCL layer — the patch QA
    stats (reference dataset_creator.py:540-566)."""
    total = scl.size
    nodata = float(np.count_nonzero(scl == 0)) / total
    cloud_snow = float(np.count_nonzero(np.isin(scl, SCL_CLOUD_SNOW))) / total
    return {"Nodata_Cover": nodata, "Snow_Cloud_Cover": cloud_snow}


def raster_resample(arr: np.ndarray, affine, factor: float,
                    method: str = "nearest"):
    """Array-space counterpart of the reference's raster_resample
    (reference src/helpers/sentinel2raster.py:417-460): factor > 1
    upsamples; the affine is rescaled accordingly. Returns (array, affine).
    """
    from crop2seg_tpu_torch.gis.raster import Affine

    h, w = arr.shape[-2], arr.shape[-1]
    out_h, out_w = int(h * factor), int(w * factor)
    new_affine = Affine(affine.a * (w / out_w), affine.b, affine.c,
                        affine.d, affine.e * (h / out_h), affine.f)
    if factor == 1.0:
        return arr, new_affine
    rows = np.clip(((np.arange(out_h) + 0.5) * (h / out_h) - 0.5), 0, h - 1)
    cols = np.clip(((np.arange(out_w) + 0.5) * (w / out_w) - 0.5), 0, w - 1)
    if method == "nearest":
        ri = np.round(rows).astype(np.int64)
        ci = np.round(cols).astype(np.int64)
        return arr[..., ri[:, None], ci[None, :]], new_affine
    if method == "bilinear":
        r0 = np.floor(rows).astype(np.int64)
        c0 = np.floor(cols).astype(np.int64)
        r1 = np.minimum(r0 + 1, h - 1)
        c1 = np.minimum(c0 + 1, w - 1)
        fr = (rows - r0)[:, None]
        fc = (cols - c0)[None, :]
        a00 = arr[..., r0[:, None], c0[None, :]]
        a01 = arr[..., r0[:, None], c1[None, :]]
        a10 = arr[..., r1[:, None], c0[None, :]]
        a11 = arr[..., r1[:, None], c1[None, :]]
        out = (a00 * (1 - fr) * (1 - fc) + a01 * (1 - fr) * fc
               + a10 * fr * (1 - fc) + a11 * fr * fc)
        return out, new_affine
    raise ValueError(f"unknown method {method!r}")


def raster_reproject(arr: np.ndarray, affine, src_epsg: int, dst_epsg: int,
                     method: str = "nearest",
                     resolution: Optional[float] = None,
                     nodata: float = 0.0):
    """Reproject a raster between the CRSs gis.geo supports — pure-python
    counterpart of the reference's WarpedVRT-based raster_reproject
    (reference src/helpers/sentinel2raster.py:463-502).

    The destination grid keeps the source resolution (like the reference:
    'we do not want change in resolution'); every destination pixel centre
    is inverse-transformed into the source and sampled nearest/bilinear.
    Returns (array (..., H', W'), dst Affine).
    """
    from crop2seg_tpu_torch.gis.geo import transform_coords
    from crop2seg_tpu_torch.gis.raster import Affine

    h, w = arr.shape[-2], arr.shape[-1]
    # source corners -> dst CRS bounding box
    corners_r = np.array([0.0, 0.0, h, h])
    corners_c = np.array([0.0, w, 0.0, w])
    cx, cy = affine.pixel_to_world(corners_r, corners_c)
    dx, dy = transform_coords(cx, cy, src_epsg, dst_epsg)
    res = abs(affine.a) if resolution is None else resolution
    left, right = float(dx.min()), float(dx.max())
    bottom, top = float(dy.min()), float(dy.max())
    out_w = max(int(np.ceil((right - left) / res)), 1)
    out_h = max(int(np.ceil((top - bottom) / res)), 1)
    dst_affine = Affine.from_origin(left, top, res, res)

    rr, cc = np.meshgrid(np.arange(out_h) + 0.5, np.arange(out_w) + 0.5,
                         indexing="ij")
    wx, wy = dst_affine.pixel_to_world(rr.ravel(), cc.ravel())
    sx, sy = transform_coords(wx, wy, dst_epsg, src_epsg)
    sr, sc = affine.world_to_pixel(sx, sy)
    sr = np.asarray(sr).reshape(out_h, out_w) - 0.5
    sc = np.asarray(sc).reshape(out_h, out_w) - 0.5
    inside = (sr > -0.5) & (sr < h - 0.5) & (sc > -0.5) & (sc < w - 0.5)
    if method == "nearest":
        ri = np.clip(np.round(sr), 0, h - 1).astype(np.int64)
        ci = np.clip(np.round(sc), 0, w - 1).astype(np.int64)
        out = arr[..., ri, ci]
    elif method == "bilinear":
        r0 = np.clip(np.floor(sr), 0, h - 1).astype(np.int64)
        c0 = np.clip(np.floor(sc), 0, w - 1).astype(np.int64)
        r1 = np.minimum(r0 + 1, h - 1)
        c1 = np.minimum(c0 + 1, w - 1)
        fr = np.clip(sr - r0, 0, 1)
        fc = np.clip(sc - c0, 0, 1)
        out = (arr[..., r0, c0] * (1 - fr) * (1 - fc)
               + arr[..., r0, c1] * (1 - fr) * fc
               + arr[..., r1, c0] * fr * (1 - fc)
               + arr[..., r1, c1] * fr * fc)
    else:
        raise ValueError(f"unknown method {method!r}")
    out = np.where(inside, out, nodata)
    return out, dst_affine


def tile_coordinates(shape: Tuple[int, int], tile: int
                     ) -> List[Tuple[int, int]]:
    """Top-left corners of a full tiling grid (reference :616-637)."""
    return [(r, c) for r in range(0, shape[0] - tile + 1, tile)
            for c in range(0, shape[1] - tile + 1, tile)]


def fast_tiling(arr: np.ndarray, tile: int) -> np.ndarray:
    """(..., H, W) -> (n_tiles, ..., tile, tile) zero-copy via stride tricks
    (reference fast_tiling :640-676)."""
    *lead, h, w = arr.shape
    nh, nw = h // tile, w // tile
    sub = arr[..., :nh * tile, :nw * tile]
    s = sub.strides
    shape = tuple(lead) + (nh, nw, tile, tile)
    strides = s[:-2] + (s[-2] * tile, s[-1] * tile, s[-2], s[-1])
    view = np.lib.stride_tricks.as_strided(sub, shape=shape, strides=strides)
    nl = len(lead)
    perm = (nl, nl + 1) + tuple(range(nl)) + (nl + 2, nl + 3)
    return np.ascontiguousarray(view.transpose(perm).reshape(
        (nh * nw,) + tuple(lead) + (tile, tile)))
