"""Legacy per-.SAFE band/mask loaders + overpass prediction.

Behavior-compatible redesign of the reference's legacy Sentinel loader
surface (reference src/helpers/sentinel.py:619-1428) — the 20 m-grid
path that predates Sentinel2Raster (gis/raster_prep.py covers the modern
10 m path). Everything degrades gracefully without rasterio: band files may
be pre-extracted ``.npy`` arrays next to (or instead of) the ``.jp2`` files,
the same portable fallback ``raster_prep.read_safe_bands`` uses.

Covered reference functions (cited per item below): sentinel_rescale,
sentinel_load_channel, sentinel_load_tile, sentinel_load_clouds /
sentinel_load_mask (SCL, CLDPRB raster and legacy GML vector masks),
sentinel_get_tilebounds, merge_bands / export_to_geotif,
sentinel_crop_shape, sentinel2_overpasses.
"""
from __future__ import annotations

import glob
import math
import os
import re
import xml.etree.ElementTree as ET
from datetime import datetime, timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from crop2seg_tpu_torch.gis.raster import Affine
from crop2seg_tpu_torch.gis.raster_prep import (
    SCL_CLOUD_SNOW, cubic_upsample, nearest_upsample)

# L2A per-resolution band sets (reference sentinel.py:668-671 comment block).
RES_BANDS = {
    "R10m": ("B02", "B03", "B04", "B08"),
    "R20m": ("B02", "B03", "B04", "B05", "B06", "B07", "B8A", "B11", "B12"),
    "R60m": ("B01", "B02", "B03", "B04", "B05", "B06", "B07", "B8A", "B09",
             "B11", "B12"),
}
# L1C single-folder band set (six 20 m-native bands, reference :652-655).
L1C_BANDS_20M = ("B05", "B06", "B07", "B8A", "B11", "B12")


def _read_raster_file(path: str) -> np.ndarray:
    """One band file -> 2-D array; .npy portable fallback, else rasterio."""
    if path.endswith(".npy"):
        return np.load(path)
    npy = os.path.splitext(path)[0] + ".npy"
    if os.path.exists(npy):
        return np.load(npy)
    try:
        import rasterio
    except ImportError as err:
        raise RuntimeError(
            f"reading {path} needs rasterio (or a .npy sidecar)") from err
    with rasterio.open(path) as src:
        return src.read(1)


def find_band_files(safe_dir: str, resolution: str = "R20m"
                    ) -> Dict[str, str]:
    """Band name -> file path inside a .SAFE tree (reference
    sentinel_load_channel's globbing, sentinel.py:692-788). Handles the L2A
    layout (GRANULE/*/IMG_DATA/R{10,20,60}m/) and the flat L1C layout
    (GRANULE/*/IMG_DATA/); .npy stand-ins are accepted anywhere."""
    out: Dict[str, str] = {}
    pats = [os.path.join(safe_dir, "GRANULE", "*", "IMG_DATA", resolution,
                         "*"),
            os.path.join(safe_dir, "GRANULE", "*", "IMG_DATA", "*")]
    for pat in pats:
        for path in sorted(glob.glob(pat)):
            if not path.endswith((".jp2", ".npy", ".tif")):
                continue
            m = re.search(r"_(B\d[\dA]|SCL|CLDPRB|TCI|AOT|WVP)",
                          os.path.basename(path))
            if m and m.group(1) not in out:
                out[m.group(1)] = path
        if out:
            break
    return out


def rescale(data: np.ndarray, ratio: float, method: str = "area"
            ) -> np.ndarray:
    """Rescale a (bands, H, W) stack (reference sentinel_rescale,
    sentinel.py:619-647, cv2-free):

    - ratio < 1 (downscale): 'area' = exact block mean (cv2.INTER_AREA for
      integer factors), 'nearest' = subsampling.
    - ratio > 1 (upscale): 'nearest' repeat, 'cubic' = the Keys cubic kernel
      GDAL/cv2 evaluate (raster_prep.cubic_upsample).
    """
    if ratio == 1:
        return data
    if ratio < 1:
        f = int(round(1 / ratio))
        if abs(1 / ratio - f) > 1e-9:
            raise ValueError(f"only integer downscale factors, got {ratio}")
        b, h, w = data.shape
        if method == "nearest":
            return data[:, ::f, ::f]
        blocks = data[:, :h - h % f, :w - w % f].reshape(
            b, h // f, f, w // f, f)
        return blocks.mean(axis=(2, 4)).astype(
            data.dtype if np.issubdtype(data.dtype, np.floating)
            else np.float32)
    f = int(round(ratio))
    if abs(ratio - f) > 1e-9:
        raise ValueError(f"only integer upscale factors, got {ratio}")
    if method == "cubic":
        return np.stack([cubic_upsample(band, f) for band in data])
    return np.stack([nearest_upsample(band, f) for band in data])


def load_channel(safe_dir: str, resolution: str = "R20m",
                 band: Optional[str] = None) -> np.ndarray:
    """All bands of one resolution folder stacked (bands, H, W), or a single
    ``band`` as (1, H, W) — reference sentinel_load_channel
    (sentinel.py:692-788). Band order follows RES_BANDS / file order."""
    files = find_band_files(safe_dir, resolution)
    if band is not None:
        if band not in files:
            return np.empty((0,))  # reference returns an empty array
        return _read_raster_file(files[band])[None]
    order = [b for b in RES_BANDS.get(resolution, ()) if b in files]
    order = order or [b for b in sorted(files) if b.startswith("B")]
    if not order:
        return np.empty((0,))
    return np.stack([_read_raster_file(files[b]) for b in order])


def load_tile_20m(safe_dir: str, only_20m: bool = True,
                  upscale_method: str = "nearest") -> np.ndarray:
    """Whole tile on the 20 m grid (reference sentinel_load_tile,
    sentinel.py:649-690): R20m bands as-is; with ``only_20m=False`` the
    R10m channel is block-mean downscaled x2 and R60m upscaled x3, then all
    are concatenated along the band axis in (R10m, R20m, R60m) order."""
    if only_20m:
        return load_channel(safe_dir, "R20m")
    parts = []
    r10 = load_channel(safe_dir, "R10m")
    if r10.size:
        parts.append(rescale(r10, 0.5, "area").astype(r10.dtype))
    r20 = load_channel(safe_dir, "R20m")
    if r20.size:
        parts.append(r20)
    r60 = load_channel(safe_dir, "R60m")
    if r60.size:
        parts.append(rescale(r60, 3, upscale_method))
    if not parts:
        return np.empty((0,))
    return np.concatenate(parts, axis=0)


def _gml_polygons(path: str) -> List[List[List[Tuple[float, float]]]]:
    """Polygons (exterior ring first, then any interior/hole rings) from a
    legacy GML mask (MSK_CLOUDS_B00.gml — the pre-04.00-baseline vector
    cloud masks the reference's sentinel_load_mask rasterizes,
    sentinel.py:913-1028). Rings of one gml:Polygon are grouped into one
    entry so the even-odd rasterizer leaves holes unfilled; bare posLists
    outside any Polygon element become single-ring polygons."""
    def _pts(pos):
        vals = [float(v) for v in pos.text.split()]
        dim = int(pos.attrib.get("srsDimension", 2))
        pts = [(vals[i], vals[i + 1]) for i in range(0, len(vals), dim)]
        return pts if len(pts) >= 3 else None

    root = ET.parse(path).getroot()
    polys: List[List[List[Tuple[float, float]]]] = []
    claimed: set = set()
    for poly in root.iter():
        if not poly.tag.endswith("Polygon"):
            continue
        rings: List[List[Tuple[float, float]]] = []
        for boundary in poly:
            is_exterior = boundary.tag.endswith("exterior")
            for pos in boundary.iter():
                if pos.tag.endswith("posList"):
                    claimed.add(id(pos))
                    pts = _pts(pos)
                    if pts:
                        if is_exterior:
                            rings.insert(0, pts)
                        else:
                            rings.append(pts)
        if rings:
            polys.append(rings)
    for pos in root.iter():
        if pos.tag.endswith("posList") and id(pos) not in claimed:
            pts = _pts(pos)
            if pts:
                polys.append([pts])
    return polys


def load_cloud_mask(safe_dir: str, resolution: str = "R20m",
                    kind: str = "CLOUDS", prob_threshold: float = 50.0,
                    ) -> np.ndarray:
    """Boolean cloud (or snow) mask on the requested grid — reference
    sentinel_load_clouds / sentinel_load_mask (sentinel.py:791-1028),
    preferring the modern rasters:

    1. L2A SCL: cloud shadow/medium/high/cirrus (+snow for kind='SNOW')
    2. MSK_CLDPRB raster: probability > ``prob_threshold``
    3. legacy GML vector mask (MSK_CLOUDS_B00.gml): rasterized with
       pixel-center containment against the tile geoposition
    """
    files = find_band_files(safe_dir, resolution)
    if "SCL" in files:
        scl = _read_raster_file(files["SCL"])
        if kind.upper() == "SNOW":
            return scl == 11
        return np.isin(scl, SCL_CLOUD_SNOW[:-1])  # clouds incl. shadows
    if "CLDPRB" in files:
        return _read_raster_file(files["CLDPRB"]) > prob_threshold
    gmls = glob.glob(os.path.join(safe_dir, "GRANULE", "*", "QI_DATA",
                                  "MSK_*.gml"))
    match = [g for g in gmls if kind.upper() in os.path.basename(g).upper()]
    if not match:
        raise FileNotFoundError(
            f"no SCL/CLDPRB/GML {kind} mask in {safe_dir}")
    affine, shape, _ = tile_geoposition(safe_dir, resolution)
    from crop2seg_tpu_torch.gis.vectorize import rasterize_polygons
    # one feature per polygon (exterior + holes): the even-odd scanline in
    # rasterize_polygons keeps interior rings uncloudy
    feats = [{"rings": poly, "value": 1}
             for poly in _gml_polygons(match[0])]
    return rasterize_polygons(feats, shape, affine).astype(bool)


def tile_geoposition(safe_dir: str, resolution: str = "R20m"
                     ) -> Tuple[Affine, Tuple[int, int], int]:
    """(affine, (rows, cols), epsg) of a .SAFE tile from MTD_TL.xml —
    reference sentinel_get_tilebounds (sentinel.py:873-910), which reads the
    granule metadata's geoposition."""
    res = int(resolution.strip("Rm"))
    cands = glob.glob(os.path.join(safe_dir, "GRANULE", "*", "MTD_TL.xml"))
    if not cands:
        raise FileNotFoundError(f"no MTD_TL.xml under {safe_dir}")
    root = ET.parse(cands[0]).getroot()
    epsg = 0
    for el in root.iter():
        if el.tag.endswith("HORIZONTAL_CS_CODE"):
            epsg = int(el.text.split(":")[-1])
    ulx = uly = None
    nrows = ncols = None
    for geo in root.iter():
        if geo.tag.endswith("Geoposition") and \
                geo.attrib.get("resolution") == str(res):
            ulx = float(geo.find("ULX").text)
            uly = float(geo.find("ULY").text)
        if geo.tag.endswith("Size") and \
                geo.attrib.get("resolution") == str(res):
            nrows = int(geo.find("NROWS").text)
            ncols = int(geo.find("NCOLS").text)
    if None in (ulx, uly, nrows, ncols):
        raise ValueError(f"no geoposition for {resolution} in {cands[0]}")
    return (Affine.from_origin(ulx, uly, float(res), float(res)),
            (nrows, ncols), epsg)


def tile_bounds(safe_dir: str, resolution: str = "R20m"
                ) -> Tuple[float, float, float, float]:
    """(left, bottom, right, top) — reference sentinel_get_tilebounds."""
    affine, (rows, cols), _ = tile_geoposition(safe_dir, resolution)
    right, bottom = affine.pixel_to_world(rows, cols)
    return (affine.c, float(bottom), float(right), affine.f)


def crop_by_shape(arr: np.ndarray, affine: Affine,
                  rings: Sequence[Sequence[Tuple[float, float]]],
                  crop: bool = True) -> Tuple[np.ndarray, Affine]:
    """Mask a (bands, H, W) raster to a polygon (zero outside) and
    optionally crop to its bounding box — reference sentinel_crop_shape
    (sentinel.py:1138-1175, rasterio.mask.mask semantics with pixel-center
    containment). Returns (masked array, cropped affine)."""
    from crop2seg_tpu_torch.gis.vectorize import rasterize_polygons

    h, w = arr.shape[-2:]
    mask = rasterize_polygons([{"rings": list(rings), "value": 1}],
                              (h, w), affine).astype(bool)
    out = np.where(mask[None] if arr.ndim == 3 else mask, arr, 0)
    if not crop:
        return out, affine
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        return out[..., :0, :0], affine
    r0, r1 = np.argmax(rows), h - np.argmax(rows[::-1])
    c0, c1 = np.argmax(cols), w - np.argmax(cols[::-1])
    x0, y0 = affine.pixel_to_world(r0, c0)
    new = Affine(affine.a, affine.b, float(x0),
                 affine.d, affine.e, float(y0))
    return out[..., r0:r1, c0:c1], new


def write_band_stack(path: str, stack: np.ndarray, affine: Affine,
                     crs: int, nodata: float = 0.0) -> str:
    """(bands, H, W) -> GeoTIFF (rasterio) or .npz sidecar — reference
    export_to_geotif / merge_bands (sentinel.py:1178-1341)."""
    try:
        import rasterio
        from rasterio.transform import Affine as RioAffine
        with rasterio.open(
                path, "w", driver="GTiff", height=stack.shape[1],
                width=stack.shape[2], count=stack.shape[0],
                dtype=str(stack.dtype), crs=f"EPSG:{crs}",
                transform=RioAffine(*affine.to_tuple()),
                nodata=nodata) as dst:
            dst.write(stack)
        return path
    except ImportError:
        alt = os.path.splitext(path)[0] + ".npz"
        np.savez_compressed(alt, data=stack, crs=crs, nodata=nodata,
                            affine=np.asarray(affine.to_tuple()))
        return alt


def merge_bands(safe_dir: str, out_path: str, resolution: str = "R20m"
                ) -> str:
    """Stack one resolution's bands into a georeferenced file — reference
    merge_bands (sentinel.py:1259-1299)."""
    stack = load_channel(safe_dir, resolution)
    affine, _, epsg = tile_geoposition(safe_dir, resolution)
    return write_band_stack(out_path, stack, affine, epsg)


S2_CYCLE_DAYS = 10.0  # one Sentinel-2 repeat cycle = 143 orbits


def sentinel2_overpasses(aoi: Tuple[float, ...] = (19.59, 49.90, 20.33,
                                                   50.21),
                         days_after: int = 7, session=None,
                         api_key: Optional[str] = None,
                         now: Optional[datetime] = None,
                         export_csv: Optional[str] = None) -> List[Dict]:
    """Predicted Sentinel-2A/B overpasses over an AOI — reference
    sentinel2_overpasses (sentinel.py:1342-1428): queries the spectator.earth
    overpass API (via an injectable ``session`` with a ``.get(url)``
    returning ``.json()``) for the first repeat cycle, then replicates the
    timeline by the 10-day cycle out to ``days_after`` and de-duplicates.

    aoi: (lon, lat) point or (left, bottom, right, top) box.
    Returns a date-sorted list of {'date', 'satellite', 'acquisition',
    'longitude', 'latitude'} dicts (acquisition is None on replicated
    cycles — it is only known for the queried window)."""
    if session is None:
        raise RuntimeError(
            "sentinel2_overpasses needs an HTTP session (zero-egress "
            "environments must inject a stub)")
    if len(aoi) == 4:
        geometry = (f"POLYGON(({aoi[0]} {aoi[1]},{aoi[2]} {aoi[1]},"
                    f"{aoi[2]} {aoi[3]},{aoi[0]} {aoi[3]},{aoi[0]} {aoi[1]}))")
    elif len(aoi) == 2:
        geometry = f"POINT({aoi[0]} {aoi[1]})"
    else:
        raise ValueError("aoi must be (lon, lat) or a 4-tuple bbox")
    url = ("https://api.spectator.earth/overpass/?api_key={}"
           "&geometry={}&satellites=Sentinel-2A,Sentinel-2B"
           "&days_after={}&days_before=0").format(
               api_key or "", geometry, min(days_after, 10))
    rows = []
    for o in session.get(url).json().get("overpasses", []):
        rows.append({
            "date": datetime.strptime(o["date"], "%Y-%m-%dT%H:%M:%SZ"),
            "satellite": o["satellite"],
            "acquisition": o.get("acquisition"),
            "longitude": o["geometry"]["coordinates"][0],
            "latitude": o["geometry"]["coordinates"][1]})
    now = now or datetime.now()
    horizon = now + timedelta(days=days_after)
    out = list(rows)
    for cycle in range(1, math.ceil(days_after / S2_CYCLE_DAYS)):
        for r in rows:
            out.append({**r, "acquisition": None,
                        "date": r["date"] + timedelta(
                            days=S2_CYCLE_DAYS * cycle)})
    seen = set()
    final = []
    for r in sorted(out, key=lambda r: r["date"]):
        if r["date"] in seen or r["date"] > horizon:
            continue
        seen.add(r["date"])
        final.append(r)
    if export_csv:
        with open(export_csv, "w") as fh:
            fh.write("date,satellite,acquisition,longitude,latitude\n")
            for r in final:
                fh.write("{},{},{},{},{}\n".format(
                    r["date"].isoformat(), r["satellite"],
                    r["acquisition"] if r["acquisition"] is not None else "",
                    r["longitude"], r["latitude"]))
    return final
