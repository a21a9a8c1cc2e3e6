"""Geodesy + patch-grid bookkeeping helpers.

Re-design of reference src/helpers/utils.py:22-123:
- ``utm_to_wgs84`` / ``wgs84_to_utm``: closed-form Transverse Mercator
  (Karney-style series, sub-cm for UTM use) replacing the reference's pyproj
  dependency (an optional package).
- ``get_row_col`` / ``get_subtile_id``: bookkeeping on the 82x82 patch grid
  used by the dataset splits and the webapp's 10x10 sub-cell picker.
LPIS acquisition (reference webapp/get_data.py:113-173) lives here too.
"""
from __future__ import annotations

import logging
import math
import os
import zipfile
from typing import Tuple

import numpy as np

# WGS84 ellipsoid
_A = 6378137.0
_F = 1 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2 - _F)
_EP2 = _E2 / (1 - _E2)


def _maybe_scalar(scalar_in: bool, *arrs):
    if scalar_in:
        return tuple(float(a) for a in arrs)
    return arrs


def wgs84_to_utm(lon, lat, zone: int):
    """(lon, lat) degrees -> (easting, northing) in the given UTM zone
    (northern hemisphere). Vectorized over numpy arrays; scalars in ->
    floats out (raster_reproject feeds ~1e6 destination pixels at once,
    so the math must stay elementwise-numpy, not per-point Python)."""
    scalar_in = np.ndim(lon) == 0 and np.ndim(lat) == 0
    lon0 = math.radians(zone * 6 - 183)
    phi = np.radians(np.asarray(lat, np.float64))
    lam = np.radians(np.asarray(lon, np.float64)) - lon0
    n = _A / np.sqrt(1 - _E2 * np.sin(phi) ** 2)
    t = np.tan(phi) ** 2
    c = _EP2 * np.cos(phi) ** 2
    a = np.cos(phi) * lam
    m = _A * ((1 - _E2 / 4 - 3 * _E2 ** 2 / 64 - 5 * _E2 ** 3 / 256) * phi
              - (3 * _E2 / 8 + 3 * _E2 ** 2 / 32 + 45 * _E2 ** 3 / 1024)
              * np.sin(2 * phi)
              + (15 * _E2 ** 2 / 256 + 45 * _E2 ** 3 / 1024) * np.sin(4 * phi)
              - (35 * _E2 ** 3 / 3072) * np.sin(6 * phi))
    east = _K0 * n * (a + (1 - t + c) * a ** 3 / 6
                      + (5 - 18 * t + t ** 2 + 72 * c - 58 * _EP2)
                      * a ** 5 / 120) + 500000.0
    north = _K0 * (m + n * np.tan(phi) * (
        a ** 2 / 2 + (5 - t + 9 * c + 4 * c ** 2) * a ** 4 / 24
        + (61 - 58 * t + t ** 2 + 600 * c - 330 * _EP2) * a ** 6 / 720))
    return _maybe_scalar(scalar_in, east, north)


def utm_to_wgs84(east, north, zone: int):
    """(easting, northing) northern-hemisphere UTM -> (lon, lat) degrees.
    Vectorized over numpy arrays; scalars in -> floats out."""
    scalar_in = np.ndim(east) == 0 and np.ndim(north) == 0
    x = np.asarray(east, np.float64) - 500000.0
    m = np.asarray(north, np.float64) / _K0
    mu = m / (_A * (1 - _E2 / 4 - 3 * _E2 ** 2 / 64 - 5 * _E2 ** 3 / 256))
    e1 = (1 - math.sqrt(1 - _E2)) / (1 + math.sqrt(1 - _E2))
    phi1 = (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu)
            + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu)
            + (151 * e1 ** 3 / 96) * np.sin(6 * mu)
            + (1097 * e1 ** 4 / 512) * np.sin(8 * mu))
    n1 = _A / np.sqrt(1 - _E2 * np.sin(phi1) ** 2)
    r1 = _A * (1 - _E2) / (1 - _E2 * np.sin(phi1) ** 2) ** 1.5
    t1 = np.tan(phi1) ** 2
    c1 = _EP2 * np.cos(phi1) ** 2
    d = x / (n1 * _K0)
    phi = phi1 - (n1 * np.tan(phi1) / r1) * (
        d ** 2 / 2 - (5 + 3 * t1 + 10 * c1 - 4 * c1 ** 2 - 9 * _EP2)
        * d ** 4 / 24
        + (61 + 90 * t1 + 298 * c1 + 45 * t1 ** 2 - 252 * _EP2 - 3 * c1 ** 2)
        * d ** 6 / 720)
    lam = (d - (1 + 2 * t1 + c1) * d ** 3 / 6
           + (5 - 2 * c1 + 28 * t1 - 3 * c1 ** 2 + 8 * _EP2 + 24 * t1 ** 2)
           * d ** 5 / 120) / np.cos(phi1)
    lon0 = zone * 6 - 183
    return _maybe_scalar(scalar_in, lon0 + np.degrees(lam), np.degrees(phi))


# --- Krovak / S-JTSK (EPSG:5514) ------------------------------------------
# The Czech LPIS parcel shapefiles ship in S-JTSK / Krovak East North; the
# reference reprojects them to the tile's UTM CRS before homogenization
# (reference crop2seg.py:341-371). Pure-math implementation of EPSG
# method 9819 (Krovak oblique conformal conic, Bessel 1841) + the standard
# S-JTSK<->WGS84 7-parameter Helmert shift (the proj +towgs84 values
# 570.8,85.7,462.8,4.998",1.587",5.261",3.56ppm; ~1 m accuracy — far below
# the 10 m pixel).
_BESSEL_A = 6377397.155
_BESSEL_F = 1 / 299.1528128
_BESSEL_E2 = _BESSEL_F * (2 - _BESSEL_F)
_BESSEL_E = math.sqrt(_BESSEL_E2)

_KROVAK_PHI_C = math.radians(49.5)                 # projection centre lat
_KROVAK_LAM0 = math.radians(24 + 50 / 60)          # origin lon (Greenwich)
_KROVAK_ALPHA = math.radians(30 + 17 / 60 + 17.3031 / 3600)  # cone azimuth
_KROVAK_PHI_P = math.radians(78.5)                 # pseudo-standard parallel
_KROVAK_K = 0.9999

_KB = math.sqrt(1 + _BESSEL_E2 * math.cos(_KROVAK_PHI_C) ** 4
                / (1 - _BESSEL_E2))
_KA = (_BESSEL_A * math.sqrt(1 - _BESSEL_E2)
       / (1 - _BESSEL_E2 * math.sin(_KROVAK_PHI_C) ** 2))
_KGAMMA0 = math.asin(math.sin(_KROVAK_PHI_C) / _KB)
_KT0 = (math.tan(math.pi / 4 + _KGAMMA0 / 2)
        * ((1 + _BESSEL_E * math.sin(_KROVAK_PHI_C))
           / (1 - _BESSEL_E * math.sin(_KROVAK_PHI_C)))
        ** (_BESSEL_E * _KB / 2)
        / math.tan(math.pi / 4 + _KROVAK_PHI_C / 2) ** _KB)
_KN = math.sin(_KROVAK_PHI_P)
_KR0 = _KROVAK_K * _KA / math.tan(_KROVAK_PHI_P)

# S-JTSK -> WGS84 position-vector Helmert (tx, ty, tz [m], rx, ry, rz ["],
# ds [ppm]); the proj/EPSG standard values for the Czech Republic.
_SJTSK_TO_WGS84 = (570.8, 85.7, 462.8, 4.998, 1.587, 5.261, 3.56)


def _geodetic_to_geocentric(lon, lat, a, e2):
    lon, lat = np.radians(np.asarray(lon, np.float64)), \
        np.radians(np.asarray(lat, np.float64))
    n = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = n * np.cos(lat) * np.cos(lon)
    y = n * np.cos(lat) * np.sin(lon)
    z = n * (1 - e2) * np.sin(lat)
    return x, y, z


def _geocentric_to_geodetic(x, y, z, a, e2):
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(6):  # converges to < 1e-12 rad in 3-4 iterations
        n = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        lat = np.arctan2(z + e2 * n * np.sin(lat), p)
    return np.degrees(lon), np.degrees(lat)


def _helmert(x, y, z, params, inverse=False):
    tx, ty, tz, rx, ry, rz, ds = params
    rx, ry, rz = (math.radians(v / 3600) for v in (rx, ry, rz))
    s = 1 + ds * 1e-6
    if not inverse:
        x2 = tx + s * (x - rz * y + ry * z)
        y2 = ty + s * (rz * x + y - rx * z)
        z2 = tz + s * (-ry * x + rx * y + z)
        return x2, y2, z2
    # exact-enough inverse for small rotations: reverse the forward
    xs, ys, zs = (x - tx) / s, (y - ty) / s, (z - tz) / s
    x1 = xs + rz * ys - ry * zs
    y1 = -rz * xs + ys + rx * zs
    z1 = ry * xs - rx * ys + zs
    return x1, y1, z1


def wgs84_to_sjtsk_geodetic(lon, lat):
    """WGS84 (lon, lat) -> S-JTSK datum (lon, lat) on Bessel 1841."""
    x, y, z = _geodetic_to_geocentric(lon, lat, _A, _E2)
    x, y, z = _helmert(x, y, z, _SJTSK_TO_WGS84, inverse=True)
    return _geocentric_to_geodetic(x, y, z, _BESSEL_A, _BESSEL_E2)


def sjtsk_geodetic_to_wgs84(lon, lat):
    x, y, z = _geodetic_to_geocentric(lon, lat, _BESSEL_A, _BESSEL_E2)
    x, y, z = _helmert(x, y, z, _SJTSK_TO_WGS84, inverse=False)
    return _geocentric_to_geodetic(x, y, z, _A, _E2)


def krovak_forward(lon, lat):
    """Bessel-datum geodetic (lon, lat, degrees, Greenwich) -> EPSG:5514
    easting/northing (negative westing/southing). EPSG method 9819."""
    lon = np.radians(np.asarray(lon, np.float64))
    lat = np.radians(np.asarray(lat, np.float64))
    e = _BESSEL_E
    u = 2 * (np.arctan(
        _KT0 * np.tan(lat / 2 + math.pi / 4) ** _KB
        / ((1 + e * np.sin(lat)) / (1 - e * np.sin(lat))) ** (e * _KB / 2))
        - math.pi / 4)
    v = _KB * (_KROVAK_LAM0 - lon)
    t = np.arcsin(np.cos(_KROVAK_ALPHA) * np.sin(u)
                  + np.sin(_KROVAK_ALPHA) * np.cos(u) * np.cos(v))
    d = np.arcsin(np.cos(u) * np.sin(v) / np.cos(t))
    theta = _KN * d
    r = (_KR0 * math.tan(math.pi / 4 + _KROVAK_PHI_P / 2) ** _KN
         / np.tan(t / 2 + math.pi / 4) ** _KN)
    southing = r * np.cos(theta)
    westing = r * np.sin(theta)
    return -westing, -southing  # EPSG:5514 (east, north)


def krovak_inverse(x, y):
    """EPSG:5514 (easting, northing) -> Bessel-datum geodetic (lon, lat)."""
    westing = -np.asarray(x, np.float64)
    southing = -np.asarray(y, np.float64)
    e = _BESSEL_E
    r = np.hypot(westing, southing)
    theta = np.arctan2(westing, southing)
    d = theta / _KN
    t = 2 * (np.arctan(
        (_KR0 / r) ** (1 / _KN) * math.tan(math.pi / 4 + _KROVAK_PHI_P / 2))
        - math.pi / 4)
    u = np.arcsin(np.cos(_KROVAK_ALPHA) * np.sin(t)
                  - np.sin(_KROVAK_ALPHA) * np.cos(t) * np.cos(d))
    v = np.arcsin(np.cos(t) * np.sin(d) / np.cos(u))
    lon = _KROVAK_LAM0 - v / _KB
    lat = u
    for _ in range(6):
        lat = 2 * (np.arctan(
            _KT0 ** (-1 / _KB) * np.tan(u / 2 + math.pi / 4) ** (1 / _KB)
            * ((1 + e * np.sin(lat)) / (1 - e * np.sin(lat))) ** (e / 2))
            - math.pi / 4)
    return np.degrees(lon), np.degrees(lat)


def sjtsk_to_wgs84(x, y):
    """EPSG:5514 -> WGS84 (lon, lat)."""
    lon_b, lat_b = krovak_inverse(x, y)
    return sjtsk_geodetic_to_wgs84(lon_b, lat_b)


def wgs84_to_sjtsk(lon, lat):
    """WGS84 (lon, lat) -> EPSG:5514."""
    lon_b, lat_b = wgs84_to_sjtsk_geodetic(lon, lat)
    return krovak_forward(lon_b, lat_b)


def transform_coords(x, y, src_epsg: int, dst_epsg: int):
    """Transform coordinate arrays between the CRSs this stack uses:
    4326 (WGS84 lon/lat), 326xx (UTM north), 5514 (S-JTSK / Krovak EN).
    Replaces the reference's pyproj usage for LPIS overlays
    (reference crop2seg.py:341-371)."""
    if src_epsg == dst_epsg:
        # honor the scalars-in-floats-out contract of the transform path
        # below (a 0-d ndarray here breaks JSON serialization of metadata)
        if np.isscalar(x) or np.ndim(x) == 0:
            return float(x), float(y)
        return np.asarray(x, np.float64), np.asarray(y, np.float64)

    def to_wgs(x, y, epsg):
        if epsg == 4326:
            return np.asarray(x, np.float64), np.asarray(y, np.float64)
        if epsg == 5514:
            return sjtsk_to_wgs84(x, y)
        if 32601 <= epsg <= 32660:
            return utm_to_wgs84(np.asarray(x, np.float64),
                                np.asarray(y, np.float64), epsg - 32600)
        raise ValueError(f"unsupported CRS EPSG:{epsg}")

    def from_wgs(lon, lat, epsg):
        if epsg == 4326:
            return lon, lat
        if epsg == 5514:
            return wgs84_to_sjtsk(lon, lat)
        if 32601 <= epsg <= 32660:
            return wgs84_to_utm(np.asarray(lon, np.float64),
                                np.asarray(lat, np.float64), epsg - 32600)
        raise ValueError(f"unsupported CRS EPSG:{epsg}")

    lon, lat = to_wgs(x, y, src_epsg)
    out_x, out_y = from_wgs(lon, lat, dst_epsg)
    if np.isscalar(x) or np.ndim(x) == 0:
        return float(np.asarray(out_x).reshape(())), \
            float(np.asarray(out_y).reshape(()))
    return np.asarray(out_x, np.float64), np.asarray(out_y, np.float64)


def get_row_col(patch_id_within_tile: int, grid: int = 82) -> Tuple[int, int]:
    """Local patch id -> (row, col) on the tile's patch grid
    (reference helpers/utils.py:71-83)."""
    return patch_id_within_tile // grid, patch_id_within_tile % grid


def get_subtile_id(patch_id_within_tile: int, grid: int = 82,
                   parts: int = 10) -> int:
    """Local patch id -> 10x10 webapp sub-cell index
    (reference helpers/utils.py:86-123 with parts=11 -> 100 cells)."""
    r, c = get_row_col(patch_id_within_tile, grid)
    cell = grid / parts
    return min(int(r / cell), parts - 1) * parts + min(int(c / cell), parts - 1)


def get_lpis(year: int, cache_dir: str, session=None,
             url_template: str = ("https://eagri.cz/public/app/eagriapp/lpisdata/"
                                  "{year}1231-CR-DPB-SHP.zip")) -> str:
    """Download + unzip the yearly Czech LPIS parcel shapefile
    (reference webapp/get_data.py:113-173). Returns the .shp path."""
    os.makedirs(cache_dir, exist_ok=True)
    name = f"{year}1231-CR-DPB-SHP"
    shp = os.path.join(cache_dir, name + ".shp")
    if os.path.exists(shp):
        return shp
    if session is None:
        import requests
        session = requests.Session()
    url = url_template.format(year=year)
    logging.info("downloading LPIS %s", url)
    zpath = os.path.join(cache_dir, name + ".zip")
    with session.get(url, stream=True) as r:
        r.raise_for_status()
        with open(zpath, "wb") as f:
            for chunk in r.iter_content(chunk_size=1 << 20):
                f.write(chunk)
    with zipfile.ZipFile(zpath) as zf:
        zf.extractall(cache_dir)
    return shp


def rasterize_lpis(shp_path: str, shape: Tuple[int, int], affine,
                   value_column: str = "value", src_epsg: int = 5514,
                   dst_epsg: int = 32633) -> np.ndarray:
    """Rasterize LPIS parcels onto the prediction grid (pure python:
    shapefile reader + Krovak->UTM reprojection + scanline rasterizer),
    replacing the reference's geopandas/rasterio path
    (dataset_creator.py:687-723, crop2seg.py:341-371).

    Parcels without ``value_column`` get sequential ids >= 1 (a parcel-id
    map for homogenize_raster)."""
    from crop2seg_tpu_torch.gis.vectorize import rasterize_polygons, read_shapefile

    feats = read_shapefile(shp_path)
    out_feats = []
    next_id = 1
    for f in feats:
        rings = f.get("rings")
        if not rings:
            continue
        new_rings = []
        for ring in rings:
            xs = np.asarray([p[0] for p in ring], np.float64)
            ys = np.asarray([p[1] for p in ring], np.float64)
            if src_epsg != dst_epsg:
                xs, ys = transform_coords(xs, ys, src_epsg, dst_epsg)
            new_rings.append(list(zip(xs.tolist(), ys.tolist())))
        value = f.get(value_column)
        if value is None:
            value, next_id = next_id, next_id + 1
        out_feats.append({"rings": new_rings, "value": int(value)})
    return rasterize_polygons(out_feats, shape, affine)
