"""Raster segments -> vector polygons + dependency-free writers.

Completes the reference's vector tail (prediction2polygon_layer + shapefile
export, reference src/helpers/postprocess.py:86-120 and the webapp's
shapefile caches) without GDAL: exact pixel-boundary polygons are traced by
crack following on the segment raster, then written as GeoJSON or as a
minimal ESRI Shapefile (.shp/.shx/.dbf, polygon type 5).

Coordinates are pixel corners mapped through an optional Affine, so the
polygons reproduce rasterio.features.shapes' geometry exactly.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from crop2seg_tpu_torch.gis.raster import Affine

Ring = List[Tuple[float, float]]


def _mask_rings(mask: np.ndarray) -> List[Ring]:
    """All boundary rings (outer + holes) of a binary mask, as pixel-corner
    coordinates (row, col). Crack-following: directed edges keep the interior
    on the LEFT, so outer rings come out counter-clockwise in (row, col)
    raster space and holes clockwise."""
    h, w = mask.shape
    pad = np.zeros((h + 2, w + 2), bool)
    pad[1:-1, 1:-1] = mask
    # directed edges: for each interior cell, emit edges on sides that face
    # outside; orientation keeps interior on the left.
    edges: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}

    def add(a, b):
        edges.setdefault(a, []).append(b)

    rs, cs = np.nonzero(pad)
    for r, c in zip(rs, cs):
        if not pad[r - 1, c]:   # open above: edge left->right along top
            add((r - 1, c - 1), (r - 1, c))
        if not pad[r + 1, c]:   # open below: edge right->left along bottom
            add((r, c), (r, c - 1))
        if not pad[r, c - 1]:   # open left: edge bottom->top along left side
            add((r, c - 1), (r - 1, c - 1))
        if not pad[r, c + 1]:   # open right: edge top->bottom along right
            add((r - 1, c), (r, c))

    rings: List[Ring] = []
    while edges:
        start = next(iter(edges))
        ring = [start]
        prev = None
        cur = start
        while True:
            outs = edges[cur]
            if len(outs) == 1:
                nxt = outs.pop()
            else:
                # corner with two choices: prefer the left turn relative to
                # the incoming direction (keeps rings separated at pinch
                # points)
                d = (cur[0] - prev[0], cur[1] - prev[1])
                left = (cur[0] - d[1], cur[1] + d[0])
                nxt = left if left in outs else outs[0]
                outs.remove(nxt)
            if not outs:
                del edges[cur]
            ring.append(nxt)
            prev, cur = cur, nxt
            if cur == start:
                break
        # collapse collinear points
        out: Ring = []
        for p in ring:
            if len(out) >= 2 and (
                    (out[-1][0] - out[-2][0]) * (p[1] - out[-1][1])
                    == (out[-1][1] - out[-2][1]) * (p[0] - out[-1][0])):
                out[-1] = p
            else:
                out.append(p)
        if len(out) >= 2 and out[0] == out[-1] and len(out) >= 4 and (
                (out[1][0] - out[0][0]) * (out[-1][1] - out[-2][1])
                == (out[1][1] - out[0][1]) * (out[-1][0] - out[-2][0])):
            out = out[1:-1] + [out[1]]
        rings.append(out)
    return rings


def _to_world(ring: Ring, affine: Optional[Affine]) -> Ring:
    if affine is None:
        return [(float(c), float(r)) for r, c in ring]  # (x=col, y=row)
    rr = np.asarray([p[0] for p in ring], np.float64)
    cc = np.asarray([p[1] for p in ring], np.float64)
    xs, ys = affine.pixel_to_world(rr, cc)
    return list(zip(np.asarray(xs).tolist(), np.asarray(ys).tolist()))


def segments_to_polygons(segments: np.ndarray, seg_class: np.ndarray,
                         affine: Optional[Affine] = None,
                         skip_background: bool = True) -> List[Dict]:
    """Segment raster (from gis.postprocess.polygonize) -> list of
    {'value', 'segment', 'rings'} features; rings[0] is the outer boundary.
    """
    from scipy import ndimage

    feats = []
    # one-pass bounding boxes: avoids O(n_segments * area) full scans
    boxes = ndimage.find_objects(segments)
    for seg_id, box in enumerate(boxes, start=1):
        if box is None:
            continue
        value = int(seg_class[seg_id])
        if skip_background and value == 0:
            continue
        r0, c0 = box[0].start, box[1].start
        sub = segments[box] == seg_id
        if sub.shape == (1, 1):
            # fast path: single-pixel segment (dominant for noisy rasters);
            # same orientation _mask_rings would trace.
            rings = [[(0, 0), (0, 1), (1, 1), (1, 0), (0, 0)]]
        else:
            rings = _mask_rings(sub)
        rings = [[(r + r0, c + c0) for r, c in ring] for ring in rings]
        feats.append({
            "value": value, "segment": seg_id,
            "rings": [_to_world(ring, affine) for ring in rings],
        })
    return feats


def polygons_to_geojson(features: List[Dict], path: Optional[str] = None,
                        crs: Optional[int] = None) -> Dict:
    out = {
        "type": "FeatureCollection",
        "features": [{
            "type": "Feature",
            "properties": {"value": f["value"], "segment": f["segment"]},
            "geometry": {"type": "Polygon",
                         "coordinates": [[list(p) for p in ring]
                                         for ring in f["rings"]]},
        } for f in features],
    }
    if crs is not None:
        out["crs"] = {"type": "name",
                      "properties": {"name": f"EPSG:{crs}"}}
    if path:
        with open(path, "w") as fh:
            json.dump(out, fh)
    return out


def read_shapefile(path: str) -> List[Dict]:
    """Minimal ESRI Shapefile reader: polygons (type 5), points (1) and
    polylines (3), plus .dbf attributes (C/N/F fields). Dependency-free
    counterpart of geopandas.read_file as used for LPIS parcels
    (reference src/helpers/postprocess.py:398-404).

    Returns a list of features: {'rings': [[(x, y), ...], ...]} for polygons
    ('points' for the other types) merged with the record's DBF attributes.
    """
    base = os.path.splitext(path)[0]
    feats: List[Dict] = []
    with open(base + ".shp", "rb") as fh:
        data = fh.read()
    pos = 100  # skip file header
    while pos < len(data):
        (_, length) = struct.unpack(">2i", data[pos:pos + 8])
        rec = data[pos + 8:pos + 8 + length * 2]
        pos += 8 + length * 2
        (shape_type,) = struct.unpack("<i", rec[:4])
        if shape_type == 0:  # null shape
            feats.append({"rings": []})
        elif shape_type == 1:  # point
            x, y = struct.unpack("<2d", rec[4:20])
            feats.append({"points": [(x, y)]})
        elif shape_type in (3, 5):  # polyline / polygon
            n_parts, n_points = struct.unpack("<2i", rec[36:44])
            parts = struct.unpack(f"<{n_parts}i", rec[44:44 + 4 * n_parts])
            pts_off = 44 + 4 * n_parts
            flat = struct.unpack(f"<{2 * n_points}d",
                                 rec[pts_off:pts_off + 16 * n_points])
            pts = list(zip(flat[0::2], flat[1::2]))
            bounds = list(parts) + [n_points]
            rings = [pts[bounds[i]:bounds[i + 1]] for i in range(n_parts)]
            feats.append({"rings": rings} if shape_type == 5
                         else {"points": pts})
        else:
            raise ValueError(f"unsupported shape type {shape_type}")

    dbf_path = base + ".dbf"
    if os.path.exists(dbf_path):
        with open(dbf_path, "rb") as fh:
            dbf = fh.read()
        n_rec, hdr_len, rec_len = struct.unpack("<IHH", dbf[4:12])
        fields = []
        p = 32
        while dbf[p] != 0x0D:
            name = dbf[p:p + 11].split(b"\x00")[0].decode("ascii",
                                                          "replace")
            ftype = chr(dbf[p + 11])
            flen = dbf[p + 16]
            fields.append((name, ftype, flen))
            p += 32
        p = hdr_len
        for i in range(min(n_rec, len(feats))):
            rec = dbf[p:p + rec_len]
            p += rec_len
            off = 1  # deletion flag
            for name, ftype, flen in fields:
                raw = rec[off:off + flen]
                off += flen
                txt = raw.decode("latin-1").strip()
                if ftype in ("N", "F") and txt:
                    feats[i][name] = float(txt) if ("." in txt or "e" in txt
                                                    ) else int(txt)
                else:
                    feats[i][name] = txt
    return feats


def rasterize_polygons(features: Sequence[Dict], shape: Tuple[int, int],
                       affine: Optional[Affine] = None,
                       value_key: str = "value", fill: int = 0,
                       dtype=np.int32) -> np.ndarray:
    """Burn polygon features onto a raster grid — pure-python counterpart of
    rasterio.features.rasterize as the reference uses it for LPIS parcels
    (reference src/helpers/dataset_creator.py:687-723).

    GDAL semantics: a pixel is burned when its CENTER is inside the polygon
    (even-odd rule, holes supported); later features overwrite earlier ones.
    """
    out = np.full(shape, fill, dtype)
    h, w = shape
    for f in features:
        rings = f.get("rings") or []
        if not rings:
            continue
        value = f.get(value_key, 1)
        # world -> pixel-coordinate edges
        edges = []  # (r0, c0, r1, c1)
        for ring in rings:
            xs = np.asarray([p[0] for p in ring], np.float64)
            ys = np.asarray([p[1] for p in ring], np.float64)
            if affine is not None:
                rr, cc = affine.world_to_pixel(xs, ys)
            else:
                rr, cc = ys, xs
            if rr[0] != rr[-1] or cc[0] != cc[-1]:
                rr = np.append(rr, rr[0])
                cc = np.append(cc, cc[0])
            edges.append((rr[:-1], cc[:-1], rr[1:], cc[1:]))
        r0 = np.concatenate([e[0] for e in edges])
        c0 = np.concatenate([e[1] for e in edges])
        r1 = np.concatenate([e[2] for e in edges])
        c1 = np.concatenate([e[3] for e in edges])
        row_lo = max(int(np.floor(min(r0.min(), r1.min()))), 0)
        row_hi = min(int(np.ceil(max(r0.max(), r1.max()))) + 1, h)
        for row in range(row_lo, row_hi):
            yc = row + 0.5  # pixel-center scanline
            # half-open rule [min, max) avoids double-counting vertices
            crosses = ((r0 <= yc) & (r1 > yc)) | ((r1 <= yc) & (r0 > yc))
            if not crosses.any():
                continue
            tt = (yc - r0[crosses]) / (r1[crosses] - r0[crosses])
            xs = np.sort(c0[crosses] + tt * (c1[crosses] - c0[crosses]))
            for lo, hi in zip(xs[0::2], xs[1::2]):
                a = max(int(np.ceil(lo - 0.5)), 0)
                b = min(int(np.ceil(hi - 0.5)), w)
                if b > a:
                    out[row, a:b] = value
    return out


def prediction_to_points(prediction: np.ndarray,
                         affine: Optional[Affine] = None,
                         stride: int = 1,
                         proba: Optional[np.ndarray] = None
                         ) -> Dict[str, np.ndarray]:
    """Per-pixel point layer of a prediction — the point-vector counterpart
    of ``segments_to_polygons`` (reference ``prediction2point_layer``,
    reference src/helpers/postprocess.py:123-172).

    ``prediction`` is either an (H, W) integer class map or an (H, W, K)
    probability stack (channels-last, this repo's layout; the reference
    takes (K, H, W)). Points sit at pixel CENTERS (the reference goes
    through ``rasterio.transform.xy`` whose default offset is 'center').

    Returns a columnar dict of arrays instead of 1.2M per-point dicts
    (a whole 1098^2 tile is ~1.2M points; the reference builds a
    GeoDataFrame row per pixel, postprocess.py:160-168):
    {'x', 'y', 'value'} plus 'proba' (N, K) when probabilities were given.
    ``stride`` subsamples the grid (stride=1 = every pixel).

    ``proba``: optional (H, W, K) probability stack gathered alongside a 2-D
    class map on the SAME sample grid (so callers with a separate class band
    — e.g. ``raster_to_points`` — never re-derive the stride grid and risk
    misaligning proba rows with x/y).
    """
    pred = np.asarray(prediction)
    if pred.ndim == 3:
        if proba is not None:
            raise ValueError("pass either a 3-D prediction or proba=, not both")
        proba = pred
        pred = np.argmax(pred, axis=-1)
    elif pred.ndim != 2:
        raise ValueError(
            f"prediction must be 2-D or 3-D, got {pred.ndim}-D")
    rows, cols = np.mgrid[0:pred.shape[0]:stride, 0:pred.shape[1]:stride]
    rows, cols = rows.ravel(), cols.ravel()
    if affine is not None:
        xs, ys = affine.pixel_to_world(rows + 0.5, cols + 0.5)
    else:
        xs, ys = cols + 0.5, rows + 0.5
    out = {"x": np.asarray(xs, np.float64), "y": np.asarray(ys, np.float64),
           "value": pred[rows, cols].astype(np.int64)}
    if proba is not None:
        out["proba"] = np.asarray(proba)[rows, cols]
    return out


def raster_to_points(path: str, stride: int = 1) -> Dict[str, np.ndarray]:
    """Prediction raster on disk -> per-pixel point layer (reference
    ``raster2point_layer``, reference src/helpers/postprocess.py:205-235,
    which round-trips through rioxarray). Reads the class band (+ probability
    bands when present) written by ``gis.raster.save_prediction_raster`` and
    georeferences each pixel center with the stored affine."""
    from crop2seg_tpu_torch.gis.raster import load_prediction_raster

    data, affine, _crs = load_prediction_raster(path)
    # 'value' comes from the stored class band (band 0), NOT argmax of the
    # probability bands: the class band may have been postprocessed (e.g.
    # homogenized via gis.postprocess) before save_prediction_raster, and
    # re-deriving it would silently disagree with the raster.
    # bands 1..K = probabilities, gathered on the same stride grid as x/y
    proba = np.moveaxis(data[1:], 0, -1) if data.shape[0] > 1 else None
    return prediction_to_points(data[0].astype(np.int64), affine, stride,
                                proba=proba)


def write_point_shapefile(path: str, points: Dict[str, np.ndarray]
                          ) -> Tuple[str, str, str]:
    """Minimal ESRI point (type 1) shapefile writer for
    ``prediction_to_points`` output: .shp/.shx plus a .dbf with the numeric
    'value' field (and one float column per class when 'proba' is present,
    named '0'..'K-1' like the reference's GeoDataFrame columns,
    postprocess.py:160-163)."""
    base = os.path.splitext(path)[0]
    xs = np.asarray(points["x"], np.float64)
    ys = np.asarray(points["y"], np.float64)
    values = np.asarray(points["value"])
    proba = points.get("proba")
    n = len(xs)
    if n:
        bbox = (xs.min(), ys.min(), xs.max(), ys.max())
    else:
        bbox = (0.0, 0.0, 0.0, 0.0)

    shp_parts, shx_parts = [], []
    offset = 50  # in 16-bit words
    length = 10  # type-1 record: int + 2 doubles = 20 bytes = 10 words
    for i in range(n):
        shp_parts.append(struct.pack(">2i", i + 1, length))
        shp_parts.append(struct.pack("<i2d", 1, xs[i], ys[i]))
        shx_parts.append(struct.pack(">2i", offset, length))
        offset += 4 + length
    shp_records = b"".join(shp_parts)
    shx_records = b"".join(shx_parts)

    def header(file_words):
        h = struct.pack(">i", 9994) + b"\x00" * 20
        h += struct.pack(">i", file_words)
        h += struct.pack("<2i", 1000, 1)
        h += struct.pack("<4d", *bbox)
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    shp = base + ".shp"
    with open(shp, "wb") as fh:
        fh.write(header(50 + len(shp_records) // 2) + shp_records)
    shx = base + ".shx"
    with open(shx, "wb") as fh:
        fh.write(header(50 + len(shx_records) // 2) + shx_records)

    k = 0 if proba is None else proba.shape[-1]
    fields = (b"value" + b"\x00" * 6 + b"N" + b"\x00" * 4 + bytes([10, 0])
              + b"\x00" * 14)
    for j in range(k):
        fields += (str(j).encode()[:11].ljust(11, b"\x00") + b"F"
                   + b"\x00" * 4 + bytes([12, 6]) + b"\x00" * 14)
    rec_len = 11 + 12 * k
    hdr = struct.pack("<B3BIHH", 0x03, 26, 8, 16, n, 33 + 32 * (1 + k),
                      rec_len) + b"\x00" * 20
    parts = [hdr, fields, b"\x0d"]
    for i in range(n):
        parts.append(b" " + str(int(values[i])).rjust(10).encode())
        for j in range(k):
            parts.append(f"{float(proba[i, j]):12.6f}".encode()[:12])
    parts.append(b"\x1a")
    dbf = base + ".dbf"
    with open(dbf, "wb") as fh:
        fh.write(b"".join(parts))
    return shp, shx, dbf


def write_shapefile(path: str, features: List[Dict],
                    extra_fields: Sequence[Tuple[str, int]] = ()
                    ) -> Tuple[str, str, str]:
    """Minimal ESRI Shapefile writer (polygon type 5) + .shx + .dbf with a
    numeric 'value' field. ESRI wants outer rings clockwise in (x, y);
    rings from the tracer are reversed as needed by signed area.

    ``extra_fields``: [(name, width), ...] additional character (C) columns
    copied from each feature dict (e.g. [("Name", 16)] for tile indexes)."""
    base = os.path.splitext(path)[0]

    def ring_oriented(ring, clockwise):
        area2 = sum((x2 - x1) * (y2 + y1)
                    for (x1, y1), (x2, y2) in zip(ring, ring[1:]))
        is_cw = area2 > 0
        return ring if is_cw == clockwise else ring[::-1]

    records = []
    for f in features:
        rings = [ring_oriented(list(r), clockwise=(i == 0))
                 for i, r in enumerate(f["rings"])]
        rings = [r if r[0] == r[-1] else r + [r[0]] for r in rings]
        pts = [p for r in rings for p in r]
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        bbox = (min(xs), min(ys), max(xs), max(ys))
        parts = []
        off = 0
        for r in rings:
            parts.append(off)
            off += len(r)
        content = struct.pack("<i", 5)
        content += struct.pack("<4d", *bbox)
        content += struct.pack("<2i", len(rings), len(pts))
        content += b"".join(struct.pack("<i", p) for p in parts)
        content += b"".join(struct.pack("<2d", x, y) for x, y in pts)
        records.append((content, bbox, f["value"],
                        [str(f.get(name, ""))[:width]
                         for name, width in extra_fields]))

    if records:
        gxmin = min(r[1][0] for r in records)
        gymin = min(r[1][1] for r in records)
        gxmax = max(r[1][2] for r in records)
        gymax = max(r[1][3] for r in records)
    else:
        gxmin = gymin = gxmax = gymax = 0.0

    # list-append + join: += on bytes is quadratic and a real shapefile can
    # carry 1e5+ records (observed 80+ min for a noise-prediction export).
    shp_parts = []
    shx_parts = []
    offset = 50  # in 16-bit words
    for i, (content, _, _, _) in enumerate(records):
        length = len(content) // 2
        shp_parts.append(struct.pack(">2i", i + 1, length))
        shp_parts.append(content)
        shx_parts.append(struct.pack(">2i", offset, length))
        offset += 4 + length
    shp_records = b"".join(shp_parts)
    shx_records = b"".join(shx_parts)

    def header(file_words):
        h = struct.pack(">i", 9994) + b"\x00" * 20
        h += struct.pack(">i", file_words)
        h += struct.pack("<2i", 1000, 5)
        h += struct.pack("<4d", gxmin, gymin, gxmax, gymax)
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    shp = base + ".shp"
    with open(shp, "wb") as fh:
        fh.write(header(50 + len(shp_records) // 2) + shp_records)
    shx = base + ".shx"
    with open(shx, "wb") as fh:
        fh.write(header(50 + len(shx_records) // 2) + shx_records)

    # minimal dbf: one numeric field 'value' + optional character columns
    dbf = base + ".dbf"
    n = len(records)
    fields = b"value" + b"\x00" * 6 + b"N" + b"\x00" * 4 + bytes([10, 0]) + b"\x00" * 14
    for name, width in extra_fields:
        fields += (name.encode("ascii")[:11].ljust(11, b"\x00") + b"C"
                   + b"\x00" * 4 + bytes([width, 0]) + b"\x00" * 14)
    nf = 1 + len(extra_fields)
    rec_len = 11 + sum(w for _, w in extra_fields)
    hdr = struct.pack("<B3BIHH", 0x03, 26, 8, 16, n, 33 + 32 * nf,
                      rec_len) + b"\x00" * 20
    parts = [hdr, fields, b"\x0d"]
    for _, _, value, extras in records:
        parts.append(b" " + str(int(value)).rjust(10).encode())
        for (name, width), text in zip(extra_fields, extras):
            parts.append(text.encode("latin-1").ljust(width))
    parts.append(b"\x1a")
    body = b"".join(parts)
    with open(dbf, "wb") as fh:
        fh.write(body)
    return shp, shx, dbf
