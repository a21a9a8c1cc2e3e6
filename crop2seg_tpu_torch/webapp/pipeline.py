"""Headless whole-tile crop-map pipeline, the webapp's engine (port of
crop2seg_tpu/webapp/pipeline.py; the model runs in PyTorch on the CUDA card).

- ``get_info``: patch-cell picking on the 10x10 sub-grid of a Sentinel-2
  tile (reference home.py:13-77 + get_data.py:33-69,176-185); the cell is
  1098 px @ 10 m. It and the other grid helpers are copies of the JAX ones.
- ``get_time_series``: acquisition + patchification via CopernicusClient +
  DatasetCreator(for_inference=True) with the retry-with-relaxed-clouds
  policy (reference get_data.py:188-247).
- ``stream_tile_inference``: the 100 patches of a cell from disk to the
  crop map; a producer thread decodes the next chunk with the native C++
  loader while the card runs the current one.
- ``generate_prediction``: the whole cell (reference prediction.py:253-355):
  conf.json, NORM_S2_patch.json and the weights of a model directory, the
  stream, then the raster, polygonize and optional LPIS homogenization.
- ``CacheManager``: cache sizing/cleanup (reference cache_management.py:21-116).

Inference defaults mirror the reference's hard-coded webapp config
(prediction.py:185-211): TimeUNet_v1, 15 classes, ref_date = {year-1}-09-01,
pretrained weights + NORM_S2_patch.json from a model directory.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch


CELL_PX = 1098         # webapp sub-cell edge in 10 m pixels
CELLS_PER_SIDE = 10    # 10x10 = 100 cells per tile (reference parts=11)
TILE_PX = 10980


def tile_cell_bounds(tile_origin_xy: Tuple[float, float], cell_idx: int,
                     res: float = 10.0) -> Tuple[float, float, float, float]:
    """Cell index (0..99, row-major) -> (left, bottom, right, top) in the
    tile CRS; tile_origin_xy is the tile's upper-left corner."""
    r, c = divmod(cell_idx, CELLS_PER_SIDE)
    left = tile_origin_xy[0] + c * CELL_PX * res
    top = tile_origin_xy[1] - r * CELL_PX * res
    return (left, top - CELL_PX * res, left + CELL_PX * res, top)


def cell_from_xy(tile_origin_xy: Tuple[float, float], x: float, y: float,
                 res: float = 10.0) -> int:
    """World coordinates (tile CRS) -> cell index 0..99 — the click->cell
    spatial join of the reference's leafmap picker (home.py:63-77,
    get_data.py:33-69). Inverse of :func:`tile_cell_bounds`; raises
    ValueError outside the 10x10 grid."""
    c = int((x - tile_origin_xy[0]) // (CELL_PX * res))
    r = int((tile_origin_xy[1] - y) // (CELL_PX * res))
    if not (0 <= r < CELLS_PER_SIDE and 0 <= c < CELLS_PER_SIDE):
        raise ValueError(f"point ({x}, {y}) outside the tile's cell grid")
    return r * CELLS_PER_SIDE + c


def cell_grid_figure(tile_name: str, selected: Optional[int] = None,
                     tile_origin_xy: Optional[Tuple[float, float]] = None,
                     index_path: Optional[str] = None):
    """Matplotlib rendering of a tile's 10x10 sub-cell grid in its UTM frame
    with cell indices labeled and the picked cell highlighted — the
    map-view companion of the app's clickable grid (the reference draws the
    same grid as leafmap polygons, home.py:13-77). Returns the Figure."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    if tile_origin_xy is None and index_path is not None:
        tile_origin_xy = tile_origin_from_index(tile_name, index_path)
    if tile_origin_xy is None:
        tile_origin_xy = mgrs_tile_origin(tile_name)
    fig, ax = plt.subplots(figsize=(5.4, 5.4))
    edge = CELL_PX * 10.0
    for idx in range(CELLS_PER_SIDE * CELLS_PER_SIDE):
        left, bottom, _, top = tile_cell_bounds(tile_origin_xy, idx)
        is_sel = idx == selected
        ax.add_patch(Rectangle(
            (left, bottom), edge, edge,
            facecolor="#2a9d8f" if is_sel else "none",
            alpha=0.65 if is_sel else 1.0,
            edgecolor="#264653", linewidth=0.6))
        ax.annotate(str(idx), (left + edge / 2, bottom + edge / 2),
                    ha="center", va="center", fontsize=7,
                    color="white" if is_sel else "#264653")
    ax.set_xlim(tile_origin_xy[0], tile_origin_xy[0] + 10 * edge)
    ax.set_ylim(tile_origin_xy[1] - 10 * edge, tile_origin_xy[1])
    ax.set_aspect("equal")
    ax.set_title(f"{tile_name} — 10x10 cells (1098 px @ 10 m)")
    ax.ticklabel_format(style="plain")
    ax.tick_params(labelsize=7)
    fig.tight_layout()
    return fig


def get_info(tile_name: str, cell_idx: int,
             tile_origin_xy: Optional[Tuple[float, float]] = None,
             index_path: Optional[str] = None) -> Dict:
    """Resolve a picked cell to tile + bounds (reference get_data.py:176-185).

    Origin resolution order: explicit ``tile_origin_xy`` > the authoritative
    Sentinel-2 shapefile index at ``index_path`` (what the reference clones,
    get_data.py:82-110) > the MGRS 100-km grid-square corner approximation
    (documented in :func:`mgrs_tile_origin`)."""
    if tile_origin_xy is None and index_path is not None:
        tile_origin_xy = tile_origin_from_index(tile_name, index_path)
    if tile_origin_xy is None:
        tile_origin_xy = mgrs_tile_origin(tile_name)
    return {"tile": tile_name, "cell": cell_idx,
            "bounds": tile_cell_bounds(tile_origin_xy, cell_idx),
            "crs": 32600 + int(tile_name[1:3])}


def tile_origin_from_index(tile_name: str, index_path: str
                           ) -> Tuple[float, float]:
    """Authoritative tile upper-left corner from the Sentinel-2 shapefile
    index (justinelliotmeyers/Sentinel-2-Shapefile-Index — the same file the
    reference clones and spatial-joins, get_data.py:82-110, home.py:63-77).

    The index stores WGS84 footprint polygons with a ``Name`` column
    ('33UVR'); the corners are reprojected into the tile's UTM zone with the
    pure-math transform and rounded to whole metres, mirroring the
    reference's ``round(geom.bounds)`` (get_data.py:34)."""
    from crop2seg_tpu_torch.gis.geo import wgs84_to_utm
    from crop2seg_tpu_torch.gis.vectorize import read_shapefile

    name = tile_name.lstrip("T")
    zone = int(name[:2])
    for feat in read_shapefile(index_path):
        if str(feat.get("Name", "")).strip() != name:
            continue
        xs, ys = [], []
        for ring in feat.get("rings", []):
            for lon, lat in ring:
                e, n = wgs84_to_utm(lon, lat, zone)
                xs.append(e)
                ys.append(n)
        if not xs:
            break
        return (round(min(xs)), round(max(ys)))
    raise KeyError(f"tile {tile_name} not in index {index_path}")


def mgrs_tile_origin(tile_name: str) -> Tuple[float, float]:
    """Approximate UTM upper-left corner of an S2 tile from its MGRS id.

    Uses the 100-km grid-square layout (column letter -> easting, row letter
    -> northing, AA pattern). Good to the grid-square corner; the official
    S2 footprint extends 4.9 km beyond it on each side (tiles overlap).
    """
    zone = int(tile_name[1:3])
    band, col_letter, row_letter = tile_name[3], tile_name[4], tile_name[5]
    col_sets = ["ABCDEFGH", "JKLMNPQR", "STUVWXYZ"]
    cols = col_sets[(zone - 1) % 3]
    easting = (cols.index(col_letter) + 1) * 100000.0
    rows = "ABCDEFGHJKLMNPQRSTUV"
    row_cycle = rows if zone % 2 == 1 else rows[5:] + rows[:5]
    row_idx = row_cycle.index(row_letter)
    # resolve the 2,000,000 m row ambiguity with the latitude band's centre
    band_lat = -80 + 8 * ("CDEFGHJKLMNPQRSTUVWX".index(band)) + 4
    approx_northing = band_lat * 111000.0
    northing = row_idx * 100000.0
    while northing + 1000000 < approx_northing:
        northing += 2000000.0
    return (easting, northing + 100000.0)  # upper-left of the 100k square


def get_time_series(tile_name: str, bounds, cache_dir: str, client=None,
                    loader=None, relax_steps=(0, 10, 20)) -> str:
    """Build the 100-patch inference time series for a cell
    (reference get_ts, get_data.py:188-247): DatasetCreator(for_inference)
    with download, retrying with cloud caps relaxed by ``relax_steps``."""
    from crop2seg_tpu_torch.gis.dataset_creator import DatasetCreator

    out = os.path.join(cache_dir, "s2_patches", tile_name)
    if os.path.exists(os.path.join(out, "metadata.json")):
        logging.info("time series already generated, skipping")
        return out
    last_err = None
    # relax_steps are ABSOLUTE increments over the client's base cloud caps
    # (reference get_data.py:230-246 swaps in fresh absolute arrays per
    # retry): each attempt derives from the saved base — not the previous
    # attempt's caps — and the base is restored afterwards so a shared
    # client doesn't start the next tile pre-relaxed.
    base_cfg = client.cfg if client is not None else None
    try:
        for relax in relax_steps:
            try:
                if client is not None:
                    client.cfg = (base_cfg.with_clouds(relax) if relax
                                  else base_cfg)
                dc = DatasetCreator(out, loader=loader, for_inference=True,
                                    download=client is not None,
                                    client=client)
                dc.run_tile(tile_name, bounds=bounds)
                return out
            except Exception as err:  # retry w/ relaxed clouds (ref :230-246)
                logging.warning("acquisition failed (%s); relaxing clouds",
                                err)
                last_err = err
    finally:
        if client is not None:
            client.cfg = base_cfg
    raise RuntimeError(f"time-series acquisition failed: {last_err}")



class _Stopped(Exception):
    """The stream's consumer has left; its producer ends."""


def _no_plan_reason(ds) -> str:
    """The option of ``ds`` that leaves it without a native batch plan."""
    ruled = [k for k in ("add_ndvi", "cache") if getattr(ds, k, False)]
    if getattr(ds, "mono_date", None) is not None:
        ruled.append("mono_date")
    return ", ".join(ruled) or "its transform"


def stream_tile_inference(model, ds, batch_size: int = 10,
                          timeline: Optional[dict] = None, device=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Overlapped disk->crop-map inference over the patches of a cell.

    ``model``: the port's TimeUNet or U-TAE (weights loaded); it is moved to
    ``device`` (the CUDA card unless "cpu" is asked for) and set to eval.
    ``ds``: an ``S2TSCZCropDataset(for_inference=True)`` over the cell that
    gives a native batch plan (no NDVI, RAM cache or mono-date): a dataset
    without one raises ``ValueError`` naming the option.

    A producer thread decodes chunk k+1 with the native C++ loader into
    planar (B, T, C, H, W) bfloat16 (no host transpose, half the bytes of
    fp32) while the card runs chunk k; ctypes releases the GIL for the
    decode. On the card the chunk is permuted to channels-last, cast to
    fp32, and the model runs in fp32 on the bf16-rounded input; softmax and
    argmax follow there, and the stitch too (``stitch_inference_tile``).
    The last chunk is zero-padded to ``batch_size``.

    The decode buffers go round a free-list of two. On the card they are
    pinned host tensors, copied with ``non_blocking=True``; a buffer goes
    back to the decoder only after an event recorded behind its copy has
    completed, so no decode overwrites a buffer still being copied.

    Returns host (1098, 1098, K) float32 probabilities and (1098, 1098)
    uint8 classes, the patch grid stitched and cropped to 1098 px (a grid
    of fewer than 100 patches keeps its whole extent).

    ``timeline``: pass a dict to receive the main loop's wall-clock budget
    in seconds, its stages summing to at most 'total': 'decode' (waiting
    for the decoder's next chunk), 'upload' (issuing the host->device copy),
    'dispatch' (issuing the forward), 'fetch' (the end of the device work,
    the stitch, and the copy of the maps to the host), plus 'bytes_up' and
    'total'; and 'decode_busy', the seconds the decoder thread itself spent
    decoding (overlapped with the loop).
    """
    import queue as _queue
    import time as _time
    from threading import Event, Thread

    from crop2seg_tpu_torch import native as nat
    from crop2seg_tpu_torch.device import resolve_device
    from crop2seg_tpu_torch.nn.temporal import pad_mask_from_lengths
    from crop2seg_tpu_torch.ops.patchify import INFER_TILE, stitch_inference_tile

    plan = ds.native_batch_plan()
    if plan is None:
        raise ValueError(
            "stream_tile_inference decodes with the native loader, and the "
            f"dataset gives it no plan: build it without {_no_plan_reason(ds)}")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    n = len(ds)
    meta0 = ds.light_item(0)
    t, dates = meta0["length"], meta0["dates"]
    pinned = dev.type == "cuda"

    # buffers travel between the threads as (buffer, event): the event is
    # recorded behind the buffer's last host->device copy
    free_q: "_queue.Queue" = _queue.Queue()
    busy = {"decode": 0.0}
    stop = Event()      # set when the consumer leaves early

    def wait(op, *args):
        """A blocking queue operation that gives up once the consumer has left."""
        while not stop.is_set():
            try:
                return op(*args, timeout=0.1)
            except (_queue.Empty, _queue.Full):
                continue
        raise _Stopped

    def chunks():
        paths = [ds.light_item(i)["path"] for i in range(n)]
        h, w = nat.npy_shape(paths[0])[2:4]
        for _ in range(2):
            free_q.put((torch.empty((batch_size, t, len(plan["reorder"]), h, w),
                                    dtype=torch.bfloat16, pin_memory=pinned), None))
        for s0 in range(0, n, batch_size):
            chunk = paths[s0:s0 + batch_size]
            buf, ev = wait(free_q.get)
            if ev is not None:
                ev.synchronize()    # the buffer's last copy has finished
            t0 = _time.perf_counter()
            nat.load_batch(chunk, t, h, w, reorder=plan["reorder"],
                           mean=plan["mean"], std=plan["std"],
                           layout="nchw", out_dtype="bf16", out=buf[:len(chunk)])
            if len(chunk) < batch_size:
                buf[len(chunk):] = 0
            busy["decode"] += _time.perf_counter() - t0
            yield buf, len(chunk)

    def produce(q):
        try:
            for item in chunks():
                wait(q.put, item)
            wait(q.put, None)
        except _Stopped:
            pass
        except Exception as err:  # raised again in the consumer
            try:
                wait(q.put, err)
            except _Stopped:
                pass

    dates_d = torch.as_tensor(dates, dtype=torch.float32,
                              device=dev)[None].expand(batch_size, t)
    mask_d = pad_mask_from_lengths(torch.tensor([t], device=dev), t).expand(batch_size, t)
    tl = {"decode": 0.0, "upload": 0.0, "dispatch": 0.0, "fetch": 0.0,
          "bytes_up": 0, "total": 0.0}
    t_run = _time.perf_counter()
    q: "_queue.Queue" = _queue.Queue(maxsize=2)
    producer = Thread(target=produce, args=(q,), daemon=True)
    producer.start()
    probs = []
    try:
        _consume(q, free_q, model, dev, pinned, dates_d, mask_d, probs, tl)
    finally:
        stop.set()
        producer.join()
    t0 = _time.perf_counter()
    with torch.inference_mode():
        proba = stitch_inference_tile(torch.cat(probs), INFER_TILE)
        classes = proba.argmax(dim=-1).to(torch.uint8)
        proba, classes = proba.cpu().numpy(), classes.cpu().numpy()
    tl["fetch"] += _time.perf_counter() - t0
    tl["total"] = _time.perf_counter() - t_run
    tl["decode_busy"] = busy["decode"]
    if timeline is not None:
        timeline.update(tl)
    return np.ascontiguousarray(proba), np.ascontiguousarray(classes)


def _consume(q, free_q, model, dev, pinned, dates_d, mask_d, probs, tl) -> None:
    """The stream's main loop: each decoded chunk to the card, its buffer
    back to the free-list behind an event, the forward, softmax."""
    import time as _time

    with torch.inference_mode():
        while True:
            t0 = _time.perf_counter()
            item = q.get()
            tl["decode"] += _time.perf_counter() - t0
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            xb, nb = item
            t0 = _time.perf_counter()
            xd = xb.to(dev, non_blocking=pinned)
            ev = None
            if pinned:
                ev = torch.cuda.Event()
                ev.record()
            tl["upload"] += _time.perf_counter() - t0
            tl["bytes_up"] += xb.numel() * xb.element_size()
            t0 = _time.perf_counter()
            # planar (B, T, C, H, W) -> channels-last, fp32
            xd = xd.permute(0, 1, 3, 4, 2).to(torch.float32,
                                              memory_format=torch.contiguous_format)
            # on the CPU ``xb.to(dev)`` is xb itself: the buffer is free once
            # the fp32 copy above is made; on the card once the event behind
            # its host->device copy has completed
            free_q.put((xb, ev))
            logits = model(xd, dates_d, mask_d)
            probs.append(torch.softmax(logits.float(), dim=-1)[:nb])
            tl["dispatch"] += _time.perf_counter() - t0


def _load_weights(model, fold_dir: str) -> None:
    """The port's own ``Fold_1/model.ckpt`` (``learning/checkpoint.py``), or
    else a reference ``model.pth.tar``. A JAX (orbax) checkpoint, a
    directory, is refused: convert it with ``utils/convert.py`` first."""
    from crop2seg_tpu_torch.learning import checkpoint as ckpt

    path = os.path.join(fold_dir, "model.ckpt")
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (a JAX orbax checkpoint); the port reads "
            "its own torch.save checkpoint or a reference model.pth.tar")
    if ckpt.has_state(fold_dir):
        state = ckpt.load_state(fold_dir)["model"]
    else:
        state = ckpt.load_torch_checkpoint(os.path.join(fold_dir, "model.pth.tar"))
    model.load_state_dict(state)


def generate_prediction(data_folder: str, model_dir: str, year: int,
                        cache_dir: str,
                        lpis_parcels: Optional[np.ndarray] = None,
                        batch_size: int = 10, device=None, timeline: Optional[dict] = None
                        ) -> Dict[str, np.ndarray]:
    """Whole-cell crop map (reference prediction.py:253-355).

    data_folder: DatasetCreator(for_inference) output (100 patches).
    model_dir: directory with conf.json + Fold_1/model.ckpt (the port's
    checkpoint, or the reference's model.pth.tar) + NORM_S2_patch.json.
    Returns {'proba', 'classes', 'segments', 'soft', 'polygons'} (and
    'lpis', 'homogenized' with ``lpis_parcels``) and writes classes.npy,
    the raster, the shapefile, the GeoJSON (and homogenized.npy) under
    ``cache_dir/prediction``.

    ``device``: the CUDA card unless "cpu" is asked for; nothing falls back
    on its own; the L-TAE serves on the fused kernel. One card serves:
    multi-card serving is ROADMAP.md item M11. ``timeline``: the stream's
    keys (see there), plus 'setup' (conf, model, weights, dataset) and
    'postprocess' (classes.npy, raster, polygonize, soften, vectors,
    homogenization), in seconds.
    """
    import time as _time

    t_setup = _time.perf_counter()
    from crop2seg_tpu_torch.data import S2TSCZCropDataset, load_norm_values
    from crop2seg_tpu_torch.device import resolve_device
    from crop2seg_tpu_torch.gis.postprocess import (
        homogenize_raster, polygonize, soften_by_segments)
    from crop2seg_tpu_torch.gis.raster import Affine, save_prediction_raster
    from crop2seg_tpu_torch.models.factory import get_model

    dev = resolve_device(device)
    pred_dir = os.path.join(cache_dir, "prediction")
    os.makedirs(pred_dir, exist_ok=True)
    done_marker = os.path.join(pred_dir, "classes.npy")
    # webapp config contract (reference prediction.py:185-211)
    conf = {"model": "timeunet", "num_classes": 15, "input_dim": 10,
            "ref_date": f"{year - 1}-09-01"}
    conf_path = os.path.join(model_dir, "conf.json")
    if os.path.exists(conf_path):
        with open(conf_path) as f:
            stored = json.load(f)
        # the model serves in fp32 on the bf16-rounded input, whatever
        # dtype it trained in
        stored.pop("dtype", None)
        # the architecture comes from the training conf, but the reference
        # date is per PREDICTION year (reference prediction.py:193-203): a
        # model trained on 2019 data with ref_date 2018-09-01 must see 2022
        # acquisitions as offsets from 2021-09-01 so day offsets land in
        # the trained 0-400 range — the stored ref_date must not win here.
        stored.pop("ref_date", None)
        conf.update(stored)
    model = get_model({**conf, "out_conv": conf.get("out_conv", [32, 15])}, device=dev)
    _load_weights(model, os.path.join(model_dir, "Fold_1"))

    norm = load_norm_values(os.path.join(model_dir, "NORM_S2_patch.json"))
    ds = S2TSCZCropDataset(data_folder, norm=True, norm_values=norm,
                           set_type="train", for_inference=True,
                           reference_date=conf["ref_date"])
    setup_s = _time.perf_counter() - t_setup
    tl = {}
    proba, classes = stream_tile_inference(model, ds, batch_size, timeline=tl, device=dev)
    t_post = _time.perf_counter()
    out = {"proba": proba, "classes": classes}

    np.save(done_marker, out["classes"])
    affine = None
    with open(os.path.join(data_folder, "metadata.json")) as f:
        meta = json.load(f)
    if meta and "affine" in meta[0]:
        affine = Affine(*meta[0]["affine"])
    save_prediction_raster(os.path.join(pred_dir, "prediction.tif"),
                           out["classes"], out["proba"], affine)
    segments, seg_class = polygonize(out["classes"])
    soft = soften_by_segments(out["proba"], segments)
    # vector cache, like the reference's shapefile outputs (crop2seg.py:344-353)
    from crop2seg_tpu_torch.gis.vectorize import (
        polygons_to_geojson, segments_to_polygons, write_shapefile)
    feats = segments_to_polygons(segments, seg_class, affine)
    write_shapefile(os.path.join(pred_dir, "prediction.shp"), feats)
    polygons_to_geojson(feats, os.path.join(pred_dir, "prediction.geojson"),
                        crs=meta[0].get("crs") if meta else None)
    result = {"proba": out["proba"], "classes": out["classes"],
              "segments": segments, "soft": soft["raster"],
              "polygons": feats}
    if lpis_parcels is not None:
        result["lpis"] = lpis_parcels
        result["homogenized"] = homogenize_raster(out["classes"], lpis_parcels)
        np.save(os.path.join(pred_dir, "homogenized.npy"),
                result["homogenized"])
    if timeline is not None:
        timeline.update(tl, setup=setup_s, postprocess=_time.perf_counter() - t_post)
    return result


class CacheManager:
    """Cache sizing + cleanup (reference cache_management.py:21-116)."""

    SUBDIRS = ("lpis", "prediction", "s2_patches", "s2_tiles", "rasters")

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        for sub in self.SUBDIRS:
            os.makedirs(os.path.join(cache_dir, sub), exist_ok=True)

    def sizes(self) -> Dict[str, int]:
        out = {}
        for sub in self.SUBDIRS:
            total = 0
            for root, _, files in os.walk(os.path.join(self.cache_dir, sub)):
                total += sum(os.path.getsize(os.path.join(root, f))
                             for f in files)
            out[sub] = total
        return out

    def clear(self, *subdirs: str) -> None:
        for sub in subdirs or self.SUBDIRS:
            path = os.path.join(self.cache_dir, sub)
            shutil.rmtree(path, ignore_errors=True)
            os.makedirs(path, exist_ok=True)
