"""Prediction post-processing in raster space (pure numpy/scipy).

Re-design of reference src/helpers/postprocess.py. The reference routes
everything through vector land (rasterio.shapes -> geopandas overlays ->
re-rasterize); the same label algebra runs directly on label/segment rasters
here — orders of magnitude faster and dependency-free. Behaviors mirrored:

- ``polygonize``: connected same-class regions (4-connectivity, like
  rasterio.features.shapes) -> segment-id map + per-segment class table
  (reference :284-374).
- ``soften_by_segments``: per-segment mean class distribution, top-1/top-2
  soft labels with the background-confidence override top1==0 kept only when
  p(bg) > 0.7 (reference soften :269-274).
- ``homogenize_raster``: per-LPIS-parcel majority vote where background wins
  only with > 0.75 area share; pixels outside parcels -> 0 (reference
  homogenize :446-489 with rasterize fill=0).
- ``homogenize_boundaries``: boundary-class-driven instance split: mask out
  boundary/background, 4-connected components, drop components < 13 px,
  relabel each component to its dominant crop class (reference :510-604).

Vector export of segment outlines lives in crop2seg_tpu_torch.gis.vectorize.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy import ndimage

FOUR_CONN = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])


def prediction_to_arrays(proba: np.ndarray) -> Dict[str, np.ndarray]:
    """(H, W, K) or (K, H, W) probabilities -> top1/top2 labels + probs."""
    if proba.shape[0] < proba.shape[-1]:  # (K, H, W) -> (H, W, K)
        proba = np.moveaxis(proba, 0, -1)
    order = np.argsort(-proba, axis=-1)
    top1, top2 = order[..., 0], order[..., 1]
    p1 = np.take_along_axis(proba, top1[..., None], axis=-1)[..., 0]
    p2 = np.take_along_axis(proba, top2[..., None], axis=-1)[..., 0]
    return {"top1": top1.astype(np.int32), "top2": top2.astype(np.int32),
            "p1": p1, "p2": p2}


def polygonize(classes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Label map (H, W) -> (segments (H, W) int32 ids starting at 1,
    seg_class (n_segments+1,) class value per segment id; seg_class[0] = -1).

    Segments are maximal 4-connected same-class regions — the regions
    rasterio.features.shapes would emit (reference :86-120).
    """
    segments = np.zeros(classes.shape, np.int32)
    next_id = 1
    classes = np.asarray(classes)
    seg_class = [-1]
    for value in np.unique(classes):
        lab, n = ndimage.label(classes == value, FOUR_CONN)
        segments = np.where(lab > 0, lab + (next_id - 1), segments)
        seg_class.extend([int(value)] * n)
        next_id += n
    return segments, np.asarray(seg_class, np.int32)


def _segment_mean_proba(proba: np.ndarray, segments: np.ndarray,
                        n_segments: int) -> np.ndarray:
    """(H, W, K), (H, W) -> (n_segments+1, K) mean probability per segment."""
    k = proba.shape[-1]
    flat_seg = segments.reshape(-1)
    flat_p = proba.reshape(-1, k)
    sums = np.zeros((n_segments + 1, k))
    np.add.at(sums, flat_seg, flat_p)
    counts = np.bincount(flat_seg, minlength=n_segments + 1).astype(np.float64)
    return sums / np.maximum(counts, 1)[:, None]


def soften_by_segments(proba: np.ndarray, segments: np.ndarray
                       ) -> Dict[str, np.ndarray]:
    """Per-segment soft labels (reference soften :238-281).

    Returns {'soft_label', 'soft_top2_label'} per segment id plus the
    rasterized soft-label map.
    """
    if proba.shape[0] < proba.shape[-1]:
        proba = np.moveaxis(proba, 0, -1)
    n_segments = int(segments.max())
    mean_p = _segment_mean_proba(proba, segments, n_segments)
    order = np.argsort(-mean_p, axis=-1)
    top1, top2 = order[:, 0].copy(), order[:, 1]
    p1 = np.take_along_axis(mean_p, order[:, :1], axis=-1)[:, 0]
    # background survives only when confidently background (reference :272-273)
    z = top1 == 0
    top1[z] = np.where(p1[z] > 0.7, 0, top2[z])
    return {"soft_label": top1.astype(np.int32),
            "soft_top2_label": top2.astype(np.int32),
            "raster": top1[segments].astype(np.uint8)}


def homogenize_raster(prediction: np.ndarray, parcels: np.ndarray,
                      type_: str = "hard",
                      background_share: float = 0.75) -> np.ndarray:
    """Per-parcel label homogenization (reference homogenize :377-507).

    prediction: (H, W) hard labels, or (H, W, K)/(K, H, W) probabilities for
    type_='soft'. parcels: (H, W) int parcel ids, 0 = outside any parcel.
    Each parcel gets one label: its majority predicted class, except that
    background (0) wins only when covering > ``background_share`` of the
    parcel. Pixels outside parcels are set to 0 (the reference rasterizes
    parcel polygons onto a zero canvas).
    """
    parcels = np.asarray(parcels, np.int64)
    n_parcels = int(parcels.max())
    if type_ == "soft":
        # per-parcel soft rule only (reference :491-507): mean probability
        # per parcel, background kept only when confidently background
        # (fixed 0.7, the reference's threshold — ``background_share``
        # governs the hard vote below, not this rule). The hard-vote
        # histogram is not computed here; it would be discarded.
        proba = prediction
        if proba.shape[0] < proba.shape[-1]:
            proba = np.moveaxis(proba, 0, -1)
        mean_p = _segment_mean_proba(proba, parcels.astype(np.int32),
                                     n_parcels)
        order = np.argsort(-mean_p, axis=-1)
        top1, top2 = order[:, 0].copy(), order[:, 1]
        p1 = np.take_along_axis(mean_p, order[:, :1], axis=-1)[:, 0]
        z = top1 == 0
        top1[z] = np.where(p1[z] > 0.7, 0, top2[z])
        top1[0] = 0  # outside parcels
        return top1[parcels].astype(np.uint8)
    hard = np.asarray(prediction, np.int64)
    k = int(hard.max()) + 1

    # joint histogram parcel x class == the area table of the vector overlay
    idx = parcels.reshape(-1) * k + hard.reshape(-1)
    hist = np.bincount(idx, minlength=(n_parcels + 1) * k
                       ).reshape(n_parcels + 1, k).astype(np.float64)
    parcel_area = hist.sum(axis=1)
    bg_share = hist[:, 0] / np.maximum(parcel_area, 1)
    nonbg = hist.copy()
    nonbg[:, 0] = 0
    winner = np.argmax(nonbg, axis=1)
    has_crop = nonbg.max(axis=1) > 0
    label = np.where((bg_share > background_share) | ~has_crop, 0, winner)
    label[0] = 0  # outside parcels
    return label[parcels].astype(np.uint8)


def homogenize_boundaries(proba: np.ndarray, boundary_code: int = 15,
                          min_size: int = 13) -> np.ndarray:
    """Boundary-driven instance homogenization (reference :510-604).

    proba: (K, H, W) or (H, W, K) class probabilities including the boundary
    class. Pixels that are boundary (top-1, or top-2 with p > 0.3) or
    background split the map into 4-connected field candidates; components
    smaller than ``min_size`` are dropped; each surviving component takes its
    dominant non-background top-1 class.
    """
    if proba.shape[0] < proba.shape[-1]:
        proba = np.moveaxis(proba, 0, -1)
    arrs = prediction_to_arrays(proba)
    t1, t2, p2 = arrs["top1"], arrs["top2"], arrs["p2"]
    field = ~((t1 == boundary_code) | ((t2 == boundary_code) & (p2 > 0.3))
              | (t1 == 0))
    labeled, n = ndimage.label(field, FOUR_CONN)
    if n == 0:
        return np.zeros(t1.shape, np.uint8)
    sizes = np.bincount(labeled.reshape(-1), minlength=n + 1)
    keep = sizes >= min_size
    keep[0] = False
    labeled = np.where(keep[labeled], labeled, 0)

    # dominant non-background, non-boundary class per component
    altered = np.where(t1 == boundary_code, t2, t1)
    k = int(altered.max()) + 1
    idx = labeled.reshape(-1) * k + altered.reshape(-1)
    hist = np.bincount(idx, minlength=(n + 1) * k).reshape(n + 1, k).astype(float)
    hist[:, 0] = 0
    if boundary_code < k:
        hist[:, boundary_code] = 0
    comp_label = np.argmax(hist, axis=1)
    comp_label[0] = 0
    comp_label = np.where(hist.max(axis=1) > 0, comp_label, 0)
    return comp_label[labeled].astype(np.uint8)
