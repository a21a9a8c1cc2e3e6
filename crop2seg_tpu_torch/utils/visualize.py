"""Visualization suite (matplotlib, headless-safe).

Re-design of reference src/visualization/: learning curves
(visualize.py:105-206), pretty confusion matrices with per-row/col totals +
IoU (confusion_matrix_pretty_print.py:133-330), LULC crop maps with the
15-class legend (visualize.py:370-434 + webapp/postprocess.py:15-42),
reliability/calibration plots (visualize.py:468-545), per-class metric
comparisons (visualize.py:547-692) and NDVI class profiles
(analyze_ts.py:32-145). All functions return the matplotlib Figure and can
save to disk; the Agg backend is forced so everything works headless.

A copy of crop2seg_tpu/utils/visualize.py whose matplotlib import waits for
the first plot (``plt`` is a stand-in that imports pyplot then), so the
module imports where matplotlib is not installed.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from crop2seg_tpu_torch.data.s2tsczcrop import LABELS


class _LazyPyplot:
    """matplotlib.pyplot, imported (with the Agg backend) at first use."""

    _pyplot = None

    def __getattr__(self, name):
        if _LazyPyplot._pyplot is None:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot
            _LazyPyplot._pyplot = matplotlib.pyplot
        return getattr(_LazyPyplot._pyplot, name)


plt = _LazyPyplot()

# 15-class colormap in class-code order (background .. not-classified),
# following the reference's legend palette (s2_ts_cz_crop.py:51-76).
CROP_CMAP = (
    "#000000",  # 0 background
    "#a0db8e",  # 1 permanent grassland
    "#cc5500",  # 2 annual fruit & vegetable
    "#e9de1b",  # 3 summer cereals
    "#748500",  # 4 winter cereals
    "#ffc1cc",  # 5 rapeseed
    "#f8d568",  # 6 maize
    "#1e90ff",  # 7 annual forage crops
    "#a52a2a",  # 8 sugar beet
    "#8b4513",  # 9 flax & hemp
    "#ff0000",  # 10 permanent fruit
    "#ccff00",  # 11 hops
    "#006d6f",  # 12 vineyards
    "#800080",  # 13 other crops
    "#ffffff",  # 14 not classified
)


def _save(fig, path: Optional[str]):
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=120)
    return fig


def plot_learning_curves(trainlog: Dict, metrics=("loss", "IoU", "accuracy"),
                         path: Optional[str] = None):
    """trainlog.json (epoch -> metrics) -> per-metric train/val curves
    (reference visualize.py:105-206)."""
    epochs = sorted(int(e) for e in trainlog)
    fig, axes = plt.subplots(1, len(metrics), figsize=(5 * len(metrics), 4))
    axes = np.atleast_1d(axes)
    for ax, metric in zip(axes, metrics):
        for split in ("train", "val"):
            key = f"{split}_{metric}"
            ys = [trainlog[str(e)].get(key) for e in epochs]
            if any(y is not None for y in ys):
                ax.plot(epochs, [y if y is not None else np.nan for y in ys],
                        label=split, marker="o", ms=3)
        ax.set_title(metric)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    return _save(fig, path)


def plot_confusion_matrix(cm: np.ndarray, labels: Sequence[str] = LABELS,
                          normalize: bool = True, show_iou: bool = True,
                          path: Optional[str] = None):
    """Pretty CM with per-row/col totals and per-class IoU appended
    (reference confusion_matrix_pretty_print.py:133-330)."""
    cm = np.asarray(cm, np.float64)
    k = cm.shape[0]
    labels = list(labels)[:k]
    tp = np.diag(cm)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / (cm.sum(0) + cm.sum(1) - tp)
        shown = cm / cm.sum(1, keepdims=True).clip(min=1) if normalize else cm
    fig, ax = plt.subplots(figsize=(0.6 * k + 3, 0.6 * k + 2))
    im = ax.imshow(shown, cmap="Blues", vmin=0)
    ax.set_xticks(range(k))
    ax.set_yticks(range(k))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ylabels = [f"{l}  (IoU {i:.2f})" if show_iou and np.isfinite(i) else l
               for l, i in zip(labels, iou)]
    ax.set_yticklabels(ylabels, fontsize=7)
    for r in range(k):
        for c in range(k):
            if shown[r, c] > 0.005:
                ax.text(c, r, f"{shown[r, c]:.2f}" if normalize
                        else f"{int(cm[r, c])}", ha="center", va="center",
                        fontsize=6,
                        color="white" if shown[r, c] > 0.5 * shown.max()
                        else "black")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im, shrink=0.7)
    fig.tight_layout()
    return _save(fig, path)


def plot_lulc(classes: np.ndarray, labels: Sequence[str] = LABELS,
              path: Optional[str] = None):
    """Crop map with the 15-class legend (reference visualize.py:370-434)."""
    from matplotlib.colors import ListedColormap
    from matplotlib.patches import Patch

    k = len(labels)
    cmap = ListedColormap(CROP_CMAP[:k])
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(classes, cmap=cmap, vmin=0, vmax=k - 1, interpolation="nearest")
    ax.set_axis_off()
    handles = [Patch(color=CROP_CMAP[i], label=f"{i}: {labels[i]}")
               for i in range(k)]
    ax.legend(handles=handles, loc="center left", bbox_to_anchor=(1.0, 0.5),
              fontsize=7)
    fig.tight_layout()
    return _save(fig, path)


def plot_crop_map(classes: np.ndarray, labels: Sequence[str] = LABELS,
                  lpis_parcels: Optional[np.ndarray] = None,
                  confidence: Optional[np.ndarray] = None,
                  path: Optional[str] = None):
    """Webapp crop-map view (reference webapp/postprocess.py:59-183):
    15-class legend map with an optional LPIS parcel-boundary overlay
    (parcels: int32 id raster, 0 = no parcel; boundaries drawn where the
    id changes) and an optional confidence layer (max softmax prob)
    rendered as alpha dimming of low-confidence pixels."""
    from matplotlib.colors import ListedColormap
    from matplotlib.patches import Patch

    k = len(labels)
    cmap = ListedColormap(CROP_CMAP[:k])
    fig, ax = plt.subplots(figsize=(9, 8))
    alpha = None
    if confidence is not None:
        alpha = np.clip(confidence.astype(float), 0.25, 1.0)
    ax.imshow(classes, cmap=cmap, vmin=0, vmax=k - 1,
              interpolation="nearest", alpha=alpha)
    if lpis_parcels is not None:
        p = np.asarray(lpis_parcels)
        edge = np.zeros(p.shape, bool)
        edge[:, 1:] |= p[:, 1:] != p[:, :-1]
        edge[1:, :] |= p[1:, :] != p[:-1, :]
        edge &= p != 0
        overlay = np.zeros(p.shape + (4,), np.float32)
        overlay[edge] = (0.0, 0.0, 0.0, 0.9)  # black parcel boundaries
        ax.imshow(overlay, interpolation="nearest")
    ax.set_axis_off()
    present = np.unique(np.asarray(classes))
    handles = [Patch(color=CROP_CMAP[i], label=f"{i}: {labels[i]}")
               for i in range(k) if i in present]
    ax.legend(handles=handles, loc="center left", bbox_to_anchor=(1.0, 0.5),
              fontsize=8)
    fig.tight_layout()
    return _save(fig, path)


def reliability_plot(confidence: np.ndarray, pred: np.ndarray,
                     target: np.ndarray, n_bins: int = 10,
                     path: Optional[str] = None):
    """Calibration curve + per-bin strength (reference visualize.py:468-545).
    Returns (figure, expected calibration error)."""
    bins = np.linspace(0, 1, n_bins + 1)
    idx = np.clip(np.digitize(confidence, bins) - 1, 0, n_bins - 1)
    acc = np.zeros(n_bins)
    conf = np.zeros(n_bins)
    weight = np.zeros(n_bins)
    correct = (pred == target).astype(np.float64)
    for b in range(n_bins):
        sel = idx == b
        if sel.any():
            acc[b] = correct[sel].mean()
            conf[b] = confidence[sel].mean()
            weight[b] = sel.mean()
    ece = float(np.sum(weight * np.abs(acc - conf)))
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    centers = (bins[:-1] + bins[1:]) / 2
    ax1.bar(centers, acc, width=1 / n_bins, edgecolor="k", alpha=0.7,
            label="accuracy")
    ax1.plot([0, 1], [0, 1], "k--", label="perfect")
    ax1.set_xlabel("confidence")
    ax1.set_ylabel("accuracy")
    ax1.set_title(f"reliability (ECE={ece:.3f})")
    ax1.legend()
    ax2.bar(centers, weight, width=1 / n_bins, edgecolor="k", alpha=0.7)
    ax2.set_xlabel("confidence")
    ax2.set_ylabel("fraction of pixels")
    ax2.set_title("bin strength")
    fig.tight_layout()
    return _save(fig, path), ece


def plot_per_class_metrics(per_class: Dict[str, Dict[str, float]],
                           metric: str = "IoU",
                           labels: Sequence[str] = LABELS,
                           path: Optional[str] = None):
    """Per-class bar comparison (reference visualize.py:547-692)."""
    ks = sorted(per_class, key=int)
    vals = [per_class[k].get(metric, np.nan) for k in ks]
    names = [labels[int(k)] if int(k) < len(labels) else k for k in ks]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(len(ks)), vals, color="#4c72b0")
    ax.set_xticks(range(len(ks)))
    ax.set_xticklabels(names, rotation=60, ha="right", fontsize=8)
    ax.set_ylabel(metric)
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    return _save(fig, path)


def ndvi_class_profiles(x: np.ndarray, dates: np.ndarray, target: np.ndarray,
                        labels: Sequence[str] = LABELS,
                        red_idx: int = 2, nir_idx: int = 6,
                        path: Optional[str] = None):
    """Per-class NDVI temporal profiles (reference analyze_ts.py:32-145).

    x: (T, H, W, C) un-normalized reflectances in PASTIS band order,
    dates: (T,) day offsets, target: (H, W) labels.
    """
    nir, red = x[..., nir_idx], x[..., red_idx]
    denom = nir + red
    ndvi = np.where(denom == 0, np.nan, (nir - red) / np.where(denom == 0, 1, denom))
    fig, ax = plt.subplots(figsize=(9, 5))
    for cls in np.unique(target):
        mask = target == cls
        if mask.sum() < 10:
            continue
        profile = np.nanmean(ndvi[:, mask], axis=1)
        name = labels[int(cls)] if int(cls) < len(labels) else str(cls)
        ax.plot(dates, profile, label=name,
                color=CROP_CMAP[int(cls) % len(CROP_CMAP)])
    ax.set_xlabel("days since reference date")
    ax.set_ylabel("mean NDVI")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=7, ncol=2)
    fig.tight_layout()
    return _save(fig, path)


# --- band/time pixel profiles (reference visualize.py:42-76) ---------------

# PASTIS channel order, i.e. the order S2TSCZCropDataset serves by default:
# the native (B04,B03,B02,B08,B05,B06,B07,B8A,B11,B12) stack reordered by
# [2,1,0,4,5,6,3,7,8,9] (s2_ts_cz_crop.py:248) — ascending wavelength.
S2_BAND_NAMES = ("B02", "B03", "B04", "B05", "B06", "B07", "B08", "B8A",
                 "B11", "B12")


def plot_spectral_profile(x: np.ndarray, time: int = 0,
                          window=(5, 10, 5, 10), scale: float = 1e4,
                          band_names: Sequence[str] = S2_BAND_NAMES,
                          title: str = "", path: Optional[str] = None):
    """Per-pixel spectral profile: band index on x, reflectance on y, one
    line per pixel of the window (reference visualize_bands,
    visualize.py:42-62). ``x`` is channels-last (T, H, W, C)."""
    y0, y1, x0, x1 = window
    vals = x[time, y0:y1, x0:x1, :].reshape(-1, x.shape[-1]) / scale
    fig, ax = plt.subplots()
    ax.plot(range(len(band_names)), vals.T)
    ax.set_xticks(range(len(band_names)), band_names)
    ax.set_xlabel("Spectral band")
    ax.set_ylabel("Reflectance")
    ax.set_title(f"Spectral profile: {title}" if title else "Spectral profile")
    return _save(fig, path)


def plot_band_over_time(x: np.ndarray, band: int = 2,
                        window=(5, 10, 5, 10), dates=None,
                        path: Optional[str] = None):
    """One band's values through the time series for each pixel of the
    window (reference visualize_time, visualize.py:66-74).
    ``x`` channels-last (T, H, W, C)."""
    y0, y1, x0, x1 = window
    vals = x[:, y0:y1, x0:x1, band].reshape(x.shape[0], -1)
    fig, ax = plt.subplots()
    t = np.arange(x.shape[0]) if dates is None else np.asarray(dates)
    ax.plot(t, vals)
    ax.set_xlabel("date" if dates is not None else "time index")
    ax.set_title(f"Band {band} in time")
    return _save(fig, path)


# --- confusion matrix with totals (confusion_matrix_pretty_print.py) -------

def cm_with_totals(cm: np.ndarray, print_iou: bool = True,
                   ignore_index: Sequence[int] = ()):
    """Augment a KxK confusion matrix (rows = actual, cols = predicted) with
    the reference's total/recall/precision/IoU/F1 margins
    (confusion_matrix_pretty_print.py:133-222, insert_totals), numpy-only.

    Returns (table, row_labels, col_labels): table is (K+3, K+3) float with
    layout [[cm, Sum(actual), Recall, IoU], [Sum(predic)...], [Precision...,
    OA], [F1..., mIoU]]; ignored classes carry -0.0 like the reference.
    """
    cm = np.asarray(cm, np.float64)
    k = cm.shape[0]
    relevant = [i for i in range(k) if i not in ignore_index]
    diag = np.diag(cm)
    sum_lin = cm.sum(axis=1)                       # per actual class
    sum_col = cm.sum(axis=0)                       # per predicted class
    sum_lin_c = cm[:, relevant].sum(axis=1)
    sum_col_c = cm[relevant, :].sum(axis=0)
    trace = diag[relevant].sum()
    total_c = sum_lin_c[relevant].sum()

    def guarded(num, den):
        return np.where(den != 0, num / np.maximum(den, 1e-12), 0.0)

    recall = guarded(diag, sum_lin_c)
    precision = guarded(diag, sum_col_c)
    iou = guarded(diag, sum_lin_c + sum_col_c - diag)
    f1 = guarded(2 * diag, sum_lin_c + sum_col_c)
    for i in ignore_index:
        recall[i] = precision[i] = iou[i] = f1[i] = -0.0
    miou = iou[relevant].mean()
    mf1 = f1[relevant].mean()
    oa = trace / total_c if total_c else 0.0

    n = k + 3
    table = np.zeros((n, n))
    table[:k, :k] = cm
    table[:k, k] = sum_lin          # Sum(actual)
    table[k, :k] = sum_col          # Sum(predic)
    table[k, k] = sum_lin.sum()
    table[:k, k + 1] = recall
    table[k + 1, :k] = precision
    table[k + 1, k + 1] = oa
    if print_iou:
        table[:k, k + 2] = iou
        table[k + 2, :k] = f1
        table[k + 2, k + 2] = miou
        table[k + 2, k + 1] = mf1
    row_labels = list(LABELS[:k]) + ["Sum(predic)", "Precision", "F1 score"]
    col_labels = list(LABELS[:k]) + ["Sum(actual)", "Recall", "IoU"]
    return table, row_labels, col_labels


def plot_pretty_confusion_matrix(cm: np.ndarray, print_iou: bool = True,
                                 ignore_index: Sequence[int] = (),
                                 labels: Sequence[str] = LABELS,
                                 fmt: str = ".2f", figsize=(18, 15),
                                 path: Optional[str] = None):
    """Matlab-style annotated confusion matrix with total/recall/precision/
    IoU/F1 margins (reference pretty_plot_confusion_matrix,
    confusion_matrix_pretty_print.py:236-330)."""
    table, row_labels, col_labels = cm_with_totals(
        cm, print_iou=print_iou, ignore_index=ignore_index)
    k = cm.shape[0]
    row_labels[:k] = list(labels[:k])
    col_labels[:k] = list(labels[:k])
    fig, ax = plt.subplots(figsize=figsize)
    body = np.log1p(np.abs(table))
    ax.imshow(body, cmap="YlGnBu")
    for i in range(table.shape[0]):
        for j in range(table.shape[1]):
            v = table[i, j]
            if i >= k or j >= k:
                txt = f"{v:{fmt}}" if (i > k or j > k) else f"{v:.0f}"
            else:
                txt = f"{v:.0f}"
            ax.text(j, i, txt, ha="center", va="center", fontsize=7)
    ax.set_xticks(range(len(col_labels)), col_labels, rotation=45,
                  ha="right", fontsize=8)
    ax.set_yticks(range(len(row_labels)), row_labels, fontsize=8)
    # cm_with_totals lays out rows = actual, cols = predicted (reference
    # confusion_matrix_pretty_print.py:248-249 labels the same layout)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    return _save(fig, path)


# --- temporal-window ablations (analyze_ts.py:146-260) ----------------------

def load_window_metrics(path: str, what: str = "overall",
                        how: str = "until", num_classes: int = 14):
    """Collect the temporal-window ablation series from overall/per-class
    metric JSONs (reference load_, analyze_ts.py:146-200): files named
    all_{overall|per_class}_{until|from}_{month}*.json plus
    all_{...}_full.json; month buckets jan..oct. Missing files -> NaN."""
    import glob as _glob

    months = ["jan", "feb", "mar", "april", "may", "jun", "jul", "aug",
              "sep", "oct"]
    stem = "all_overall" if what == "overall" else "all_per_class"
    prefix = f"{stem}_{how}_" if how in ("until", "from") else f"{stem}_"
    values = []
    for m in months:
        pattern = os.path.join(path, prefix + m + ("*.json" if how != "month"
                                                   else ".json"))
        hits = sorted(_glob.glob(pattern))
        try:
            with open(hits[0]) as fh:
                blob = json.load(fh)
            if what == "overall":
                values.append(blob["MACRO_IoU"])
            else:
                values.append([blob[str(c)]["IoU"]
                               for c in range(num_classes)])
        except (IndexError, KeyError, OSError):
            values.append(np.nan if what == "overall"
                          else [np.nan] * num_classes)
    # the "full"-window point closes the 'until' series
    tail = np.nan if what == "overall" else [np.nan] * num_classes
    if how == "until":
        try:
            with open(os.path.join(path, f"{stem}_full.json")) as fh:
                blob = json.load(fh)
            tail = (blob["MACRO_IoU"] if what == "overall" else
                    [blob[str(c)]["IoU"] for c in range(num_classes)])
        except (OSError, KeyError):
            pass
    values.append(tail)
    return np.asarray(values, np.float64) * 100.0


def plot_time_dependence(path: str, what: str = "overall",
                         how: str = "until", classes: Sequence[int] = (3, 4, 5, 6),
                         labels: Sequence[str] = LABELS,
                         out_path: Optional[str] = None):
    """Cumulative-metric vs temporal-window plot (reference
    plot_time_dependence, analyze_ts.py:203-227)."""
    values = load_window_metrics(path, what=what, how=how)
    if what == "overall":
        values = values[None, :]
        classes = (0,)
        series_labels = ["MACRO mIoU"]
    else:
        values = values.T
        series_labels = [labels[i] for i in classes]
    fig, ax = plt.subplots()
    xs = np.arange(values.shape[1])
    for i, cls in enumerate(classes):
        ax.plot(xs, values[cls], marker="*", label=series_labels[i])
    ax.set_ylabel("mIoU")
    ax.set_xlabel("window end month" if how == "until" else "window start month")
    ax.set_title(f"Cumulative metric - {how} date")
    if what == "class":
        ax.legend(fontsize=8)
    return _save(fig, out_path)
