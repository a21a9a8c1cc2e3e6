"""Confusion matrices and IoU metrics (port of
crop2seg_tpu/learning/metrics.py): the per-batch confusion matrix and top-2
prediction on the device, and on the host in numpy the IoU / accuracy of a
matrix (``iou_from_cm``), the per-class and overall precision, recall, F1
and IoU (``confusion_matrix_analysis``) and the epoch's streaming
``IoUMeter``."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """Integer predictions / targets of any shape -> (K, K) int64 counts,
    rows = ground truth. Labels outside [0, K), negatives included, are
    dropped, as the JAX package's one-hot formulation drops them."""
    t, p = target.reshape(-1).long(), pred.reshape(-1).long()
    ok = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    idx = torch.where(ok, t * num_classes + p, num_classes * num_classes)
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def top2_prediction(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The lenient top-2 prediction: the 2nd-best class counts as the
    prediction where it matches the target, else the best one. Ties go to
    the lower class, as ``jax.lax.top_k`` breaks them (the heads end in a
    ReLU, so zero logits tie often); ``torch.topk`` leaves their order
    open."""
    first = logits.argmax(-1)
    rest = logits.scatter(-1, first[..., None], float("-inf"))
    second = rest.argmax(-1)
    return torch.where(target == second, second, first)


def iou_from_cm(cm: np.ndarray, ignore_index: int | None = None
                ) -> Tuple[np.ndarray, float, float]:
    """(per-class IoU, mIoU %, accuracy %) of a confusion matrix, the
    ignore row and column zeroed first (the accuracy too)."""
    cm = np.asarray(cm, np.float64).copy()
    if ignore_index is not None:
        cm[:, ignore_index] = 0
        cm[ignore_index, :] = 0
    tp = np.diag(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / (tp + fp + fn)
    miou = float(np.nanmean(iou) * 100)
    acc = float(tp.sum() / max(cm.sum(), 1e-12) * 100)
    return iou, miou, acc


def confusion_matrix_analysis(mat: np.ndarray) -> Tuple[Dict, Dict]:
    """Per-class IoU, precision, recall and F1, and their micro and macro
    averages and the accuracy over all classes."""
    mat = np.asarray(mat, np.float64)
    TP = FP = FN = 0.0
    per_class = {}
    for j in range(mat.shape[0]):
        tp = mat[j, j]
        fp = mat[:, j].sum() - tp
        fn = mat[j, :].sum() - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            per_class[str(j)] = {
                "IoU": tp / (tp + fp + fn),
                "Precision": tp / (tp + fp),
                "Recall": tp / (tp + fn),
                "F1-score": 2 * tp / (2 * tp + fp + fn),
            }
        TP, FP, FN = TP + tp, FP + fp, FN + fn
    overall = {
        "micro_IoU": TP / (TP + FP + FN),
        "micro_Precision": TP / (TP + FP),
        "micro_Recall": TP / (TP + FN),
        "micro_F1-score": 2 * TP / (2 * TP + FP + FN),
    }
    for key in ("IoU", "Precision", "Recall", "F1-score"):
        overall[f"MACRO_{key}"] = float(
            np.mean([d[key] for d in per_class.values()]))
    overall["Accuracy"] = float(np.diag(mat).sum() / mat.sum())
    return per_class, overall


class IoUMeter:
    """Host-side streaming sum of confusion matrices (numpy arrays or
    tensors on any device; a tensor is copied to the host here)."""

    def __init__(self, num_classes: int, ignore_index: int | None = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self.cm = np.zeros((self.num_classes, self.num_classes), np.int64)

    def add_cm(self, cm) -> None:
        if isinstance(cm, torch.Tensor):
            cm = cm.cpu().numpy()
        self.cm += np.asarray(cm, np.int64)

    def value(self):
        return iou_from_cm(self.cm, self.ignore_index)

    def get_miou_acc(self) -> Tuple[float, float]:
        _, miou, acc = self.value()
        return miou, acc
