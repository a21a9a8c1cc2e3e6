"""Checkpoints, resume and run artifacts (port of
crop2seg_tpu/learning/checkpoint.py; ``torch.save`` where the JAX package
writes orbax trees).

- ``conf.json``, the run's configuration (read back on resume and test);
- ``Fold_k/trainlog.json``, the metrics by epoch;
- ``Fold_k/{region}_test_metrics.json`` and ``{region}_conf_mat.pkl``, and
  ``{region}_overall.json`` / ``{region}_per_class.json`` over the folds:
  the same file names, JSON keys and pickle layout as the JAX package's;
- state files ``{"model": state dict (parameters and BatchNorm buffers),
  "optimizer": Adam's state dict, "meta": {"epoch", "best_mIoU"}}``, kept
  best-k by ``StateCheckpointer`` with ``model.ckpt`` pointing at the best;
- ``load_torch_checkpoint``: a reference ``model.pth.tar`` (``{"state_dict":
  ...}``), whose names are the port's.
"""
from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from crop2seg_tpu_torch.learning.metrics import confusion_matrix_analysis


def prepare_output(res_dir: str, fold: int = 1) -> str:
    out = os.path.join(res_dir, f"Fold_{fold}")
    os.makedirs(out, exist_ok=True)
    return out


def save_conf(res_dir: str, config: Dict[str, Any]) -> None:
    with open(os.path.join(res_dir, "conf.json"), "w") as f:
        json.dump(config, f, indent=4, default=str)


def load_conf(res_dir: str) -> Dict[str, Any]:
    with open(os.path.join(res_dir, "conf.json")) as f:
        return json.load(f)


def checkpoint_log(fold_dir: str, trainlog: Dict) -> None:
    with open(os.path.join(fold_dir, "trainlog.json"), "w") as f:
        json.dump(trainlog, f, indent=4)


def save_results(fold_dir: str, metrics: Dict, cms: Dict[str, np.ndarray],
                 region: str = "all") -> None:
    with open(os.path.join(fold_dir, f"{region}_test_metrics.json"), "w") as f:
        json.dump({k: float(v) for k, v in metrics.items()}, f, indent=4)
    with open(os.path.join(fold_dir, f"{region}_conf_mat.pkl"), "wb") as f:
        pickle.dump({k: np.asarray(v) for k, v in cms.items()}, f)


def aggregate_fold_cms(res_dir: str, region: str = "all",
                       key: str = "top1") -> np.ndarray:
    """The sum of the test confusion matrices of every finished Fold_k."""
    cm = None
    for p in sorted(glob.glob(os.path.join(res_dir, "Fold_*",
                                           f"{region}_conf_mat.pkl"))):
        with open(p, "rb") as f:
            cms = pickle.load(f)
        c = np.asarray(cms[key], np.float64)
        cm = c if cm is None else cm + c
    if cm is None:
        raise FileNotFoundError(
            f"no {region}_conf_mat.pkl under {res_dir}/Fold_*")
    return cm


def overall_performance(res_dir: str, cm: np.ndarray, region: str = "all",
                        prefix: str = "") -> None:
    """The overall and per-class metrics of a confusion matrix, as JSON."""
    per_class, overall = confusion_matrix_analysis(cm)
    with open(os.path.join(res_dir, f"{prefix}{region}_overall.json"), "w") as f:
        json.dump({k: float(v) for k, v in overall.items()}, f, indent=4)
    with open(os.path.join(res_dir, f"{prefix}{region}_per_class.json"), "w") as f:
        json.dump({k: {kk: float(vv) for kk, vv in d.items()}
                   for k, d in per_class.items()}, f, indent=4)


# --- model and optimizer state ---------------------------------------------

def _payload(model, optimizer, epoch: int, best_miou: float) -> Dict[str, Any]:
    payload = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
               "meta": {"epoch": int(epoch), "best_mIoU": float(best_miou)}}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    return payload


def _write(path: str, payload: Dict[str, Any]) -> None:
    """torch.save to a temporary name, then an atomic rename."""
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_state(fold_dir: str, model, optimizer, epoch: int, best_miou: float) -> str:
    """Write ``fold_dir/model.ckpt`` (model state, Adam state, meta); with
    ``optimizer`` None the weights alone (a resume from them starts Adam
    fresh)."""
    path = os.path.join(fold_dir, "model.ckpt")
    if os.path.islink(path):
        os.unlink(path)
    _write(path, _payload(model, optimizer, epoch, best_miou))
    return path


def _resolve_state_path(fold_dir: str) -> Optional[str]:
    """``model.ckpt`` (a file or a link to one) wins; else the best entry of
    ``best_ckpt.json`` (``StateCheckpointer``'s index, for file systems
    without links)."""
    path = os.path.join(fold_dir, "model.ckpt")
    if os.path.exists(path):
        return os.path.realpath(path)
    index = os.path.join(fold_dir, "best_ckpt.json")
    if os.path.exists(index):
        with open(index) as f:
            entries = json.load(f)
        for e in entries[:1]:
            for p in (e["path"], os.path.join(fold_dir, os.path.basename(e["path"]))):
                if os.path.exists(p):
                    return p
    return None


def has_state(fold_dir: str) -> bool:
    return _resolve_state_path(fold_dir) is not None


def load_state(fold_dir: str, map_location="cpu") -> Dict[str, Any]:
    """The payload of ``fold_dir``'s state: {"model", "meta"[, "optimizer"]}."""
    path = _resolve_state_path(fold_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {fold_dir}")
    return torch.load(path, map_location=map_location, weights_only=True)


def has_opt_state(fold_dir: str) -> bool:
    """True when the saved state carries optimizer state (weights saved
    alone do not), so that a resume can tell "no Adam state on purpose"
    from a failing restore."""
    return has_state(fold_dir) and "optimizer" in load_state(fold_dir)


class StateCheckpointer:
    """Best-k checkpointing by val mIoU.

    Each save writes ``ckpt_e{epoch:04d}`` synchronously (a plain
    ``torch.save``, then a rename; the host waits for the write, a few MB
    for the factory models), keeps the ``keep`` best by mIoU (ties to the
    newest epoch), points ``model.ckpt`` at the best (a relative link) and
    lists them in ``best_ckpt.json``. A resumed run adopts the previous
    run's retained checkpoints. ``wait`` returns at once: nothing is in
    flight."""

    def __init__(self, fold_dir: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.fold_dir = fold_dir
        self.keep = keep
        # (miou, epoch, path), best first
        self._saved = []
        index = os.path.join(fold_dir, "best_ckpt.json")
        if os.path.exists(index):
            with open(index) as f:
                self._saved = [(e["mIoU"], e["epoch"], e["path"])
                               for e in json.load(f) if os.path.exists(e["path"])]

    def save(self, model, optimizer, epoch: int, miou: float) -> str:
        path = os.path.abspath(os.path.join(self.fold_dir, f"ckpt_e{epoch:04d}"))
        _write(path, _payload(model, optimizer, epoch, miou))
        self._saved = [s for s in self._saved if s[2] != path]
        self._saved.append((float(miou), epoch, path))
        self._saved.sort(key=lambda s: (s[0], s[1]), reverse=True)
        for _, _, stale in self._saved[self.keep:]:
            if os.path.exists(stale):
                os.remove(stale)
        self._saved = self._saved[:self.keep]
        self._point_at_best()
        return path

    def _point_at_best(self) -> None:
        best = self._saved[0][2]
        link = os.path.join(self.fold_dir, "model.ckpt")
        try:
            if os.path.islink(link) or os.path.exists(link):
                os.remove(link)
            os.symlink(os.path.basename(best), link)
        except OSError:
            pass  # no links here: best_ckpt.json below is the pointer
        with open(os.path.join(self.fold_dir, "best_ckpt.json"), "w") as f:
            json.dump([{"mIoU": m, "epoch": e, "path": p}
                       for m, e, p in self._saved], f, indent=2)

    def wait(self) -> None:
        """Every save is durable when it returns; nothing to wait for."""


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (``{"state_dict": ..., "optimizer": ...,
    "epoch": ...}`` or a bare state dict) -> its state dict, which the
    port's models load with ``load_state_dict`` (the names are the same)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}
