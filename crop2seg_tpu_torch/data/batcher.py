"""Batching with fixed T buckets and explicit pad masks (port of
crop2seg_tpu/data/batcher.py).

Every batch is padded up to the smallest bucket of ``t_buckets`` that fits
its longest sample, so the steps see a few shapes only; the pad mask is an
input, and no model reads pads from the data values.

- ``BatchLoader``: shuffle (or weighted sampling with replacement), batch,
  bucket-pad, drop the last partial batch on request; the batches of the
  JAX ``BatchLoader`` for the same seed. With ``native=True`` (the default)
  the native C++ loader (``crop2seg_tpu_torch/native``) assembles x and the
  pad mask wherever the dataset's ``native_batch_plan`` allows.
- ``DeviceCacheLoader``: the batches uploaded once, to the card by default,
  then replayed from device memory (later epochs gather fresh shuffles from
  per-bucket stacks with ``index_select``).
- ``PrefetchLoader``: a background thread assembles the next batches.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from crop2seg_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_T_BUCKETS = (32, 48, 61)


def pick_bucket(t: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if t <= b:
            return b
    return buckets[-1]


def collate(samples: List[Dict[str, np.ndarray]],
            t_buckets: Sequence[int] = DEFAULT_T_BUCKETS,
            pad_value: float = 0.0) -> Dict[str, np.ndarray]:
    """Stack samples into one batch, T padded to a shared bucket: x (B, Tb,
    H, W, C), dates (B, Tb[, 2]), pad_mask (B, Tb) bool, y (B, H, W) when
    present, lengths (B,), ids (B,)[, affine]. A sample longer than the
    largest bucket keeps its first Tb steps."""
    max_len = max(s["length"] for s in samples)
    tb = pick_bucket(max_len, t_buckets)
    b = len(samples)
    x0 = samples[0]["x"]
    x = np.full((b, tb) + x0.shape[1:], pad_value, np.float32)
    dshape = (b, tb) + samples[0]["dates"].shape[1:]
    dates = np.zeros(dshape, np.float32)
    pad_mask = np.ones((b, tb), bool)
    lengths = np.zeros((b,), np.int32)
    for i, s in enumerate(samples):
        t = min(s["length"], tb)
        x[i, :t] = s["x"][:t]
        dates[i, :t] = s["dates"][:t]
        pad_mask[i, :t] = False
        lengths[i] = t
    out = {"x": x, "dates": dates, "pad_mask": pad_mask, "lengths": lengths,
           "ids": np.asarray([s["id"] for s in samples], np.int64)}
    if "y" in samples[0]:
        out["y"] = np.stack([s["y"] for s in samples]).astype(np.int32)
    if "affine" in samples[0]:
        out["affine"] = np.stack([s["affine"] for s in samples])
    return out


class BatchLoader:
    """Epoch iterator over a dataset: shuffle (or, with ``sample_weights``,
    weighted sampling with replacement), batch, bucket-pad, and with
    ``drop_last`` drop the last partial batch.

    ``native=True`` assembles x and pad_mask with the native C++ loader
    (npy parse, channel reorder, standardization, flip+rotate and temporal
    dropout through gather maps, bucket pad; ``native_threads`` threads,
    off the GIL) whenever the dataset gives a plan (``native_batch_plan``).
    The loader is built at first use; a failed build raises. A file the
    loader rejects mid-run makes the loader warn and take the Python path
    for the rest of the run."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 t_buckets: Sequence[int] = DEFAULT_T_BUCKETS,
                 pad_value: float = 0.0, drop_last: bool = True,
                 sample_weights: Optional[np.ndarray] = None, seed: int = 0,
                 native: bool = True, native_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.t_buckets = tuple(t_buckets)
        self.pad_value = pad_value
        self.drop_last = drop_last
        self.sample_weights = sample_weights
        self.native_threads = native_threads
        self._rng = np.random.default_rng(seed)
        self._plan = None
        plan_fn = getattr(dataset, "native_batch_plan", None)
        if native and plan_fn is not None:
            self._plan = plan_fn()
            if self._plan is not None:
                from crop2seg_tpu_torch import native as nat
                nat.load_library()    # builds at first use; raises on failure
                self._native = nat

    def _native_batch(self, chunk) -> Dict[str, np.ndarray]:
        augment = self._plan.get("augment", False)
        if augment:
            # the draws and the y / dates transforms in Python, in the order
            # of __getitem__; the per-pixel work on x through the gather maps
            metas = [self.dataset.aug_item(int(i)) for i in chunk]
        else:
            metas = [self.dataset.light_item(int(i)) for i in chunk]
        tb = pick_bucket(max(m["length"] for m in metas), self.t_buckets)
        paths = [m["path"] for m in metas]
        shape = self._native.npy_shape(paths[0])
        frame_maps = gathers = None
        if augment:
            frame_maps = np.full((len(metas), tb), -1, np.int32)
            for i, m in enumerate(metas):
                fi = m["frame_idx"][:tb]
                frame_maps[i, :len(fi)] = fi
            if metas[0]["gather"] is not None:
                gathers = np.stack([m["gather"] for m in metas])
        x, pad_mask, lengths = self._native.load_batch(
            paths, tb, shape[2], shape[3], reorder=self._plan["reorder"],
            mean=self._plan["mean"], std=self._plan["std"],
            pad_value=self.pad_value, n_threads=self.native_threads,
            frame_maps=frame_maps, gathers=gathers)
        dshape = (len(metas), tb) + metas[0]["dates"].shape[1:]
        dates = np.zeros(dshape, np.float32)
        for i, m in enumerate(metas):
            t = min(m["length"], tb)
            dates[i, :t] = m["dates"][:t]
        out = {"x": x, "dates": dates, "pad_mask": pad_mask, "lengths": lengths,
               "ids": np.asarray([m["id"] for m in metas], np.int64)}
        if "y" in metas[0]:
            out["y"] = np.stack([m["y"] for m in metas]).astype(np.int32)
        if "affine" in metas[0]:
            out["affine"] = np.stack([m["affine"] for m in metas])
        return out

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        if self.sample_weights is not None:
            p = np.asarray(self.sample_weights, np.float64)
            idx = self._rng.choice(n, size=n, replace=True, p=p / p.sum())
        elif self.shuffle:
            idx = self._rng.permutation(n)
        else:
            idx = np.arange(n)
        for start in range(0, n, self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            if self._plan is not None:
                try:
                    yield self._native_batch(chunk)
                    continue
                except OSError as e:
                    # a file the parser rejects (e.g. an npy dtype it does
                    # not read): the Python path for the rest of the run
                    log.warning("native batch load failed, using the Python "
                                "collate path from here on: %s", e)
                    self._plan = None
            samples = [self.dataset[int(i)] for i in chunk]
            yield collate(samples, self.t_buckets, self.pad_value)


class DeviceCacheLoader:
    """Keeps a loader's batches resident on ``device`` (the card by default)
    after the first epoch, which uploads each batch as it streams it.

    - ``shuffle=True``: every later epoch draws a fresh permutation of the
      samples within each T bucket and assembles the batches on the device
      (``index_select`` on the bucket's stacked tensors), the batches of all
      buckets in a fresh order; each bucket's remainder is dropped
      (``drop_last``). The epoch's indices go to the device in one copy.
    - ``shuffle=False`` (eval): the first epoch's batches replay as they
      were.
    - Augmentation, if any, stays frozen at its first-epoch draw.
    - Only ``keys`` (the steps' inputs) are kept; ids, affine and lengths
      are dropped.

    ``cast``: a dtype for x (``torch.bfloat16`` for a bf16 run), applied on
    the host before the upload; it halves the upload and the resident size.
    The (T bucket, permutation) draws are the JAX ``DeviceCacheLoader``'s
    for the same seed."""

    def __init__(self, loader, cast: torch.dtype | None = None, shuffle: bool = True,
                 seed: int = 0, keys: Sequence[str] = ("x", "dates", "pad_mask", "y"),
                 device=None):
        self.loader = loader
        self.cast = cast
        self.shuffle = shuffle
        self.keys = tuple(keys)
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[List[dict]] = None
        self._stacks: Optional[dict] = None    # bucket T -> stacked tensors
        self._batch_size: Optional[int] = None

    def __len__(self):
        if self._cache is None:
            return len(self.loader)
        if self.shuffle and self._stacks is not None:
            b = self._batch_size or 1
            return sum(s["x"].shape[0] // b for s in self._stacks.values())
        return len(self._cache)

    def _upload(self, batch: Dict[str, np.ndarray]) -> dict:
        out = {}
        for k in self.keys:
            if k not in batch:
                continue
            v = torch.as_tensor(batch[k])
            if k == "x" and self.cast is not None:
                v = v.to(self.cast)
            out[k] = v.to(self.device)
        return out

    def _build_stacks(self):
        """Concatenate the cached batches per T bucket; each bucket's batch
        copies are released right after its concatenation, so the peak is
        the dataset plus one bucket."""
        buckets: dict = {}
        for dev in self._cache:
            buckets.setdefault(dev["x"].shape[1], []).append(dev)
        self._batch_size = max(d["x"].shape[0] for d in self._cache)
        self._cache = []  # the bucket lists below hold the only references
        self._stacks = {}
        for t in sorted(buckets):
            devs = buckets.pop(t)
            self._stacks[t] = {k: torch.cat([d[k] for d in devs]) for k in devs[0]}
            devs.clear()

    def __iter__(self):
        if self._cache is None:
            cache: List[dict] = []
            for batch in self.loader:
                dev = self._upload(batch)
                cache.append(dev)
                yield dev
            self._cache = cache
            return
        if not self.shuffle:
            yield from self._cache
            return
        if self._stacks is None:
            self._build_stacks()
        b = self._batch_size
        batches = []
        for t, stack in self._stacks.items():
            perm = self._rng.permutation(stack["x"].shape[0])
            for start in range(0, len(perm) - b + 1, b):
                batches.append((t, perm[start:start + b]))
        self._rng.shuffle(batches)
        if not batches:
            return
        index = torch.as_tensor(np.concatenate([i for _, i in batches]),
                                device=self.device)
        for j, (t, _) in enumerate(batches):
            idx = index[j * b:(j + 1) * b]
            yield {k: v.index_select(0, idx) for k, v in self._stacks[t].items()}


class PrefetchLoader:
    """Background-thread prefetcher around a loader: the host assembles the
    next ``prefetch`` batches while the device computes."""

    def __init__(self, loader, prefetch: int = 2):
        self.loader = loader
        self.prefetch = prefetch

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early sets ``stop`` (the generator's
            # finalizer); a plain put would block this thread forever on the
            # full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except Exception as e:  # raised again on the consumer's side
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if err:
                raise err[0]
        finally:
            stop.set()
