"""Geometric train-time augmentation on the host (port of
crop2seg_tpu/data/transforms.py; the same draws for the same generator).

A random flip (none, horizontal, vertical), a rotation from a fixed set of
degrees (nearest neighbour, shape kept, fill 0), optional gaussian noise and
an optional random 64^2 crop, applied jointly to (T, C, H, W) data and its
(H, W) label map.
"""
from __future__ import annotations

import numpy as np

ROTATION_DEGREES = (-180, -150, -120, -90, -75, -45, -25, -10, 0, 0, 0, 0,
                    10, 25, 45, 75, 90, 120, 150, 180)


def _rotate_nearest(img: np.ndarray, deg: float) -> np.ndarray:
    """Rotate the trailing two axes by ``deg`` (counter-clockwise, like
    torchvision), nearest neighbour, keep shape, fill 0."""
    if deg % 360 == 0:
        return img
    if deg % 90 == 0:
        return np.rot90(img, k=int(deg // 90), axes=(-2, -1)).copy()
    from scipy import ndimage
    return ndimage.rotate(img, deg, axes=(-1, -2), reshape=False, order=0,
                          mode="constant", cval=0.0)


class Transform:
    def __init__(self, add_noise: bool = False, crop: bool = False,
                 crop_size: int = 64):
        self.add_noise = add_noise
        self.crop = crop
        self.crop_size = crop_size

    def sample_geometry(self, rng: np.random.Generator):
        """Draw (deg, flip) — the exact first two draws of ``__call__``."""
        deg = int(rng.choice(ROTATION_DEGREES))
        flip = int(rng.choice([0, 1, 2]))
        return deg, flip

    @staticmethod
    def index_map(h: int, w: int, deg: int, flip: int) -> np.ndarray:
        """(h*w,) int32 gather map of the flip+rotate pixel permutation:
        out.flat[p] = in.flat[map[p]] with map[p] == -1 meaning fill 0.

        Built by pushing an index field through the SAME ops the data takes
        (slice-flip then nearest rotate), so gather-by-map is bit-identical
        to transforming the data directly; a batch loader can then apply
        the augmentation as a gather (``S2TSCZCropDataset.aug_item``)."""
        idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
        if flip == 1:
            idx = idx[..., ::-1]
        elif flip == 2:
            idx = idx[..., ::-1, :]
        idx = np.ascontiguousarray(idx)
        if deg % 360 != 0:
            if deg % 90 == 0:
                idx = np.rot90(idx, k=int(deg // 90), axes=(-2, -1)).copy()
            else:
                from scipy import ndimage
                idx = ndimage.rotate(idx, deg, axes=(-1, -2), reshape=False,
                                     order=0, mode="constant", cval=-1)
        return idx.ravel().astype(np.int32)

    @staticmethod
    def apply_map(arr: np.ndarray, gmap: np.ndarray) -> np.ndarray:
        """Gather the trailing (h, w) axes of ``arr`` through ``gmap``."""
        h, w = arr.shape[-2:]
        flat = arr.reshape(arr.shape[:-2] + (h * w,))
        out = flat[..., np.clip(gmap, 0, None)]
        out[..., gmap < 0] = 0
        return np.ascontiguousarray(out.reshape(arr.shape))

    def __call__(self, img: np.ndarray, mask: np.ndarray,
                 rng: np.random.Generator):
        deg, flip = self.sample_geometry(rng)

        if self.add_noise and rng.random() > 0.5:
            img = img + 0.01 * rng.standard_normal(img.shape).astype(img.dtype)

        gmap = self.index_map(img.shape[-2], img.shape[-1], deg, flip)
        img = self.apply_map(np.ascontiguousarray(img), gmap)
        mask = self.apply_map(np.ascontiguousarray(mask), gmap)

        if self.crop:
            x0, y0 = rng.integers(0, 64, 2)
            img = img[..., y0:y0 + self.crop_size, x0:x0 + self.crop_size]
            mask = mask[..., y0:y0 + self.crop_size, x0:x0 + self.crop_size]

        return np.ascontiguousarray(img), np.ascontiguousarray(mask)
