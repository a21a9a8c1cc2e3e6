"""ctypes bindings for the native C++ batch loader (port of
crop2seg_tpu/native/__init__.py; ``loader.cpp`` is a copy of the JAX one).

``load_batch`` assembles a padded batch straight from npy patch archives on
a C++ thread pool (see loader.cpp). The library is built with ``g++`` at
first use into ``crop2seg_tpu_torch/_build/`` (listed in .gitignore), keyed
by a hash of the source and the flags, as the kernels are
(``ops/_build.py``), and of the host CPU's features (``-march=native``).
A build that fails raises with the compiler's error: nothing falls back on
its own. A file the parser rejects (a dtype it does
not read, a broken header) makes ``load_batch`` raise ``OSError``; the
``BatchLoader`` then warns and takes its Python path.

bf16 output is a ``torch.bfloat16`` tensor (numpy has no bf16 type), or a
caller's bf16 CPU tensor (pinned or not).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from crop2seg_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().with_name("loader.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _host_cpu() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so
    a library built on one host is not loaded on another."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    """Where loader.cpp builds to: ``_build/loader-<hash>.so``, the hash of
    the source, the flags and the host CPU's features."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _host_cpu())
    return BUILD_DIR / f"loader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile loader.cpp unless its library exists; returns the path.
    Raises RuntimeError naming the compiler's error. Concurrent builds race
    benignly: each writes its own temp file and renames it into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native loader build failed: cannot run g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native loader build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    common_args = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.c2s_load_batch.restype = ctypes.c_int
    lib.c2s_load_batch.argtypes = common_args
    lib.c2s_load_batch_aug.restype = ctypes.c_int
    lib.c2s_load_batch_aug.argtypes = common_args + [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.c2s_npy_shape.restype = ctypes.c_int
    lib.c2s_npy_shape.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    return lib


def npy_shape(path: str):
    shape = (ctypes.c_int64 * 4)()
    ndim = load_library().c2s_npy_shape(path.encode(), shape)
    if ndim < 0:
        raise OSError(f"cannot parse npy header: {path} (rc={ndim})")
    return tuple(int(shape[i]) for i in range(ndim))


def _out_pointer(out: torch.Tensor, shape, out_dtype: str) -> int:
    """The address of a caller's contiguous CPU tensor of ``shape``, float32
    for f4 and bfloat16 for bf16 (pinned or not)."""
    want = torch.float32 if out_dtype == "f4" else torch.bfloat16
    if (tuple(out.shape) != shape or out.dtype != want or out.device.type != "cpu"
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous CPU {want} tensor of {shape}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out.data_ptr()


def load_batch(paths: Sequence[str], t_bucket: int, h: int, w: int,
               reorder: Optional[Sequence[int]] = None,
               mean: Optional[np.ndarray] = None,
               std: Optional[np.ndarray] = None,
               pad_value: float = 0.0,
               n_threads: int = 4,
               layout: str = "nhwc",
               out_dtype: str = "f4",
               out=None,
               frame_maps: Optional[np.ndarray] = None,
               gathers: Optional[np.ndarray] = None):
    """Assemble (x, pad_mask, lengths) from npy patch files.

    x (B, t_bucket, h, w, C) channels-last (``layout='nhwc'``) or
    (B, t_bucket, C, h, w) planar (``layout='nchw'``), standardized as
    ``(x - mean) * (1 / std)``; pad_mask (B, t_bucket) bool True at pads;
    lengths (B,) int32. ``reorder`` maps output channel -> source channel
    index; ``mean``/``std`` are per OUTPUT channel.

    ``out_dtype='f4'`` gives a numpy float32 x, ``'bf16'`` a
    ``torch.bfloat16`` tensor; ``out``, a contiguous CPU tensor of that
    dtype, is filled instead and returned as x.

    Augmentation runs off the GIL too: ``frame_maps`` (B, t_bucket) int32
    per-sample source-frame gather (-1 = pad from there on) implements
    temporal dropout; ``gathers`` (B, h*w) int32 per-sample pixel
    permutations (-1 = fill 0, from transforms.Transform.index_map)
    implement flip+rotate. The random draws stay in Python.
    """
    lib = load_library()
    n = len(paths)
    if reorder is None:
        c_out = npy_shape(paths[0])[1]
        reorder = list(range(c_out))
    c_out = len(reorder)
    reorder_a = np.ascontiguousarray(reorder, np.int32)
    mean_p = std_p = None
    if (mean is None) != (std is None):
        raise ValueError("mean and std must be given together "
                         f"(got mean={'set' if mean is not None else None}, "
                         f"std={'set' if std is not None else None})")
    if mean is not None:
        mean_a = np.ascontiguousarray(mean, np.float32)
        std_a = np.ascontiguousarray(std, np.float32)
        if mean_a.shape != (c_out,) or std_a.shape != (c_out,):
            raise ValueError(
                f"mean/std must have shape ({c_out},) matching the reorder "
                f"list; got {mean_a.shape} / {std_a.shape}")
        mean_p = mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        std_p = std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"layout must be 'nhwc' or 'nchw', got {layout!r}")
    if out_dtype not in ("f4", "bf16"):
        raise ValueError(f"out_dtype must be 'f4' or 'bf16', got {out_dtype!r}")
    planar = layout == "nchw"
    shape = ((n, t_bucket, c_out, h, w) if planar
             else (n, t_bucket, h, w, c_out))
    if out is None:
        x = (np.empty(shape, np.float32) if out_dtype == "f4"
             else torch.empty(shape, dtype=torch.bfloat16))
        x_ptr = x.ctypes.data if out_dtype == "f4" else x.data_ptr()
    else:
        x, x_ptr = out, _out_pointer(out, shape, out_dtype)
    mask = np.empty((n, t_bucket), np.uint8)
    lengths = np.empty((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fm_p = g_p = None
    if frame_maps is not None:
        fm_a = np.ascontiguousarray(frame_maps, np.int32)
        if fm_a.shape != (n, t_bucket):
            raise ValueError(f"frame_maps must be ({n}, {t_bucket}), got {fm_a.shape}")
        fm_p = fm_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if gathers is not None:
        g_a = np.ascontiguousarray(gathers, np.int32)
        if g_a.shape != (n, h * w):
            raise ValueError(f"gathers must be ({n}, {h * w}), got {g_a.shape}")
        g_p = g_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.c2s_load_batch_aug(
        c_paths, n, t_bucket, pad_value, mean_p, std_p,
        reorder_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), c_out, h, w,
        ctypes.c_void_p(x_ptr),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads,
        int(planar), int(out_dtype == "bf16"), fm_p, g_p)
    if rc != 0:
        raise OSError(f"native batch load failed (rc={rc})")
    return x, mask.astype(bool), lengths
