"""Whole-tile inference: patchify -> batched forward -> softmax -> stitch
(port of crop2seg_tpu/inference/tile.py:24-77), on one device or split
over a patch-parallel mesh (``parallel/mesh.py::patch_parallel_infer``).

The model is any of the port's factory (models/factory.py::MODELS) that
returns logits alone; TimeUNet_v2's full-resolution TAE2d runs in chunks
of pixel rows (nn/tae2d.py), so a batch of 10 patches fits on one card.
The tile is patchified on the device, the 100 patches run in batches of
``batch_size`` (the last one padded to the same shape), and softmax,
stitch and argmax happen on the device; only the 1098^2 maps come back to
the host. The stages are spans (``utils/profiling.py``): ``tile.predict``
around ``tile.patchify``, each batch's ``tile.forward``, ``tile.stitch`` and
``tile.fetch``; the counter ``tile.patches`` counts the tile's patches.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from crop2seg_tpu_torch.device import resolve_device
from crop2seg_tpu_torch.nn.temporal import pad_mask_from_lengths
from crop2seg_tpu_torch.ops.patchify import (
    patchify_inference_tile, stitch_inference_tile)
from crop2seg_tpu_torch.utils.profiling import count, span


def make_tile_predictor(model: torch.nn.Module, batch_size: int = 10,
                        device=None, dtype: torch.dtype | None = None, mesh=None):
    """Returns predict(tile_ts, dates, length) ->
    {'proba': (1098, 1098, K) float32, 'classes': (1098, 1098) uint8}.

    tile_ts: (T, 1098, 1098, C) standardized series (numpy or tensor);
    dates: (T,) day offsets; length: valid series length. ``device``: the
    CUDA card unless "cpu" is asked for; the model is moved there and set to
    eval. ``dtype``: compute dtype under autocast (e.g. torch.bfloat16);
    None runs float32. ``mesh``: a list of devices (``parallel/mesh.py::
    make_mesh``) over which each batch's patches split, the model copied to
    each once; the tile lives on the first, which replaces ``device``, and
    ``batch_size`` is rounded up to a multiple of the mesh's size, as
    crop2seg_tpu/inference/tile.py:34-40 rounds it.
    """
    if mesh is None:
        dev = resolve_device(device)
        model = model.to(dev).eval()
        forward = model
    else:
        from crop2seg_tpu_torch.parallel.mesh import make_mesh, patch_parallel_infer

        mesh = make_mesh(mesh)
        dev = resolve_device(mesh[0])
        batch_size += -batch_size % len(mesh)
        forward = patch_parallel_infer(model, mesh)
    amp = dtype is not None and dtype != torch.float32

    def predict(tile_ts, dates, length) -> Dict[str, np.ndarray]:
        with span("tile.predict"), torch.inference_mode(), torch.autocast(
                dev.type, dtype=dtype, enabled=amp):
            with span("tile.patchify"):
                tile = torch.as_tensor(tile_ts, dtype=torch.float32, device=dev)
                t = tile.shape[0]
                patches = patchify_inference_tile(tile)       # (100, T, 128, 128, C)
                del tile
            n_patches = patches.shape[0]
            count("tile.patches", n_patches)
            db = torch.as_tensor(dates, dtype=torch.float32,
                                 device=dev)[None].expand(batch_size, t)
            mb = pad_mask_from_lengths(
                torch.tensor([int(length)], device=dev), t).expand(batch_size, t)
            probs = []
            for start in range(0, n_patches, batch_size):
                with span("tile.forward"):
                    xb = patches[start:start + batch_size]
                    nb = xb.shape[0]
                    if nb < batch_size:  # pad the final batch to the same shape
                        xb = torch.cat([xb, xb.new_zeros((batch_size - nb,) + xb.shape[1:])])
                    logits = forward(xb, db, mb)
                    probs.append(torch.softmax(logits.float(), dim=-1)[:nb])
            with span("tile.stitch"):
                proba = stitch_inference_tile(torch.cat(probs))
                classes = proba.argmax(dim=-1).to(torch.uint8)
            with span("tile.fetch"):      # waits for the device's work
                return {"proba": proba.cpu().numpy(), "classes": classes.cpu().numpy()}

    return predict
