"""The train CLI's initialization from scratch (port of
crop2seg_tpu/learning/weight_init.py), by module type:

- Conv2d, ConvTranspose2d and Linear weights (the day-of-year encoder's fc,
  the depthwise and pointwise convs and the squeeze-excitation Linears
  included): Xavier-normal (gain 1);
- Conv1d weights (the L-TAE's and LTAE4WTAE's ``inconv``): N(0, 1);
- every bias of those (MBConv's depthwise conv has one; the
  depthwise-separable convs and the SE Linears have none): N(0, 1);
- BatchNorm weight N(0, 1), bias 0;
- GroupNorm, instance norm (no parameters) and the attention's bare
  query ``Q``: left as they are.

``models/factory.py::init_weights`` (PyTorch's default schemes) stays the
seeded models' init; this is the recipe the JAX train CLI applies before
training from scratch.
"""
from __future__ import annotations

import torch
from torch import nn


def apply_reference_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s weights in place from ``generator`` (on the
    parameters' device) by the rules above, module by module in
    ``model.modules()`` order. Returns ``model``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv1d):
                m.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                nn.init.xavier_normal_(m.weight, generator=generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.normal_(0.0, 1.0, generator=generator)
                m.bias.zero_()
                continue
            else:
                continue
            if m.bias is not None:
                m.bias.normal_(0.0, 1.0, generator=generator)
    return model
