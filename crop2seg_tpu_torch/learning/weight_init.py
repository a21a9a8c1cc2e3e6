"""The train CLI's initialization from scratch (port of
crop2seg_tpu/learning/weight_init.py), by module type:

- Conv2d, Conv3d, ConvTranspose2d and Linear weights (the day-of-year
  encoder's fc, the depthwise and pointwise convs, the squeeze-excitation
  Linears, the classical attention's fc_q / fc_k / fc_v / fc_out and TAE2d's
  cls merges and linear reductions included): Xavier-normal (gain 1);
- the L-TAE's and TAE2d's ``inconv`` (a Conv1d): N(0, 1);
- every bias of those (MBConv's depthwise conv has one; the
  depthwise-separable convs, the SE Linears and fc_out have none): N(0, 1);
- BatchNorm (1-D, 2-D and 3-D) weight N(0, 1), bias 0;
- GroupNorm, LayerNorm, instance norm (no parameters), the attention's bare
  query ``Q``, TAE2d's cls tokens and UNet3D's transposed convs: left as
  they are (the JAX rules match these parameters by their flax names, and
  no rule matches UNet3D's ``center_out_kernel`` / ``trans3_kernel`` and
  their biases).

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
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv1d) and name.rsplit(".", 1)[-1] == "inconv":
                m.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                                nn.Linear)):
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
