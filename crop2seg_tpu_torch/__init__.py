"""crop2seg_tpu_torch: the PyTorch / CUDA port of crop2seg_tpu for NVIDIA Hopper.

Serves TimeUNet_v1 whole-tile inference (eval only). The layout mirrors the
JAX package module for module; inputs are channels-last ``(B, T, H, W, C)``
with explicit ``(B, T)`` pad masks, and parameters carry the reference's
torch state-dict names. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. The package imports ``torch`` and numpy only.
"""
