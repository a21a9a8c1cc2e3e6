"""crop2seg_tpu_torch: the PyTorch / CUDA port of crop2seg_tpu for NVIDIA Hopper.

Serves and trains TimeUNet_v1 and U-TAE (whole tiles in memory, or a cell of
patches from disk to the crop map and its GIS outputs through
``webapp.pipeline``), with its own train CLI (S2TSCzCrop, synthetic data,
PASTIS's five folds) and Sentinel-2 acquisition CLI. The layout mirrors the JAX
package module for module; inputs are channels-last ``(B, T, H, W, C)``
with explicit ``(B, T)`` pad masks, and parameters carry the reference's
torch state-dict names. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. The package imports ``torch``, numpy and scipy
(matplotlib, streamlit, rasterio and requests only where a function needs
them), and nothing of JAX or crop2seg_tpu.
"""
