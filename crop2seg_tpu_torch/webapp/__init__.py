"""Web application layer: whole-tile crop-map generation pipeline + UI (port
of crop2seg_tpu/webapp/).

The pipeline (patch picking, time-series acquisition, batched inference on
the CUDA card, crop-map post-processing, cache management) is headless and
importable (crop2seg_tpu_torch.webapp.pipeline); the Streamlit UI
(crop2seg_tpu_torch.webapp.app) is a thin shell over it, gated on streamlit
being installed.
"""
from crop2seg_tpu_torch.webapp.pipeline import (  # noqa: F401
    CacheManager, generate_prediction, get_info, tile_cell_bounds,
)
