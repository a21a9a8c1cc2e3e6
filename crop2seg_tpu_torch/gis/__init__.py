"""GIS layer: raster post-processing, vectorization, parcel homogenization
(a copy of crop2seg_tpu/gis/; numpy and scipy only).

Host-side (numpy/scipy) re-design of reference src/helpers/postprocess.py
and the raster utilities in sentinel2raster.py. Raster-space operations
(vectorize, soften, homogenize, boundary instance splitting) are implemented
in pure numpy/scipy and fully tested; file-format/vector-IO tails (GeoTIFF,
shapefile, CRS reprojection) degrade gracefully when rasterio/geopandas/
pyproj are absent (each is an optional, lazy import).
"""
from crop2seg_tpu_torch.gis.postprocess import (
    polygonize, soften_by_segments, homogenize_raster, homogenize_boundaries,
    prediction_to_arrays,
)
from crop2seg_tpu_torch.gis.raster import Affine, GeoRef, save_prediction_raster
