"""crop2seg_tpu_torch's GIS layer and config (gis/*, config.py): copies of the
JAX package's numpy modules, held against their twins on the CPU.

- the code of every top-level function, class and constant is the JAX
  twin's, docstrings aside and module paths mapped (``same_code``), so each
  returns exactly what its twin returns on every input;
- the JAX package's own tests of these modules (tests/test_gis.py,
  test_vectorize.py, test_geo.py, test_raster_prep.py,
  test_dataset_creator.py, test_safe_legacy.py, test_sentinel.py) run
  again on the port (``test_<file>__<name>``);
- the port and the JAX functions on the same seeded inputs: outputs equal
  exactly (tolerance 0), files byte for byte.
"""
import json

import numpy as np
import pytest
import torch

from tests.torch_port_mirror import mirror_jax_tests, same_code

COPIED = ["config.py", "gis/__init__.py", "gis/dataset_creator.py", "gis/geo.py",
          "gis/postprocess.py", "gis/raster.py", "gis/raster_prep.py",
          "gis/safe_legacy.py", "gis/sentinel.py", "gis/vectorize.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copy_has_the_jax_code(rel):
    assert same_code(rel) == {}


def test_port_imports_no_jax_package():
    """The copies import their siblings in the port, never crop2seg_tpu."""
    import importlib
    import sys

    for rel in COPIED:
        name = "crop2seg_tpu_torch." + rel[:-3].replace("/__init__", "").replace("/", ".")
        mod = importlib.import_module(name)
        src = open(mod.__file__).read()
        assert "crop2seg_tpu." not in src.replace("crop2seg_tpu_torch.", ""), name
    assert "crop2seg_tpu_torch.gis" in sys.modules


# the JAX tests of these modules, run on the port; test_tiling_roundtrip
# compares with the JAX patchify (jax arrays), so it has its port version below
MIRRORED = []
for _stem, _skip in (("test_gis", ()), ("test_vectorize", ()), ("test_geo", ()),
                     ("test_raster_prep", ("test_tiling_roundtrip",)),
                     ("test_dataset_creator", ()), ("test_safe_legacy", ()),
                     ("test_sentinel", ())):
    MIRRORED += mirror_jax_tests(_stem, globals(), skip=_skip)


def test_mirrored_every_jax_case():
    assert len(MIRRORED) == 10 + 12 + 7 + 8 + 3 + 12 + 8


def test_raster_prep__tiling_roundtrip():
    """tests/test_raster_prep.py::test_tiling_roundtrip on the port: the
    tiles follow the port's patchify order (row-major)."""
    from crop2seg_tpu_torch.gis.raster_prep import fast_tiling, tile_coordinates
    from crop2seg_tpu_torch.ops.patchify import patchify_grid

    arr = np.arange(3 * 8 * 8).reshape(3, 8, 8).astype(np.float32)
    tiles = fast_tiling(arr, 4)
    assert tiles.shape == (4, 3, 4, 4)
    np.testing.assert_array_equal(tiles[1], arr[:, :4, 4:])
    assert tile_coordinates((8, 8), 4) == [(0, 0), (0, 4), (4, 0), (4, 4)]
    p = patchify_grid(torch.tensor(np.moveaxis(arr, 0, -1)), 4).numpy()
    np.testing.assert_array_equal(np.moveaxis(p, -1, 1), tiles)


# --- the two packages on the same inputs -----------------------------------

def _class_map(seed: int, hw: int = 96, k: int = 6) -> np.ndarray:
    """Blocky classes with noise: segments of many sizes."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, k, (hw // 8 + 1, hw // 8 + 1))
    cls = np.repeat(np.repeat(small, 8, 0), 8, 1)[:hw, :hw]
    flip = rng.random((hw, hw)) < 0.05
    cls[flip] = rng.integers(0, k, flip.sum())
    return cls.astype(np.uint8)


def _proba(seed: int, hw: int = 96, k: int = 6) -> np.ndarray:
    p = np.random.default_rng(seed + 100).random((hw, hw, k)).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _both(rel: str):
    import importlib

    mod = rel.replace("/", ".")
    return (importlib.import_module(f"crop2seg_tpu_torch.{mod}"),
            importlib.import_module(f"crop2seg_tpu.{mod}"))


def _assert_same(got, want, path="out"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_postprocess_same_outputs(seed):
    """polygonize, soften_by_segments, homogenize_raster,
    homogenize_boundaries and prediction_to_arrays: equal outputs."""
    port, ref = _both("gis/postprocess")
    cls, proba = _class_map(seed), _proba(seed)
    parcels = np.repeat(np.repeat(np.arange(36).reshape(6, 6), 16, 0), 16, 1)
    parcels[:, :10] = 0
    seg, seg_cls = port.polygonize(cls)
    _assert_same((seg, seg_cls), ref.polygonize(cls))
    _assert_same(port.soften_by_segments(proba, seg), ref.soften_by_segments(proba, seg))
    _assert_same(port.homogenize_raster(cls, parcels), ref.homogenize_raster(cls, parcels))
    proba16 = _proba(seed, k=16)
    _assert_same(port.homogenize_boundaries(proba16), ref.homogenize_boundaries(proba16))
    _assert_same(port.prediction_to_arrays(proba), ref.prediction_to_arrays(proba))


@pytest.mark.parametrize("seed", [0, 1])
def test_vectorize_same_outputs_and_files(tmp_path, seed):
    """segments_to_polygons, rasterize_polygons, prediction_to_points and
    the shapefile, point-shapefile and GeoJSON writers: equal outputs, the
    files byte for byte."""
    port, ref = _both("gis/vectorize")
    from crop2seg_tpu.gis.postprocess import polygonize
    from crop2seg_tpu.gis.raster import Affine as JaxAffine
    from crop2seg_tpu_torch.gis.raster import Affine

    cls = _class_map(seed)
    seg, seg_cls = polygonize(cls)
    args = (10.0, 0.0, 500000.0, 0.0, -10.0, 5600000.0)
    feats = port.segments_to_polygons(seg, seg_cls, Affine(*args))
    want = ref.segments_to_polygons(seg, seg_cls, JaxAffine(*args))
    _assert_same(feats, want)
    _assert_same(port.rasterize_polygons(feats, cls.shape, Affine(*args)),
                 ref.rasterize_polygons(want, cls.shape, JaxAffine(*args)))
    pts = port.prediction_to_points(_proba(seed), Affine(*args), stride=3)
    _assert_same(pts, ref.prediction_to_points(_proba(seed), JaxAffine(*args), stride=3))
    for side, mod, f in (("port", port, feats), ("jax", ref, want)):
        d = tmp_path / side
        d.mkdir()
        mod.write_shapefile(str(d / "p.shp"), f)
        mod.polygons_to_geojson(f, str(d / "p.geojson"), crs=32633)
        mod.write_point_shapefile(str(d / "pts.shp"), pts)
    for name in ("p.shp", "p.shx", "p.dbf", "p.geojson", "pts.shp", "pts.shx", "pts.dbf"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    _assert_same(port.read_shapefile(str(tmp_path / "port" / "p.shp")),
                 ref.read_shapefile(str(tmp_path / "jax" / "p.shp")))


def test_raster_same_files(tmp_path):
    """save_prediction_raster (the .npz sidecar without rasterio) and
    load_prediction_raster: the same arrays, the same files."""
    port, ref = _both("gis/raster")
    cls, proba = _class_map(3), _proba(3)
    args = (10.0, 0.0, 500000.0, 0.0, -10.0, 5600000.0)
    p1 = port.save_prediction_raster(str(tmp_path / "a.tif"), cls, proba, port.Affine(*args))
    p2 = ref.save_prediction_raster(str(tmp_path / "b.tif"), cls, proba, ref.Affine(*args))
    assert (p1 is None) == (p2 is None)
    got, want = port.load_prediction_raster(p1 or str(tmp_path / "a.tif")), \
        ref.load_prediction_raster(p2 or str(tmp_path / "b.tif"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("zone", [32, 33, 34])
def test_geo_same_outputs(zone):
    """UTM, S-JTSK (Krovak) and EPSG transforms on the same points."""
    port, ref = _both("gis/geo")
    rng = np.random.default_rng(zone)
    lon = rng.uniform(12.0, 18.8, 50)
    lat = rng.uniform(48.6, 51.0, 50)
    _assert_same(port.wgs84_to_utm(lon, lat, zone), ref.wgs84_to_utm(lon, lat, zone))
    e, n = ref.wgs84_to_utm(lon, lat, zone)
    _assert_same(port.utm_to_wgs84(e, n, zone), ref.utm_to_wgs84(e, n, zone))
    _assert_same(port.wgs84_to_sjtsk(lon, lat), ref.wgs84_to_sjtsk(lon, lat))
    x, y = ref.wgs84_to_sjtsk(lon, lat)
    _assert_same(port.sjtsk_to_wgs84(x, y), ref.sjtsk_to_wgs84(x, y))
    _assert_same(port.transform_coords(e, n, 32600 + zone, 5514),
                 ref.transform_coords(e, n, 32600 + zone, 5514))
    _assert_same([port.get_subtile_id(i) for i in (0, 81, 6723)],
                 [ref.get_subtile_id(i) for i in (0, 81, 6723)])


@pytest.mark.parametrize("factor", [2, 6])
def test_raster_prep_same_outputs(factor):
    """cubic / nearest upsampling, the index, the SCL covers, resampling,
    reprojection and tiling on the same rasters."""
    port, ref = _both("gis/raster_prep")
    from crop2seg_tpu.gis.raster import Affine as JaxAffine
    from crop2seg_tpu_torch.gis.raster import Affine

    rng = np.random.default_rng(factor)
    band = rng.uniform(0, 4000, (12, 12)).astype(np.float32)
    for name in ("cubic_upsample", "nearest_upsample"):
        _assert_same(getattr(port, name)(band, factor), getattr(ref, name)(band, factor))
    a, b = rng.uniform(0, 1, (2, 16, 16)).astype(np.float32)
    _assert_same(port.normalized_difference_index(a, b), ref.normalized_difference_index(a, b))
    scl = rng.integers(0, 12, (32, 32)).astype(np.uint8)
    _assert_same(port.cover_fractions(scl), ref.cover_fractions(scl))
    args = (20.0, 0.0, 500000.0, 0.0, -20.0, 5600000.0)
    got = port.raster_resample(band, Affine(*args), factor)
    want = ref.raster_resample(band, JaxAffine(*args), factor)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].to_tuple() == want[1].to_tuple()
    got = port.raster_reproject(band, Affine(*args), 32633, 32633)
    want = ref.raster_reproject(band, JaxAffine(*args), 32633, 32633)
    np.testing.assert_array_equal(got[0], want[0])
    stack = rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    _assert_same(port.fast_tiling(stack, 8), ref.fast_tiling(stack, 8))


def test_dataset_creator_same_cell(tmp_path):
    """patchify_inference, patch_affines and an inference run of
    DatasetCreator on the same small series: the same patches and
    metadata, the .npy files byte for byte."""
    port, ref = _both("gis/dataset_creator")
    from crop2seg_tpu.gis.raster import Affine as JaxAffine
    from crop2seg_tpu_torch.gis.raster import Affine

    rng = np.random.default_rng(7)
    ts = rng.integers(0, 10000, (2, 13, 1098, 1098)).astype(np.uint16)
    _assert_same(port.DatasetCreator.patchify_inference(ts[:, :2]),
                 ref.DatasetCreator.patchify_inference(ts[:, :2]))
    args = (10.0, 0.0, 500000.0, 0.0, -10.0, 5600000.0)
    _assert_same(port.patch_affines(Affine(*args), 10), ref.patch_affines(JaxAffine(*args), 10))
    dates = [20190105, 20190210]
    for side, mod, aff in (("port", port, Affine), ("jax", ref, JaxAffine)):
        dc = mod.DatasetCreator(str(tmp_path / side), for_inference=True,
                                loader=lambda name, bounds, aff=aff: (ts, aff(*args), 32633, dates))
        assert dc.run_tile("T33UVR") == 100
    for i in (0, 37, 99):
        a = (tmp_path / "port" / "DATA_S2" / f"S2_{i}.npy").read_bytes()
        assert a == (tmp_path / "jax" / "DATA_S2" / f"S2_{i}.npy").read_bytes()
    with open(tmp_path / "port" / "metadata.json") as f, \
            open(tmp_path / "jax" / "metadata.json") as g:
        assert json.load(f) == json.load(g)


def test_config_same_values(tmp_path):
    """SentinelConfig's defaults, its JSON round trip and DEFAULT_TILES."""
    port, ref = _both("config")
    assert port.DEFAULT_TILES == ref.DEFAULT_TILES
    a, b = port.SentinelConfig(), ref.SentinelConfig()
    import dataclasses

    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.with_clouds(10)) == dataclasses.asdict(b.with_clouds(10))
