"""crop2seg_tpu_torch.data.tooling against crop2seg_tpu/data/tooling.py on
the CPU: the cases of tests/test_tooling.py, each run by both packages on
two copies of one folder and compared file by file (the port reads and
writes its JSON records with ``json``, the JAX package with pandas, which
rounds floats to 10 decimal places): the cover statistics, the tile
grid split, the train/val/test split over two crafted tiles of 82x82
patches, the sample weights and the train norms."""
import json
import math
import os
import shutil

import numpy as np
import pytest
from scipy import ndimage

from crop2seg_tpu.data import tooling as jt
from crop2seg_tpu_torch.data import load_norm_values, make_synthetic_dataset
from crop2seg_tpu_torch.data import tooling as pt


def _copies(src, root):
    dirs = {}
    for name in ("port", "jax"):
        dirs[name] = str(root / name)
        shutil.copytree(src, dirs[name])
    return dirs


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """make_synthetic_dataset(6 patches, 32^2) with patch 2 marked REMOVED."""
    path = str(tmp_path_factory.mktemp("tool") / "data")
    make_synthetic_dataset(path, n_patches=6, hw=32)
    meta_path = os.path.join(path, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta[2]["Status"] = "REMOVED"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return path


def _load(path):
    with open(path) as f:
        return json.load(f)


def _same(a, b, where=""):
    """JSON values equal, floats to pandas' 10 decimal places, null for NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (int, float)) and not isinstance(a, bool) and b is not None:
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-10), (where, a, b)
    else:
        assert a == b, (where, a, b)


def test_cover_statistics_match_jax(synthetic, tmp_path):
    dirs = _copies(synthetic, tmp_path)
    records = pt.calc_cover_statistics(dirs["port"])
    frame = jt.calc_cover_statistics(dirs["jax"])
    name = "metadata_and_stats.json"
    _same(_load(os.path.join(dirs["port"], name)), _load(os.path.join(dirs["jax"], name)))
    assert [r["Grassland_Cover"] for r in records if r["Status"] == "OK"] == \
        frame.loc[frame["Status"] == "OK", "Grassland_Cover"].tolist()
    assert all(math.isnan(records[2][c]) for c in pt.COVER_COLUMNS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tile_grid_matches_jax(seed):
    rng = np.random.default_rng(seed)
    minority = rng.random((82, 82)) < 0.4
    flax = rng.random((82, 82)) < 0.02
    out = pt.split_tile_grid(minority, flax, np.random.default_rng(42))
    np.testing.assert_array_equal(out, jt.split_tile_grid(minority, flax,
                                                          np.random.default_rng(42)))
    counts = {s: int((out == s).sum()) for s in (1, 2, 3)}
    assert counts[1] > counts[2] and counts[1] > counts[3]
    assert counts[1] / sum(counts.values()) > 0.5
    # val / test components are cut off from train by the corridors
    grown = ndimage.binary_dilation((out == 2) | (out == 3), np.ones((3, 3)))
    assert not (grown & (out == 1)).any()


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """metadata.json and metadata_and_stats.json of two 82x82-patch tiles
    (13448 records) with random covers, a few REMOVED, some patches
    missing; no images (the split reads the stats file)."""
    path = tmp_path_factory.mktemp("tiles") / "data"
    path.mkdir()
    rng = np.random.default_rng(3)
    meta, stats = [], []
    for e, tile in enumerate(("T33UVR", "T33UWR")):
        for local in range(82 * 82):
            if rng.random() < 0.05:
                continue
            pid = e * 82 * 82 + local
            removed = rng.random() < 0.02
            rec = {"ID_PATCH": pid, "TILE": tile,
                   "Status": "REMOVED" if removed else "OK", "set": "",
                   "Background_Cover": float(rng.random() * 0.5)}
            meta.append(dict(rec))
            covers = {c: (None if removed else int(rng.integers(0, 60) * (rng.random() < 0.15)))
                      for c in pt.COVER_COLUMNS}
            stats.append({**rec, **covers})
    for name, recs in (("metadata.json", meta), ("metadata_and_stats.json", stats)):
        with open(path / name, "w") as f:
            json.dump(recs, f)
    return str(path)


def test_train_test_split_and_weights_match_jax(tiles, tmp_path):
    dirs = _copies(tiles, tmp_path)
    got = pt.create_train_test_split(dirs["port"])
    want = jt.create_train_test_split(dirs["jax"])
    assert [r["set"] for r in got] == want["set"].tolist()
    assert {r["set"] for r in got} == {"train", "val", "test", ""}
    for tile in ("T33UVR", "T33UWR"):
        name = f"patches_distribution_{tile}.npy"
        np.testing.assert_array_equal(np.load(os.path.join(dirs["port"], name)),
                                      np.load(os.path.join(dirs["jax"], name)))
    for name in ("metadata.json", "metadata_and_stats.json"):
        _same(_load(os.path.join(dirs["port"], name)), _load(os.path.join(dirs["jax"], name)),
              name)

    w_port = pt.compute_sample_weights(dirs["port"])
    w_jax = jt.compute_sample_weights(dirs["jax"])
    np.testing.assert_array_equal(w_port, w_jax)
    assert (w_port >= 1).all() and len(w_port) == sum(
        r["set"] == "train" and r["Status"] == "OK" for r in got)
    _same(_load(os.path.join(dirs["port"], "metadata.json")),
          _load(os.path.join(dirs["jax"], "metadata.json")), "weighted metadata.json")


def test_sample_weights_on_the_synthetic_dataset_match_jax(synthetic, tmp_path):
    dirs = _copies(synthetic, tmp_path)
    pt.calc_cover_statistics(dirs["port"])
    jt.calc_cover_statistics(dirs["jax"])
    np.testing.assert_array_equal(pt.compute_sample_weights(dirs["port"]),
                                  jt.compute_sample_weights(dirs["jax"]))
    _same(_load(os.path.join(dirs["port"], "metadata.json")),
          _load(os.path.join(dirs["jax"], "metadata.json")))


def test_compute_norm_vals_matches_jax(synthetic, tmp_path):
    dirs = _copies(synthetic, tmp_path)
    got = pt.compute_norm_vals(dirs["port"])
    want = jt.compute_norm_vals(dirs["jax"])
    for s in ("mean", "std"):
        np.testing.assert_allclose(got["train"][s], want["train"][s], rtol=1e-6)
    nv = load_norm_values(os.path.join(dirs["port"], "NORM_S2_patch.json"))
    assert nv["mean"].shape == (10,) and (nv["std"] > 0).all()
