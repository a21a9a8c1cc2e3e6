"""crop2seg_tpu_torch's data readers against the JAX package's on the same
files and seeds: the synthetic generator byte for byte, S2TSCZCropDataset
items (norm, day of year, NDVI, augmentation, temporal dropout, affine, the
cache, the light and augmented items), the BatchLoader's batches (shuffles,
T buckets, weighted sampling, drop_last), PrefetchLoader's order and the
DeviceCacheLoader's replays on the CPU. Every array equal.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from crop2seg_tpu import data as jdata
from crop2seg_tpu_torch import data as tdata
from crop2seg_tpu_torch.data.batcher import pick_bucket
from tests.torch_port_mirror import jax_native

GEN = dict(n_patches=12, t_range=(5, 11), hw=16, seed=3)
BUCKETS = (6, 8, 11)


@pytest.fixture(scope="module")
def jn(tmp_path_factory):
    """The JAX native loader built into a temporary directory, so that its
    BatchLoader(native=True) does not build beside the JAX source."""
    return jax_native(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("s2")
    tdata.make_synthetic_dataset(str(root / "port"), **GEN)
    jdata.make_synthetic_dataset(str(root / "jax"), **GEN)
    return root


def test_synthetic_dataset_files_are_byte_identical(folder):
    names = []
    for dirpath, _, files in os.walk(folder / "jax"):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), folder / "jax")
            names.append(rel)
            assert filecmp.cmp(folder / "jax" / rel, folder / "port" / rel, shallow=False), rel
    assert len(names) == 2 * GEN["n_patches"] + 2
    port = {os.path.relpath(os.path.join(d, f), folder / "port")
            for d, _, fs in os.walk(folder / "port") for f in fs}
    assert port == set(names)


def _assert_items_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        else:
            assert a[k] == b[k], k


def _datasets(folder, set_type="train", transform=False, **kw):
    path = str(folder / "jax")
    norm = jdata.load_norm_values(os.path.join(path, "NORM_S2_patch.json"))
    np.testing.assert_array_equal(
        tdata.load_norm_values(os.path.join(path, "NORM_S2_patch.json"))["mean"], norm["mean"])
    common = dict(folder=path, set_type=set_type, norm=True, norm_values=norm, seed=7, **kw)
    return (jdata.S2TSCZCropDataset(transform=jdata.Transform() if transform else None,
                                    **common),
            tdata.S2TSCZCropDataset(transform=tdata.Transform() if transform else None,
                                    **common))


OPTIONS = {
    "norm": {},
    "use_doy": dict(use_doy=True),
    "abs_rel": dict(use_abs_rel_enc=True),
    "ndvi_affine": dict(add_ndvi=True, get_affine=True),
    "augment_dropout": dict(transform=True, temporal_dropout=0.3),
    "cache_dropout": dict(cache=True, temporal_dropout=0.5),
    "mono_date": dict(mono_date="2018-12-01"),
    "val": dict(set_type="val"),
    "inference": dict(for_inference=True),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_dataset_items_match_jax(folder, option):
    jd, td = _datasets(folder, **OPTIONS[option])
    assert len(jd) == len(td) and td.id_patches == jd.id_patches
    for _ in range(2):                # twice: the cache, and fresh draws
        for i in range(len(jd)):
            _assert_items_equal(jd[i], td[i])


@pytest.mark.parametrize("augment", [False, True])
def test_light_and_aug_items_match_jax(folder, augment):
    jd, td = _datasets(folder, transform=augment, temporal_dropout=0.3 if augment else 0.0)
    for i in range(len(jd)):
        _assert_items_equal(jd.light_item(i), td.light_item(i))
        _assert_items_equal(jd.aug_item(i), td.aug_item(i))


def test_norm_values_formats(tmp_path):
    """The release format ("train") is reordered to the PASTIS band order,
    the fold format averaged over the folds asked for, the flat one kept."""
    import json

    mean = list(range(10))
    blobs = {"train": {"train": {"mean": mean, "std": [1.0] * 10}},
             "folds": {f"Fold_{k}": {"mean": [k] * 10, "std": [2.0] * 10} for k in (1, 2, 3)},
             "flat": {"mean": mean, "std": [3.0] * 10}}
    for name, blob in blobs.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(blob))
        for folds in (None, (1, 3)) if name == "folds" else (None,):
            want = jdata.load_norm_values(str(path), folds=folds)
            got = tdata.load_norm_values(str(path), folds=folds)
            for k in ("mean", "std"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    assert list(tdata.load_norm_values(str(tmp_path / "train.json"))["mean"]) == list(
        tdata.PASTIS_CHANNEL_ORDER)


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


@pytest.mark.parametrize("mode", ["shuffle", "weighted", "ordered"])
def test_batch_loader_matches_jax(folder, mode, jn):
    """The JAX BatchLoader against the port's, each on its Python path
    (native=False) and on its native path (native=True, the default of
    both), two epochs, 5 train samples in batches of 2 over the T buckets."""
    for native in (False, True):
        jd, td = _datasets(folder, transform=True, temporal_dropout=0.2)
        kw = dict(batch_size=2, t_buckets=BUCKETS, pad_value=0.0, seed=11,
                  shuffle=mode != "ordered", drop_last=mode != "ordered",
                  sample_weights=np.linspace(1, 3, len(jd)) if mode == "weighted" else None,
                  native=native)
        want = _batches(jdata.BatchLoader(jd, **kw))
        loader = tdata.BatchLoader(td, **kw)
        assert (loader._plan is not None) == native
        got = _batches(loader)
        assert len(got) == len(want) > 2
        assert len(tdata.BatchLoader(td, **kw)) == len(jdata.BatchLoader(jd, **kw))
        for a, b in zip(want, got):
            _assert_items_equal(a, b)
            assert b["x"].shape[1] in BUCKETS
    assert pick_bucket(7, BUCKETS) == 8 and pick_bucket(99, BUCKETS) == 11


def test_prefetch_loader_keeps_the_order(folder, jn):
    for native in (False, True):
        jd, td = _datasets(folder)
        want = list(jdata.BatchLoader(jd, 2, t_buckets=BUCKETS, seed=1, native=native))
        got = list(tdata.PrefetchLoader(tdata.BatchLoader(td, 2, t_buckets=BUCKETS, seed=1,
                                                          native=native)))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            _assert_items_equal(a, b)


def test_prefetch_loader_raises_the_loaders_error():
    def broken():
        yield {"x": 1}
        raise OSError("disk gone")
    it = iter(tdata.PrefetchLoader(broken()))
    assert next(it) == {"x": 1}
    with pytest.raises(OSError, match="disk gone"):
        next(it)


@pytest.mark.parametrize("cast", [None, "bf16"])
def test_device_cache_loader_replays_like_jax(folder, cast, jn):
    """Three epochs on device="cpu": the first streams and uploads, the
    later ones gather shuffles from the per-bucket stacks (train) or replay
    (val); the same batches as the JAX DeviceCacheLoader for the same seed
    (both over their BatchLoader's default, native path), x cast to bf16 on
    both sides when asked."""
    import jax.numpy as jnp

    jd, td = _datasets(folder)
    jv, tv = _datasets(folder, set_type="val")
    for (jds, tds, shuffle) in ((jd, td, True), (jv, tv, False)):
        kw = dict(batch_size=2, t_buckets=BUCKETS, seed=5, shuffle=shuffle, drop_last=shuffle)
        jl = jdata.DeviceCacheLoader(jdata.BatchLoader(jds, **kw),
                                     cast=jnp.bfloat16 if cast else None, shuffle=shuffle,
                                     seed=9)
        tl = tdata.DeviceCacheLoader(tdata.BatchLoader(tds, **kw),
                                     cast=torch.bfloat16 if cast else None, shuffle=shuffle,
                                     seed=9, device="cpu")
        for epoch in range(3):
            want, got = list(jl), list(tl)
            assert len(got) == len(want) == len(tl) and got, (shuffle, epoch)
            for a, b in zip(want, got):
                assert a.keys() == b.keys() == {"x", "dates", "pad_mask", "y"}
                for k in a:
                    assert b[k].device.type == "cpu"
                    want_k = np.asarray(a[k].astype(jnp.float32) if k == "x" else a[k])
                    np.testing.assert_array_equal(b[k].float().numpy() if k == "x"
                                                  else b[k].numpy(), want_k, err_msg=k)
                assert b["x"].dtype == (torch.bfloat16 if cast else torch.float32)


def test_device_cache_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.DeviceCacheLoader([], shuffle=False)
