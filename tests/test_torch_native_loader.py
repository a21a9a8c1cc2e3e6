"""crop2seg_tpu_torch's native C++ batch loader (native/) and the native path
of its BatchLoader, on the CPU, held against the JAX package's loader and
against the port's own Python collate path.

Tolerances:
- the port's loader against the JAX loader: bit for bit (the same source,
  built by the same compiler with the same flags), for every source dtype
  (f4, f2, u2, i2, u1), both layouts, f4 and bf16 output, with and without
  the augmentation's gather maps;
- the native BatchLoader against the Python collate path: 1e-6 (the loader
  standardizes as (x - mean) * (1 / std), the Python path as
  (x - mean) / std; one rounding apart), as the JAX tests hold them.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

from crop2seg_tpu_torch import native
from tests.torch_port_mirror import jax_native

PASTIS = [2, 1, 0, 4, 5, 6, 3, 7, 8, 9]


@pytest.fixture(scope="module")
def jn(tmp_path_factory):
    return jax_native(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Six training patches of 32^2, T 7-12 (tests/test_native_loader.py's)."""
    folder = tmp_path_factory.mktemp("ds")
    os.makedirs(folder / "DATA_S2")
    os.makedirs(folder / "ANNOTATIONS")
    rng = np.random.default_rng(0)
    records = []
    for i, t in enumerate([9, 12, 7, 12, 10, 8]):
        np.save(folder / "DATA_S2" / f"S2_{i}.npy",
                rng.normal(500, 100, (t, 10, 32, 32)).astype(np.float32))
        np.save(folder / "ANNOTATIONS" / f"TARGET_{i}.npy",
                rng.integers(0, 15, (32, 32)).astype(np.int64))
        records.append({
            "ID_PATCH": i, "TILE": "T33UVR", "Status": "OK", "set": "train",
            "Fold": 1, "crs": 32633, "time-series_length": t,
            "dates-S2": {str(j): 20190101 + j for j in range(t)}})
    with open(folder / "metadata.json", "w") as f:
        json.dump(records, f)
    return str(folder)


def _datasets(dataset_dir, **kw):
    """The same dataset through the port and through the JAX package."""
    from crop2seg_tpu.data import S2TSCZCropDataset as JaxDataset
    from crop2seg_tpu_torch.data import S2TSCZCropDataset

    norm = {"mean": np.full(10, 500.0), "std": np.full(10, 100.0)}
    args = dict(norm=True, norm_values=norm, set_type="train", **kw)
    return S2TSCZCropDataset(dataset_dir, **args), JaxDataset(dataset_dir, **args)


def _bits(x) -> np.ndarray:
    """The raw bytes of a loader output (a bf16 tensor, an ml_dtypes bf16
    array or a float32 array)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


def _archive(path, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        arr = rng.normal(500, 100, shape).astype(dtype)
    else:
        arr = rng.integers(0, 250, shape).astype(dtype)
    np.save(path, arr)
    return arr


@pytest.mark.parametrize("aug", [False, True], ids=["plain", "gather_maps"])
@pytest.mark.parametrize("out_dtype", ["f4", "bf16"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", ["f4", "f2", "u2", "i2", "u1"])
def test_load_batch_matches_jax_bit_for_bit(tmp_path, jn, dtype, layout, out_dtype, aug):
    """Three archives of one source dtype (T 6, 3, 8; 16^2) into a T = 8
    bucket: x, the pad mask and the lengths of both loaders agree bit for
    bit; with ``aug`` through per-sample frame and pixel gathers."""
    from crop2seg_tpu_torch.data.transforms import Transform

    paths = []
    for i, t in enumerate((6, 3, 8)):
        paths.append(str(tmp_path / f"a{i}.npy"))
        _archive(paths[-1], np.dtype(dtype), (t, 10, 16, 16), seed=i)
    kw = dict(reorder=PASTIS, mean=np.linspace(50, 400, 10), std=np.linspace(20, 90, 10),
              pad_value=0.5, layout=layout, out_dtype=out_dtype)
    if aug:
        kw["frame_maps"] = np.array([[5, 3, 0, -1, -1, -1, -1, -1],
                                     [2, 1, 0, -1, -1, -1, -1, -1],
                                     [0, 2, 4, 6, 7, -1, -1, -1]], np.int32)
        kw["gathers"] = np.stack([Transform.index_map(16, 16, deg, flip)
                                  for deg, flip in ((90, 0), (0, 1), (270, 1))])
    x, mask, lengths = native.load_batch(paths, 8, 16, 16, **kw)
    jx, jmask, jlengths = jn.load_batch(paths, 8, 16, 16, **kw)
    want_shape = (3, 8, 10, 16, 16) if layout == "nchw" else (3, 8, 16, 16, 10)
    assert tuple(x.shape) == want_shape
    assert isinstance(x, torch.Tensor if out_dtype == "bf16" else np.ndarray)
    np.testing.assert_array_equal(_bits(x), _bits(jx))
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(lengths, jlengths)


def test_load_batch_fills_a_callers_buffer(tmp_path):
    """``out``: a bf16 (or float32) CPU tensor is filled in place and
    returned; a buffer of another shape or dtype is refused."""
    p = str(tmp_path / "a.npy")
    _archive(p, np.float32, (4, 10, 8, 8), seed=3)
    want, _, _ = native.load_batch([p], 5, 8, 8, layout="nchw", out_dtype="bf16")
    buf = torch.full((1, 5, 10, 8, 8), 7.0, dtype=torch.bfloat16)
    x, _, _ = native.load_batch([p], 5, 8, 8, layout="nchw", out_dtype="bf16", out=buf)
    assert x is buf
    torch.testing.assert_close(buf, want, rtol=0, atol=0)
    want32, _, _ = native.load_batch([p], 5, 8, 8)
    buf32 = torch.zeros((1, 5, 8, 8, 10))
    native.load_batch([p], 5, 8, 8, out=buf32)
    np.testing.assert_array_equal(buf32.numpy(), want32)
    with pytest.raises(ValueError, match="out must be"):
        native.load_batch([p], 5, 8, 8, out_dtype="bf16",
                          out=torch.zeros((1, 5, 10, 8, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="out must be"):
        native.load_batch([p], 5, 8, 8, layout="nchw", out_dtype="f4", out=buf)


def test_library_builds_into_the_build_dir():
    """The library is keyed by a hash of the source and the flags, under
    crop2seg_tpu_torch/_build/, never beside its source."""
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "crop2seg_tpu_torch"
    assert path.name.startswith("loader-") and path.suffix == ".so"


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    """No silent fallback: a source g++ refuses raises RuntimeError that
    carries the compiler's message."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native loader build failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert not (tmp_path / "_build" / native.library_path().name).exists()


def test_native_matches_python_collate(dataset_dir):
    """tests/test_native_loader.py's case on the port: the native batches
    equal the Python path's (1e-6) and the JAX native batches bit for bit."""
    from crop2seg_tpu.data.batcher import BatchLoader as JaxLoader
    from crop2seg_tpu_torch.data.batcher import BatchLoader

    ds, jds = _datasets(dataset_dir)
    assert ds.native_batch_plan() is not None
    kw = dict(batch_size=3, shuffle=False, drop_last=False, t_buckets=(12,))
    py = list(BatchLoader(ds, native=False, **kw))
    loader = BatchLoader(ds, **kw)            # native by default
    assert loader._plan is not None
    nat = list(loader)
    jnat = list(JaxLoader(jds, native=True, **kw))
    assert len(py) == len(nat) == len(jnat) == 2
    for bp, bn, bj in zip(py, nat, jnat):
        assert set(bp) == set(bn) == set(bj)
        for k in bp:
            np.testing.assert_allclose(np.asarray(bn[k], np.float64),
                                       np.asarray(bp[k], np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(bn[k], bj[k], err_msg=k)


PLAN_CASES = {
    "plain": {},
    "temporal_dropout": {"temporal_dropout": 0.5},
    "ndvi": {"add_ndvi": True},
    "mono_date": {"mono_date": 2},
    "ram_cache": {"cache": True},
    "geometric": {"transform": "Transform()"},
    "noise": {"transform": "Transform(add_noise=True)"},
    "crop": {"transform": "Transform(crop=True)"},
    "geometric_val": {"transform": "Transform()", "set_type": "val"},
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_native_plan_gating(dataset_dir, case):
    """native_batch_plan gives the JAX dataset's plan (or None) for every
    option: NDVI, mono-date, the RAM cache, noise and crop need Python;
    flip+rotate and temporal dropout run natively."""
    from crop2seg_tpu.data.transforms import Transform as JaxTransform
    from crop2seg_tpu_torch.data.transforms import Transform

    kw = dict(PLAN_CASES[case])
    set_type = kw.pop("set_type", "train")
    spec = kw.pop("transform", None)
    port_kw, jax_kw = dict(kw), dict(kw)
    if spec:
        port_kw["transform"] = eval(spec, {"Transform": Transform})
        jax_kw["transform"] = eval(spec, {"Transform": JaxTransform})
    from crop2seg_tpu.data import S2TSCZCropDataset as JaxDataset
    from crop2seg_tpu_torch.data import S2TSCZCropDataset

    norm = {"mean": np.full(10, 500.0), "std": np.full(10, 100.0)}
    plan = S2TSCZCropDataset(dataset_dir, norm=True, norm_values=norm,
                             set_type=set_type, **port_kw).native_batch_plan()
    want = JaxDataset(dataset_dir, norm=True, norm_values=norm, set_type=set_type,
                      **jax_kw).native_batch_plan()
    assert (plan is None) == (want is None)
    if want is not None:
        assert plan["reorder"] == want["reorder"] and plan["augment"] == want["augment"]
        np.testing.assert_array_equal(plan["mean"], want["mean"])
        np.testing.assert_array_equal(plan["std"], want["std"])


def test_native_npy_shape(dataset_dir, jn):
    path = os.path.join(dataset_dir, "DATA_S2", "S2_0.npy")
    assert native.npy_shape(path) == jn.npy_shape(path) == (9, 10, 32, 32)


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.uint8, np.float16])
def test_native_archives_widen(tmp_path, dtype):
    """Integer archives (the reference dataset creator saves DATA_S2 as
    uint16) and float16 ones are widened, reordered and standardized
    (1e-5 against numpy; test_native_loader.py's cases)."""
    arr = _archive(str(tmp_path / "u.npy"), dtype, (6, 10, 16, 16), seed=2)
    x, mask, lengths = native.load_batch(
        [str(tmp_path / "u.npy")], 8, 16, 16, reorder=PASTIS,
        mean=np.full(10, 100.0), std=np.full(10, 50.0))
    assert lengths[0] == 6 and mask[0].tolist() == [False] * 6 + [True] * 2
    want = (arr.astype(np.float32)[:, PASTIS] - 100.0) / 50.0
    np.testing.assert_allclose(x[0, :6], np.transpose(want, (0, 2, 3, 1)),
                               rtol=1e-5, atol=1e-5)


def test_load_batch_mean_without_std_raises(tmp_path):
    p = str(tmp_path / "v.npy")
    np.save(p, np.zeros((2, 3, 4, 4), np.float32))
    with pytest.raises(ValueError, match="together"):
        native.load_batch([p], 4, 4, 4, mean=np.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        native.load_batch([p], 4, 4, 4, mean=np.zeros(2), std=np.ones(2))


def test_batcher_falls_back_on_bad_native_file(dataset_dir, tmp_path, caplog):
    """A file the parser rejects raises OSError in the loader; mid-run, the
    BatchLoader warns and takes the Python path, whose batches it then
    gives (here: one patch's archive replaced by complex64 data, which
    numpy reads and the loader does not)."""
    import shutil

    from crop2seg_tpu_torch.data.batcher import BatchLoader

    p = str(tmp_path / "c8.npy")
    np.save(p, np.zeros((3, 10, 32, 32), np.complex64))
    with pytest.raises(OSError):
        native.load_batch([p], 4, 32, 32)

    folder = tmp_path / "ds"
    shutil.copytree(dataset_dir, folder)
    arr = np.load(folder / "DATA_S2" / "S2_4.npy")
    np.save(folder / "DATA_S2" / "S2_4.npy", arr.astype(np.float64))
    ds, _ = _datasets(str(folder))
    kw = dict(batch_size=3, shuffle=False, drop_last=False, t_buckets=(12,))
    loader = BatchLoader(ds, **kw)
    assert loader._plan is not None
    with caplog.at_level(logging.WARNING):
        got = list(loader)
    assert loader._plan is None
    assert any("Python collate path" in r.getMessage() for r in caplog.records)
    want = list(BatchLoader(ds, native=False, **kw))
    np.testing.assert_array_equal(got[1]["x"], want[1]["x"])
    np.testing.assert_allclose(got[0]["x"], want[0]["x"], rtol=1e-6, atol=1e-6)


def test_native_augmented_matches_python_and_jax(dataset_dir):
    """Flip+rotate and temporal dropout through the gather maps: the same
    batches as the Python __getitem__ path for the same generator (1e-6),
    and as the JAX native path bit for bit."""
    from crop2seg_tpu.data.batcher import BatchLoader as JaxLoader
    from crop2seg_tpu.data.transforms import Transform as JaxTransform
    from crop2seg_tpu_torch.data.batcher import BatchLoader
    from crop2seg_tpu_torch.data.transforms import Transform

    ds_py, _ = _datasets(dataset_dir, transform=Transform(), temporal_dropout=0.3)
    ds_nat, _ = _datasets(dataset_dir, transform=Transform(), temporal_dropout=0.3)
    _, jds = _datasets(dataset_dir, transform=JaxTransform(), temporal_dropout=0.3)
    assert ds_nat.native_batch_plan()["augment"]
    kw = dict(batch_size=3, shuffle=False, drop_last=False, t_buckets=(8, 12))
    py = list(BatchLoader(ds_py, native=False, **kw))
    nat = list(BatchLoader(ds_nat, **kw))
    jnat = list(JaxLoader(jds, native=True, **kw))
    assert len(py) == len(nat) == len(jnat) == 2
    for bp, bn, bj in zip(py, nat, jnat):
        assert set(bp) == set(bn) == set(bj)
        for k in bp:
            np.testing.assert_allclose(np.asarray(bn[k], np.float64),
                                       np.asarray(bp[k], np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(bn[k], bj[k], err_msg=k)


def test_train_cli_loader_takes_the_native_path(tmp_path):
    """The train CLI's training BatchLoader on the synthetic dataset holds
    a native plan, so the CLI decodes natively, as the JAX CLI does."""
    from crop2seg_tpu_torch import train as cli
    from crop2seg_tpu_torch.data import BatchLoader, make_synthetic_dataset

    folder = str(tmp_path / "syn")
    make_synthetic_dataset(folder, n_patches=6, t_range=(5, 8), hw=16)
    cfg = cli.parse_config(["--dataset", "synthetic", "--dataset_folder", folder])
    dt_train = cli.build_datasets(cfg)[0]
    loader = BatchLoader(dt_train, 2, t_buckets=(8,))
    assert loader._plan is not None
    batch = next(iter(loader))
    assert batch["x"].shape == (2, 8, 16, 16, 10) and np.isfinite(batch["x"]).all()
