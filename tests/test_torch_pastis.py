"""crop2seg_tpu_torch's PASTIS reader, its synthetic generator and the
train CLI's five-fold protocol against the JAX package on the CPU, on one
``make_synthetic_pastis`` folder (10 patches at 16^2, T 8-14, two per
fold) with an INSTANCE_ANNOTATIONS stack written beside it: both targets,
folds, NDVI, norms, mono-date, augmentation and temporal dropout item by
item against crop2seg_tpu/data/pastis.py; the two generators write the same
files; the CLI's fold splits, normalization and fold sequence against the
JAX train.py's; then one five-fold port CLI run with a tiny U-TAE and its
aggregated files."""
import importlib.util
import json
import math
import os
import pathlib

import numpy as np
import pytest

from crop2seg_tpu.data import Transform as JTransform
from crop2seg_tpu.data.pastis import PASTISDataset as JPASTIS
from crop2seg_tpu.data.pastis import compute_norm_vals as j_norm_vals
from crop2seg_tpu.data.synthetic import make_synthetic_pastis as j_make
from crop2seg_tpu_torch import train as cli
from crop2seg_tpu_torch.data import Transform, make_synthetic_pastis
from crop2seg_tpu_torch.data.pastis import PASTISDataset, compute_norm_vals
from crop2seg_tpu_torch.learning.checkpoint import aggregate_fold_cms

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW, N_PATCHES = 16, 10


def _jax_cli():
    spec = importlib.util.spec_from_file_location("crop2seg_jax_train_cli_pastis",
                                                  ROOT / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CLI = _jax_cli()


def _write_instances(folder):
    """HEATMAP / INSTANCES / ZONES for every patch: two square parcels and
    zones one pixel wider than them."""
    os.makedirs(os.path.join(folder, "INSTANCE_ANNOTATIONS"), exist_ok=True)
    rng = np.random.default_rng(1)
    for i in range(N_PATCHES):
        inst = np.zeros((HW, HW), np.int32)
        inst[2:6, 2:6] = 1
        inst[8:13, 7:11] = 2
        zones = inst.copy()
        zones[1:7, 1:7] = 1
        out = os.path.join(folder, "INSTANCE_ANNOTATIONS")
        np.save(os.path.join(out, f"HEATMAP_{i}.npy"), rng.random((HW, HW)).astype(np.float32))
        np.save(os.path.join(out, f"INSTANCES_{i}.npy"), inst)
        np.save(os.path.join(out, f"ZONES_{i}.npy"), zones)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pastis") / "data")
    make_synthetic_pastis(path, n_patches=N_PATCHES, hw=HW)
    _write_instances(path)
    return path


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*")
                  if p.is_file())


def test_generators_write_the_same_files(tmp_path):
    make_synthetic_pastis(str(tmp_path / "port"), n_patches=7, t_range=(5, 9), hw=12, seed=3)
    j_make(str(tmp_path / "jax"), n_patches=7, t_range=(5, 9), hw=12, seed=3)
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "jax") and len(names) == 2 + 2 * 7
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


NORM = {"mean": np.linspace(400, 600, 10).astype(np.float32),
        "std": np.linspace(150, 250, 10).astype(np.float32)}
CASES = {
    "raw": dict(norm=False),
    "norm_ndvi": dict(norm_values=NORM, add_ndvi=True),
    "doy_folds": dict(norm_values=NORM, use_doy=True, folds=[2, 5]),
    "abs_rel": dict(norm_values=NORM, use_abs_rel_enc=True, folds=[1]),
    "mono_date": dict(norm_values=NORM, mono_date="2019-03-01", folds=[3, 4]),
    "mono_index": dict(norm=False, mono_date=2, cache=True),
    "augment_dropout": dict(norm_values=NORM, temporal_dropout=0.3, seed=5,
                            set_type="train", transform=True),
    "val_no_dropout": dict(norm_values=NORM, temporal_dropout=0.3, set_type="val"),
    "instance": dict(norm=False, target="instance"),
    "class_mapping": dict(norm=False, class_mapping={c: c % 7 for c in range(20)}),
}


def _items(cls, transform_cls, folder, kw):
    kw = dict(kw)
    if kw.pop("transform", False):
        kw["transform"] = transform_cls()
    ds = cls(folder, **kw)
    # twice over the cached dataset: the second pass reads the RAM cache
    return [ds[i] for _ in range(2 if kw.get("cache") else 1) for i in range(len(ds))]


@pytest.mark.parametrize("case", list(CASES))
def test_items_match_jax(folder, case):
    got = _items(PASTISDataset, Transform, folder, CASES[case])
    want = _items(JPASTIS, JTransform, folder, CASES[case])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert (g["id"], g["length"]) == (w["id"], w["length"])
        for k in ("x", "dates", "y"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{case} {k}")


def test_ndvi_channel_and_instance_sizes(folder):
    """NDVI sits last, in [-1, 1]; a parcel's (h, w) fills its zone."""
    s = PASTISDataset(folder, norm_values=NORM, add_ndvi=True)[0]
    assert s["x"].shape[-1] == 11 and np.abs(s["x"][..., -1]).max() <= 1.0
    y = PASTISDataset(folder, norm=False, target="instance")[0]["y"]
    assert y.shape == (HW, HW, 7)
    assert tuple(y[1, 1, 3:5]) == (4.0, 4.0) and tuple(y[9, 8, 3:5]) == (5.0, 4.0)


def test_norm_vals_match_jax(folder, tmp_path):
    got = compute_norm_vals(folder, out_name="port_norm.json")
    want = j_norm_vals(folder, out_name="jax_norm.json")
    assert list(got) == [f"Fold_{f}" for f in range(1, 6)]
    for k in got:
        for s in ("mean", "std"):
            np.testing.assert_allclose(got[k][s], want[k][s], rtol=1e-6)
    with open(os.path.join(folder, "port_norm.json")) as f:
        assert json.load(f) == got


def test_fold_sequence_matches_jax():
    assert cli.PASTIS_FOLD_SEQUENCE == JAX_CLI.PASTIS_FOLD_SEQUENCE
    for argv in ([], ["--fold", "3"], ["--test"], ["--test", "--fold", "2"]):
        for dataset in ("pastis", "synthetic", "s2tsczcrops"):
            a = ["--dataset", dataset] + argv
            assert (cli.fold_sequence(cli.parse_config(a))
                    == JAX_CLI.fold_sequence(JAX_CLI.parse_config(a))), a
    assert cli.fold_sequence(cli.parse_config(["--dataset", "pastis"])) == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("fold", [1, 2, 3, 4, 5])
def test_build_datasets_match_jax(folder, fold):
    """Each fold's train / val / test patches and the training folds'
    normalization, as the JAX CLI builds them."""
    argv = ["--dataset", "pastis", "--dataset_folder", folder, "--fold", str(fold),
            "--augment", "--temporal_dropout", "0.2"]
    got = cli.build_datasets(cli.parse_config(argv))
    want = JAX_CLI.build_datasets(JAX_CLI.parse_config(argv))
    train_f, val_f, test_f = cli.PASTIS_FOLD_SEQUENCE[fold - 1]
    for g, w, folds in zip(got, want, (train_f, val_f, test_f)):
        assert g.id_patches == w.id_patches and len(g) == 2 * len(folds)
        assert {g.meta_patch[i]["Fold"] for i in g.id_patches} == set(folds)
        for a, b in zip(g.norm, w.norm):
            np.testing.assert_array_equal(a, b)
        gi, wi = g[0], w[0]
        np.testing.assert_array_equal(gi["x"], wi["x"])
        np.testing.assert_array_equal(gi["y"], wi["y"])
    assert got[0].transform is not None and got[0].temporal_dropout == 0.2
    assert got[1].transform is None and got[2].temporal_dropout == 0.0


def test_five_fold_cli_run(folder, tmp_path):
    """``--dataset pastis`` without ``--fold``: five folds in turn, each
    fold's files, the confusion matrices aggregated over all five folds'
    test pixels, and the overall metrics of the last fold's aggregation."""
    res = tmp_path / "run"
    cli.cli(["--device", "cpu", "--dataset", "pastis", "--dataset_folder", folder,
             "--model", "utae", "--encoder_widths", "[8,8,16]",
             "--decoder_widths", "[4,8,16]", "--out_conv", "[8,20]", "--n_head", "4",
             "--d_model", "32", "--num_classes", "20", "--batch_size", "2",
             "--t_buckets", "[14]", "--epochs", "1", "--res_dir", str(res)])
    for f in range(1, 6):
        for name in ("trainlog.json", "all_test_metrics.json", "all_conf_mat.pkl",
                     "model.ckpt"):
            assert os.path.exists(res / f"Fold_{f}" / name), (f, name)
        with open(res / f"Fold_{f}" / "all_test_metrics.json") as fh:
            assert math.isfinite(json.load(fh)["test_loss"])
    assert int(aggregate_fold_cms(str(res)).sum()) == N_PATCHES * HW * HW
    with open(res / "all_overall.json") as fh:
        overall = json.load(fh)
    assert math.isfinite(overall["micro_IoU"]) and math.isfinite(overall["Accuracy"])
    with open(res / "conf.json") as fh:
        conf = json.load(fh)
    assert conf["dataset"] == "pastis" and conf["fold"] == 5
