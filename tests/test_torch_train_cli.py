"""crop2seg_tpu_torch's train CLI (``python -m crop2seg_tpu_torch.train``)
end to end on the CPU, on a synthetic dataset of 10 patches at 16^2, T 5-12,
with narrow widths. Against the JAX CLI (train.py, loaded by its path) on
the same folder and flags: the same files, JSON keys and pickles after a
run, a resume and a --test; a resume starts at the same epoch and writes
the same conf.json; --test of one reference-layout checkpoint gives the
same test metrics, confusion matrices and fold aggregation. The port alone:
TimeUNet for 2 epochs (in a subprocess, as a user runs it) writes that
layout with finite metrics; a resume to epoch 3 continues after the best
epoch with Adam's step count restored; ``--test`` repeats the run's test
metrics; ``--finetune`` with another class count keeps a fresh head; U-TAE
trains with the boundary loss, frozen layers, the device cache and bf16,
and writes a profiler trace of its first epoch; every flag of a feature not
ported yet raises; and no module of the package imports JAX, the JAX
package, pandas or orbax.
"""
import ast
import contextlib
import importlib.util
import json
import logging
import math
import os
import pathlib
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from crop2seg_tpu_torch import train as cli
from crop2seg_tpu_torch.data import make_synthetic_dataset
from crop2seg_tpu_torch.models.factory import get_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
NARROW = ["--encoder_widths", "[8,8]", "--decoder_widths", "[8,8]", "--out_conv", "[8,15]",
          "--n_head", "2", "--d_model", "16", "--batch_size", "2", "--t_buckets", "[8,12]",
          "--display_step", "2"]
# one T bucket: the JAX CLI compiles its steps once
ONE_BUCKET = NARROW[:NARROW.index("--t_buckets")] + ["--t_buckets", "[12]", "--display_step", "2"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "data"
    make_synthetic_dataset(str(path), n_patches=10, t_range=(5, 12), hw=16)
    return str(path)


def _argv(data, res_dir, *extra, model="timeunet"):
    return ["--device", "cpu", "--dataset", "synthetic", "--dataset_folder", data,
            "--res_dir", str(res_dir), "--model", model] + NARROW + list(extra)


def _run(argv):
    return cli.main(cli.parse_config(argv))


def _jax_cli():
    """The JAX package's train.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location("crop2seg_jax_train_cli",
                                                  ROOT / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(v):
    if isinstance(v, dict):
        return {k: _keys(x) for k, x in v.items()}
    if isinstance(v, list) and v and isinstance(v[0], dict):
        return [_keys(x) for x in v]
    return None


def _layout(res_dir):
    """What a run wrote, without the values it computed: the entries of the
    result folder and of Fold_1 (a checkpoint is one entry: JAX writes a
    directory where the port writes a file), every JSON file's keys,
    nested, and every pickle's names, dtypes and shapes."""
    out = {}
    for sub in ("", "Fold_1"):
        folder = os.path.join(res_dir, sub)
        out[sub or "."] = sorted(os.listdir(folder))
        for name in out[sub or "."]:
            path = os.path.join(folder, name)
            if name.endswith(".json"):
                with open(path) as f:
                    out[os.path.join(sub, name)] = _keys(json.load(f))
            elif name.endswith(".pkl"):
                with open(path, "rb") as f:
                    out[os.path.join(sub, name)] = {
                        k: (str(v.dtype), v.shape) for k, v in pickle.load(f).items()}
    return out


@contextlib.contextmanager
def _epochs_logged():
    """The epochs a CLI announces ("EPOCH n/N", on the root logger's
    handlers: the JAX CLI logs there, the port's logger propagates there)."""
    epochs = []

    class Handler(logging.Handler):
        def emit(self, record):
            m = re.match(r"EPOCH (\d+)/", record.getMessage())
            if m:
                epochs.append(int(m.group(1)))
    handler, root = Handler(), logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield epochs
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


@pytest.fixture(scope="module")
def jax_and_port(data, tmp_path_factory):
    """The JAX CLI (train.py) and the port's on the same folder with the same
    flags: TimeUNet for 2 epochs, validated at epoch 2 only; each resumed
    from its own folder to epoch 3 with another --lr and --display_step
    (conf.json's win); each tested with --test from
    one reference-layout model.pth.tar (the same weights on both sides).
    Returns {"jax" | "port": {"first", "resumed", "tested": folder,
    "epochs": the resumed run's logged epochs}}."""
    root = tmp_path_factory.mktemp("vs_jax")
    jax_cli = _jax_cli()

    def jax_main(argv):
        # an empty C2S_JAX_CACHE keeps train.py from moving JAX's compile
        # cache for the rest of the process
        old = os.environ.get("C2S_JAX_CACHE")
        os.environ["C2S_JAX_CACHE"] = ""
        try:
            return jax_cli.main(jax_cli.parse_config(argv))
        finally:
            if old is None:
                del os.environ["C2S_JAX_CACHE"]
            else:
                os.environ["C2S_JAX_CACHE"] = old
    mains = {"jax": jax_main, "port": _run}
    flags = ["--device", "cpu", "--dataset", "synthetic", "--dataset_folder", data,
             "--model", "timeunet", "--val_every", "2"] + ONE_BUCKET
    torch.manual_seed(5)
    weights = root / "weights"
    os.makedirs(weights / "Fold_1")
    model = get_model(vars(cli.parse_config(flags)), device="cpu")
    torch.save({"state_dict": model.state_dict()}, weights / "Fold_1" / "model.pth.tar")
    out = {}
    for name, main in mains.items():
        run = {k: str(root / name / k) for k in ("first", "resumed", "tested")}
        main(flags + ["--res_dir", run["first"], "--epochs", "2"])
        with _epochs_logged() as epochs:
            main(flags + ["--res_dir", run["resumed"], "--epochs", "3", "--weight_folder",
                          run["first"], "--lr", "0.01", "--display_step", "1"])
        run["epochs"] = epochs
        main(flags + ["--res_dir", run["tested"], "--test", "--weight_folder", str(weights)])
        out[name] = run
    return out


@pytest.mark.parametrize("stage", ["first", "resumed", "tested"])
def test_cli_writes_the_jax_clis_files_and_keys(jax_and_port, stage):
    """The same entries in the result folder and in Fold_1, the same keys in
    every JSON file (conf.json, trainlog.json with its epochs, the test
    metrics, best_ckpt.json, the overall and per-class files) and the same
    pickled confusion matrices as train.py, after a run, a resume and a
    --test."""
    assert _layout(jax_and_port["port"][stage]) == _layout(jax_and_port["jax"][stage])


def test_resume_starts_and_merges_conf_json_as_jax(jax_and_port):
    """A resume starts at the epoch train.py's does (after the best, epoch
    2) and writes the same conf.json: the weight folder's values, but for
    the keys the command line keeps (the folders, epochs, batch size)."""
    jax, port = jax_and_port["jax"], jax_and_port["port"]
    assert port["epochs"] == jax["epochs"] == [3]

    def conf(run):
        with open(os.path.join(run["resumed"], "conf.json")) as f:
            text = f.read()
        return json.loads(text.replace(os.path.dirname(run["first"]), "<run>"))
    assert conf(port) == conf(jax)
    assert conf(port)["lr"] == 0.001 and conf(port)["display_step"] == 2


def test_test_mode_on_a_reference_checkpoint_matches_jax(jax_and_port):
    """--test of the same model.pth.tar: the port's test metrics, confusion
    matrices and fold aggregation (the overall and per-class files) equal
    train.py's within 1e-5 (the losses) or exactly (the counts and the
    scores derived from them)."""
    jax, port = (os.path.join(jax_and_port[k]["tested"]) for k in ("jax", "port"))

    def read(run, rel):
        with open(os.path.join(run, rel), "rb" if rel.endswith(".pkl") else "r") as f:
            return pickle.load(f) if rel.endswith(".pkl") else json.load(f)
    cm_p, cm_j = read(port, "Fold_1/all_conf_mat.pkl"), read(jax, "Fold_1/all_conf_mat.pkl")
    for k in cm_j:
        np.testing.assert_array_equal(cm_p[k], cm_j[k], err_msg=k)
    test_p, test_j = read(port, "Fold_1/all_test_metrics.json"), read(jax, "Fold_1/all_test_metrics.json")
    for k, v in test_j.items():
        if not k.endswith("epoch_time"):
            np.testing.assert_allclose(test_p[k], v, rtol=1e-5, err_msg=k)
    for rel in ("all_overall.json", "all_per_class.json"):
        assert read(port, rel) == read(jax, rel) or _nan_equal(read(port, rel), read(jax, rel))


def _nan_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nan_equal(a[k], b[k]) for k in a)
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


def _check_outputs(res_dir, epochs, jax_layout, boundary=False):
    """A port run's files hold finite metrics and the JAX run's layout: its
    entries (the checkpoints aside), its test metrics' keys, and per
    validated epoch its trainlog keys (with the boundary head's two more in
    each split)."""
    got = _layout(res_dir)
    for sub in (".", "Fold_1"):
        assert ([n for n in got[sub] if not n.startswith("ckpt_e")]
                == [n for n in jax_layout[sub] if not n.startswith("ckpt_e")])
    assert any(n.startswith("ckpt_e") for n in got["Fold_1"])

    def extra(split):
        return {f"{split}_accuracy_b": None, f"{split}_IoU_b": None} if boundary else {}
    validated = jax_layout["Fold_1/trainlog.json"][str(max(map(int, jax_layout[
        "Fold_1/trainlog.json"])))]
    with open(os.path.join(res_dir, "Fold_1", "trainlog.json")) as f:
        log = json.load(f)
    assert sorted(int(e) for e in log) == list(epochs)
    for m in log.values():
        assert _keys(m) == {**validated, **extra("train"), **extra("val")}
        assert all(math.isfinite(v) for v in m.values())
    with open(os.path.join(res_dir, "Fold_1", "all_test_metrics.json")) as f:
        test = json.load(f)
    assert _keys(test) == {**jax_layout["Fold_1/all_test_metrics.json"], **extra("test")}
    assert all(math.isfinite(v) for v in test.values())
    cms = got["Fold_1/all_conf_mat.pkl"]
    want = dict(jax_layout["Fold_1/all_conf_mat.pkl"])
    if boundary:
        want["boundary"] = ("int64", (2, 2))
    assert cms == want
    for rel in ("all_overall.json", "all_per_class.json"):
        assert got[rel] == jax_layout[rel]
    return test


@pytest.fixture(scope="module")
def timeunet_run(data, tmp_path_factory):
    """Two epochs of TimeUNet through ``python -m crop2seg_tpu_torch.train``."""
    res = tmp_path_factory.mktemp("cli") / "timeunet"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "crop2seg_tpu_torch.train",
                           *_argv(data, res, "--epochs", "2")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TESTING BEST EPOCH" in proc.stderr
    return str(res)


def test_cli_trains_validates_and_tests_timeunet(timeunet_run, jax_and_port):
    _check_outputs(timeunet_run, (1, 2), _layout(jax_and_port["jax"]["first"]))
    with open(os.path.join(timeunet_run, "conf.json")) as f:
        conf = json.load(f)
    assert conf["model"] == "timeunet" and conf["encoder_widths"] == [8, 8]


def test_resume_continues_with_adam_restored(data, timeunet_run, tmp_path):
    """A resume continues after the best epoch (the checkpoint model.ckpt
    holds), as the JAX CLI resumes."""
    from crop2seg_tpu_torch.learning.checkpoint import load_state

    n_train = 7 // 2            # 7 train patches, batches of 2, drop_last
    best = load_state(os.path.join(timeunet_run, "Fold_1"))["meta"]["epoch"]
    run = _run(_argv(data, tmp_path, "--epochs", "3", "--weight_folder", timeunet_run))
    assert run.start_epoch == best + 1
    assert run.restored_adam_step == best * n_train and run.adam_step == 3 * n_train
    assert sorted(run.trainlog) == [1, 2, 3]
    assert all(math.isfinite(v) for v in run.test_metrics.values())


def test_test_mode_repeats_the_runs_test(data, timeunet_run, tmp_path):
    run = _run(_argv(data, tmp_path, "--test", "--weight_folder", timeunet_run))
    with open(os.path.join(timeunet_run, "Fold_1", "all_test_metrics.json")) as f:
        want = json.load(f)
    for k, v in want.items():
        if not k.endswith("epoch_time"):
            np.testing.assert_allclose(run.test_metrics[k], v, rtol=1e-6, err_msg=k)
    assert run.trainlog == {} and os.path.exists(tmp_path / "Fold_1" / "all_test_metrics.json")


def test_finetune_with_another_class_count_keeps_a_fresh_head(data, timeunet_run, tmp_path,
                                                              caplog):
    argv = _argv(data, tmp_path, "--finetune", "--weight_folder", timeunet_run,
                 "--epochs", "1", "--num_classes", "16")
    argv[argv.index("[8,15]")] = "[8,16]"
    with caplog.at_level(logging.INFO, logger="crop2seg_tpu_torch.train"):
        run = _run(argv)
    fresh = {r.getMessage().split()[-3] for r in caplog.records
             if "fresh init" in r.getMessage()}
    # the head's last conv and its BatchNorm, and nothing else
    assert fresh == {f"out_conv.conv.conv.{k}" for k in (
        "3.weight", "3.bias", "4.weight", "4.bias", "4.running_mean", "4.running_var")}
    assert run.start_epoch == 1 and math.isfinite(run.test_metrics["test_loss"])


def test_merge_pretrained_keeps_mismatched_and_missing_leaves():
    fresh = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    loaded = {"a": torch.ones(2), "b": torch.ones(4)}
    merged, skipped = cli.merge_pretrained(fresh, loaded)
    assert torch.equal(merged["a"], torch.ones(2)) and torch.equal(merged["b"], torch.zeros(3))
    assert skipped == ["b", "c (missing)"]


def test_utae_with_boundary_loss_frozen_layers_device_cache_bf16(data, tmp_path, caplog,
                                                                jax_and_port):
    argv = _argv(data, tmp_path / "res", "--epochs", "2", "--add_boundary_loss", "--device_cache",
                 "--bf16", "--freeze_layers", "in_conv,down", "--profile",
                 str(tmp_path / "trace"), model="utae")
    argv[argv.index("[8,8]")] = "[8,8,16]"
    argv[argv.index("[8,8]")] = "[8,8,16]"
    with caplog.at_level(logging.INFO, logger="crop2seg_tpu_torch.train"):
        run = _run(argv)
    _check_outputs(str(tmp_path / "res"), (1, 2), _layout(jax_and_port["jax"]["first"]),
                   boundary=True)
    assert any(r.getMessage().startswith("freezing ") for r in caplog.records)
    assert run.adam_step == 2 * (7 // 2)
    # --profile: epoch 1's third step, after the skipped one and the profiler's warm-up
    assert sorted(os.listdir(tmp_path / "trace")) == ["spans.json", "trace.json"]
    with open(tmp_path / "trace" / "spans.json") as f:
        spans = json.load(f)
    assert spans["spans"]["step"]["calls"] == 1 and spans["counters"]["step.samples"] == 2


def test_sample_weights_fill_missing_with_one():
    class Stub:
        id_patches = [3, 1, 2]
        meta_patch = {1: {"weight": 2.0}, 2: {"weight": None}, 3: {"weight": float("nan")}}
    np.testing.assert_array_equal(cli.sample_weights(Stub()), [1.0, 2.0, 1.0])
    Stub.meta_patch = {i: {} for i in (1, 2, 3)}
    assert cli.sample_weights(Stub()) is None


@pytest.mark.parametrize("extra,match", [
    # --num_devices is ported (parallel/mesh.py); what it still refuses, as
    # the JAX CLI does, is a batch the ranks do not divide
    pytest.param(["--num_devices", "3"], "divisible by --num_devices", id="extra0-M11"),
    (["--add_boundary_loss"], "no boundary head"),
    (["--model", "timeunet_v3"], "no such model"), (["--platform", "cpu"], "--device")])
def test_unported_flags_raise(data, tmp_path, extra, match):
    argv = _argv(data, tmp_path / "res") + extra
    with pytest.raises(SystemExit, match=match):
        _run(argv)
    assert not os.path.exists(tmp_path / "res")


@pytest.mark.parametrize("model,extra", [
    ("timeunet_v2", []), ("unet3d", []), ("convgru", []), ("uconvlstm", []),
    ("convlstm", []), ("unet_naive", ["--t_buckets", "[12]", "--max_temp", "12"])])
def test_every_model_of_the_jax_cli_trains(data, tmp_path, model, extra):
    """Each model the JAX CLI's --model names trains for an epoch on the CPU
    and tests with finite metrics (the baselines at their fixed widths;
    unet_naive with --max_temp, its batches padded to that T)."""
    run = _run(_argv(data, tmp_path / "res", "--epochs", "1", *extra, model=model))
    assert run.adam_step == 7 // 2
    assert all(math.isfinite(v) for v in run.test_metrics.values())


def test_the_card_is_the_default(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = _argv(data, tmp_path)
    argv[argv.index("--device"):argv.index("--device") + 2] = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(argv)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "crop2seg_tpu", "pandas", "orbax")


def test_package_imports_no_jax_pandas_or_orbax():
    """Every import statement of every module of the package, top level or
    inside a function."""
    found = []
    for path in sorted((ROOT / "crop2seg_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    found.append(f"{path.relative_to(ROOT)}: {name}")
    assert not found, found


def test_main_gives_the_backend_flags_back():
    """The CLI's run turns TF32 and cuDNN's benchmarking off (so --test
    repeats a run) and leaves the process's own settings as it found them."""
    flags = ((torch.backends.cudnn, "benchmark"), (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cuda.matmul, "allow_tf32"))
    saved = [getattr(o, n) for o, n in flags]
    try:
        for o, n in flags:
            setattr(o, n, True)
        with cli._repeatable_backends():
            assert [getattr(o, n) for o, n in flags] == [False] * 3
        assert [getattr(o, n) for o, n in flags] == [True] * 3
    finally:
        for (o, n), v in zip(flags, saved):
            setattr(o, n, v)
