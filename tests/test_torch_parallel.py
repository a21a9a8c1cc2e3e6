"""crop2seg_tpu_torch's data-parallel step and patch-parallel serving
(``parallel/mesh.py``) against the JAX package's math on the CPU.

A 2-rank gloo group (tests/torch_dp_workers.py) runs the port's
``data_parallel_step`` on each rank's shard of one global batch; the JAX
package's mesh step is its one-device step on the global batch
(tests/test_train_step.py:67), so the reference is ``jax.value_and_grad``
of the JAX trainer's loss on the whole batch: the loss (1e-5 relative), the
confusion matrices (exact), every gradient before Adam's update (Adam's
first step is lr * sign(g), so rounding could move a parameter whose
gradient is near zero by 2 * lr) held as tests/test_torch_train.py's
``_assert_model_grads`` holds them, and the BatchNorm running statistics
(that file's TOL). Cases: TimeUNet on its plain route; TimeUNet with rank
1's shard all ignore labels (a mean of per-rank means is wrong there);
U-TAE with BatchNorm in its encoder too and remat, whose recompute runs the
statistics' all-reduces again in the backward pass. The group's eval step
on a ragged batch padded with ignored rows equals the one-process eval step
on the ragged batch (the JAX test of it: tests/test_train_step.py:116; the
port's eval step matches the JAX one's in tests/test_torch_train.py), the
sharded loader's rows make
up the one-process loader's batches, and ``patch_parallel_infer`` matches
the JAX ``patch_parallel_infer`` on a 2-device CPU mesh (1e-4 / 1e-5),
raising on a batch that does not divide. Dropout is zeroed on both sides
(tests/test_torch_train.py).
"""
import concurrent.futures
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.models.timeunet as jtimeunet
import crop2seg_tpu.models.utae as jutae
from crop2seg_tpu.learning import trainer as jtrainer
from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu.parallel import make_mesh as jmake_mesh
from crop2seg_tpu.parallel.mesh import patch_parallel_infer as jpatch_parallel_infer
from crop2seg_tpu.utils.torch_convert import convert_timeunet, convert_utae
from crop2seg_tpu_torch.data import BatchLoader, S2TSCZCropDataset, make_synthetic_dataset
from crop2seg_tpu_torch.learning.trainer import StepConfig, make_eval_step
from crop2seg_tpu_torch.models.factory import init_weights
from crop2seg_tpu_torch.parallel import make_mesh, patch_parallel_infer, run_workers
from crop2seg_tpu_torch.utils import convert
from tests import torch_dp_workers
from tests.test_torch_train import TOL, _assert_model_grads, _np, _stats

# tests/test_torch_train.py's widths
KW = dict(input_dim=6, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
          out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
PLAIN = dict(use_pallas=False, use_pallas_train=False)
UTAE_KW = dict(KW, encoder_norm="batch")
UTAE_REMAT = dict(remat=True, remat_policy="conv_out")
WEIGHTS = (1.0, 1.0, 1.0, 1.0, 0.0)        # class 4 is the ignored one
IGNORE = 4
CFG = dict(num_classes=5, ignore_index=-1, class_weights=WEIGHTS, label_smoothing=0.1)
# the padded eval rows leave the loss alone without label smoothing only: its
# smooth term weighs each class's log-probability by the class's weight, not
# by w[y], in the JAX loss too (tests/test_train_step.py:116 runs without it)
EVAL_CFG = dict(CFG, label_smoothing=0.0)
B, T, HW = 4, 7, 8


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    pad = np.arange(T)[None] >= np.array([T, T - 2, T, T - 3, T][:b])[:, None]
    x = rng.standard_normal((b, T, HW, HW, 6)).astype(np.float32)
    x[pad] = 0.0
    return {"x": x, "pad_mask": pad, "y": rng.integers(0, 5, (b, HW, HW)),
            "dates": np.sort(rng.integers(0, 300, (b, T))).astype(np.float32)}


@contextlib.contextmanager
def _no_dropout():
    """The JAX U-TAE and TimeUNet build their L-TAE with dropout rates 0
    inside (they look the ``LTAE`` name up at every call)."""
    orig = jtimeunet.LTAE, jutae.LTAE
    jtimeunet.LTAE = jutae.LTAE = functools.partial(JLTAE, dropout=0.0, attn_dropout=0.0)
    try:
        yield
    finally:
        jtimeunet.LTAE, jutae.LTAE = orig


@functools.lru_cache(maxsize=None)
def _jax_step(m):
    """The JAX trainer's train-mode loss and metrics and their gradient,
    jitted once per model: (params, batch_stats, batch) -> ((loss, (stats,
    aux)), grads)."""
    cfg = jtrainer.StepConfig(**CFG)

    def loss(params, batch_stats, batch):
        return jtrainer._loss_and_metrics(m, cfg, params, batch_stats, batch, True)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _jax_reference(m, v, batch):
    """The JAX trainer's loss, metrics, gradients and updated statistics on
    the whole batch in training mode."""
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    (val, (stats, aux)), grads = _jax_step(m)(v["params"], v["batch_stats"], jb)
    return {"loss": float(val), "cm": np.asarray(aux["cm"]),
            "cm_top2": np.asarray(aux["cm_top2"]), "grads": _np(grads), "stats": _np(stats)}


def _weights(kind: str, kw: dict, seed: int):
    """The port's model ``kind`` with weights drawn from ``seed``: its state
    dict, and the JAX model's variables from it through the JAX package's
    own importer of reference state dicts (no JAX init to compile)."""
    model = init_weights(torch_dp_workers.build(kind, kw), torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    convert_fn = convert_timeunet if kind == "timeunet" else convert_utae
    # copies: handing sd to the spawned ranks moves its tensors' storage into
    # shared memory, which would leave views of it dangling
    variables = convert_fn({k: v.numpy().copy() for k, v in sd.items()},
                           n_stages=len(kw["encoder_widths"]))
    return sd, _np(variables)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, and one 2-rank group running every port case."""
    # the JAX U-TAE's gradients do not depend on its remat: it is left off
    tu, ut = jtimeunet.TimeUNet(**KW), jutae.UTAE(**UTAE_KW)
    tu_kw = dict(KW, **PLAIN)
    ut_kw = dict(UTAE_KW, **UTAE_REMAT)
    tu_sd, tu_v = _weights("timeunet", tu_kw, 1)
    ut_sd, ut_v = _weights("utae", ut_kw, 2)
    ignored = _batch(2)
    ignored["y"][B // 2:] = IGNORE                 # rank 1's shard: ignore labels only
    ragged = {k: v[:3] for k, v in _batch(4).items()}
    padded = {k: np.concatenate([v, v[:1]]) for k, v in ragged.items()}
    padded["y"][3:] = IGNORE                       # the JAX CLI's to_host_batch(pad_to=4)
    # name: (encoder norm, JAX model and variables, port case)
    table = {
        "timeunet": ("group", tu, tu_v, ("timeunet", tu_kw, tu_sd, _batch(1), CFG, "train")),
        "timeunet, rank 1 ignored": ("group", tu, tu_v,
                                     ("timeunet", tu_kw, tu_sd, ignored, CFG, "train")),
        "utae batch norm remat": ("batch", ut, ut_v,
                                  ("utae", ut_kw, ut_sd, _batch(3), CFG, "train")),
        "timeunet ragged eval": ("group", tu, tu_v,
                                 ("timeunet", tu_kw, tu_sd, padded, EVAL_CFG, "eval")),
    }
    # the group runs in its processes while this one compiles the JAX steps
    pool = concurrent.futures.ThreadPoolExecutor(1)
    group = pool.submit(run_workers, torch_dp_workers.run_cases, 2,
                        [c[3] for c in table.values()], threads=1,
                        base_dir=str(tmp_path_factory.mktemp("store")))
    refs = {}
    with _no_dropout():
        for name, (norm, jm, v, case) in table.items():
            if case[5] == "train":
                refs[name] = (norm, _jax_reference(jm, v, case[3]))
    # the ragged eval's reference: the port's one-process eval step on the
    # three real rows (its eval step matches the JAX one's,
    # tests/test_torch_train.py)
    model = torch_dp_workers.build("timeunet", tu_kw)
    model.load_state_dict(tu_sd)
    aux = make_eval_step(model, StepConfig(**EVAL_CFG), device="cpu")(ragged)
    refs["timeunet ragged eval"] = ("group", {k: aux[k].numpy() for k in ("loss", "cm",
                                                                          "cm_top2")})
    results = group.result()
    pool.shutdown()
    return {name: (norm, ref, [r[i] for r in results])
            for i, (name, (norm, ref)) in enumerate((n, refs[n]) for n in table)}


@pytest.mark.parametrize("name", ["timeunet", "timeunet, rank 1 ignored",
                                  "utae batch norm remat"])
def test_data_parallel_step_matches_the_global_batch(runs, name):
    norm, want, ranks = runs[name]
    for got in ranks:                              # the global numbers on every rank
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["cm"].numpy(), want["cm"])
        np.testing.assert_array_equal(got["cm_top2"].numpy(), want["cm_top2"])
    assert int(ranks[0]["cm"].sum()) == B * HW * HW
    for k, g in ranks[0]["grads"].items():         # summed: the same on both ranks
        torch.testing.assert_close(ranks[1]["grads"][k], g, rtol=0, atol=0, msg=k)
    sd = convert.utae_state_dict_from_flax({"params": want["grads"],
                                            "batch_stats": want["stats"]}, norm)
    grads = ranks[0]["grads"]
    _assert_model_grads({k: g.numpy() for k, g in grads.items()},
                        {k: sd[k].numpy() for k in grads})
    stats = _stats(sd)
    assert stats
    for k, w in stats.items():
        for got in ranks:
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_ragged_eval_batch_padding_over_the_group(runs):
    """A last eval batch of 3 padded to the global 4 with ignore-labelled
    copies of sample 0: the group's loss and confusion matrices (the ignore
    class's row zeroed, as the meters do) equal one process's eval step on
    the 3 real rows."""
    _, want, ranks = runs["timeunet ragged eval"]
    for got in ranks:
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        for k in ("cm", "cm_top2"):
            cm_got, cm_want = got[k].numpy().copy(), want[k].copy()
            cm_got[IGNORE], cm_want[IGNORE] = 0, 0
            np.testing.assert_array_equal(cm_got, cm_want)


def test_sharded_loader_rows_make_up_the_global_batches(tmp_path):
    """Each rank's BatchLoader(shard=(rank, 2)) yields its half of every
    batch of the one-process loader with the same seed (the T bucket of the
    whole batch), natively and on the Python path; the ragged last eval
    batch is padded with ignore-labelled copies of its first sample."""
    make_synthetic_dataset(str(tmp_path), n_patches=10, t_range=(5, 12), hw=8)
    ds = S2TSCZCropDataset(str(tmp_path), norm=False, set_type="train")
    assert len(ds) % 4 == 3                      # a ragged last batch of 3
    for native in (True, False):
        for shuffle, drop_last in ((True, True), (False, False)):
            kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5, native=native,
                      t_buckets=(8, 12))
            whole = list(BatchLoader(ds, 4, **kw))
            halves = [list(BatchLoader(ds, 4, shard=(r, 2), ignore_label=IGNORE, **kw))
                      for r in range(2)]
            assert len(halves[0]) == len(halves[1]) == len(whole)
            for i, w in enumerate(whole):
                got = {k: np.concatenate([h[i][k] for h in halves]) for k in w}
                n = len(w["y"])
                for k, v in w.items():
                    np.testing.assert_array_equal(got[k][:n], v, err_msg=k)
                if n < 4:                          # padded rows: sample 0, targets ignored
                    np.testing.assert_array_equal(got["x"][n:], np.repeat(w["x"][:1], 4 - n, 0))
                    assert (got["y"][n:] == IGNORE).all()
    with pytest.raises(ValueError):
        BatchLoader(ds, 3, shard=(0, 2))
    with pytest.raises(ValueError):
        BatchLoader(ds, 4, shard=(0, 2), drop_last=False)


def test_patch_parallel_infer_matches_the_jax_mesh():
    """16 patches over a 2-device mesh (two CPU replicas) against the JAX
    ``patch_parallel_infer`` over two CPU devices, on the same weights: the
    logits within 1e-4 / 1e-5 and the same as one device's; a batch of 6
    does not divide over 4 devices and raises."""
    n = 16
    rng = np.random.default_rng(7)
    px = rng.standard_normal((n, T, HW, HW, 6)).astype(np.float32)
    b0 = _batch(8, 1)
    pdates, pmask = np.repeat(b0["dates"], n, 0), np.repeat(b0["pad_mask"], n, 0)
    jm = jutae.UTAE(**KW)
    sd, v = _weights("utae", KW, 3)

    def fwd(variables, xb):
        return jm.apply(variables, xb, pdates, pad_mask=pmask, train=False)

    want = np.asarray(jpatch_parallel_infer(fwd, jmake_mesh(jax.devices("cpu")[:2]))(v, px))
    model = torch_dp_workers.build("utae", KW)
    model.load_state_dict(sd)
    model.eval()
    args = [torch.from_numpy(a) for a in (px, pdates, pmask)]
    with torch.inference_mode():
        got = patch_parallel_infer(model, make_mesh(["cpu", "cpu"]))(*args).numpy()
        one = model(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        patch_parallel_infer(model, make_mesh(["cpu"] * 4))(*(a[:6] for a in args))


def test_cli_num_devices_trains_resumes_and_tests(tmp_path):
    """``--device cpu --num_devices 2``: two gloo processes train an epoch
    and write the CLI's files (rank 0 alone writes); a 2-rank resume
    continues from its checkpoint with Adam's state; one process's
    ``--test`` of the first run repeats its test loss within 1e-5."""
    from crop2seg_tpu_torch import train as cli

    data = tmp_path / "data"
    make_synthetic_dataset(str(data), n_patches=10, t_range=(5, 12), hw=16)
    common = ["--device", "cpu", "--dataset", "synthetic", "--dataset_folder", str(data),
              "--model", "timeunet", "--encoder_widths", "[8,8]", "--decoder_widths", "[8,8]",
              "--out_conv", "[8,15]", "--n_head", "2", "--d_model", "16",
              "--batch_size", "2", "--t_buckets", "[8,12]", "--display_step", "1000"]
    res = tmp_path / "res"
    run = cli.main(cli.parse_config(common + ["--epochs", "1", "--num_devices", "2",
                                              "--res_dir", str(res)]))
    steps = 7 // 2                                   # the train set's 7 patches, B = 2
    assert run.adam_step == steps and np.isfinite(run.test_metrics["test_loss"])
    for f in ("conf.json", "Fold_1/trainlog.json", "Fold_1/all_test_metrics.json",
              "Fold_1/all_conf_mat.pkl", "Fold_1/model.ckpt", "all_overall.json"):
        assert (res / f).exists(), f
    assert not [p for p in res.iterdir() if p.name.startswith("dp_")]   # the store is gone
    resumed = cli.main(cli.parse_config(common + [
        "--epochs", "2", "--num_devices", "2", "--weight_folder", str(res),
        "--res_dir", str(tmp_path / "resumed")]))
    assert resumed.start_epoch == 2 and resumed.restored_adam_step == steps
    assert resumed.adam_step == 2 * steps
    tested = cli.main(cli.parse_config(common + ["--test", "--weight_folder", str(res),
                                                 "--res_dir", str(tmp_path / "tested")]))
    np.testing.assert_allclose(tested.test_metrics["test_loss"], run.test_metrics["test_loss"],
                               rtol=1e-5)
