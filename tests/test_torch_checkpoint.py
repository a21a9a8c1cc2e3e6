"""crop2seg_tpu_torch's checkpoints and run artifacts.

- save, load and continue equals training without the interruption: the
  state dicts, Adam's state and the next steps bit for bit on the CPU;
- ``StateCheckpointer``'s best-k retention, ``best_ckpt.json`` and the
  ``model.ckpt`` pointer, and a resumed checkpointer adopting them;
- the JSON and pickle writers give files byte-identical to the JAX
  package's for the same inputs;
- a reference-layout ``model.pth.tar`` built from a golden's ``sd::``
  entries loads with ``load_state_dict`` and gives that golden's logits
  within 5e-4 (the goldens' tolerance).
"""
import json
import os

import numpy as np
import pytest
import torch

from crop2seg_tpu.learning import checkpoint as jckpt
from crop2seg_tpu_torch.learning import checkpoint as ckpt
from crop2seg_tpu_torch.learning.trainer import StepConfig, create_train_state, make_train_step
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.models.utae import UTAE
from tests.parity_utils import from_nhwc, load_fixture, to_nhwc_seq

KW = dict(input_dim=10, encoder_widths=(8, 8), decoder_widths=(8, 8), out_conv=(8, 15),
          n_head=2, d_model=16, d_k=4)
CFG = StepConfig(num_classes=15, class_weights=(1.0,) * 14 + (0.0,))


def _batch(seed):
    rng = np.random.default_rng(seed)
    pad = np.zeros((2, 5), bool)
    pad[1, 3:] = True
    x = rng.standard_normal((2, 5, 8, 8, 10)).astype(np.float32)
    x[pad] = 0
    return {"x": x, "pad_mask": pad, "y": rng.integers(0, 15, (2, 8, 8)),
            "dates": np.sort(rng.integers(0, 300, (2, 5))).astype(np.float32)}


def _fresh():
    torch.manual_seed(0)
    model = TimeUNet(**KW)
    return model, create_train_state(model, 1e-3)


def _steps(model, opt, seeds, gen_seed):
    step = make_train_step(model, CFG, opt, device="cpu")
    gen = torch.Generator().manual_seed(gen_seed)
    return [step(_batch(s), gen)["loss"] for s in seeds]


def test_save_load_continue_equals_uninterrupted(tmp_path):
    model, opt = _fresh()
    _steps(model, opt, (0, 1), 0)
    want_losses = _steps(model, opt, (2, 3), 1)

    first, opt1 = _fresh()
    _steps(first, opt1, (0, 1), 0)
    ckpt.save_state(str(tmp_path), first, opt1, epoch=2, best_miou=12.5)
    assert ckpt.has_state(str(tmp_path)) and ckpt.has_opt_state(str(tmp_path))
    payload = ckpt.load_state(str(tmp_path))
    assert payload["meta"] == {"epoch": 2, "best_mIoU": 12.5}
    resumed, opt2 = _fresh()
    resumed.load_state_dict(payload["model"])
    opt2.load_state_dict(payload["optimizer"])
    assert all(int(s["step"]) == 2 for s in opt2.state.values())
    got_losses = _steps(resumed, opt2, (2, 3), 1)
    assert [float(v) for v in got_losses] == [float(v) for v in want_losses]
    for (k, a), b in zip(model.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = opt.state_dict()["state"], opt2.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_weights_alone_carry_no_optimizer_state(tmp_path):
    model, _ = _fresh()
    ckpt.save_state(str(tmp_path), model, None, epoch=0, best_miou=0.0)
    assert ckpt.has_state(str(tmp_path)) and not ckpt.has_opt_state(str(tmp_path))
    assert not ckpt.has_state(str(tmp_path / "nothing"))


def test_best_k_retention_and_pointer(tmp_path):
    model, opt = _fresh()
    ck = ckpt.StateCheckpointer(str(tmp_path), keep=2)
    for epoch, miou in ((1, 1.0), (2, 3.0), (3, 2.0), (4, 5.0), (5, 5.0)):
        ck.save(model, opt, epoch, miou)
    ck.wait()
    kept = sorted(p for p in os.listdir(tmp_path) if p.startswith("ckpt_e"))
    assert kept == ["ckpt_e0004", "ckpt_e0005"]
    with open(tmp_path / "best_ckpt.json") as f:
        index = json.load(f)
    assert [(e["epoch"], e["mIoU"]) for e in index] == [(5, 5.0), (4, 5.0)]
    assert os.path.islink(tmp_path / "model.ckpt")
    assert ckpt.load_state(str(tmp_path))["meta"] == {"epoch": 5, "best_mIoU": 5.0}
    os.remove(tmp_path / "model.ckpt")       # no link: best_ckpt.json points
    assert ckpt.load_state(str(tmp_path))["meta"]["epoch"] == 5
    again = ckpt.StateCheckpointer(str(tmp_path), keep=2)
    again.save(model, opt, 6, 4.0)
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("ckpt_e")) == [
        "ckpt_e0004", "ckpt_e0005"]
    again.save(model, opt, 7, 9.0)
    assert ckpt.load_state(str(tmp_path))["meta"]["epoch"] == 7
    with pytest.raises(ValueError):
        ckpt.StateCheckpointer(str(tmp_path), keep=0)


def test_writers_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    conf = {"model": "utae", "encoder_widths": [64, 64], "lr": 0.001, "fold": 1,
            "weight_folder": None, "dtype": torch.float32}
    trainlog = {1: {"train_loss": 2.5, "val_IoU": 10.25}, 2: {"train_loss": 2.0}}
    metrics = {"test_loss": np.float32(2.25), "test_IoU": 12.5}
    cms = {"top1": rng.integers(0, 9, (15, 15)), "top2": rng.integers(0, 9, (15, 15))}
    cm = rng.integers(0, 9, (15, 15)).astype(np.float64)
    for mod, sub in ((jckpt, "jax"), (ckpt, "port")):
        d = str(tmp_path / sub)
        fold = mod.prepare_output(d, 2)
        mod.save_conf(d, conf)
        mod.checkpoint_log(fold, trainlog)
        mod.save_results(fold, metrics, cms, region="boundary")
        mod.overall_performance(d, cm, region="boundary")
    files = ["conf.json", "Fold_2/trainlog.json", "Fold_2/boundary_test_metrics.json",
             "Fold_2/boundary_conf_mat.pkl", "boundary_overall.json",
             "boundary_per_class.json"]
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    assert ckpt.load_conf(str(tmp_path / "port")) == jckpt.load_conf(str(tmp_path / "jax"))
    np.testing.assert_array_equal(ckpt.aggregate_fold_cms(str(tmp_path / "port"), "boundary"),
                                  jckpt.aggregate_fold_cms(str(tmp_path / "jax"), "boundary"))
    with pytest.raises(FileNotFoundError):
        ckpt.aggregate_fold_cms(str(tmp_path / "port"), "interior")


@pytest.mark.parametrize("name", ["timeunet_small", "utae_boundary_absrel"])
def test_reference_checkpoint_loads_and_reproduces_the_golden(tmp_path, name):
    arrays, sd = load_fixture(name)
    path = tmp_path / "model.pth.tar"
    torch.save({"epoch": 7, "state_dict": {k: torch.tensor(v) for k, v in sd.items()},
                "optimizer": {}, "best_mIoU": 0.5}, path)
    loaded = ckpt.load_torch_checkpoint(str(path))
    if name == "timeunet_small":
        m = TimeUNet(input_dim=10, encoder_widths=(16, 16, 32), decoder_widths=(8, 16, 32),
                     out_conv=(8, 5), n_head=4, d_model=32, d_k=4)
    else:
        m = UTAE(input_dim=10, encoder_widths=(16, 16, 128), decoder_widths=(8, 16, 128),
                 out_conv=(8, 5), n_head=4, d_model=256, d_k=4,
                 add_boundary_loss=True, use_abs_rel_enc=True)
    m.load_state_dict(loaded)
    with torch.inference_mode():
        out = m.eval()(torch.tensor(to_nhwc_seq(arrays["x"])), torch.tensor(arrays["dates"]))
    outs = out if isinstance(out, tuple) else (out,)
    for key, y in zip(("y", "y_b"), outs):
        np.testing.assert_allclose(from_nhwc(y.numpy()), arrays[key], rtol=5e-4, atol=5e-4,
                                   err_msg=key)
