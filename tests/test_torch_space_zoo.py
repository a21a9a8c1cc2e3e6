"""The rest of the zoo on crop2seg_tpu_torch's 2-D (data x space) training
mesh (``parallel/mesh.py``): TimeUNet_v2, UNet3D, ConvLSTM, BConvLSTM,
ConvGRU, RecUNet ("lstm", "blstm", "mean"), U-Net naive, U-TAE with the
boundary loss and TimeUNet with ``test_region``, against the JAX package's
math on the CPU.

Two gloo groups (tests/torch_dp_workers.py::run_zoo_cases), each spawned
once for all of its cases: 2 ranks and 4 ranks.

- Every primitive and module the zoo adds to the halos (ZOO_OPS: Conv3d and
  ConvTranspose3d at UNet3D's and TemporalAggregator3D's shapes, a dilated
  and a strided Conv2d, ConvTranspose2d with output padding,
  ``boundary_mask`` at connectivity 4 and 8, ConvBlock3D, DownConvBlock3D,
  TemporalAggregator3D in its three modes, UNetEx, the 2-D U-Net) over 2
  and 4 space ranks against the same op unsharded, in training mode
  (BatchNorm on the global statistics): the outputs to 1e-6, the mask
  exactly, the inputs' and the weights' gradients to 1e-5.
- The step on the (1, 2) mesh (2 ranks) and on the (2, 2) mesh (4 ranks)
  against ``jax.value_and_grad`` of the JAX trainer's loss on the global
  batch (the JAX mesh step is its one-device step on the global arrays),
  as tests/test_torch_space_parallel.py holds TimeUNet, U-TAE and W-TAE:
  the loss 1e-5 relative, the confusion matrices exact (the boundary
  head's too), the gradients by ``_assert_model_grads``, the BatchNorm
  statistics at that file's TOL. The JAX weights are drawn in numpy on the
  shapes of the JAX model's init (traced, not compiled) and reach the port
  through ``utils/convert.py``, as do the JAX gradients. Dropout is zeroed
  on both sides: each rank draws its own masks. TimeUNet runs the pair's
  plain version (the CPU's) with its tail deferred, from the port's own
  init through the JAX package's importer, as
  tests/test_torch_space_parallel.py draws it: with the numpy draw's
  GroupNorm scales and biases, the gradients upstream of its L-TAE's out
  GroupNorm (two channels a group at these widths: ROADMAP.md §3, "Not
  port faults") are rounding-dominated in fp32; two draws put one
  process's fp32 step, the mesh's or the JAX one 4-39 % from the port's
  float64 step, where the mesh in float64 is the one-process step in
  float64 to 5e-13.
- UNet3D's step through the JAX package's own ``data_space_parallel_step``
  on a (2, 2) mesh of tests/conftest.py's virtual CPU devices: its loss
  and confusion matrix are the port's (2, 2) mesh's.

Size: tests/test_torch_zoo.py's: B = 2, T = 8, 16 x 16, K = 5, hidden width
12, U-Net widths (8, 8, 16) / (4, 8, 16), UNet3D feats 4, TimeUNet_v2 at
tests/test_torch_timeunet_v2.py's widths; labels in blocks of 4 x 4 pixels,
so that ``test_region`` keeps boundary and interior pixels.
"""
import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crop2seg_tpu.models.timeunet as jtimeunet
import crop2seg_tpu.models.utae as jutae
from crop2seg_tpu.learning import trainer as jtrainer
from crop2seg_tpu.models import convgru as jgru
from crop2seg_tpu.models import convlstm as jlstm
from crop2seg_tpu.models import recunet as jrec
from crop2seg_tpu.models import timeunet_v2 as jtv2
from crop2seg_tpu.models import unet as junet
from crop2seg_tpu.models import unet3d as ju3d
from crop2seg_tpu.parallel import make_mesh as jmake_mesh
from crop2seg_tpu.parallel.mesh import data_space_parallel_step as jdata_space_parallel_step
from crop2seg_tpu_torch.parallel import run_workers
from crop2seg_tpu_torch.utils import convert
from tests import torch_dp_workers
from tests.conftest import cpu_devices
from tests.test_torch_parallel import CFG, IGNORE, KW
from tests.test_torch_space_parallel import PAIR
from tests.test_torch_space_parallel import _weights as _port_init_weights
from tests.test_torch_space_parallel import _no_dropout as _no_ltae_dropout
from tests.test_torch_timeunet_v2 import SMALL as V2_SMALL
from tests.test_torch_timeunet_v2 import _no_dropout as _no_v2_dropout
from tests.test_torch_train import TOL, _assert_model_grads, _np, _stats

B, T, HW, K = 2, 8, 16, 5
# the factory's uconvlstm pads with zeros (in_conv by reflection, always)
REC = dict(input_dim=10, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
           out_conv=(8, K), hidden_dim=12, padding_mode="zeros")
NAIVE = dict(encoder_widths=(4, 4, 8), decoder_widths=(2, 4, 8), out_conv=(2, K))
TU_KW = dict(KW, input_dim=10)
BOUNDARY = dict(CFG, add_boundary_loss=True)


def _utae_sd(v):
    return convert.utae_state_dict_from_flax(v, "group")


# name: (kind, port kwargs, JAX model, JAX variables -> port state dict,
# StepConfig kwargs); X64: the cases held to the JAX step under x64
STEPS = {
    "timeunet_v2": ("timeunet_v2", V2_SMALL, lambda: jtv2.TimeUNetV2(**V2_SMALL),
                    lambda v: convert.timeunet_v2_state_dict_from_flax(v, "group"), CFG),
    "unet3d": ("unet3d", dict(n_classes=K, in_channel=10, feats=4),
               lambda: ju3d.UNet3D(n_classes=K, feats=4),
               convert.unet3d_state_dict_from_flax, CFG),
    "convlstm": ("convlstm", dict(num_classes=K, input_dim=10, hidden_dim=12),
                 lambda: jlstm.ConvLSTMSeg(num_classes=K, hidden_dim=12),
                 convert.convlstm_seg_state_dict_from_flax, CFG),
    "bconvlstm": ("bconvlstm", dict(num_classes=K, input_dim=10, hidden_dim=12),
                  lambda: jlstm.BConvLSTMSeg(num_classes=K, hidden_dim=12),
                  convert.convlstm_seg_state_dict_from_flax, CFG),
    "convgru": ("convgru", dict(num_classes=K, input_dim=10, hidden_dim=12),
                lambda: jgru.ConvGRUSeg(num_classes=K, hidden_dim=12),
                convert.convlstm_seg_state_dict_from_flax, CFG),
    "recunet lstm": ("recunet", dict(REC, temporal="lstm"),
                     lambda: jrec.RecUNet(**REC, temporal="lstm"),
                     convert.recunet_state_dict_from_flax, CFG),
    "recunet blstm": ("recunet", dict(REC, temporal="blstm"),
                      lambda: jrec.RecUNet(**REC, temporal="blstm"),
                      convert.recunet_state_dict_from_flax, CFG),
    "recunet mean": ("recunet", dict(REC, temporal="mean"),
                     lambda: jrec.RecUNet(**REC, temporal="mean"),
                     convert.recunet_state_dict_from_flax, CFG),
    "unet_naive": ("unet_naive", dict(NAIVE, input_dim=10, temporal_length=T),
                   lambda: junet.UnetNaive(temporal_length=T, **NAIVE),
                   convert.unet_state_dict_from_flax, CFG),
    "utae boundary loss": ("utae", dict(TU_KW, add_boundary_loss=True),
                           lambda: jutae.UTAE(**TU_KW, add_boundary_loss=True), _utae_sd,
                           BOUNDARY),
    "timeunet pair test_region boundary": (
        "timeunet", dict(TU_KW, **PAIR), lambda: jtimeunet.TimeUNet(**TU_KW), _utae_sd,
        dict(CFG, test_region="boundary")),
    "timeunet pair test_region interior": (
        "timeunet", dict(TU_KW, **PAIR), lambda: jtimeunet.TimeUNet(**TU_KW), _utae_sd,
        dict(CFG, test_region="interior")),
}
# TimeUNet's cases: weights from the port's init (identity norms), as in
# tests/test_torch_space_parallel.py (the module docstring says why), one draw
REGIONS = ("timeunet pair test_region boundary", "timeunet pair test_region interior")
OPS = list(torch_dp_workers.ZOO_OPS)


def _batch(seed):
    rng = np.random.default_rng(seed)
    pad = np.zeros((B, T), bool)
    pad[-1, T - 2:] = True
    x = rng.standard_normal((B, T, HW, HW, 10)).astype(np.float32)
    x[pad] = 0.0
    y = rng.integers(0, K, (B, HW // 4, HW // 4)).repeat(4, 1).repeat(4, 2)
    return {"x": x, "pad_mask": pad, "y": y,
            "dates": np.sort(rng.integers(0, 300, (B, T))).astype(np.float32)}


def _fill(path, leaf, rng):
    """A JAX variable of ``leaf``'s shape: kernels uniform within 1 /
    sqrt(fan in), biases within 0.1, scales 1 + 0.1 N(0, 1), the
    attention's query N(0, 2 / d_k), the BatchNorm moments 0.1 N(0, 1) and 1
    + 0.2 |N(0, 1)|."""
    name, shape = str(path[-1].key), leaf.shape
    z = rng.standard_normal(shape)
    if name.endswith("kernel"):
        bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        a = rng.uniform(-bound, bound, shape)
    elif name.endswith("bias"):
        a = rng.uniform(-0.1, 0.1, shape)
    elif name.endswith("scale"):
        a = 1.0 + 0.1 * z
    elif name == "query":
        a = z * np.sqrt(2.0 / shape[-1])
    elif name == "mean":
        a = 0.1 * z
    elif name == "var":
        a = 1.0 + 0.2 * np.abs(z)
    else:
        raise ValueError(f"no draw for the variable {name} {shape}")
    return a.astype(np.float32)


def _weights(jm, to_port, batch, seed: int):
    """The JAX model's variables drawn from ``seed`` on the shapes of its
    init, and the port's state dict from them (``utils/convert.py``)."""
    x, d, p = (jnp.asarray(batch[k]) for k in ("x", "dates", "pad_mask"))
    shapes = jax.eval_shape(lambda x, d, p: jm.init(jax.random.PRNGKey(0), x, d, pad_mask=p,
                                                    train=False), x, d, p)
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map_with_path(lambda path, leaf: _fill(path, leaf, rng), shapes)
    v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    # copies: handing the state dict to the spawned ranks moves its tensors'
    # storage into shared memory
    return v, {k: t.clone() for k, t in to_port(v).items()}


def _jax_reference(jm, v, batch, cfg_kw):
    """The JAX trainer's loss, metrics, gradients and updated statistics on
    the whole batch in training mode (dropout off)."""
    cfg = jtrainer.StepConfig(**cfg_kw)

    def loss(params, batch_stats, batch):
        return jtrainer._loss_and_metrics(jm, cfg, params, batch_stats, batch, True)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    (val, (stats, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"], v["batch_stats"], jb)
    return {"loss": float(val), "aux": _np(aux), "grads": _np(grads), "stats": _np(stats)}


def _jax_mesh_step(jm, v, batch, cfg_kw):
    """The JAX package's ``data_space_parallel_step`` of its train step on a
    (2, 2) mesh of virtual CPU devices: the step's metrics."""
    mesh = jmake_mesh(cpu_devices(4), axes=("data", "space"), shape=(2, 2))
    state = jtrainer.create_train_state(jm, v, 1e-3)
    step = jdata_space_parallel_step(jtrainer.make_train_step(jm, jtrainer.StepConfig(**cfg_kw)),
                                     mesh, donate_state=False)
    _, aux = step(state, dict(batch), jax.random.PRNGKey(0))
    return _np(aux)


def _jax_metrics(jm, v, batch, cfg_kw) -> dict:
    """The JAX trainer's train-mode loss and metrics on the whole batch, its
    forward alone."""
    cfg = jtrainer.StepConfig(**cfg_kw)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    _, (_, aux) = jax.jit(lambda p, s, b: jtrainer._loss_and_metrics(jm, cfg, p, s, b, True))(
        v["params"], v["batch_stats"], jb)
    return _np(aux)


def _reference_job(name: str, variables, batch) -> dict:
    """One JAX reference in a process of its own (``runs``): the step case
    ``name``'s, or with "unet3d mesh" UNet3D's JAX mesh step, dropout off.
    TimeUNet's two regions share one weight draw: the "boundary" job also
    gives the "interior" case's metrics from the forward alone (the
    region changes no gradient)."""
    with _no_ltae_dropout(), _no_v2_dropout():
        if name == "unet3d mesh":
            return _jax_mesh_step(STEPS["unet3d"][2](), variables, batch, STEPS["unet3d"][4])
        jm = STEPS[name][2]()
        ref = _jax_reference(jm, variables, batch, STEPS[name][4])
        if name == REGIONS[0]:
            ref["interior aux"] = _jax_metrics(jm, variables, batch, STEPS[REGIONS[1]][4])
        return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references of the step cases and the JAX mesh step, and the
    2-rank and 4-rank groups running every port case. The JAX steps compile
    in four spawned processes (one compile takes 1-12 s, and compiles in
    threads of one process barely overlap)."""
    batch = _batch(7)
    weights = {name: _weights(make(), to_port, batch, seed)
               for seed, (name, (_, _, make, to_port, _)) in enumerate(STEPS.items())
               if name not in REGIONS}
    sd, v = _port_init_weights(STEPS[REGIONS[0]][0], STEPS[REGIONS[0]][1], 1)
    for name in REGIONS:
        weights[name] = v, {k: t.clone() for k, t in sd.items()}
    cases = [(kind, kw, weights[name][1], batch, cfg_kw)
             for name, (kind, kw, _, _, cfg_kw) in STEPS.items()]
    pool = concurrent.futures.ThreadPoolExecutor(2)
    groups = {world: pool.submit(run_workers, torch_dp_workers.run_zoo_cases, world, OPS,
                                 cases, threads=1,
                                 base_dir=str(tmp_path_factory.mktemp(f"store{world}")))
              for world in (2, 4)}
    jobs = {name: (name, weights[name][0], batch) for name in STEPS if name != REGIONS[1]}
    jobs["unet3d mesh"] = ("unet3d mesh", weights["unet3d"][0], batch)
    with concurrent.futures.ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as jax_pool:
        refs = {name: jax_pool.submit(_reference_job, *job) for name, job in jobs.items()}
        refs = {name: f.result() for name, f in refs.items()}
    mesh_aux = refs.pop("unet3d mesh")
    refs[REGIONS[1]] = dict(refs[REGIONS[0]], aux=refs[REGIONS[0]].pop("interior aux"))
    results = {world: g.result() for world, g in groups.items()}
    pool.shutdown()
    return refs, mesh_aux, results


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", OPS)
def test_zoo_op_matches_the_unsharded_op(runs, name, world):
    """The ranks' outputs make up the unsharded op's (an output that is the
    whole frame's on each rank: each is it; the boundary mask exactly),
    their inputs' gradients make up its inputs' gradients and their weight
    gradients add up to its weight gradients."""
    ranks = [r["ops"][name] for r in runs[2][world]]
    want = torch_dp_workers.run_zoo_op(name)
    _, _, inputs, out_axes = torch_dp_workers.zoo_op(name)
    for i, (w, axis) in enumerate(zip(want["out"], out_axes)):
        if w is None:
            assert all(r["out"][i] is None for r in ranks)
            continue
        got = ([torch.cat([r["out"][i] for r in ranks], axis)] if axis is not None
               else [r["out"][i] for r in ranks])
        for g in got:
            if w.is_floating_point():
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(g.numpy(), w.numpy())
    in_axes = [axis for _, axis, diff in inputs if diff]
    assert len(want["dx"]) == len(in_axes)
    for i, (w, axis) in enumerate(zip(want["dx"], in_axes)):
        dx = torch.cat([r["dx"][i] for r in ranks], axis)
        np.testing.assert_allclose(dx.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    for k, w in want["dparams"].items():
        got = sum(r["dparams"][k] for r in ranks)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(STEPS))
def test_zoo_step_matches_the_jax_global_batch(runs, name, world):
    """Every rank of the (world / 2, 2) mesh: the global loss and confusion
    matrices (with the boundary loss also ``loss_b`` and ``cm_b``); the
    summed gradients, the same on every rank, and the running statistics
    against the JAX step on the whole batch."""
    refs, _, results = runs
    want = refs[name]
    ranks = [r["steps"][list(STEPS).index(name)] for r in results[world]]
    boundary = STEPS[name][4].get("add_boundary_loss", False)
    for got in ranks:
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        for k in ("cm", "cm_top2") + (("cm_b",) if boundary else ()):
            np.testing.assert_array_equal(got[k].numpy(), want["aux"][k], err_msg=k)
        if boundary:
            np.testing.assert_allclose(float(got["loss_b"]), float(want["aux"]["loss_b"]),
                                       rtol=1e-5)
    assert int(ranks[0]["cm"].sum()) == B * HW * HW
    if STEPS[name][4].get("test_region", "all") != "all":
        # the region leaves pixels of real classes on either side of it
        y = _batch(7)["y"]
        relabelled = int(ranks[0]["cm"][IGNORE].sum()) - int((y == IGNORE).sum())
        assert 0 < relabelled < int((y != IGNORE).sum())
    for got in ranks[1:]:
        for k, g in ranks[0]["grads"].items():
            torch.testing.assert_close(got["grads"][k], g, rtol=0, atol=0, msg=k)
    sd = STEPS[name][3]({"params": want["grads"], "batch_stats": want["stats"]})
    grads = ranks[0]["grads"]
    _assert_model_grads({k: g.numpy() for k, g in grads.items()},
                        {k: sd[k].numpy() for k in grads})
    for k, w in _stats(sd).items():
        for got in ranks:
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_unet3d_matches_the_jax_packages_mesh_step(runs):
    """UNet3D through the JAX package's own ``data_space_parallel_step`` on
    a (2, 2) mesh: the port's (2, 2) mesh gives its loss and confusion
    matrix."""
    _, mesh_aux, results = runs
    got = results[4][0]["steps"][list(STEPS).index("unet3d")]
    np.testing.assert_allclose(float(got["loss"]), float(mesh_aux["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["cm"].numpy(), mesh_aux["cm"])
    np.testing.assert_array_equal(got["cm_top2"].numpy(), mesh_aux["cm_top2"])
