"""crop2seg_tpu_torch's 2-D (data x space) training mesh (``parallel/mesh.py``:
``make_mesh_2d``, ``shard_batch_2d``, ``data_space_parallel_step``) against
the JAX package's math on the CPU.

Two gloo groups (tests/torch_dp_workers.py::run_space_cases), each spawned
once for all of its cases: 2 ranks and 4 ranks.

- Every halo'd primitive (``nn/layers.py::space_shards``) over 2 and over 4
  space ranks against the same op unsharded: the outputs to 1e-6, the
  input's and the weights' gradients to 1e-5.
- The step on the (1, 2) mesh (2 ranks) and on the (2, 2) mesh (4 ranks)
  against ``jax.value_and_grad`` of the JAX trainer's loss on the global
  batch, as tests/test_torch_parallel.py holds the 1-D step (the JAX mesh
  step is its one-device step on the global arrays, tests/test_train_step.py:
  67): the loss 1e-5 relative, the confusion matrices exact, the gradients
  by ``_assert_model_grads``, the BatchNorm statistics at that file's TOL.
  Cases: TimeUNet on its plain route; TimeUNet with ``defer_tail=True`` on
  the pair's route (the pair's plain version on the CPU, in_conv's tail
  affine from the space-summed moments); U-TAE with BatchNorm in its
  encoder and remat ``conv_out`` (the recompute runs the halos again);
  W-TAE. Dropout is zeroed on both sides: each rank draws its own masks.
  The U-TAE case's reference runs under ``jax.enable_x64`` on float64
  weights and inputs: flax's BatchNorm takes the variance as E[x^2] -
  E[x]^2, which in fp32 moves this batch's gradients by up to 3.5e-3 of
  their norm (against the port's step in float64), past the 1e-3 that
  ``_assert_model_grads`` allows; under x64 it is within 9e-5 of the
  port's float64 step.
- The refusals: an H that does not divide, a misaligned shard, a
  bottleneck shard of one row, a mesh of the wrong size and a missing pad
  mask each raise.
"""
import concurrent.futures
import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

import crop2seg_tpu.models.timeunet as jtimeunet
import crop2seg_tpu.models.utae as jutae
import crop2seg_tpu.nn.ltae as jltae
from crop2seg_tpu.models import WTAE as JWTAE
from crop2seg_tpu.utils.torch_convert import convert_timeunet, convert_utae, convert_wtae
from crop2seg_tpu_torch.models.factory import init_weights
from crop2seg_tpu_torch.parallel import run_workers
from crop2seg_tpu_torch.utils import convert
from tests import torch_dp_workers
from tests.test_torch_parallel import CFG, KW, PLAIN, UTAE_KW, UTAE_REMAT, _jax_reference
from tests.test_torch_train import TOL, _assert_model_grads, _np, _stats

B, T, HW = 2, 7, 16
LEVELS = len(KW["encoder_widths"])
PAIR = dict(use_pallas=False, use_pallas_train=True, defer_tail=True)
# name: (kind, port kwargs, weights' seed, the JAX reference under x64)
STEPS = {
    "timeunet plain": ("timeunet", dict(KW, **PLAIN), 1, False),
    "timeunet pair deferred tail": ("timeunet", dict(KW, **PAIR), 1, False),
    "utae batch norm remat": ("utae", dict(UTAE_KW, **UTAE_REMAT), 2, True),
    "wtae": ("wtae", dict(KW), 3, False),
}
PRIMITIVES = list(torch_dp_workers.PRIMITIVES)


def _batch(seed):
    rng = np.random.default_rng(seed)
    pad = np.arange(T)[None] >= np.array([T, T - 3])[:, None]
    x = rng.standard_normal((B, T, HW, HW, 6)).astype(np.float32)
    x[pad] = 0.0
    return {"x": x, "pad_mask": pad, "y": rng.integers(0, 5, (B, HW, HW)),
            "dates": np.sort(rng.integers(0, 300, (B, T))).astype(np.float32)}


@contextlib.contextmanager
def _no_dropout():
    """The JAX models with their L-TAE's dropout rates at 0 (they look the
    names up at every call)."""
    orig = jtimeunet.LTAE, jutae.LTAE, jltae.MaskedLightweightAttention
    jtimeunet.LTAE = jutae.LTAE = functools.partial(jltae.LTAE, dropout=0.0,
                                                    attn_dropout=0.0)
    jltae.MaskedLightweightAttention = functools.partial(orig[2], attn_dropout=0.0)
    try:
        yield
    finally:
        jtimeunet.LTAE, jutae.LTAE, jltae.MaskedLightweightAttention = orig


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def _weights(kind: str, kw: dict, seed: int):
    """The port's model with weights drawn from ``seed``: its state dict,
    and the JAX variables through the JAX package's own importer."""
    model = init_weights(torch_dp_workers.build(kind, kw), torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    convert_fn = {"timeunet": convert_timeunet, "utae": convert_utae, "wtae": convert_wtae}[kind]
    variables = convert_fn({k: v.numpy().copy() for k, v in sd.items()}, n_stages=LEVELS)
    return sd, _np(variables)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references of the step cases, and the 2-rank and 4-rank
    groups running every port case."""
    batch = _batch(5)
    weights = {name: _weights(kind, kw, seed) for name, (kind, kw, seed, _) in STEPS.items()}
    cases = [(kind, kw, weights[name][0], batch, CFG, LEVELS)
             for name, (kind, kw, _, _) in STEPS.items()]
    pool = concurrent.futures.ThreadPoolExecutor(2)
    groups = {world: pool.submit(run_workers, torch_dp_workers.run_space_cases, world,
                                 PRIMITIVES, cases, world == 2, threads=1,
                                 base_dir=str(tmp_path_factory.mktemp(f"store{world}")))
              for world in (2, 4)}
    jax_models = {"timeunet": jtimeunet.TimeUNet(**KW), "utae": jutae.UTAE(**UTAE_KW),
                  "wtae": JWTAE(**KW)}
    refs = {}
    with _no_dropout():
        for name, (kind, _, _, x64) in STEPS.items():
            if x64:
                with jax.enable_x64(True):
                    refs[name] = _jax_reference(jax_models[kind], _f64(weights[name][1]),
                                                _f64(batch))
            else:
                refs[name] = _jax_reference(jax_models[kind], weights[name][1], batch)
    results = {world: g.result() for world, g in groups.items()}
    pool.shutdown()
    return refs, results


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_halo_primitive_matches_the_unsharded_op(runs, name, world):
    """The ranks' outputs make up the unsharded op's (a whole-frame output:
    each rank's is it), their input gradients make up its input gradient
    and their weight gradients add up to its weight gradients."""
    ranks = [r["primitives"][name] for r in runs[1][world]]
    x, grads = torch_dp_workers.primitive_inputs(name)
    want = torch_dp_workers.run_primitive(name, x, grads)
    _, _, _, in_axis, out_axis = torch_dp_workers.PRIMITIVES[name]
    for i, w in enumerate(want["out"]):
        got = ([torch.cat([r["out"][i] for r in ranks], out_axis)] if out_axis is not None
               else [r["out"][i] for r in ranks])
        for g in got:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
    dx = torch.cat([r["dx"] for r in ranks], in_axis)
    np.testing.assert_allclose(dx.numpy(), want["dx"].numpy(), rtol=1e-5, atol=1e-5)
    for k, w in want["dparams"].items():
        got = sum(r["dparams"][k] for r in ranks)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(STEPS))
def test_data_space_step_matches_the_global_batch(runs, name, world):
    """Every rank of the (world / 2, 2) mesh: the global loss and confusion
    matrices; the summed gradients, the same on every rank, and the running
    statistics against the JAX step on the whole batch."""
    refs, results = runs
    want = refs[name]
    ranks = [r["steps"][list(STEPS).index(name)] for r in results[world]]
    for got in ranks:
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["cm"].numpy(), want["cm"])
        np.testing.assert_array_equal(got["cm_top2"].numpy(), want["cm_top2"])
    assert int(ranks[0]["cm"].sum()) == B * HW * HW
    for got in ranks[1:]:
        for k, g in ranks[0]["grads"].items():
            torch.testing.assert_close(got["grads"][k], g, rtol=0, atol=0, msg=k)
    kind = STEPS[name][0]
    tree = {"params": want["grads"], "batch_stats": want["stats"]}
    sd = (convert.wtae_state_dict_from_flax(tree) if kind == "wtae" else
          convert.utae_state_dict_from_flax(tree, STEPS[name][1].get("encoder_norm", "group")))
    grads = ranks[0]["grads"]
    _assert_model_grads({k: g.numpy() for k, g in grads.items()},
                        {k: sd[k].numpy() for k in grads})
    stats = _stats(sd)
    assert stats
    for k, w in stats.items():
        for got in ranks:
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("refusal", ["H does not divide", "misaligned shard",
                                     "bottleneck of one row", "mesh shape",
                                     "missing pad_mask"])
def test_the_mesh_refuses(runs, refusal):
    for r in runs[1][2]:
        assert r["refusals"][refusal] == "ValueError", r["refusals"]
