"""The ranks of tests/test_torch_parallel.py's data-parallel groups and of
tests/test_torch_space_parallel.py's data x space meshes. JAX-free: each
rank is a spawned process, which imports this module and not the test file
(whose JAX import would cost every rank seconds)."""
import numpy as np
import torch

from crop2seg_tpu_torch.learning.trainer import StepConfig
from crop2seg_tpu_torch.parallel import (
    data_parallel_eval, data_parallel_step, data_space_parallel_step, init_group,
    make_mesh_2d, rank_seed, replicate, shard_batch, shard_batch_2d)


def build(kind: str, kw: dict) -> torch.nn.Module:
    """The port's model ``kind`` ("timeunet", "utae" or "wtae") with its
    dropout rates at 0."""
    from crop2seg_tpu_torch.models import UTAE, WTAE, TimeUNet

    model = {"timeunet": TimeUNet, "utae": UTAE, "wtae": WTAE}[kind](**kw)
    model.temporal_encoder.attn_dropout = 0.0
    if hasattr(model.temporal_encoder, "mlp"):
        model.temporal_encoder.mlp[1].p = 0.0
    return model


def run_cases(rank: int, world: int, store_dir: str, cases: list) -> list:
    """Every case in one gloo group on the CPU. A case: (kind, kw, state
    dict, global batch, StepConfig kwargs, "train" or "eval"); this rank's
    shard of the batch through the group's step. Returns per case the loss,
    the confusion matrices and, in training, every gradient before Adam's
    update and the running statistics after the forward."""
    group = init_group(rank, world, store_dir, "cpu")
    out = []
    for kind, kw, state, batch, cfg_kw, mode in cases:
        model = build(kind, kw)
        if rank == 0:
            model.load_state_dict(state)
        replicate(model, group)            # the other ranks take rank 0's weights
        cfg = StepConfig(**cfg_kw)
        shard = shard_batch(batch, group)
        if mode == "train":
            step = data_parallel_step(model, cfg, device="cpu")
            aux = step(shard, torch.Generator().manual_seed(rank_seed(0, rank)))
        else:
            aux = data_parallel_eval(model, cfg, device="cpu")(shard)
        res = {k: v.clone() for k, v in aux.items()}
        if mode == "train":
            res["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
            res["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        out.append(res)
    return out


# --- the data x space mesh (tests/test_torch_space_parallel.py) -------------

# name: (the op's kind, its arguments, the input's shape, the axis of H in
# the input and the output: None where the output is the whole frame's)
PRIMITIVES = {
    "conv k3 reflect": ("conv", dict(d_in=4, d_out=5, k=3, p=1), (2, 16, 6, 4), 1, 1),
    "conv k3 zeros": ("conv", dict(d_in=4, d_out=5, k=3, p=1, padding_mode="zeros"),
                      (2, 16, 6, 4), 1, 1),
    "conv k4 s2 reflect": ("conv", dict(d_in=4, d_out=5, k=4, s=2, p=1), (2, 16, 6, 4), 1, 1),
    "conv 1x1": ("conv", dict(d_in=4, d_out=5, k=1, p=0), (2, 16, 6, 4), 1, 1),
    "depthwise k3 reflect": ("conv", dict(d_in=4, d_out=4, k=3, p=1, groups=4, bias=False),
                             (2, 16, 6, 4), 1, 1),
    "depthwise-separable k4 s2": ("dws", dict(d_in=4, d_out=6, k=4, s=2, p=1,
                                              padding_mode="reflect"), (2, 16, 6, 4), 1, 1),
    "conv transpose k4 s2": ("convt", dict(d_in=4, d_out=3, k=4, s=2, p=1),
                             (2, 16, 6, 4), 1, 1),
    "group norm": ("gn", dict(groups=2, c=4), (2, 16, 6, 4), 1, 1),
    "group norm frame_affine": ("gn_affine", dict(groups=2, c=4), (2, 16, 6, 4), 1, None),
    "instance norm": ("in", dict(c=4), (2, 16, 6, 4), 1, 1),
    "squeeze-excitation mean": ("mean", {}, (2, 16, 6, 4), 1, None),
    "resample x2": ("resample", dict(f=2), (3, 2, 16, 5), 2, 2),
    "resample x8": ("resample", dict(f=8), (3, 2, 8, 3), 2, 2),
    "resample pool /2": ("resample", dict(f=0.5), (3, 2, 16, 6), 2, 2),
}


def primitive(name: str):
    """The op of PRIMITIVES ``name`` with its weights drawn from a fixed
    seed: (fn (x -> tuple of outputs), its module or None), the same in
    every process."""
    from crop2seg_tpu_torch.nn import layers
    from crop2seg_tpu_torch.nn.aggregator import _resample_attn

    kind, a, shape, _, _ = PRIMITIVES[name]
    torch.manual_seed(0)
    if kind == "conv":
        mod = layers.Conv2d(a["d_in"], a["d_out"], a["k"], stride=a.get("s", 1),
                            padding=a["p"], groups=a.get("groups", 1),
                            bias=a.get("bias", True),
                            padding_mode=a.get("padding_mode", "reflect"))
    elif kind == "dws":
        mod = layers.DepthwiseSeparableConv2d(**a)
    elif kind == "convt":
        mod = layers.ConvTranspose2d(a["d_in"], a["d_out"], a["k"], stride=a["s"],
                                     padding=a["p"])
    elif kind in ("gn", "gn_affine"):
        mod = layers.GroupNorm(a["groups"], a["c"], eps=1e-5)
        with torch.no_grad():
            mod.weight.normal_()
            mod.bias.normal_()
    elif kind == "in":
        mod = layers.InstanceNorm2d(a["c"], eps=1e-5, affine=False)
    elif kind == "mean":
        mod = layers._SpatialMean()
    else:
        f = a["f"]

        def fn(x):
            h, w = (int(x.shape[2] * f), int(x.shape[3] * f))
            return (_resample_attn(x, h, w),)
        return fn, None
    if kind == "gn_affine":
        return (lambda x: mod.frame_affine(x)), mod
    return (lambda x: (mod(x),)), mod


def primitive_inputs(name: str):
    """The global input of PRIMITIVES ``name`` and the upstream gradient of
    each of its outputs (unsharded), from a fixed seed."""
    fn, _ = primitive(name)
    shape = PRIMITIVES[name][2]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        outs = fn(x)
    grads = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
             for o in outs]
    return x, grads


def run_primitive(name: str, x: torch.Tensor, grads: list, rows=None, share: float = 1.0):
    """The op's outputs, the input's gradient and the weights' gradients
    from the upstream ``grads``. ``rows(t, axis)`` cuts a rank's rows of a
    global tensor along H; a whole-frame output's gradient is weighed by
    ``share`` (1 / the space ranks: the ranks' losses add up to one)."""
    fn, mod = primitive(name)
    _, _, _, in_axis, out_axis = PRIMITIVES[name]
    if rows is not None:
        x = rows(x, in_axis)
        grads = [rows(g, out_axis) if out_axis is not None else g * share for g in grads]
    x = x.clone().requires_grad_(True)
    outs = fn(x)
    torch.autograd.backward(outs, grads)
    params = {} if mod is None else {k: p.grad.clone() for k, p in mod.named_parameters()}
    return {"out": [o.detach() for o in outs], "dx": x.grad.clone(), "dparams": params}


def run_space_cases(rank: int, world: int, store_dir: str, primitives: list, steps: list,
                    refusals: bool) -> dict:
    """One rank of a data x space mesh over ``world`` gloo ranks on the CPU:
    each primitive op over ``world`` space ranks (``run_primitive``), each
    step case on the (world / 2, 2) mesh, and with ``refusals`` the inputs
    the mesh refuses. A step case: (kind, kw, state dict, global batch,
    StepConfig kwargs, levels); per case the loss, the confusion matrices,
    every gradient before Adam's update and the state after the forward."""
    from crop2seg_tpu_torch.nn.layers import space_shards

    init_group(rank, world, store_dir, "cpu")
    line = make_mesh_2d(1, world)
    out = {"primitives": {}, "steps": [], "refusals": {}}

    def rows(t, axis):
        n = t.shape[axis] // world
        return t.narrow(axis, rank * n, n)
    for name in primitives:
        x, grads = primitive_inputs(name)
        with space_shards(line.space_group):
            out["primitives"][name] = run_primitive(name, x, grads, rows, 1.0 / world)
    mesh = make_mesh_2d(world // 2, 2)
    for kind, kw, state, batch, cfg_kw, levels in steps:
        model = build(kind, kw)
        if rank == 0:
            model.load_state_dict(state)
        replicate(model, mesh.group)
        step = data_space_parallel_step(model, StepConfig(**cfg_kw), mesh, device="cpu")
        aux = step(shard_batch_2d(batch, mesh, levels),
                   torch.Generator().manual_seed(rank_seed(0, rank)))
        res = {k: v.clone() for k, v in aux.items()}
        res["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
        res["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["steps"].append(res)
    if refusals:
        out["refusals"] = _refusals(mesh, steps[0])
    return out


def _refusals(mesh, case) -> dict:
    """Each refused input -> the name of the exception it raised (None when
    none was)."""
    from crop2seg_tpu_torch.models import Unet
    from crop2seg_tpu_torch.nn.layers import space_shards

    kind, kw, state, batch, cfg_kw, levels = case

    def rows(h):
        return {k: (v[:, :, :h] if k == "x" else v[:, :h] if k == "y" else v)
                for k, v in batch.items()}
    h = batch["x"].shape[2]
    tries = {
        "H does not divide": lambda: shard_batch_2d(rows(h - 1), mesh, levels),
        "misaligned shard": lambda: shard_batch_2d(rows(h - 4), mesh, levels),
        "bottleneck of one row": lambda: shard_batch_2d(batch, mesh, levels + 1),
        "mesh shape": lambda: make_mesh_2d(mesh.data, mesh.space + 1),
        "model outside the slice": lambda: data_space_parallel_step(
            Unet(encoder_widths=kw["encoder_widths"], decoder_widths=kw["decoder_widths"],
                 out_conv=kw["out_conv"]),
            StepConfig(**cfg_kw), mesh, device="cpu")(
                shard_batch_2d(batch, mesh, levels), torch.Generator()),
        "boundary loss": lambda: data_space_parallel_step(
            build(kind, kw), StepConfig(**dict(cfg_kw, add_boundary_loss=True)), mesh,
            device="cpu"),
    }

    def no_pad_mask():
        shard = shard_batch_2d(batch, mesh, levels)
        with space_shards(mesh.space_group):
            build(kind, kw)(torch.as_tensor(shard["x"]), torch.as_tensor(shard["dates"]))
    tries["missing pad_mask"] = no_pad_mask
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = type(e).__name__
    return out
