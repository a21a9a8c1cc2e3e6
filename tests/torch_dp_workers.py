"""The ranks of tests/test_torch_parallel.py's data-parallel groups and of
the data x space meshes of tests/test_torch_space_parallel.py and
tests/test_torch_space_zoo.py. JAX-free: each
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
    StepConfig kwargs, levels: the model's resolutions, which only the
    refusals read); per case the loss, the confusion matrices, every
    gradient before Adam's update and the state after the forward."""
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
        aux = step(shard_batch_2d(batch, mesh, model),
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
    from crop2seg_tpu_torch.nn.layers import space_shards

    kind, kw, state, batch, cfg_kw, levels = case
    model = build(kind, kw)
    # one level more: the bottleneck's shard holds one row
    deeper = build(kind, dict(kw, encoder_widths=tuple(kw["encoder_widths"])[:levels] + (16,),
                              decoder_widths=tuple(kw["decoder_widths"])[:levels] + (16,)))

    def rows(h):
        return {k: (v[:, :, :h] if k == "x" else v[:, :h] if k == "y" else v)
                for k, v in batch.items()}
    h = batch["x"].shape[2]
    tries = {
        "H does not divide": lambda: shard_batch_2d(rows(h - 1), mesh, model),
        "misaligned shard": lambda: shard_batch_2d(rows(h - 4), mesh, model),
        "bottleneck of one row": lambda: shard_batch_2d(batch, mesh, deeper),
        "mesh shape": lambda: make_mesh_2d(mesh.data, mesh.space + 1),
    }

    def no_pad_mask():
        shard = shard_batch_2d(batch, mesh, model)
        with space_shards(mesh.space_group):
            model(torch.as_tensor(shard["x"]), torch.as_tensor(shard["dates"]))
    tries["missing pad_mask"] = no_pad_mask
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = type(e).__name__
    return out


# --- the rest of the zoo on the data x space mesh (tests/test_torch_space_zoo.py)

def build_zoo(kind: str, kw: dict) -> torch.nn.Module:
    """The port's model ``kind`` with every dropout rate at 0: a zoo model
    (TimeUNet_v2, UNet3D, ConvLSTMSeg, BConvLSTMSeg, ConvGRUSeg, RecUNet,
    UnetNaive) or one of ``build``'s."""
    from crop2seg_tpu_torch import models

    if kind in ("timeunet", "utae", "wtae"):
        return build(kind, kw)
    model = {"timeunet_v2": models.TimeUNetV2, "unet3d": models.UNet3D,
             "convlstm": models.ConvLSTMSeg, "bconvlstm": models.BConvLSTMSeg,
             "convgru": models.ConvGRUSeg, "recunet": models.RecUNet,
             "unet_naive": models.UnetNaive}[kind](**kw)
    if kind == "timeunet_v2":
        for tae in (model.temporal_encoder_full_resolution,
                    model.temporal_encoder_low_resolution):
            tae.dropout = tae.attn_dropout = 0.0
            for stage in tae.attention_heads:
                if hasattr(stage, "dropout"):
                    stage.dropout = 0.0
    return model


# name: (the op's kind, its arguments): primitives and modules of the zoo,
# each over the space ranks against the same op unsharded (``zoo_op``)
ZOO_OPS = {
    "conv3d k3 p1": ("conv3d", dict(k=3, s=1, p=1)),
    "conv3d k(3,4,4) s(1,2,2) p1": ("conv3d", dict(k=(3, 4, 4), s=(1, 2, 2), p=1)),
    "conv transpose3d k3 s2 p1 op1": ("convt3d", dict(k=3, s=2, p=1, op=1)),
    "conv transpose3d k(3,4,4) s(1,2,2) p1": ("convt3d", dict(k=(3, 4, 4), s=(1, 2, 2), p=1,
                                                              op=0)),
    "conv k3 d2 zeros": ("conv", dict(k=3, s=1, p=2, d=2, padding_mode="zeros")),
    "conv k3 d2 reflect": ("conv", dict(k=3, s=1, p=2, d=2, padding_mode="reflect")),
    "conv k3 s2 p1 zeros": ("conv", dict(k=3, s=2, p=1, d=1, padding_mode="zeros")),
    "conv transpose k3 s2 p1 op1": ("convt", dict(k=3, s=2, p=1, op=1)),
    "boundary mask connectivity 4": ("boundary", dict(connectivity=4)),
    "boundary mask connectivity 8": ("boundary", dict(connectivity=8)),
    "ConvBlock3D batch norm": ("block3d", dict(norm="batch")),
    "ConvBlock3D instance norm": ("block3d", dict(norm="instance")),
    "DownConvBlock3D group norm": ("down3d", dict(norm="group")),
    "TemporalAggregator3D att_group upsampled": ("agg3d", dict(mode="att_group", f=0.5)),
    "TemporalAggregator3D att_mean pooled": ("agg3d", dict(mode="att_mean", f=2)),
    "TemporalAggregator3D mean": ("agg3d", dict(mode="mean", f=1)),
    "UNetEx": ("unet_ex", {}),
    "UNetEx deconv strided dilated": ("unet_ex", dict(use_deconv=True, strides=(1, 2, 1),
                                                      downsamples=(True, True),
                                                      enc_dilations=(1, 1, 2),
                                                      dec_dilations=(2, 1))),
    "Unet": ("unet", {}),
}
ZOO_OP_H = 16    # H of every op's input (the U-Nets: 32, the bottleneck 2 rows a rank at 4 ranks)


def zoo_op(name: str):
    """The op of ZOO_OPS ``name`` in float64 with its weights and global
    inputs drawn from fixed seeds, the same in every process: (fn (inputs ->
    tuple of outputs, None where an output is absent), its module or None,
    [(global input, its H axis or None, differentiable)], the outputs' H
    axes). Float64 leaves each comparison the halos' error alone: in fp32
    the ranks' partial weight gradients of a 3-D transposed conv (sums of
    ~1000 products, ~30 in size) differ from one sum by ~1e-6 of that,
    past 1e-5 of an entry that happens to be small."""
    from crop2seg_tpu_torch.models import UNetEx, Unet
    from crop2seg_tpu_torch.nn import blocks3d
    from crop2seg_tpu_torch.nn import layers
    from crop2seg_tpu_torch.ops.boundary import boundary_mask

    kind, a = ZOO_OPS[name]
    torch.manual_seed(0)
    rng = np.random.default_rng(1)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    h = ZOO_OP_H
    x3 = (randn(2, 5, h, 6, 4), 2, True)              # (B, T, H, W, C)
    x2 = (randn(2, h, 6, 4), 1, True)                 # (B, H, W, C)
    if kind == "conv3d":
        mod = blocks3d.Conv3d(4, 5, a["k"], stride=a["s"], padding=a["p"])
        return (lambda x: (mod(x),)), mod, [x3], [2]
    if kind == "convt3d":
        mod = blocks3d.ConvTranspose3d(4, 3, a["k"], stride=a["s"], padding=a["p"],
                                       output_padding=a["op"])
        return (lambda x: (mod(x),)), mod, [x3], [2]
    if kind == "conv":
        mod = layers.Conv2d(4, 5, a["k"], stride=a["s"], padding=a["p"], dilation=a["d"],
                            padding_mode=a["padding_mode"])
        return (lambda x: (mod(x),)), mod, [x2], [1]
    if kind == "convt":
        mod = layers.ConvTranspose2d(4, 3, a["k"], stride=a["s"], padding=a["p"],
                                     output_padding=a["op"])
        return (lambda x: (mod(x),)), mod, [x2], [1]
    if kind == "boundary":
        # 2 x 2 blocks of one class: boundary and interior pixels both
        y = torch.from_numpy(rng.integers(0, 5, (2, h // 2, 3))).repeat_interleave(
            2, 1).repeat_interleave(2, 2)
        return ((lambda y: (boundary_mask(y, 5, a["connectivity"]),)), None,
                [(y, 1, False)], [1])
    if kind == "block3d":
        mod = blocks3d.ConvBlock3D((4, 6, 6), norm=a["norm"])
        return (lambda x: (mod(x),)), mod, [x3], [2]
    if kind == "down3d":
        mod = blocks3d.DownConvBlock3D(4, 8, norm=a["norm"])
        return (lambda x: (mod(x),)), mod, [x3], [2]
    if kind == "agg3d":
        mod = blocks3d.TemporalAggregator3D(a["mode"])
        x = randn(2, 5, h, 6, 8)
        ha, wa = int(h * a["f"]), int(6 * a["f"])
        attn = torch.softmax(randn(2, ha, wa, 2, 5), -1)
        pad = torch.tensor([[False] * 5, [False] * 3 + [True] * 2])

        def fn(x, attn, pad):
            out, masks = mod(x, attn, pad)
            return out, masks
        mask_axis = {"att_group": 2, "att_mean": 1, "mean": None}[a["mode"]]
        return (fn, mod, [(x, 2, True), (attn, 1, a["mode"] != "mean"), (pad, None, False)],
                [1, mask_axis])
    if kind == "unet_ex":
        stages = len(a.get("strides", (1, 1, 1)))
        mod = UNetEx(in_channels=4, base_channels=4, num_stages=stages,
                     strides=a.get("strides", (1, 1, 1)), enc_num_convs=(2,) * stages,
                     dec_num_convs=(2,) * (stages - 1),
                     downsamples=a.get("downsamples", (True, True)),
                     enc_dilations=a.get("enc_dilations", (1,) * stages),
                     dec_dilations=a.get("dec_dilations", (1,) * (stages - 1)),
                     use_deconv=a.get("use_deconv", False), num_classes=5, return_maps=True)

        def fn(x):
            out, maps = mod(x)
            return (out,) + tuple(maps)
        return fn, mod, [(randn(2, 2 * h, 8, 4), 1, True)], [1] * (stages + 1)
    mod = Unet(encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16), out_conv=(4, 5),
               encoder_norm="batch")
    return (lambda x: (mod(x),)), mod, [(randn(2, 2 * h, 8, 8), 1, True)], [1]


def run_zoo_op(name: str, rows=None, share: float = 1.0) -> dict:
    """The op's outputs in training mode, the differentiable inputs'
    gradients and the weights' gradients from upstream gradients drawn from
    a fixed seed (the outputs' shapes: unsharded). ``rows(t, axis)`` cuts a
    rank's rows of a global tensor along H; a whole-frame output's gradient
    is weighed by ``share`` (1 / the space ranks)."""
    fn, mod, inputs, out_axes = zoo_op(name)
    if mod is not None:
        mod.double().train()
    with torch.no_grad():
        full = [o for o in fn(*[t for t, _, _ in inputs])]
    rng = np.random.default_rng(2)
    grads = [None if o is None or not o.is_floating_point() else
             torch.from_numpy(rng.standard_normal(tuple(o.shape)))
             for o in full]
    xs = []
    for t, axis, diff in inputs:
        if rows is not None and axis is not None:
            t = rows(t, axis)
        xs.append(t.clone().requires_grad_(True) if diff else t)
    outs = fn(*xs)
    pairs = [(o, g if rows is None or axis is None else rows(g, axis))
             if axis is not None else (o, g * share)
             for o, g, axis in zip(outs, grads, out_axes) if g is not None]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    params = {} if mod is None else {k: p.grad.clone() for k, p in mod.named_parameters()
                                     if p.grad is not None}
    return {"out": [None if o is None else o.detach() for o in outs],
            "dx": [x.grad.clone() for x in xs if x.requires_grad], "dparams": params}


def run_zoo_cases(rank: int, world: int, store_dir: str, ops: list, steps: list) -> dict:
    """One rank of ``world`` gloo ranks on the CPU: each op of ZOO_OPS over
    ``world`` space ranks (``run_zoo_op``, inside ``space_shards`` and
    ``global_batch_stats`` of the line's group), and each step case on the
    (world / 2, 2) mesh. A step case: (kind, kw, state dict, global batch,
    StepConfig kwargs); per case the loss, the confusion matrices (and the
    boundary loss's), every gradient before Adam's update and the state
    after the forward."""
    from crop2seg_tpu_torch.nn.layers import global_batch_stats, space_shards

    init_group(rank, world, store_dir, "cpu")
    line = make_mesh_2d(1, world)
    out = {"ops": {}, "steps": []}

    def rows(t, axis):
        n = t.shape[axis] // world
        return t.narrow(axis, rank * n, n)
    for name in ops:
        with space_shards(line.space_group), global_batch_stats(line.space_group):
            out["ops"][name] = run_zoo_op(name, rows, 1.0 / world)
    mesh = make_mesh_2d(world // 2, 2)
    for kind, kw, state, batch, cfg_kw in steps:
        model = build_zoo(kind, kw)
        if rank == 0:
            model.load_state_dict(state)
        replicate(model, mesh.group)
        step = data_space_parallel_step(model, StepConfig(**cfg_kw), mesh, device="cpu")
        aux = step(shard_batch_2d(batch, mesh, model),
                   torch.Generator().manual_seed(rank_seed(0, rank)))
        res = {k: v.clone() for k, v in aux.items()}
        res["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
        res["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["steps"].append(res)
    return out
