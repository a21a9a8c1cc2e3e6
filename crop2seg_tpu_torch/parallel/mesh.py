"""Data-parallel training and patch-parallel serving over cards (port of
crop2seg_tpu/parallel/mesh.py:1-111).

The JAX package jits its one-device step on global arrays over a device
mesh, and GSPMD inserts the all-reduces. Here the same math runs in
``torch.distributed``'s idiom: one process per card (NCCL), or per CPU
worker (gloo), each holding a replica of the model and an equal shard of
every global batch.

- ``run_workers`` starts N processes (spawn) in one group, rendezvous
  through a ``FileStore`` in a temporary directory (no TCP port), and
  returns each rank's result; ``init_group`` joins a process to the group.
- ``replicate`` broadcasts rank 0's parameters and buffers;
  ``shard_batch`` cuts a rank's rows out of a global batch.
- ``data_parallel_step`` / ``data_parallel_eval``: the train and eval steps
  over the group (``learning/trainer.py``: the loss denominators and the
  gradients summed over the ranks, BatchNorm on the global batch's
  statistics, the loss and confusion matrices global). N ranks give the
  loss, confusion matrices, gradients and BatchNorm statistics of one
  process on the concatenated batch, up to the order of sums. Dropout
  differs: each rank draws from its own generator (``rank_seed``), so no two
  ranks draw the same masks or the same attention-dropout hash seed;
  comparisons of N ranks against one process set every dropout rate to 0.
- ``make_mesh`` / ``patch_parallel_infer``: one process, a list of devices
  (duplicates allowed: two replicas on one card run the same split); the
  patch axis of a tile's batch splits evenly over them.
- ``make_mesh_2d`` / ``shard_batch_2d`` / ``data_space_parallel_step``: the
  2-D (data, space) training mesh. Rank (d, s) holds the d-th slice of the
  global batch and the s-th slice of H of its frames and labels. GSPMD
  inserts the halo exchanges of the JAX step; here the layers exchange
  their neighbours' rows themselves inside ``nn/layers.py::space_shards``
  and sum GroupNorm's statistics over the space shards, and the loss, the
  gradients, BatchNorm and the confusion matrices are summed over every
  rank. The step gives what the 1-D step gives on the global batch, for
  every model of ``models/factory.py::get_model`` (and BConvLSTMSeg), with
  the boundary loss and ``test_region`` too.
"""
from __future__ import annotations

import copy
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from crop2seg_tpu_torch.learning.trainer import make_eval_step, make_train_step


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of ``rank`` in a run seeded ``seed``:
    ``seed`` itself on rank 0, distinct on every other rank."""
    return int(seed) + 1_000_003 * int(rank)


def init_group(rank: int, world_size: int, store_dir: str, device,
               backend: Optional[str] = None):
    """Join this process to the group of ``world_size`` ranks as ``rank``,
    through a ``FileStore`` in ``store_dir`` (shared by the ranks). The
    backend is NCCL for a CUDA ``device`` (made the current one) and gloo
    for the CPU, unless ``backend`` says (gloo on a CUDA device lets ranks
    share one card). The ranks are one host's: gloo talks over the loopback
    device unless ``GLOO_SOCKET_IFNAME`` names another. A failed init
    raises. Returns the group (``torch.distributed.group.WORLD``)."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return dist.group.WORLD


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; NCCL on this process's card."""
    group = group or dist.group.WORLD
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def _worker(rank: int, fn: Callable, world_size: int, store_dir: str,
            threads: Optional[int], args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        result = fn(rank, world_size, store_dir, *args)
        torch.save(result, os.path.join(store_dir, f"result_{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_workers(fn: Callable, world_size: int, *args, base_dir: Optional[str] = None,
                threads: Optional[int] = None) -> List:
    """Run ``fn(rank, world_size, store_dir, *args)`` in ``world_size``
    spawned processes and return their results by rank (each picklable by
    ``torch.save``). ``fn`` joins the group itself (``init_group(rank,
    world_size, store_dir, ...)``). ``store_dir`` is a temporary directory
    under ``base_dir`` (default: the system's), removed at the end.
    ``threads``: each worker's ``torch.set_num_threads``. A worker that
    raises ends the others, and the error is raised here."""
    import torch.multiprocessing as mp

    store_dir = tempfile.mkdtemp(prefix="dp_", dir=base_dir)
    try:
        mp.start_processes(_worker, args=(fn, world_size, store_dir, threads, args),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(store_dir, f"result_{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def replicate(model: torch.nn.Module, group=None) -> torch.nn.Module:
    """Rank 0's parameters and buffers (BatchNorm's running statistics)
    broadcast to every rank of ``group``, in place; returns ``model``."""
    group = group or dist.group.WORLD
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return model


def shard_batch(batch: Mapping, group=None) -> Dict:
    """This rank's rows of every array of a global ``batch`` (the JAX
    ``shard_batch``, placed by the caller's step); ValueError unless the
    ranks divide the batch."""
    group = group or dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = len(batch["x"])
    if n % world:
        raise ValueError(f"batch {n} must divide over {world} ranks")
    per = n // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def data_parallel_step(model: torch.nn.Module, cfg, group=None, **kw) -> Callable:
    """``make_train_step(model, cfg, **kw)`` over ``group`` (default: the
    whole group): ``step(shard, generator)`` takes this rank's shard of the
    global batch and returns the global loss and confusion matrices.
    Call ``replicate`` first so that every rank starts from the same
    parameters; Adam's state then stays equal on every rank, since the
    gradients are."""
    return make_train_step(model, cfg, group=group or dist.group.WORLD, **kw)


def data_parallel_eval(model: torch.nn.Module, cfg, group=None, **kw) -> Callable:
    """``make_eval_step(model, cfg, **kw)`` over ``group``: the global
    batch's loss and confusion matrices from each rank's shard."""
    return make_eval_step(model, cfg, group=group or dist.group.WORLD, **kw)


@dataclass(frozen=True)
class Mesh2D:
    """A (data, space) mesh over a group: ``group`` (every rank: the loss,
    the gradients, BatchNorm and the confusion matrices), ``space_group``
    (this rank's row of the mesh, which splits H), the mesh's shape
    ``data`` x ``space`` and this rank's place ``(d, s)``."""
    group: Any
    space_group: Any
    data: int
    space: int
    d: int
    s: int


def make_mesh_2d(data: int, space: int, group=None) -> Mesh2D:
    """The ``data`` x ``space`` mesh over ``group`` (default: the whole
    group), its ranks in row-major order: rank r is (r // space, r % space),
    as the JAX mesh reshapes its devices. Every rank of the default group
    must call it, since every rank makes every row's group, in order.
    ValueError unless data * space is the group's size."""
    group = group or dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if data < 1 or space < 1 or data * space != world:
        raise ValueError(f"a {data} x {space} mesh needs {data * space} ranks, not {world}")
    ranks = dist.get_process_group_ranks(group)
    rows = [dist.new_group([ranks[d * space + s] for s in range(space)]) for d in range(data)]
    return Mesh2D(group, rows[rank // space], data, space, rank // space, rank % space)


def shard_batch_2d(batch: Mapping, mesh: Mesh2D, model: torch.nn.Module) -> Dict:
    """This rank's part of a global ``batch`` on ``mesh`` (the JAX
    ``shard_batch_2d``): every array's rows of the data axis, and of x (B,
    T, H, W, C) and y (B, H, W) also the rows of H of the space axis.
    ``model``'s ``space_rows`` (multiple, least), which each model sets
    beside its layers, says which shards its layers take: a U-Net's keep
    every level's grid and give its bottleneck a row to mirror or to send
    (``nn/layers.py::unet_space_rows``), UNet3D's pool twice, the recurrent
    baselines' take any height. ValueError unless the data ranks divide B
    and the space ranks H, and each shard's height is a multiple of the
    first and at least the second."""
    n, h = len(batch["x"]), batch["x"].shape[2]
    if n % mesh.data or h % mesh.space:
        raise ValueError(f"batch {n} x H {h} must divide over the {mesh.data} x "
                         f"{mesh.space} mesh")
    rows = h // mesh.space
    multiple, least = model.space_rows
    if rows % multiple or rows < least:
        raise ValueError(f"space shards of {rows} rows: {type(model).__name__} needs a "
                         f"multiple of {multiple} rows and {least} at least")
    per = n // mesh.data
    batch_rows = slice(mesh.d * per, (mesh.d + 1) * per)
    space_rows = slice(mesh.s * rows, (mesh.s + 1) * rows)
    out = {k: v[batch_rows] for k, v in batch.items()}
    out["x"] = out["x"][:, :, space_rows]
    out["y"] = out["y"][:, space_rows]
    return out


def data_space_parallel_step(model: torch.nn.Module, cfg, mesh: Mesh2D, **kw) -> Callable:
    """``make_train_step(model, cfg, **kw)`` over ``mesh``: ``step(shard,
    generator)`` takes this rank's ``shard_batch_2d`` of the global batch
    and returns the global loss and confusion matrices, the boundary loss's
    and ``test_region``'s included (``ops/boundary.py`` takes a label row of
    each neighbour). The loss denominators, the gradients, BatchNorm and the
    matrices are summed over the whole group, and the forward and backward
    run inside ``space_shards(mesh.space_group)``. Call ``replicate``
    first. Each rank draws its dropout masks from its own generator
    (``rank_seed``), so only dropout 0 compares with one process."""
    return make_train_step(model, cfg, group=mesh.group, space_group=mesh.space_group, **kw)


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a patch-parallel mesh: ``devices`` (names or
    ``torch.device``; one may repeat), by default every visible card."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device; no card is visible")
    return mesh


def patch_parallel_infer(model: torch.nn.Module, mesh: Sequence) -> Callable:
    """Whole-tile inference split over ``mesh`` (a list of devices,
    ``make_mesh``): a copy of ``model`` in eval mode on each device, made
    now. Returns ``fwd(x, *per_row)``: x (B, ...) and every per-row tensor
    (dates, pad mask) split evenly along B, each device's share run (all
    shares issued before any is gathered), the outputs gathered back onto
    the first device in order (``model`` returns one tensor, as the tile
    predictors' models do). ValueError when B does not divide over the mesh
    (crop2seg_tpu/parallel/mesh.py:102-109)."""
    devices = make_mesh(mesh)
    replicas = [copy.deepcopy(model).to(d).eval() for d in devices]

    def fwd(x: torch.Tensor, *per_row: torch.Tensor):
        n, b = len(devices), x.shape[0]
        if b % n:
            raise ValueError(f"patch batch {b} must divide over {n} devices")
        per = b // n
        outs = []
        for i, (dev, m) in enumerate(zip(devices, replicas)):
            rows = slice(i * per, (i + 1) * per)
            outs.append(m(*(a[rows].to(dev, non_blocking=True) for a in (x,) + per_row)))
        return torch.cat([o.to(devices[0]) for o in outs])

    return fwd
