"""The ranks of tests/test_torch_parallel.py's data-parallel groups. JAX-free:
each rank is a spawned process, which imports this module and not the test
file (whose JAX import would cost every rank seconds)."""
import torch

from crop2seg_tpu_torch.learning.trainer import StepConfig
from crop2seg_tpu_torch.parallel import (
    data_parallel_eval, data_parallel_step, init_group, rank_seed, replicate,
    shard_batch)


def build(kind: str, kw: dict) -> torch.nn.Module:
    """The port's model ``kind`` ("timeunet" or "utae") with its dropout
    rates at 0."""
    from crop2seg_tpu_torch.models import UTAE, TimeUNet

    model = {"timeunet": TimeUNet, "utae": UTAE}[kind](**kw)
    model.temporal_encoder.attn_dropout = 0.0
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
