"""Data-parallel training and patch-parallel serving (``mesh.py``)."""
from crop2seg_tpu_torch.parallel.mesh import (
    barrier, data_parallel_eval, data_parallel_step, init_group, make_mesh,
    patch_parallel_infer, rank_seed, replicate, run_workers, shard_batch)

__all__ = ["barrier", "data_parallel_eval", "data_parallel_step", "init_group", "make_mesh",
           "patch_parallel_infer", "rank_seed", "replicate", "run_workers",
           "shard_batch"]
