"""Data-parallel and data x space training, patch-parallel serving
(``mesh.py``). Every model of ``models/factory.py::get_model`` trains on
the 2-D (data x space) mesh, with the boundary loss and ``test_region``."""
from crop2seg_tpu_torch.parallel.mesh import (
    Mesh2D, barrier, data_parallel_eval, data_parallel_step, data_space_parallel_step,
    init_group, make_mesh, make_mesh_2d, patch_parallel_infer, rank_seed, replicate,
    run_workers, shard_batch, shard_batch_2d)

__all__ = ["Mesh2D", "barrier", "data_parallel_eval", "data_parallel_step",
           "data_space_parallel_step", "init_group", "make_mesh", "make_mesh_2d",
           "patch_parallel_infer", "rank_seed", "replicate", "run_workers", "shard_batch",
           "shard_batch_2d"]
