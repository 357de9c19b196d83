"""Parallelism layer (counterpart of `vibo_tpu.parallel`): the (students,
items) mesh over torch.distributed ranks, its groups and the collectives
the mesh steps and the sharded evaluators use."""

from vibo_tpu_torch.parallel.mesh import (  # noqa: F401
    ITEMS, STUDENTS, Mesh, all_reduce_grads, all_reduce_sum,
    broadcast_params, default_backend, group_size, init_distributed,
    make_mesh, pad_rows, psum, rank_device,
)
