"""Parallelism on ``torch.distributed`` (counterpart of
``fastegnn_tpu/parallel``): process groups and device meshes, data
parallelism over graphs (``data_parallel.py``) and owner-sharded graph
parallelism within a graph batch (``owner_graph.py``)."""

from fastegnn_tpu_torch.parallel.data_parallel import (
    iter_dp_batches,
    make_dp_agree,
    make_dp_eval_step,
    make_dp_train_step,
    rank_key,
)
from fastegnn_tpu_torch.parallel.mesh import (
    initialize_distributed,
    local_device,
    make_hybrid_mesh,
    make_mesh,
    mesh_group,
    process_rank,
)
from fastegnn_tpu_torch.parallel.owner_graph import (
    OwnerBatchFactory,
    OwnerCapacityError,
    OwnerShard,
    halo_exchange,
    halo_pair_rows,
    iter_owner_sharded_batches,
    make_owner_gp_eval_step,
    make_owner_gp_forward,
    make_owner_gp_train_step,
    make_owner_sharded_batch,
    owner_sharded_fastegnn,
)

__all__ = [
    "OwnerBatchFactory",
    "OwnerCapacityError",
    "OwnerShard",
    "halo_exchange",
    "halo_pair_rows",
    "initialize_distributed",
    "iter_dp_batches",
    "iter_owner_sharded_batches",
    "local_device",
    "make_dp_agree",
    "make_dp_eval_step",
    "make_dp_train_step",
    "make_hybrid_mesh",
    "make_mesh",
    "make_owner_gp_eval_step",
    "make_owner_gp_forward",
    "make_owner_gp_train_step",
    "make_owner_sharded_batch",
    "mesh_group",
    "owner_sharded_fastegnn",
    "process_rank",
    "rank_key",
]
