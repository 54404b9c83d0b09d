"""Parallelism on ``torch.distributed`` (counterpart of
``fastegnn_tpu/parallel``): process groups and device meshes, and data
parallelism over graphs.  Graph parallelism (``owner_graph.py``) is not
ported yet."""

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
    process_rank,
)

__all__ = [
    "initialize_distributed",
    "iter_dp_batches",
    "local_device",
    "make_dp_agree",
    "make_dp_eval_step",
    "make_dp_train_step",
    "make_hybrid_mesh",
    "make_mesh",
    "process_rank",
    "rank_key",
]
