"""Data parallelism over graphs (counterpart of
``fastegnn_tpu/parallel/data_parallel.py``).

Each of the D processes of the mesh's ``data`` axis holds the whole model
and takes ``batch_size / D`` contiguous graphs of each global batch; graphs
never straddle processes, so the only collectives are the means of the
gradients and of the metrics.  The one-process model code and steps run
unchanged: the data-parallel steps wrap ``train/step.py``'s.

The JAX package stacks the D sub-batches into one ``[D, ...]`` pytree
placed across the devices (``stack_shards`` / ``shard_batch_for_mesh``);
those have no counterpart here, because each process collates and holds only
its own sub-batch.  Unlike the JAX path, a sub-batch keeps its CSR tables,
so each process runs the fused edge kernels on them.

Each rank's MMD draw comes from the loop's host key mixed with its rank
(:func:`rank_key`; rank 0 takes the key unchanged), as the JAX step folds
the shard index into its key: at D = 1 the step is the one-process step.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.parallel.mesh import mesh_group
from fastegnn_tpu_torch.train.step import make_eval_step, make_train_step

AXIS = "data"


def rank_key(key, rank: int) -> np.ndarray:
    """The host key of ``rank``'s MMD draw: ``key`` itself on rank 0, else
    ``key`` mixed with the rank (SeedSequence)."""
    key = np.asarray(key, np.uint32)
    if rank == 0:
        return key
    return np.random.SeedSequence([*(int(k) for k in key), rank]).generate_state(2, np.uint32)


def _mean_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` replaced in place by its mean over ``group``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(dist.get_world_size(group))


def _on_axis(plain_step: Callable, mesh: DeviceMesh) -> Callable:
    """``plain_step`` on this rank's sub-batch with this rank's key, and
    the mean of its three metrics over the axis (one ``all_reduce``)."""
    group = mesh.get_group(AXIS)
    rank = dist.get_rank(group)

    def step(graph: GraphBatch, key=None,
             draw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        m = plain_step(graph, None if key is None else rank_key(key, rank), draw)
        v = _mean_(torch.stack([m["loss"], m["mse"], m["mmd"]]).float(), group)
        return {"loss": v[0], "mse": v[1], "mmd": v[2]}

    return step


def reduce_gradients_before_step(model, optimizer: torch.optim.Optimizer, group,
                                 mean: bool) -> None:
    """Register on ``optimizer`` a pre-step hook that replaces each
    gradient of ``model`` by its sum over ``group`` (``mean``: its mean),
    with one ``all_reduce`` of a flat buffer.

    The flat buffer is made once, one slot per parameter in ``parameters()``
    order.  Only gradients that are not None go through it and come back: a
    None gradient stays None, so Adam skips the parameter as the
    one-process step does.  Which parameters get a gradient depends on the
    model, not on the batch, so it is the same on every rank.
    """
    params = list(model.parameters())
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                       device=params[0].device)
    slots = [s.view(p.shape) for s, p in zip(flat.split([p.numel() for p in params]), params)]

    def reduce_gradients(*_):
        flat.zero_()
        have = [(p, s) for p, s in zip(params, slots) if p.grad is not None]
        for p, s in have:
            s.copy_(p.grad)
        if mean:
            _mean_(flat, group)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for p, s in have:
            p.grad.copy_(s)

    optimizer.register_step_pre_hook(reduce_gradients)


def make_dp_train_step(model, optimizer: torch.optim.Optimizer, mesh: DeviceMesh,
                       sigma: float = 1.5, weight: float = 0.01, sample: int = 3,
                       per_graph_sampling: bool = False, use_mmd: bool = True) -> Callable:
    """``step(graph, key=None, draw=None) -> {"loss", "mse", "mmd"}``, where
    ``graph`` is this rank's sub-batch: ``train/step.py::make_train_step``
    with one ``all_reduce`` of the flat gradient (its mean over the axis,
    :func:`reduce_gradients_before_step`) before each of ``optimizer``'s
    steps, then the metrics' mean.
    """
    reduce_gradients_before_step(model, optimizer, mesh.get_group(AXIS), mean=True)
    return _on_axis(make_train_step(model, optimizer, sigma, weight, sample,
                                    per_graph_sampling, use_mmd), mesh)


def make_dp_eval_step(model, mesh: DeviceMesh, sigma: float = 1.5, weight: float = 0.01,
                      sample: int = 3, per_graph_sampling: bool = False,
                      use_mmd: bool = True) -> Callable:
    """``step(graph, key=None, draw=None) -> {"loss", "mse", "mmd"}`` on this
    rank's sub-batch without gradients: the metrics' mean over the axis."""
    return _on_axis(make_eval_step(model, sigma, weight, sample, per_graph_sampling,
                                   use_mmd), mesh)


def make_dp_agree(mesh: DeviceMesh) -> Callable:
    """``agree(*values) -> list``: rank 0's floats on every rank of the
    mesh (one broadcast).  The training loop decides its best epoch and its
    early stop on them, so that every rank decides alike, although each
    rank's evaluation on the card sums with float atomics whose last bits
    differ."""
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)

    def agree(*values: float) -> List[float]:
        t = torch.tensor(values, dtype=torch.float64, device=mesh.device_type)
        dist.broadcast(t, src=src, group=group)
        return t.tolist()

    return agree


def iter_dp_batches(dataset, batch_size: int, mesh: DeviceMesh,
                    rng: Optional[np.random.Generator] = None) -> Iterator[GraphBatch]:
    """This rank's sub-batches (the CLI's ``--mesh data=D`` path): the global
    batches of ``dataset.iter_batches(batch_size, rng)`` (the same shuffle,
    drawn alike on every rank from the same ``rng``), each cut into D
    contiguous sub-batches of ``batch_size / D`` graphs, of which this rank
    collates its own onto its device."""
    data = mesh.get_group(AXIS).size()
    if batch_size % data:
        raise ValueError(f"batch size {batch_size} not divisible by data axis {data}")
    per = batch_size // data
    r = mesh.get_local_rank(AXIS)
    lists = dataset.batch_indices(batch_size, rng)
    yield from dataset.iter_collated([idx[r * per:(r + 1) * per] for idx in lists])
