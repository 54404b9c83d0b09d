"""Owner-sharded graph parallelism (counterpart of
``fastegnn_tpu/parallel/owner_graph.py``): O(N/G) node state per process
and one halo exchange per layer, for FastEGNN at the paper configuration
(mean aggregation, no attention, normalize or tanh).

- A batch's N node rows are cut into G contiguous owner ranges of
  ``Nl = N / G`` rows; process ``i`` of the mesh's ``graph`` axis holds only
  rows ``[i * Nl, (i + 1) * Nl)`` (:class:`OwnerShard`).
- Each real edge lives on the owner of its dst: the edges are dst-sorted,
  so each owner's edges are a contiguous run and its dst sums are local and
  exact.
- Per layer, each process sends each peer the rows of ``[h | x]`` that the
  peer's edges read as src, the targeted per-pair boundary sets worked out
  on the host, with one ``all_to_all`` of ``[G, S, H + 3]`` blocks
  (:func:`halo_exchange`).  The edge block then runs on a local table of
  ``Nl + G * S`` rows, owned rows first, over the shard's own dst CSR
  (halo rows have no incoming edges): the fused edge kernels, or the CSR
  branch's segment-sum kernel.
- The per-graph pools of the virtual block are partial sums over each
  shard, summed over the ``graph`` axis by a differentiable ``all_reduce``
  and divided by global counts (:func:`shard_take_pool`).

The layers are the port's own ``FastEGNN`` modules, so the parameters, the
``state_dict`` and the checkpoints are the one-process ones.  Unlike the
JAX package, which stacks the G shards on a leading axis and runs them in
``shard_map``, each process holds its own shard, and the losses of the G
(times D, with a ``data`` axis) processes sum to the global loss: the sum of
their gradients is the exact gradient (:func:`make_owner_gp_train_step`).

The JAX package's v5 slot metas (``ek5_*``, ``make_v5_meta``, superchunk
capacities) are a TPU layout and have no counterpart: the shard carries the
dst CSR ``rowptr`` and the src-sorted ``src_perm`` / ``src_rowptr`` over its
table, which the port's kernels read.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.fastegnn_core import real_edge_sums, virtual_and_node_update
from fastegnn_tpu_torch.ops.segment import segment_count, segment_sum
from fastegnn_tpu_torch.parallel.data_parallel import rank_key, reduce_gradients_before_step
from fastegnn_tpu_torch.parallel.mesh import mesh_group
from fastegnn_tpu_torch.train.loss import mmd_loss
from fastegnn_tpu_torch.train.step import draw_sample, key_generator

AXIS = "graph"
DATA_AXIS = "data"
EDGE_QUANTUM, HALO_QUANTUM = 1024, 256   # OwnerBatchFactory's capacity steps


class OwnerCapacityError(ValueError):
    """A batch needs more per-shard edge slots or halo rows than the
    capacity it was given."""


@dataclasses.dataclass
class OwnerShard:
    """Shard ``shard`` of G of one batch: its ``Nl`` owned node
    rows, its edges, and the tables of its halo exchange.  The edge block
    reads it as a batch over its table of ``Nl + G * S`` rows (owned rows,
    then S halo rows from each shard)."""

    node_feat: torch.Tensor       # [Nl, F]
    coord: torch.Tensor           # [Nl, 3]
    vel: torch.Tensor             # [Nl, 3]
    node_mask: torch.Tensor       # [Nl] bool
    graph_id: torch.Tensor        # [Nl] int64 in [0, B]; B = padding
    coord_target: torch.Tensor    # [Nl, 3]
    dst: torch.Tensor             # [El] int32 owned row; sentinel Nl past the real edges
    src: torch.Tensor             # [El] int32 table row; 0 past the real edges
    edge_attr: torch.Tensor       # [El, Fe]
    edge_mask: torch.Tensor       # [El] bool
    dst_count: torch.Tensor       # [Nl] f32 global in-degree
    send_idx: torch.Tensor        # [G, S] int32 owned rows sent to each shard
    loc_mean: torch.Tensor        # [B, 3, C]
    rowptr: torch.Tensor          # [Nl + G*S + 1] int32 dst CSR over the table
    src_perm: torch.Tensor        # [n_real] int32 stable argsort of the real src
    src_rowptr: torch.Tensor      # [Nl + G*S + 1] int32 its row pointer
    node_mask_full: torch.Tensor  # [N] bool, the whole batch's (the MMD's)
    n_graphs: int
    shard: int
    n_real_edges: int

    @property
    def n_owned(self) -> int:
        return self.node_feat.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coord.device


@dataclasses.dataclass
class _Partition:
    """The host analysis shared by every shard of one batch."""

    owner: np.ndarray             # [E] owner shard of each edge, -1 if padded
    pair_sets: list               # [j][i]: rows of shard j that shard i reads
    halo: int                     # natural S: the largest pair set (>= 1)
    edges: int                    # natural El: the most edges of a shard (>= 1)
    n_owned: int


def _partition(batch: GraphBatch, n_shards: int) -> _Partition:
    N, G = batch.num_nodes, n_shards
    if N % G:
        raise ValueError(f"node capacity {N} must divide by {n_shards}")
    Nl = N // G
    dst, src = batch.dst.cpu().numpy(), batch.src.cpu().numpy()
    real = batch.edge_mask.cpu().numpy() & (dst < N)
    owner = np.where(real, dst // Nl, -1)
    pair_sets = [[np.empty(0, np.int64)] * G for _ in range(G)]
    for i in range(G):
        src_i = src[owner == i]
        for j in range(G):
            if j != i:
                pair_sets[j][i] = np.unique(src_i[src_i // Nl == j])
    halo = max([1] + [pair_sets[j][i].size for j in range(G) for i in range(G)])
    edges = max([1] + [int((owner == i).sum()) for i in range(G)])
    return _Partition(owner, pair_sets, halo, edges, Nl)


def _capacity(natural: int, capacity: Optional[int], what: str) -> int:
    if capacity is None:
        return natural
    if natural > capacity:
        raise OwnerCapacityError(f"{what} {natural} exceed capacity {capacity}")
    return capacity


def _build(batch: GraphBatch, part: _Partition, shard: int, S: int, El: int,
           device) -> OwnerShard:
    G, Nl, i = len(part.pair_sets), part.n_owned, shard
    if not 0 <= i < G:
        raise ValueError(f"shard {shard} of {G}")
    NT = Nl + G * S
    dst, src = batch.dst.cpu().numpy(), batch.src.cpu().numpy()
    # send_idx[d] = local ids of the rows shard i sends shard d; after the
    # all_to_all, shard i's halo row for a node of shard j sits at
    # Nl + j * S + its position in pair_sets[j][i]
    send_idx = np.zeros((G, S), np.int32)
    halo_pos = np.full(batch.num_nodes, -1, np.int64)
    for j in range(G):
        send_idx[j, :part.pair_sets[i][j].size] = part.pair_sets[i][j] - i * Nl
        halo_pos[part.pair_sets[j][i]] = Nl + j * S + np.arange(part.pair_sets[j][i].size)
    sel = part.owner == i
    ne = int(sel.sum())
    d, s = dst[sel] - i * Nl, src[sel]
    dst_l = np.full(El, Nl, np.int32)
    dst_l[:ne] = d
    src_l = np.zeros(El, np.int32)
    src_l[:ne] = np.where(s // Nl == i, s - i * Nl, halo_pos[s])
    ea = batch.edge_attr.cpu().numpy()
    ea_l = np.zeros((El, ea.shape[1]), ea.dtype)
    ea_l[:ne] = ea[sel]
    em_l = np.zeros(El, bool)
    em_l[:ne] = True
    src_perm = np.argsort(src_l[:ne], kind="stable")
    rows = np.arange(NT + 1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def own(a: torch.Tensor) -> torch.Tensor:
        return a[i * Nl:(i + 1) * Nl].to(device)

    return OwnerShard(
        node_feat=own(batch.node_feat), coord=own(batch.coord), vel=own(batch.vel),
        node_mask=own(batch.node_mask), graph_id=own(batch.graph_id),
        coord_target=own(batch.coord_target),
        dst=t(dst_l), src=t(src_l), edge_attr=t(ea_l), edge_mask=t(em_l),
        dst_count=t(np.bincount(d, minlength=Nl).astype(np.float32)),
        send_idx=t(send_idx), loc_mean=batch.loc_mean.to(device),
        rowptr=t(np.searchsorted(d, rows, side="left").astype(np.int32)),
        src_perm=t(src_perm.astype(np.int32)),
        src_rowptr=t(np.searchsorted(src_l[:ne][src_perm], rows, side="left").astype(np.int32)),
        node_mask_full=batch.node_mask.to(device),
        n_graphs=batch.n_graphs, shard=i, n_real_edges=ne)


def make_owner_sharded_batch(batch: GraphBatch, n_shards: int, *, shard: int,
                             el_capacity: Optional[int] = None,
                             halo_capacity: Optional[int] = None,
                             device=None) -> OwnerShard:
    """Shard ``shard`` of ``batch`` (host partitioner, numpy), on ``device``
    (the batch's unless given).  The node capacity must divide by
    ``n_shards``.  ``el_capacity`` / ``halo_capacity`` pin the edge slots
    and halo rows per shard (:class:`OwnerCapacityError` if the batch needs
    more); ``None`` sizes them exactly to this batch.  Array for array,
    the JAX ``make_owner_sharded_batch(..., build_ek5=False)``'s shard
    ``shard``, plus the CSR tables over the shard's table."""
    part = _partition(batch, n_shards)
    S = _capacity(part.halo, halo_capacity, "halo rows")
    El = _capacity(part.edges, el_capacity, "per-shard edges")
    return _build(batch, part, shard, S, El, batch.device if device is None else device)


class OwnerBatchFactory:
    """Owner shards with capacities that only grow: the edge slots
    quantised to ``EDGE_QUANTUM``, the halo rows to ``HALO_QUANTUM``, each
    the running maximum, so that the shapes settle after the first batches.
    Every rank of a data replica sees the same batches in the same order,
    so their factories agree on the capacities without a collective."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.el_capacity = 0
        self.halo_capacity = 0

    @staticmethod
    def _q(x: int, m: int) -> int:
        return -(-x // m) * m

    def __call__(self, batch: GraphBatch, shard: int, device=None) -> OwnerShard:
        part = _partition(batch, self.n_shards)
        self.el_capacity = max(self.el_capacity, self._q(part.edges, EDGE_QUANTUM))
        self.halo_capacity = max(self.halo_capacity, self._q(part.halo, HALO_QUANTUM))
        return _build(batch, part, shard, self.halo_capacity, self.el_capacity,
                      batch.device if device is None else device)


def _axis(mesh: DeviceMesh, name: str):
    """``(size, this rank's index)`` of the mesh axis ``name``; (1, 0) if
    the mesh has no such axis."""
    if name not in (mesh.mesh_dim_names or ()):
        return 1, 0
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)


def iter_owner_sharded_batches(dataset, batch_size: int, mesh: DeviceMesh,
                               factory: OwnerBatchFactory,
                               rng: Optional[np.random.Generator] = None) -> Iterator[OwnerShard]:
    """This rank's shards (the CLI's ``--mesh graph=G`` path): the global
    batches of ``dataset.batch_indices(batch_size, rng)`` (the same shuffle
    on every rank, drawn from the same ``rng``), each cut into D contiguous
    sub-batches, one per data replica as ``data_parallel.py::
    iter_dp_batches`` cuts them; every rank of a replica collates the
    replica's sub-batch on the host and moves its own shard to the
    dataset's device."""
    data, r = _axis(mesh, DATA_AXIS)
    _, shard = _axis(mesh, AXIS)
    if batch_size % data:
        raise ValueError(f"batch size {batch_size} not divisible by data axis {data}")
    per = batch_size // data
    for idx in dataset.batch_indices(batch_size, rng):
        sub = idx[r * per:(r + 1) * per]
        yield factory(dataset.host_collate(sub), shard, dataset.device)


def halo_pair_rows(batch: GraphBatch, n_shards: int) -> int:
    """The real boundary rows over all ordered shard pairs: what one layer's
    exchange must move at the least, against the ``G * G * S`` rows its
    equal blocks move."""
    part = _partition(batch, n_shards)
    return sum(s.size for row in part.pair_sets for s in row)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """Block ``j`` of dim 0 goes to rank ``j`` of ``group``, equal blocks;
    with equal blocks the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its backward sums the cotangents over
    ``group`` (JAX's ``psum`` transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows, in rank order; the backward is this rank's rows
    of the cotangents summed over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g.chunk(dist.get_world_size(ctx.group))[dist.get_rank(ctx.group)], None


def halo_exchange(hx: torch.Tensor, send_idx: torch.Tensor, group) -> torch.Tensor:
    """``[Nl + G * S, F]``: the owned rows ``hx`` [Nl, F], then the S rows
    from each shard that this shard's edges read (one ``all_to_all`` of the
    ``[G, S, F]`` blocks ``hx[send_idx]``).  Differentiable: the backward
    sends the halo rows' gradients back to their owners."""
    G, S = send_idx.shape
    send = hx.index_select(0, send_idx.reshape(-1).long()).reshape(G, S, hx.shape[1])
    halo = _AllToAll.apply(send, group)
    return torch.cat([hx, halo.reshape(G * S, hx.shape[1])])


def shard_take_pool(shard: OwnerShard, group):
    """``(take, pool)`` for ``virtual_block`` on a shard: the take by
    ``graph_id`` (padded rows read graph B - 1, the JAX f32 take's clip),
    and the per-graph mean over real nodes as the shard's partial sums
    summed over ``group`` (differentiably) and divided by the global
    counts, reduced once here."""
    B, gid, mask = shard.n_graphs, shard.graph_id, shard.node_mask
    rows = gid.clamp_max(B - 1)
    count = segment_count(gid, B, mask)
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
    count = count.clamp_min(1.0)

    def take(table: torch.Tensor) -> torch.Tensor:
        return table.index_select(0, rows)

    def pool(z: torch.Tensor) -> torch.Tensor:
        total = _AllReduceSum.apply(segment_sum(z.float(), gid, B, mask), group)
        return total / count.reshape(count.shape + (1,) * (total.dim() - 1))

    return take, pool


# ---------------------------------------------------------------------------
# forward and steps
# ---------------------------------------------------------------------------


def owner_sharded_fastegnn(model, shard: OwnerShard, group, *, csr: bool = False):
    """``model``'s (the port's ``FastEGNN``) forward on one shard, the
    ``graph`` axis's process group ``group`` holding the others: ``(x
    [Nl, 3] owned rows, virtual coordinates [B, 3, C])``, the virtual ones
    equal on every rank.  ``csr`` takes the CSR branch (the segment-sum
    kernel) where the layer fits the fused edge kernels, as the JAX
    ``build_ek5=False`` does."""
    Nl = shard.n_owned
    h, vx, vh = model.embed(shard)
    x, v = shard.coord, shard.vel
    take, pool = shard_take_pool(shard, group)
    cnt = shard.dst_count.clamp_min(1.0)[:, None]
    for layer in model.layers():
        table = halo_exchange(torch.cat([h, x], -1), shard.send_idx, group)
        H = h.shape[1]
        m_sum, t_sum = real_edge_sums(layer, table[:, :H], table[:, H:], shard, csr=csr)
        h, x, vx, vh = virtual_and_node_update(
            layer.cfg, layer, h, x, v, vx, vh, shard.graph_id, shard.node_mask,
            t_sum[:Nl] / cnt, m_sum[:Nl] / cnt, gravity=model.gravity, take=take, pool=pool)
    return x, vx.transpose(1, 2)


def make_owner_gp_forward(model, mesh: DeviceMesh, csr: bool = False) -> Callable:
    """``fwd(shard) -> (x [N, 3], virtual coordinates [B, 3, C])`` without
    gradients: the shards' predictions gathered over the ``graph`` axis."""
    group = mesh.get_group(AXIS)

    @torch.no_grad()
    def fwd(shard: OwnerShard):
        x, vloc = owner_sharded_fastegnn(model, shard, group, csr=csr)
        return _AllGatherRows.apply(x, group), vloc

    return fwd


def _owner_loss(model, shard, groups, draw, *, sigma, weight, sample, per_graph_sampling,
                use_mmd, csr):
    """``(local loss, local squared error, mmd)``.  The local losses of all
    ranks sum to the global loss: the squared error over the owned real
    rows divided by the global count, plus ``weight * mmd / (G * D)``, the
    MMD of the replica's whole sub-batch on the gathered predictions, which
    each of its G ranks computes alike (the JAX ``_owner_local_loss``)."""
    graph, world = groups
    m = shard.node_mask.float()[:, None]
    count = (m.sum() * 3.0).reshape(1)
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=world)
    x, vloc = owner_sharded_fastegnn(model, shard, graph, csr=csr)
    local_se = ((x - shard.coord_target) ** 2 * m).sum()
    loss = local_se / count[0].clamp_min(1.0)
    if not use_mmd:
        return loss, local_se, torch.zeros_like(local_se), count[0]
    kw = {"scores": draw} if per_graph_sampling else {"perm": draw}
    mmd = mmd_loss(_AllGatherRows.apply(x, graph), vloc, shard.node_mask_full, shard.n_graphs,
                   sigma, sample, **kw)
    return loss + weight * mmd / dist.get_world_size(world), local_se, mmd, count[0]


def _make_owner_step(model, optimizer, mesh, sigma, weight, sample, per_graph_sampling,
                     use_mmd, csr):
    groups = (mesh.get_group(AXIS), mesh_group(mesh))
    n_all = mesh.size()
    _, data_rank = _axis(mesh, DATA_AXIS)
    if optimizer is not None:
        reduce_gradients_before_step(model, optimizer, groups[1], mean=False)

    def run(shard: OwnerShard, key, draw) -> Dict[str, torch.Tensor]:
        if draw is None and use_mmd:
            if key is None:
                raise ValueError("the owner-sharded step needs key= or draw= for its MMD "
                                 "draw, which every rank of a replica must draw alike")
            # one draw over the replica's whole sub-batch, the same on its
            # G ranks: the key of its data rank
            whole = SimpleNamespace(n_graphs=shard.n_graphs, device=shard.device,
                                    num_nodes=shard.node_mask_full.shape[0])
            draw = draw_sample(whole, per_graph_sampling,
                               key_generator(rank_key(key, data_rank), shard.device))
        if optimizer is not None:
            optimizer.zero_grad(set_to_none=True)
        loss, local_se, mmd, count = _owner_loss(
            model, shard, groups, draw, sigma=sigma, weight=weight, sample=sample,
            per_graph_sampling=per_graph_sampling, use_mmd=use_mmd, csr=csr)
        if optimizer is not None:
            loss.backward()
            optimizer.step()
        # the squared errors summed; the replicas' MMDs averaged (each
        # replica's G ranks hold the same value)
        v = torch.stack([local_se.detach(), mmd.detach() / n_all])
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=groups[1])
        mse = v[0] / count.clamp_min(1.0)
        return {"loss": mse + weight * v[1], "mse": mse, "mmd": v[1]}

    return run


def make_owner_gp_train_step(model, optimizer: torch.optim.Optimizer, mesh: DeviceMesh,
                             sigma: float = 1.5, weight: float = 0.01, sample: int = 3,
                             per_graph_sampling: bool = False, use_mmd: bool = True,
                             csr: bool = False) -> Callable:
    """``step(shard, key=None, draw=None) -> {"loss", "mse", "mmd"}``: one
    owner-sharded forward, backward and ``optimizer`` step on this rank's
    shard.  The gradients are summed over every rank of ``mesh`` (``data``
    and ``graph``) before the step, which makes them the exact gradient of
    the global loss.  The MMD draw: ``draw`` (over the replica's whole
    sub-batch, as ``train/step.py``'s steps take it), else from
    ``rank_key(key, data rank)``, the one-process step's at one replica.
    The metrics are the global MSE and the replicas' mean MMD."""
    run = _make_owner_step(model, optimizer, mesh, sigma, weight, sample, per_graph_sampling,
                           use_mmd, csr)

    def step(shard: OwnerShard, key=None, draw: Optional[torch.Tensor] = None):
        model.train()
        return run(shard, key, draw)

    return step


def make_owner_gp_eval_step(model, mesh: DeviceMesh, sigma: float = 1.5, weight: float = 0.01,
                            sample: int = 3, per_graph_sampling: bool = False,
                            use_mmd: bool = True, csr: bool = False) -> Callable:
    """``step(shard, key=None, draw=None) -> {"loss", "mse", "mmd"}``: the
    train step's forward and metrics without gradients."""
    run = _make_owner_step(model, None, mesh, sigma, weight, sample, per_graph_sampling,
                           use_mmd, csr)

    @torch.no_grad()
    def step(shard: OwnerShard, key=None, draw: Optional[torch.Tensor] = None):
        model.eval()
        return run(shard, key, draw)

    return step

