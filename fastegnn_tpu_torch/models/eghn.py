"""EGHN, the equivariant graph hierarchy network (counterpart of
``fastegnn_tpu/models/eghn.py``; reference ``basic.py:514-736``).

A low EGNN force block on the real edges; a learned soft pooling of the
nodes into ``n_cluster`` clusters by :class:`PoolingNet` on the *local*
(bond) edges; a high EGNN over the dense cluster graph, whose edge feature
is the pooled adjacency of the real edges; and an equivariant kinematics
decoder that brings the clusters' updates back to the nodes.

``forward(graph) -> (x_out, h_out, cut_loss)`` reads the bond edges from
the batch (``GraphBatch.local_*``, the protein dataset's
``with_local_edges``), so the training loop needs no hook.  The cut loss
on the pooled bond adjacency is returned and, as in the JAX CLI, not added
to the training loss.  The JAX module's quirks are kept:

- the double embedding: EGHN's ``embedding``, then the low EGNN's own;
- the cluster graph is complete, its diagonal included, with no mask (the
  reference computes a mask and does not apply it, ``basic.py:678``);
- the softmax over clusters is masked by the node mask afterwards, and the
  cluster sizes are clamped at 1e-5;
- ``layer_decoder == 1`` decodes with one ``EquivariantScalarNet``, else an
  ``EGMN`` of that depth.

Every edge sum runs on the segment-sum kernel on a CUDA batch: the EGNNs'
through ``models/basic.py``; the pooled adjacency of the real edges over
the dst CSR, with its gather's backward over the src CSR; the bond sums
and the bond gathers' backwards through the kernel's perm form
(``ops/spmm.py::segment_sum_through`` / ``gather_through`` over the
batch's ``local_perm`` / ``local_src_perm``), the bonds staying in the
JAX order.  The cluster graph's edges are made sorted by dst, P per
cluster, so its row pointers are ``arange(0, B P P + 1, P)`` at dst and at
src and it needs no sort.  Per-graph pooling runs on the batch's ``[B,
n_max]`` node layout as batched products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from fastegnn_tpu_torch import resolve_device
from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.basic import (
    EGMN, EGNN, BaseMLP, EquivariantEdgeScalarNet, EquivariantScalarNet)
from fastegnn_tpu_torch.models.fastegnn_core import per_graph_take
from fastegnn_tpu_torch.models.nn import init_parameters_
from fastegnn_tpu_torch.ops.spmm import (
    gather_src, gather_through, segment_sum_through, sorted_segment_sum_csr)

N_POOL_VECTORS = 3   # the pooling net's stack: [x - graph mean, nf, v]


@dataclasses.dataclass
class Bonds:
    """The batch's local (bond) edges, as the bond sums and gathers read
    them: ``sum_ids`` is ``dst`` with the masked slots moved out of range,
    so that their rows get no gradient; ``count`` the real bonds at each
    dst, clamped at 1."""

    dst: torch.Tensor
    src: torch.Tensor
    attr: torch.Tensor
    sum_ids: torch.Tensor
    perm: torch.Tensor
    rowptr: torch.Tensor
    src_perm: torch.Tensor
    src_rowptr: torch.Tensor
    count: torch.Tensor

    @classmethod
    def of(cls, graph: GraphBatch) -> "Bonds":
        if graph.local_dst is None:
            raise ValueError("EGHN needs local bond edges: construct the dataset with "
                             "with_local_edges=True")
        n = graph.num_nodes
        return cls(
            dst=graph.local_dst, src=graph.local_src, attr=graph.local_edge_attr,
            sum_ids=torch.where(graph.local_edge_mask, graph.local_dst,
                                torch.full_like(graph.local_dst, n)),
            perm=graph.local_perm, rowptr=graph.local_rowptr, src_perm=graph.local_src_perm,
            src_rowptr=graph.local_src_rowptr,
            count=(graph.local_rowptr[1:] - graph.local_rowptr[:-1]).float().clamp_min(1.0))

    def sum_at_dst(self, rows: torch.Tensor) -> torch.Tensor:
        """``[N, F]`` sums of the bonds' ``rows`` at their dst."""
        return segment_sum_through(rows, self.sum_ids, self.perm, self.rowptr,
                                   self.rowptr.shape[0] - 1)

    def ends(self, table: torch.Tensor):
        """``(table[dst], table[src])`` of every bond slot."""
        return (gather_through(table, self.dst, self.perm, self.rowptr),
                gather_through(table, self.src, self.src_perm, self.src_rowptr))


class PoolingLayer(nn.Module):
    """Message passing on a stack of vectors per node (``basic.py:514-543``)."""

    def __init__(self, hidden: int, n_vectors: int, edge_attr_dim: int, flat: bool = False):
        super().__init__()
        H = hidden
        self.edge_message_net = EquivariantEdgeScalarNet(n_vectors, 2 * H + edge_attr_dim, H,
                                                         norm=True, flat=flat)
        self.node_net = BaseMLP(2 * H, H, H, flat=flat)

    def forward(self, vectors, h, bonds: Bonds):
        n, H, V = h.shape[0], h.shape[1], vectors.shape[-1]
        e_d, e_s = bonds.ends(torch.cat([h, vectors.reshape(n, 3 * V)], -1))
        hij = torch.cat([e_d[:, :H], e_s[:, :H], bonds.attr], -1)
        v_out, msg = self.edge_message_net(e_d[:, H:].reshape(-1, 3, V),
                                           e_s[:, H:].reshape(-1, 3, V), hij)
        agg_v = bonds.sum_at_dst(v_out.reshape(-1, 3 * V)) / bonds.count[:, None]
        vectors = vectors + agg_v.reshape(n, 3, V)
        h = h + self.node_net(torch.cat([h, bonds.sum_at_dst(msg)], -1))
        return vectors, h


class PoolingNet(nn.Module):
    """The cluster-assignment network (``basic.py:546-568``): ``[N,
    n_cluster]`` logits."""

    def __init__(self, hidden: int, out: int, n_vectors: int, edge_attr_dim: int,
                 n_layers: int = 3, flat: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(PoolingLayer(hidden, n_vectors, edge_attr_dim, flat)
                                    for _ in range(n_layers))
        self.pooling = nn.Sequential(nn.Linear(hidden, 8 * hidden), nn.Tanh(),
                                     nn.Linear(8 * hidden, out))

    def forward(self, vectors, h, bonds: Bonds):
        vectors = torch.stack(list(vectors), -1)   # [N, 3, V]
        for layer in self.layers:
            vectors, h = layer(vectors, h, bonds)
        return self.pooling(h)


def cluster_graph(Hc, X, Vc, A_global, graph: GraphBatch) -> GraphBatch:
    """The dense cluster graph of a batch: ``B * P`` nodes (features ``Hc``,
    positions ``X``, velocities ``Vc`` or zeros: ``[B, P, .]``), every
    ordered pair of a graph's clusters an edge, the diagonal included, with
    the pooled adjacency ``A_global[b, dst, src]`` as its feature.  Edge
    ``e = b P P + r P + c`` runs from ``b P + c`` to ``b P + r``, so the
    edges are sorted by dst with P per node; the src order reads them
    through ``perm[(b P + c) P + r] = e``."""
    B, P = X.shape[0], X.shape[1]
    n, e = B * P, B * P * P
    i32 = dict(dtype=torch.int32, device=X.device)
    node = torch.arange(n, **i32)
    rowptr = torch.arange(0, e + 1, P, **i32)
    coord = X.reshape(n, 3)
    return GraphBatch(
        node_feat=Hc.reshape(n, -1), coord=coord,
        vel=Vc.reshape(n, 3) if Vc is not None else torch.zeros_like(coord),
        node_mask=torch.ones(n, dtype=torch.bool, device=X.device),
        graph_id=torch.arange(B, device=X.device).repeat_interleave(P),
        dst=node.repeat_interleave(P), src=node.view(B, 1, P).expand(B, P, P).reshape(e),
        edge_attr=A_global.reshape(e, 1),
        edge_mask=torch.ones(e, dtype=torch.bool, device=X.device),
        coord_target=coord, loc_mean=graph.loc_mean,
        dst_count=torch.full((n,), float(P), device=X.device), rowptr=rowptr,
        src_perm=torch.arange(e, **i32).view(B, P, P).transpose(1, 2).reshape(e),
        src_rowptr=rowptr, n_graphs=B, n_real_edges=e)


class EGHN(nn.Module):
    """Reference ``EGHN`` (``basic.py:571-736``; protein only, driven with
    the bond graph as local edges, ``utils/train.py:69-79``).

    ``forward(graph) -> (x_out [N, 3], h_out [N, H], cut_loss [])``; the
    batch must carry local edges (``local_edge_attr_dim`` wide)."""

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 n_cluster: int = 15, layer_per_block: int = 3, layer_pooling: int = 4,
                 layer_decoder: int = 2, flat: bool = False, with_v: bool = True,
                 local_edge_attr_dim: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = hidden
        self.n_cluster, self.with_v, self.layer_decoder = n_cluster, with_v, layer_decoder
        self.embedding = nn.Linear(node_feat_dim, H)
        self.low_force_net = EGNN(H, edge_attr_dim, H, layer_per_block, with_v=with_v,
                                  flat=flat, device="cpu", generator=generator)
        self.high_force_net = EGNN(H, 1, H, layer_per_block, with_v=with_v, flat=flat,
                                   device="cpu", generator=generator)
        self.low_pooling = PoolingNet(H, n_cluster, N_POOL_VECTORS, local_edge_attr_dim,
                                      n_layers=layer_pooling, flat=flat)
        # the decoder's stack: [l_nf, x - l_X, (v - l_V), nf]; scalars [h, l_H]
        n_vectors = 4 if with_v else 3
        if layer_decoder == 1:
            self.kinematics_net = EquivariantScalarNet(n_vectors, 2 * H, H, norm=True,
                                                       flat=flat)
        else:
            self.kinematics_net = EGMN(n_vectors, 2 * H, H, layer_decoder, norm=True,
                                       flat=flat)
        for part in (self.embedding, self.low_pooling, self.kinematics_net):
            init_parameters_(part, generator)
        self.to(resolve_device(device))

    def forward(self, graph: GraphBatch):
        bonds = Bonds.of(graph)
        B, N, P = graph.n_graphs, graph.num_nodes, self.n_cluster
        n_max = N // B
        x, v = graph.coord, graph.vel
        nmask = graph.node_mask.float()
        m = nmask.view(B, n_max)

        h = self.embedding(graph.node_feat)
        new_x, _, h = self.low_force_net(dataclasses.replace(graph, node_feat=h))
        nf = new_x - x

        x_mean = (x.view(B, n_max, 3) * m[..., None]).sum(1) / m.sum(1).clamp_min(1.0)[:, None]
        logits = self.low_pooling([x - per_graph_take(x_mean, N), nf, v], h, bonds)
        s_flat = torch.softmax(logits, dim=1) * nmask[:, None]          # [N, P]
        s = s_flat.view(B, n_max, P)
        sT = s.transpose(1, 2)                                           # [B, P, n]
        count = torch.einsum("bpn,bn->bp", sT, m).clamp_min(1e-5)[..., None]

        def pool(a):
            return torch.bmm(sT, a.reshape(B, n_max, -1)) / count

        def unpool(a):
            return torch.bmm(s, a).reshape(N, -1)

        X, Hc = pool(x), pool(h)
        Vc = pool(v) if self.with_v else None

        # pooled adjacencies: A @ s over each edge set, then s^T @ that
        ne = graph.n_real_edges
        a_local = bonds.sum_at_dst(gather_through(s_flat, bonds.src, bonds.src_perm,
                                                  bonds.src_rowptr))
        a_global = sorted_segment_sum_csr(
            gather_src(s_flat, graph.src[:ne], graph.src_perm, graph.src_rowptr),
            graph.dst[:ne], graph.rowptr, N)
        A_local = torch.bmm(sT, a_local.view(B, n_max, P))
        A_global = torch.bmm(sT, a_global.view(B, n_max, P))
        A_n = A_local / A_local.norm(dim=2, keepdim=True).clamp_min(1e-12)
        eye = torch.eye(P, device=x.device)
        cut_loss = (A_n - eye).reshape(B, -1).norm(dim=1).mean()

        h_x, _, h_h = self.high_force_net(cluster_graph(Hc, X, Vc, A_global, graph))
        h_nf = (h_x - X.reshape(B * P, 3)).view(B, P, 3)

        vectors = [unpool(h_nf), x - unpool(X)]
        if self.with_v:
            vectors.append(v - unpool(Vc))
        vectors.append(nf)
        scalars = torch.cat([h, unpool(h_h.view(B, P, -1))], -1)
        if self.layer_decoder == 1:
            l_kin, h_out = self.kinematics_net(torch.stack(vectors, -1), scalars)
        else:
            l_kin, h_out = self.kinematics_net(vectors, scalars)
        return unpool(X + h_nf) + l_kin, h_out, cut_loss
