"""FastEGNN — E(3)-equivariant message passing with virtual nodes
(counterpart of ``fastegnn_tpu/models/fast_egnn.py``; reference
``models/FastEGNN.py``).

Modules keep the reference layout and ``state_dict`` keys
(``embedding_in``, ``virtual_node_feat`` [1, H, C], ``gcl_{i}.edge_mlp.0``,
...), so weights cross to the JAX package through
``fastegnn_tpu/utils/torch_import.py::params_from_reference_state_dict``
and back through :func:`fastegnn_tpu_torch.utils.weights.state_dict_from_jax_params`.

The real-edge block takes the fused path (``ops/edge_kernel.py``: the CUDA
kernels on a CUDA batch, their plain versions on a CPU batch) whenever the
layer fits it — hidden 64, at most 3 edge attributes, no attention,
normalize or tanh, mean aggregation — with the whole batch in one call.
Other variants gather the edges and run :func:`edge_messages`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch import resolve_device
from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.fastegnn_core import (
    LayerCfg, edge_messages, virtual_and_node_update)
from fastegnn_tpu_torch.models.nn import coord_mlp, init_parameters_, mlp
from fastegnn_tpu_torch.ops.edge_kernel import FE_MAX, H as EDGE_H, fused_edge_block
from fastegnn_tpu_torch.ops.segment import segment_sum


class EGCLVel(nn.Module):
    """One FastEGNN layer (reference ``E_GCL_vel``, ``models/FastEGNN.py:6-223``)."""

    def __init__(self, hidden: int, virtual_channels: int, edge_attr_dim: int,
                 node_attr_dim: int = 0, residual: bool = True,
                 attention: bool = False, normalize: bool = False,
                 coords_agg: str = "mean", tanh: bool = False,
                 has_gravity: bool = False, epsilon: float = 1e-8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        H, C = hidden, virtual_channels
        self.cfg = LayerCfg(hidden=H, virtual_channels=C, residual=residual,
                            attention=attention, normalize=normalize, tanh=tanh,
                            coords_agg=coords_agg, has_gravity=has_gravity,
                            epsilon=epsilon, compute_dtype=compute_dtype)
        self.edge_mlp = mlp(2 * H + 1 + edge_attr_dim, H, H, act_final=True)
        self.edge_mlp_virtual = mlp(2 * H + 1 + C, H, H, act_final=True)
        self.coord_mlp_r = coord_mlp(H)
        self.coord_mlp_r_virtual = coord_mlp(H)
        self.coord_mlp_v_virtual = coord_mlp(H)
        self.coord_mlp_vel = mlp(H, H, 1)
        if has_gravity:
            self.gravity_mlp = mlp(H, H, 1)
        self.node_mlp = mlp(2 * H + C * H + node_attr_dim, H, H)
        self.node_mlp_virtual = mlp(2 * H, H, H)
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
            self.att_mlp_virtual = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
        self.fused = (H == EDGE_H and edge_attr_dim <= FE_MAX and not attention
                      and not normalize and not tanh and coords_agg == "mean")

    def forward(self, h, x, v, vx, vh, graph: GraphBatch,
                gravity: Optional[torch.Tensor] = None,
                node_attr: Optional[torch.Tensor] = None):
        cfg = self.cfg
        N = h.shape[0]
        if self.fused:
            e0, e2, g0, g2 = (self.edge_mlp[0], self.edge_mlp[2],
                              self.coord_mlp_r[0], self.coord_mlp_r[2])
            m_sum, trans_sum = fused_edge_block(
                h, x, graph.rowptr, graph.src, graph.dst, graph.edge_attr,
                e0.weight.t(), e0.bias, e2.weight.t(), e2.bias,
                g0.weight.t(), g0.bias, g2.weight.t(),
                compute_dtype=cfg.compute_dtype)
        else:
            ne = graph.n_real_edges
            d, s = graph.dst[:ne].long(), graph.src[:ne].long()
            m_e, trans = edge_messages(cfg, self, h[d], h[s], x[d], x[s],
                                       graph.edge_attr[:ne])
            m_sum = segment_sum(m_e.float(), d, N)
            trans_sum = segment_sum(trans, d, N)
        cnt = graph.dst_count.clamp_min(1.0)[:, None]
        agg_x = trans_sum / cnt if cfg.coords_agg == "mean" else trans_sum
        agg_e = m_sum / cnt
        return virtual_and_node_update(
            cfg, self, h, x, v, vx, vh, graph.graph_id, graph.node_mask,
            agg_x, agg_e, gravity=gravity, node_attr=node_attr)


class FastEGNN(nn.Module):
    """Reference ``FastEGNN`` (``models/FastEGNN.py:226-276``).

    ``forward(graph) -> (coord_pred [N, 3], virtual_coord [B, 3, C])``.
    Parameters are drawn from ``generator`` on the CPU, then the model moves
    to ``device`` (CUDA unless ``"cpu"`` is asked for).
    """

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, tanh: bool = False,
                 gravity: Optional[Sequence[float]] = None,
                 node_attr_dim: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if virtual_channels <= 0:
            raise ValueError("virtual_channels must be > 0")
        dev = resolve_device(device)
        H, C = hidden, virtual_channels
        self.hidden, self.virtual_channels, self.n_layers = H, C, n_layers
        self.use_node_attr = node_attr_dim > 0
        self.embedding_in = nn.Linear(node_feat_dim, H)
        self.virtual_node_feat = nn.Parameter(torch.empty(1, H, C))
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", EGCLVel(
                H, C, edge_attr_dim, node_attr_dim=node_attr_dim,
                residual=residual, attention=attention, normalize=normalize,
                tanh=tanh, has_gravity=gravity is not None,
                compute_dtype=compute_dtype))
        self.register_buffer(
            "gravity", None if gravity is None
            else torch.tensor(gravity, dtype=torch.float32), persistent=False)
        init_parameters_(self, generator)
        with torch.no_grad():
            nn.init.normal_(self.virtual_node_feat, generator=generator)
        self.to(dev)

    def layers(self):
        return [getattr(self, f"gcl_{i}") for i in range(self.n_layers)]

    def forward(self, graph: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        B, C, H = graph.n_graphs, self.virtual_channels, self.hidden
        vh = self.virtual_node_feat.transpose(1, 2).expand(B, C, H)
        vx = graph.loc_mean.transpose(1, 2)                     # [B, C, 3]
        h = self.embedding_in(graph.node_feat)
        x, v = graph.coord, graph.vel
        node_attr = graph.node_attr if self.use_node_attr else None
        for layer in self.layers():
            h, x, vx, vh = layer(h, x, v, vx, vh, graph, gravity=self.gravity,
                                 node_attr=node_attr)
        return x, vx.transpose(1, 2)
