"""FastRF — the Fast* variant with a Radial-Field real-node update
(counterpart of ``fastegnn_tpu/models/fast_rf.py``; reference
``models/FastRF.py``).

FastEGNN's virtual-node machinery (``models/fastegnn_core.py::
virtual_block``), with two differences (``FastRF.py:128,167,186``):

- the velocity term is gated by ``phi_v(||v||)``, a ``Linear(1, H), SiLU,
  Linear(H, 1)`` on the velocity norm with its gradient stopped, not by
  ``phi_v(h)``;
- there is no node or virtual feature update: ``h`` and ``vh`` pass
  through every layer unchanged, so the layer has no ``node_mlp`` and no
  ``node_mlp_virtual``.

The real edges go through FastEGNN's dispatch
(``models/fastegnn_core.py::real_edge_sums``): the fused edge block in f32
where the layer fits it, whose ``m_sum`` FastRF does not use, else the CSR
branch.  Modules keep the reference's ``state_dict`` keys, so a port
``state_dict`` maps into JAX params through
``fastegnn_tpu/utils/torch_import.py::params_from_fastrf_state_dict`` and
back through :func:`fastegnn_tpu_torch.utils.weights.state_dict_from_fastrf_params`.
As in the JAX package the model computes in f32 only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.fastegnn_core import (
    LayerCfg, VirtualNodeModel, fits_fused, node_gate, real_edge_sums, virtual_block)
from fastegnn_tpu_torch.models.nn import coord_mlp, mlp


class RFGCLVel(nn.Module):
    """One FastRF layer (reference ``FastRF.py:8-186``)."""

    def __init__(self, hidden: int, virtual_channels: int, edge_attr_dim: int,
                 attention: bool = False, normalize: bool = False, tanh: bool = False,
                 has_gravity: bool = False):
        super().__init__()
        H, C = hidden, virtual_channels
        self.cfg = LayerCfg(hidden=H, virtual_channels=C, attention=attention,
                            normalize=normalize, tanh=tanh, has_gravity=has_gravity)
        self.edge_mlp = mlp(2 * H + 1 + edge_attr_dim, H, H, act_final=True)
        self.edge_mlp_virtual = mlp(2 * H + 1 + C, H, H, act_final=True)
        self.coord_mlp_r = coord_mlp(H)
        self.coord_mlp_r_virtual = coord_mlp(H)
        self.coord_mlp_v_virtual = coord_mlp(H)
        self.coord_mlp_vel = mlp(1, H, 1)
        if has_gravity:
            self.gravity_mlp = mlp(H, H, 1)
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
            self.att_mlp_virtual = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
        self.fused = fits_fused(self.cfg, edge_attr_dim)

    def forward(self, h, x, v, v_norm, vx, vh, graph: GraphBatch,
                gravity: Optional[torch.Tensor] = None):
        """``(x [N, 3], vx [B, C, 3])``; ``h`` and ``vh`` are unchanged."""
        cfg = self.cfg
        _, trans_sum = real_edge_sums(self, h, x, graph)
        vb = virtual_block(cfg, self, h, x, vx, vh, graph.node_mask,
                           pool_messages=False)
        x_new = x + trans_sum / graph.dst_count.clamp_min(1.0)[:, None]
        x_new = x_new - vb.pull
        x_new = x_new + node_gate(self.coord_mlp_vel, v_norm, cfg.compute_dtype) * v
        if cfg.has_gravity:
            x_new = x_new + node_gate(self.gravity_mlp, h, cfg.compute_dtype) * gravity
        return x_new, vb.vx_new


class FastRF(VirtualNodeModel):
    """Reference ``FastRF`` (``FastRF.py:189-239``).

    ``forward(graph) -> (coord_pred [N, 3], virtual_coord [B, 3, C])``.
    """

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4, attention: bool = False,
                 normalize: bool = False, tanh: bool = False,
                 gravity: Optional[Sequence[float]] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(
            node_feat_dim, hidden, virtual_channels, n_layers, gravity,
            lambda: RFGCLVel(hidden, virtual_channels, edge_attr_dim, attention=attention,
                             normalize=normalize, tanh=tanh, has_gravity=gravity is not None),
            device, generator)

    def forward(self, graph: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        h, vx, vh = self.embed(graph)
        x, v = graph.coord, graph.vel
        v_norm = v.norm(dim=-1, keepdim=True).detach()
        for layer in self.layers():
            x, vx = layer(h, x, v, v_norm, vx, vh, graph, gravity=self.gravity)
        return x, vx.transpose(1, 2)
