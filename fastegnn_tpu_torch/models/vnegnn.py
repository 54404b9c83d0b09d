"""VNEGNN — the virtual-node EGNN baseline (counterpart of
``fastegnn_tpu/models/vnegnn.py``; reference ``models/VNEGNN.py``).

Each layer runs three sub-cells in turn:

- ``A2A_i`` (:class:`EGCL_A2A`): an EGNN cell over the real edges
  (``VNEGNN.py:28-132``).  Its edge sums go through FastEGNN's dispatch
  (``models/fastegnn_core.py::real_edge_sums``, with the cell's
  ``coord_mlp`` as the gate head): the fused f32 edge block where the cell
  fits it, else the CSR branch (attention, normalize, tanh).  The node
  messages are *summed* (``:88``), the coordinate translations averaged
  (``:105``).
- ``A2V_i`` (:class:`EGCL_A2V`): dense real -> virtual messages on ``[h,
  vh, vrad]`` (no Gram block, unlike FastEGNN's), pooled per graph into the
  virtual features and positions (``:136-226``).
- ``V2A_i`` (:class:`EGCL_V2A`): the same messages move the real positions
  and, through their *mean over channels* (``:297``, not FastEGNN's
  flatten), update the real features (``:229-320``).

The virtual positions start at ``graph.virtual_fibonacci`` (the protein
dataset's Fibonacci sphere) when the batch has them, else at
``graph.loc_mean``.  With ``residual=False`` each cell's feature update
replaces the features instead of adding to them
(``fastegnn_tpu/models/vnegnn.py:86, 116, 141``).  ``node_attr_dim > 0`` (the JAX ``use_node_attr``) feeds
``graph.node_attr`` to the ``node_mlp`` of A2A and V2A, as the last
``node_attr_dim`` columns of its input.  No CLI sets either.  VNEGNN
trains on the MSE alone (it is not in ``MMD_MODELS``).  Modules keep the
reference's ``state_dict`` keys, so weights cross to the JAX package
through ``fastegnn_tpu/utils/torch_import.py::params_from_vnegnn_state_dict``
and back through
:func:`fastegnn_tpu_torch.utils.weights.state_dict_from_vnegnn_params`.
The model computes in f32 only.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn.functional import silu

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.fastegnn_core import (
    LayerCfg, VirtualNodeModel, fits_fused, gate_head, per_graph_pool, per_graph_take,
    real_edge_sums)
from fastegnn_tpu_torch.models.nn import coord_mlp, mlp


def _cell(module: nn.Module, hidden: int, edge_in: int, attention: bool,
          node_attr_dim: int = 0) -> None:
    """The three heads every cell has (``edge_mlp``, ``coord_mlp``,
    ``node_mlp`` on ``[features, messages (, node_attr)]``), and ``att_mlp``
    with attention."""
    H = hidden
    module.edge_mlp = mlp(edge_in, H, H, act_final=True)
    module.coord_mlp = coord_mlp(H)
    module.node_mlp = mlp(2 * H + node_attr_dim, H, H)
    if attention:
        module.att_mlp = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())


def dense_messages(cell, h, x, vh, vx):
    """``(m [n, C, H], vdiff [n, C, 3], gate [n, C])``: the real <-> virtual
    messages of A2V and V2A (the JAX ``_dense_messages``), their attention
    and their coordinate gate.  The edge MLP's first layer is split over
    ``[h | vh | vrad]``, its per-graph part computed at ``[B, C, H]`` and
    broadcast to the nodes."""
    cfg = cell.cfg
    n, H = h.shape
    vdiff = per_graph_take(vx, n) - x[:, None, :]                    # [n, C, 3]
    vrad = (vdiff * vdiff).sum(-1).sqrt()                             # [n, C]
    e0 = cell.edge_mlp[0]
    W0 = e0.weight                                                    # [H, 2H+1]
    zb = vh @ W0[:, H:2 * H].T + e0.bias                              # [B, C, H]
    z1 = (h @ W0[:, :H].T)[:, None, :] + vrad[..., None] * W0[:, 2 * H] + per_graph_take(zb, n)
    m = silu(cell.edge_mlp[2](silu(z1)))
    if cfg.attention:
        m = m * cell.att_mlp(m)
    gate = gate_head(cell.coord_mlp, m)[..., 0]
    if cfg.tanh:
        gate = torch.tanh(gate)
    return m, vdiff, gate


def feature_update(cell, h, messages, node_attr=None):
    """``h`` after the cell's ``node_mlp`` on ``[h, messages (, node_attr)]``:
    added to ``h``, or in its place without ``residual``."""
    parts = [h, messages] if node_attr is None else [h, messages, node_attr]
    dh = gate_head(cell.node_mlp, torch.cat(parts, -1))
    return h + dh if cell.cfg.residual else dh


class EGCL_A2A(nn.Module):
    """Real -> real cell (``VNEGNN.py:28-132``)."""

    def __init__(self, hidden: int, virtual_channels: int, edge_attr_dim: int,
                 node_attr_dim: int = 0, residual: bool = True, attention: bool = False,
                 normalize: bool = False, tanh: bool = False):
        super().__init__()
        self.cfg = LayerCfg(hidden=hidden, virtual_channels=virtual_channels,
                            residual=residual, attention=attention, normalize=normalize,
                            tanh=tanh)
        _cell(self, hidden, 2 * hidden + 1 + edge_attr_dim, attention, node_attr_dim)
        self.fused = fits_fused(self.cfg, edge_attr_dim)

    def forward(self, h, x, graph: GraphBatch, node_attr=None):
        m_sum, trans_sum = real_edge_sums(self, h, x, graph, self.coord_mlp)
        x = x + trans_sum / graph.dst_count.clamp_min(1.0)[:, None]
        return feature_update(self, h, m_sum, node_attr), x


class EGCL_A2V(nn.Module):
    """Real -> virtual cell (``VNEGNN.py:136-226``)."""

    def __init__(self, hidden: int, virtual_channels: int, residual: bool = True,
                 attention: bool = False, tanh: bool = False):
        super().__init__()
        self.cfg = LayerCfg(hidden=hidden, virtual_channels=virtual_channels,
                            residual=residual, attention=attention, tanh=tanh)
        _cell(self, hidden, 2 * hidden + 1, attention)

    def forward(self, h, x, vh, vx, graph: GraphBatch):
        """``(vh [B, C, H], vx [B, C, 3])`` after the cell."""
        m, vdiff, gate = dense_messages(self, h, x, vh, vx)
        n, C, H = m.shape
        B = vx.shape[0]

        def pool(z):
            return per_graph_pool(z, graph.node_mask, B)

        vx = vx + pool((vdiff * gate[..., None]).reshape(n, C * 3)).reshape(B, C, 3)
        pool_m = pool(m.reshape(n, C * H)).reshape(B, C, H)
        return feature_update(self, vh, pool_m), vx


class EGCL_V2A(nn.Module):
    """Virtual -> real cell (``VNEGNN.py:229-320``)."""

    def __init__(self, hidden: int, virtual_channels: int, node_attr_dim: int = 0,
                 residual: bool = True, attention: bool = False, tanh: bool = False):
        super().__init__()
        self.cfg = LayerCfg(hidden=hidden, virtual_channels=virtual_channels,
                            residual=residual, attention=attention, tanh=tanh)
        _cell(self, hidden, 2 * hidden + 1, attention, node_attr_dim)

    def forward(self, vh, vx, h, x, graph: GraphBatch, node_attr=None):
        """``(h [N, H], x [N, 3])`` after the cell."""
        m, vdiff, gate = dense_messages(self, h, x, vh, vx)
        x = x - (vdiff * gate[..., None]).sum(1) / m.shape[1]
        return feature_update(self, h, m.mean(1), node_attr), x


class VNEGNN(VirtualNodeModel):
    """Reference ``VNEGNN`` (its sub-cells ``VNEGNN.py:337-342``).

    ``forward(graph) -> (coord_pred [N, 3], virtual_coord [B, 3, C])``.
    """

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4, residual: bool = True,
                 attention: bool = False, normalize: bool = False, tanh: bool = False,
                 node_attr_dim: int = 0, device=None, generator=None):
        H, C, Fa = hidden, virtual_channels, node_attr_dim
        super().__init__(
            node_feat_dim, H, C, n_layers, None,
            lambda: {"A2A": EGCL_A2A(H, C, edge_attr_dim, Fa, residual, attention, normalize,
                                     tanh),
                     "A2V": EGCL_A2V(H, C, residual, attention, tanh),
                     "V2A": EGCL_V2A(H, C, Fa, residual, attention, tanh)},
            device, generator)
        self.use_node_attr = node_attr_dim > 0

    def forward(self, graph: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        h, vx, vh = self.embed(graph)
        if graph.virtual_fibonacci is not None:
            vx = graph.virtual_fibonacci.transpose(1, 2)
        x = graph.coord
        node_attr = graph.node_attr if self.use_node_attr else None
        for i in range(self.n_layers):
            h, x = getattr(self, f"A2A_{i}")(h, x, graph, node_attr)
            vh, vx = getattr(self, f"A2V_{i}")(h, x, vh, vx, graph)
            h, x = getattr(self, f"V2A_{i}")(vh, vx, h, x, graph, node_attr)
        return x, vx.transpose(1, 2)
