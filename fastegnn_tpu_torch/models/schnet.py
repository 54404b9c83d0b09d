"""FastSchNet — the Fast* variant whose real-edge coordinate update is an
embedded one-interaction SchNet (counterpart of the FastSchNet part of
``fastegnn_tpu/models/schnet.py``; reference ``models/SchNet.py`` and
``models/FastSchNet.py``).

- :func:`shifted_softplus`, :func:`gaussian_smearing`, :class:`CFConv`,
  :class:`InteractionBlock` and :class:`SchNetCore`: PyG's SchNet adapted
  to return positions (``SchNet.py:187-193, 299-349``).  The CFConv filter
  is ``MLP(gauss) * cosine cutoff``; its messages ``lin1(h)[dst] * W`` sum
  at *src*, PyG's flow (``SchNet.py:299-332``), through
  ``ops/spmm.py::src_segment_sum_csr``.  Each interaction moves the
  positions by the dst mean of ``(pos_dst - pos_src) * Linear([gauss,
  h_dst, h_src])``.  The interaction linears are xavier-uniform with zero
  biases, ``lin1`` without a bias (``SchNet.py:282-289, 316-319``).
- :class:`SchNet` (``SchNet.py:119-195``): the standalone baseline, the
  interaction stack behind a ``Linear(node_feat_dim, H)`` embedding,
  returning positions.  As in the JAX package's default
  (``freeze_distances=True``, the reference's quirk) the Gaussians come
  from the input positions once (``SchNet.py:181-183``); the JAX option
  to recompute them per interaction, which no CLI sets, is not taken.
  The CLI's configuration is 16 interactions, 128 filters, 64 Gaussians,
  cutoff 1.0 (``main_nbody.py:129``).  The last interaction's feature
  update reaches no position and does not run.
- :class:`SchNetGCL` and :class:`FastSchNet` (``FastSchNet.py:18-284``):
  FastEGNN's virtual block, virtual / node feature updates and gravity
  term; the real <-> real coordinate update is the embedded SchNet (1
  interaction, cutoff 10, 50 Gaussians, 128 filters, no input embedding),
  whose feature output FastSchNet discards, so FastSchNet runs it with
  ``features=False`` and its CFConv does not run.  There is no velocity
  term.

Every sum over edges runs through the segment-sum kernel on a CUDA batch
(``ops/spmm.py``); the edge ends are gathered once per layer and shared by
the edge MLP and the embedded SchNet.  Only the real edges are read, since
padded edges carry the out-of-range sentinel ``dst == N``.

The reference's unused parameters are left out, as the JAX package leaves
them out (``schnet.py:20-25``, ``torch_import.py:184-189``): FastSchNet's
``coord_mlp_r``, ``coord_mlp_vel`` and ``W``, and the embedded SchNet's
output head ``lin1`` / ``lin2``.  The rest keep the reference's
``state_dict`` keys (``gcl_i.SchNetLayer.coord_updates.0``,
``gcl_i.SchNetLayer.interactions.0.conv.nn.{0,2}``, ...), so a port
``state_dict`` maps into JAX params through ``fastegnn_tpu/utils/
torch_import.py::params_from_fastschnet_state_dict`` and back through
:func:`fastegnn_tpu_torch.utils.weights.state_dict_from_fastschnet_params`.
The standalone SchNet keeps the reference's keys too (``embedding``,
``interactions.{i}``, ``coord_updates.{i}``; ``params_from_schnet_state_dict``
and :func:`fastegnn_tpu_torch.utils.weights.state_dict_from_schnet_params`).
As in the JAX package the models compute in f32 only.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.basic import placed
from fastegnn_tpu_torch.models.fastegnn_core import (
    LayerCfg, VirtualNodeModel, edge_features, gather_edge_ends, node_feature_update,
    node_gate, segment_mean_at_dst, virtual_block, virtual_feature_update)
from fastegnn_tpu_torch.models.nn import coord_mlp, mlp, xavier_linear
from fastegnn_tpu_torch.ops.spmm import gather_dst, src_segment_sum_csr

LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log 2`` as flax computes it, ``logaddexp(x, 0)``:
    torch's ``softplus`` returns ``x`` itself above 20."""
    return torch.logaddexp(x, torch.zeros_like(x)) - LOG2


class ShiftedSoftplus(nn.Module):
    def forward(self, x):
        return shifted_softplus(x)


def gaussian_smearing(dist: torch.Tensor, start: float, stop: float,
                      num_gaussians: int) -> torch.Tensor:
    """``exp(coeff (d - offset)^2)`` over ``num_gaussians`` f32 centres from
    ``start`` to ``stop``, with ``coeff = -0.5 / (offset[1] - offset[0])^2``
    taken from those centres (``SchNet.py:335-349``)."""
    offset = torch.linspace(start, stop, num_gaussians, dtype=torch.float32,
                            device=dist.device)
    coeff = -0.5 / (offset[1] - offset[0]) ** 2
    d = dist[..., None] - offset
    return torch.exp(coeff * d**2)


class CFConv(nn.Module):
    """Continuous-filter convolution (``SchNet.py:299-332``)."""

    def __init__(self, hidden: int, num_filters: int, num_gaussians: int, cutoff: float):
        super().__init__()
        self.cutoff = cutoff
        self.nn = nn.Sequential(xavier_linear(num_gaussians, num_filters), ShiftedSoftplus(),
                                xavier_linear(num_filters, num_filters))
        self.lin1 = xavier_linear(hidden, num_filters, bias=False)
        self.lin2 = xavier_linear(num_filters, hidden)

    def forward(self, h, gauss, edge_weight, graph: GraphBatch):
        ne = graph.n_real_edges
        cut = 0.5 * (torch.cos(edge_weight * math.pi / self.cutoff) + 1.0)
        W = self.nn(gauss) * cut[:, None]
        msg = gather_dst(self.lin1(h), graph.dst[:ne], graph.rowptr) * W
        agg = src_segment_sum_csr(msg, graph.src[:ne], graph.src_perm, graph.src_rowptr,
                                  h.shape[0])
        return self.lin2(agg)


class InteractionBlock(nn.Module):
    """``lin(ssp(CFConv(h)))`` (``SchNet.py:198-249``)."""

    def __init__(self, hidden: int, num_filters: int, num_gaussians: int, cutoff: float):
        super().__init__()
        self.conv = CFConv(hidden, num_filters, num_gaussians, cutoff)
        self.lin = xavier_linear(hidden, hidden)

    def forward(self, h, gauss, edge_weight, graph: GraphBatch):
        return self.lin(shifted_softplus(self.conv(h, gauss, edge_weight, graph)))


class SchNetCore(nn.Module):
    """The interaction stack on pre-embedded features; ``forward`` returns
    ``(pos, h)`` (the JAX ``SchNetCore`` with ``embed_input=False``,
    FastSchNet's embedded SchNet, ``FastSchNet.py:472``)."""

    def __init__(self, hidden: int = 64, num_filters: int = 128, num_interactions: int = 6,
                 num_gaussians: int = 50, cutoff: float = 10.0):
        super().__init__()
        self.num_gaussians, self.cutoff = num_gaussians, cutoff
        self.coord_updates = nn.ModuleList(
            nn.Linear(num_gaussians + 2 * hidden, 1) for _ in range(num_interactions))
        self.interactions = nn.ModuleList(
            InteractionBlock(hidden, num_filters, num_gaussians, cutoff)
            for _ in range(num_interactions))

    def forward(self, h, pos, graph: GraphBatch, edge_ends=None, features: bool = True):
        """``edge_ends``: the first interaction's ``gather_edge_ends(graph,
        h, pos)``, when the caller has it already.  With ``features=False``
        the caller reads only the positions: the last interaction's feature
        update, which no position depends on, is skipped and ``h`` comes
        back as ``None`` (the JAX step drops that work as dead code)."""
        last = len(self.interactions) - 1
        for i, (update, interaction) in enumerate(zip(self.coord_updates, self.interactions)):
            h_d, h_s, p_d, p_s = (edge_ends if i == 0 and edge_ends is not None
                                  else gather_edge_ends(graph, h, pos))
            diff = p_d - p_s
            edge_weight = diff.norm(dim=-1)
            gauss = gaussian_smearing(edge_weight, 0.0, self.cutoff, self.num_gaussians)
            gate = update(torch.cat([gauss, h_d, h_s], -1))
            pos = pos + segment_mean_at_dst(diff * gate, graph)
            if i == last and not features:
                return pos, None
            h = h + interaction(h, gauss, edge_weight, graph)
        return pos, h


class SchNet(SchNetCore):
    """The standalone SchNet (``SchNet.py:165-195``): ``forward(graph) ->
    positions [N, 3]``, every interaction on the Gaussians of the input
    positions.  ``edge_attr_dim`` is not read."""

    def __init__(self, node_feat_dim: int, edge_attr_dim: int = 0, hidden: int = 64,
                 num_filters: int = 128, num_interactions: int = 16, num_gaussians: int = 64,
                 cutoff: float = 1.0, device=None, generator: Optional[torch.Generator] = None):
        super().__init__(hidden, num_filters, num_interactions, num_gaussians, cutoff)
        self.embedding = nn.Linear(node_feat_dim, hidden)
        placed(self, device, generator)

    def forward(self, graph: GraphBatch) -> torch.Tensor:
        h, pos = self.embedding(graph.node_feat), graph.coord
        last = len(self.interactions) - 1
        for i, (update, interaction) in enumerate(zip(self.coord_updates, self.interactions)):
            h_d, h_s, p_d, p_s = gather_edge_ends(graph, h, pos)
            diff = p_d - p_s
            if i == 0:
                edge_weight = diff.norm(dim=-1)
                gauss = gaussian_smearing(edge_weight, 0.0, self.cutoff, self.num_gaussians)
            gate = update(torch.cat([gauss, h_d, h_s], -1))
            pos = pos + segment_mean_at_dst(diff * gate, graph)
            if i < last:   # the last feature update reaches no position
                h = h + interaction(h, gauss, edge_weight, graph)
        return pos


class SchNetGCL(nn.Module):
    """One FastSchNet layer (``FastSchNet.py:18-229``)."""

    def __init__(self, hidden: int, virtual_channels: int, edge_attr_dim: int,
                 node_attr_dim: int = 0, residual: bool = True, attention: bool = False,
                 tanh: bool = False, has_gravity: bool = False):
        super().__init__()
        H, C = hidden, virtual_channels
        self.cfg = LayerCfg(hidden=H, virtual_channels=C, residual=residual,
                            attention=attention, tanh=tanh, has_gravity=has_gravity)
        self.edge_mlp = mlp(2 * H + 1 + edge_attr_dim, H, H, act_final=True)
        self.edge_mlp_virtual = mlp(2 * H + 1 + C, H, H, act_final=True)
        self.coord_mlp_r_virtual = coord_mlp(H)
        self.coord_mlp_v_virtual = coord_mlp(H)
        if has_gravity:
            self.gravity_mlp = mlp(H, H, 1)
        self.node_mlp = mlp(2 * H + C * H + node_attr_dim, H, H)
        self.node_mlp_virtual = mlp(2 * H, H, H)
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
            self.att_mlp_virtual = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
        self.SchNetLayer = SchNetCore(H, num_filters=128, num_interactions=1,
                                      num_gaussians=50, cutoff=10.0)

    def forward(self, h, x, vx, vh, graph: GraphBatch, gravity: Optional[torch.Tensor] = None,
                node_attr: Optional[torch.Tensor] = None):
        """``(h, x, vx, vh)`` after the layer."""
        cfg = self.cfg
        ends = gather_edge_ends(graph, h, x)
        h_d, h_s, x_d, x_s = ends
        radial = ((x_d - x_s) ** 2).sum(-1, keepdim=True)
        m_e = edge_features(cfg, self, h_d, h_s, radial, graph.edge_attr[:graph.n_real_edges])
        x_new, _ = self.SchNetLayer(h, x, graph, edge_ends=ends, features=False)
        vb = virtual_block(cfg, self, h, x, vx, vh, graph.node_mask)
        x_new = x_new - vb.pull
        if cfg.has_gravity:
            x_new = x_new + node_gate(self.gravity_mlp, h, cfg.compute_dtype) * gravity
        vh_new = virtual_feature_update(cfg, self, vh, vb.pool_mv)
        h_new = node_feature_update(cfg, self, h, segment_mean_at_dst(m_e, graph), vb.m_v,
                                    node_attr)
        return h_new, x_new, vb.vx_new, vh_new


class FastSchNet(VirtualNodeModel):
    """Reference ``FastSchNet`` (``FastSchNet.py:232-284``).

    ``forward(graph) -> (coord_pred [N, 3], virtual_coord [B, 3, C])``.
    ``residual`` and ``node_attr_dim`` (the JAX ``use_node_attr``: the last
    ``node_attr_dim`` columns of ``node_mlp``'s input read
    ``graph.node_attr``) act as in FastEGNN; no CLI sets them.
    ``normalize`` is taken and unused, as in the JAX model.
    """

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4, residual: bool = True,
                 attention: bool = False, normalize: bool = False, tanh: bool = False,
                 gravity: Optional[Sequence[float]] = None, node_attr_dim: int = 0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(
            node_feat_dim, hidden, virtual_channels, n_layers, gravity,
            lambda: SchNetGCL(hidden, virtual_channels, edge_attr_dim,
                              node_attr_dim=node_attr_dim, residual=residual,
                              attention=attention, tanh=tanh, has_gravity=gravity is not None),
            device, generator)
        self.use_node_attr = node_attr_dim > 0

    def forward(self, graph: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        h, vx, vh = self.embed(graph)
        x = graph.coord
        node_attr = graph.node_attr if self.use_node_attr else None
        for layer in self.layers():
            h, x, vx, vh = layer(h, x, vx, vh, graph, gravity=self.gravity,
                                 node_attr=node_attr)
        return x, vx.transpose(1, 2)
