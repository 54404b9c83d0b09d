"""FastTFN — the Fast* variant whose real <-> real coordinate update is a
one-layer TFN (counterpart of ``fastegnn_tpu/models/tfn/fast_tfn.py``;
reference ``models/FastTFN.py``).

FastEGNN's virtual-node machinery (``models/fastegnn_core.py``: the dense
virtual block with its Gram input, the virtual and node feature updates,
the gravity term) around ``OursTFN(num_layers=1, num_channels=1,
num_degrees=2)`` on (charges as type 0, velocity as type 1), whose type-1
output moves the positions (``FastTFN.py:30, 99-119, 225``).  There is no
velocity term and no real-edge coordinate gate; the real edges' messages
``m_e`` (the edge MLP on the gathered edge ends) feed the node update
through their dst mean.

The TFN reads the batch (``graph.coord``, ``graph.vel`` and the charges),
not the layer's positions, so its edge geometry and gathered inputs are
built once per forward and shared by the layers; the JAX model rebuilds
them in each layer, with the same numbers.  In the last layer the edge
MLP, its dst mean and the node and virtual feature updates feed only
features the model discards, so the last layer skips them (``features=
False``), as FastSchNet skips its dead CFConv.  On a CUDA batch each layer
launches the segment-sum kernel for the TFN's sum at src (``[E, 3]``)
and, outside the last layer, for the dst sum of ``m_e`` (``[E, 64]``)
forward and the backwards of the gathers of ``[h | x]`` at dst and src.

Outside ``tfn_layer`` the modules keep the reference's ``state_dict`` keys
(``gcl_i.edge_mlp``, ``edge_mlp_virtual``, ``coord_mlp_r_virtual``, ...,
``virtual_node_feat`` [1, H, C]); ``tfn_layer`` takes the JAX tree's
names (``utils/weights.py::state_dict_from_fasttfn_params``).  The
reference's unused ``W`` is dropped, as in the JAX package; ``normalize``
is taken and unused, as there.  The model computes in f32 only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.fastegnn_core import (
    LayerCfg, VirtualNodeModel, edge_features, gather_edge_ends, node_feature_update,
    node_gate, segment_mean_at_dst, virtual_block, virtual_feature_update)
from fastegnn_tpu_torch.models.nn import coord_mlp, mlp
from fastegnn_tpu_torch.models.tfn.models import OursTFN, TFNInputs, vec_from_sh, vec_to_sh
from fastegnn_tpu_torch.utils.profiling import span


class TFNGCLVel(nn.Module):
    """One FastTFN layer (reference ``TFN_GCL_vel``, ``FastTFN.py:8-234``)."""

    def __init__(self, hidden: int, virtual_channels: int, edge_attr_dim: int,
                 residual: bool = True, attention: bool = False, tanh: bool = False,
                 has_gravity: bool = False):
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
        self.node_mlp = mlp(2 * H + C * H, H, H)
        self.node_mlp_virtual = mlp(2 * H, H, H)
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
            self.att_mlp_virtual = nn.Sequential(nn.Linear(H, 1), nn.Sigmoid())
        self.tfn_layer = OursTFN(num_layers=1, num_channels=1)

    def forward(self, h, x, vx, vh, graph: GraphBatch, tfn_h, tfn_inputs: TFNInputs,
                gravity: Optional[torch.Tensor] = None, features: bool = True):
        """``(h, x, vx, vh)`` after the layer; with ``features=False`` the
        caller reads only ``x`` and ``vx``, and ``h`` and ``vh`` come back
        as ``None``."""
        cfg = self.cfg
        with span("layer.tfn"):
            tfn_out = self.tfn_layer(tfn_h, graph, tfn_inputs)
        x_new = x + vec_from_sh(tfn_out[1][:, 0, :])
        vb = virtual_block(cfg, self, h, x, vx, vh, graph.node_mask,
                           pool_messages=features)
        x_new = x_new - vb.pull
        if cfg.has_gravity:
            x_new = x_new + node_gate(self.gravity_mlp, h, cfg.compute_dtype) * gravity
        if not features:
            return None, x_new, vb.vx_new, None
        with span("layer.edges"):
            h_d, h_s, x_d, x_s = gather_edge_ends(graph, h, x)
            radial = ((x_d - x_s) ** 2).sum(-1, keepdim=True)
            m_e = edge_features(cfg, self, h_d, h_s, radial,
                                graph.edge_attr[:graph.n_real_edges])
            agg_e = segment_mean_at_dst(m_e, graph)
        with span("layer.update"):
            vh_new = virtual_feature_update(cfg, self, vh, vb.pool_mv)
            h_new = node_feature_update(cfg, self, h, agg_e, vb.m_v)
        return h_new, x_new, vb.vx_new, vh_new


class FastTFN(VirtualNodeModel):
    """Reference ``FastTFN`` (``FastTFN.py:237-288``).

    ``forward(graph) -> (coord_pred [N, 3], virtual_coord [B, 3, C])``.
    The charges are ``graph.node_attr``, or else the first node feature
    (the reference's train wiring, ``utils/train.py:60-62``).  With
    ``residual=False`` the feature updates replace the features, as in
    FastEGNN; no CLI sets it.  The JAX model has no ``use_node_attr``.
    """

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4, residual: bool = True,
                 attention: bool = False, normalize: bool = False, tanh: bool = False,
                 gravity: Optional[Sequence[float]] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(
            node_feat_dim, hidden, virtual_channels, n_layers, gravity,
            lambda: TFNGCLVel(hidden, virtual_channels, edge_attr_dim, residual=residual,
                              attention=attention, tanh=tanh, has_gravity=gravity is not None),
            device, generator)

    def forward(self, graph: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        h, vx, vh = self.embed(graph)
        x = graph.coord
        charges = graph.node_attr if graph.node_attr is not None else graph.node_feat[:, :1]
        tfn_h = {0: charges[..., None], 1: vec_to_sh(graph.vel)[:, None, :]}
        # the same for every layer: the TFN reads the batch, not the layer
        with span("tfn.inputs"):
            tfn_inputs = self.gcl_0.tfn_layer.inputs(tfn_h, graph)
        last = self.n_layers - 1
        for i, layer in enumerate(self.layers()):
            h, x, vx, vh = layer(h, x, vx, vh, graph, tfn_h, tfn_inputs, gravity=self.gravity,
                                 features=i < last)
        return x, vx.transpose(1, 2)
