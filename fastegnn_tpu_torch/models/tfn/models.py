"""TFN / SE(3)-Transformer models and the dynamics adapter (counterpart of
``fastegnn_tpu/models/tfn/models.py``; reference ``se3_dynamics/models.py``
and ``dynamics.py``).

Type-1 features are plain (x, y, z) vectors at the model boundary and are
permuted to the real-SH (y, z, x) order inside (``so3.py``): an orthogonal
change of basis, so the models stay exactly SE(3)-equivariant.  The edge
geometry reads the batch's positions ``graph.coord``, as the JAX models
do, so a caller that runs several TFNs on one batch builds it once
(:meth:`OursTFN.inputs`; FastTFN's layers share it).

``OurDynamics`` is the CLIs' ``--model TFN`` (``nf=32``, ``num_degrees=2``,
``div=1``, ``n_layers = --num_layer``); ``TFN`` and ``SE3Transformer`` are
the scalar-output models with per-graph max and mean pooling, which no CLI
trains.  The modules keep the JAX tree's names (``se3.conv_{i}``,
``se3.norm_{i}``, ``se3.res_{i}``, ``se3.conv_out``, ``se3.scalar_trick``,
``fc0``, ``fc1``; ``utils/weights.py::state_dict_from_ourdynamics_params``):
the reference's DGL layout is not in this repository.  The models compute
in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.basic import placed
from fastegnn_tpu_torch.models.tfn.layers import (
    Fiber, GConvSE3, GNormSE3, GSE3Res, compute_basis, gather_ends)
from fastegnn_tpu_torch.ops.segment import graph_mean_pool

_TO_SH = (1, 2, 0)    # (x,y,z) -> (y,z,x)
_FROM_SH = (2, 0, 1)  # inverse


def vec_to_sh(v: torch.Tensor) -> torch.Tensor:
    return v[..., _TO_SH]


def vec_from_sh(v: torch.Tensor) -> torch.Tensor:
    return v[..., _FROM_SH]


def edge_geometry(graph: GraphBatch, max_degree: int):
    """``(r [E, 1], basis)`` over the real edges: the relative vectors
    ``coord[src] - coord[dst]`` (reference ``dynamics.py:93``), their
    lengths and the kernel basis (``layers.py::compute_basis``, which takes
    the raw cartesian vectors)."""
    ne = graph.n_real_edges
    d = graph.coord[graph.src[:ne].long()] - graph.coord[graph.dst[:ne].long()]
    return d.norm(dim=-1, keepdim=True), compute_basis(d, max_degree)


@dataclass
class TFNInputs:
    """What a TFN over one batch and one input needs beside its weights:
    the edge lengths, the kernel basis and the input gathered at the edge
    ends (``layers.py::gather_ends``)."""

    r: torch.Tensor
    basis: Dict[Tuple[int, int], torch.Tensor]
    ends: dict


class OursTFN(nn.Module):
    """TFN over (type-0 charges, type-1 velocity) -> ``out_types``
    (reference ``models.py:79-152``): ``num_layers - 1`` convolutions
    ``conv_{i}`` to ``num_channels`` channels of each of ``num_degrees``
    degrees, each followed by ``norm_{i}`` (``GNormSE3`` with
    ``num_nlayers``), then ``conv_out``; all with self-interaction.
    FastTFN embeds ``OursTFN(num_layers=1, num_channels=1)``."""

    def __init__(self, num_layers: int, num_channels: int, num_nlayers: int = 1,
                 num_degrees: int = 2, edge_dim: int = 0, in_types=((1, 0), (1, 1)),
                 out_types=((1, 1),)):
        super().__init__()
        self.num_layers, self.max_degree = num_layers, num_degrees - 1
        mid, fin = Fiber(num_degrees, num_channels).structure, in_types
        for i in range(num_layers - 1):
            self.add_module(f"conv_{i}", GConvSE3(fin, mid, self_interaction=True,
                                                  edge_dim=edge_dim))
            self.add_module(f"norm_{i}", GNormSE3(mid, num_layers=num_nlayers))
            fin = mid
        self.conv_out = GConvSE3(fin, out_types, self_interaction=True, edge_dim=edge_dim)

    def inputs(self, h, graph: GraphBatch) -> TFNInputs:
        r, basis = edge_geometry(graph, self.max_degree)
        return TFNInputs(r=r, basis=basis, ends=gather_ends(h, graph))

    def forward(self, h, graph: GraphBatch, inputs: Optional[TFNInputs] = None):
        """``{d: [N, m, 2d+1]}`` for the input ``h``; ``inputs`` are
        :meth:`inputs` of ``h`` and ``graph`` when the caller has them."""
        if inputs is None:
            inputs = self.inputs(h, graph)
        ends = inputs.ends
        for i in range(self.num_layers - 1):
            h = getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(
                h, graph, inputs.r, inputs.basis, ends))
            ends = None
        return self.conv_out(h, graph, inputs.r, inputs.basis, ends)


class OurSE3Transformer(nn.Module):
    """SE(3)-Transformer (reference ``models.py:207-295``): ``num_layers``
    attention blocks ``res_{i}`` (``GSE3Res``), each followed by
    ``norm_{i}`` (``GNormSE3`` without linears), then ``conv_out``, and the
    reference's output scale ``scalar_trick`` (starting at 0.01; the
    pooled model has none).

    The JAX ``GSE3Res`` returns the attention's widths, ``num_channels //
    div`` per degree, and the layers after it are built for
    ``num_channels`` (ROADMAP.md §3, reference defect 10): its norm's
    LayerNorms take their width from their input, and its einsums broadcast
    a width of 1 over the channels the next layer's weights have (any other
    width fails).  The port builds each norm at the attention's widths and
    broadcasts the same way, so at ``div = 1`` (the CLIs' configuration)
    nothing changes and at ``num_channels // div = 1`` it computes what the
    JAX model computes."""

    def __init__(self, num_layers: int, num_channels: int, num_degrees: int = 2,
                 edge_dim: int = 0, div: float = 1, n_heads: int = 1,
                 in_types=((1, 0), (1, 1)), out_types=((1, 1),), scalar_trick: bool = True):
        super().__init__()
        self.num_layers, self.max_degree = num_layers, num_degrees - 1
        self.mid = mid = Fiber(num_degrees, num_channels).structure
        fin = in_types
        for i in range(num_layers):
            res = GSE3Res(fin, mid, edge_dim=edge_dim, div=div, n_heads=n_heads)
            self.add_module(f"res_{i}", res)
            self.add_module(f"norm_{i}", GNormSE3(res.attn.f_value.structure))
            fin = mid
        self.conv_out = GConvSE3(fin, out_types, self_interaction=True, edge_dim=edge_dim)
        if scalar_trick:
            self.scalar_trick = nn.Parameter(torch.full((1,), 0.01))

    def forward(self, h, graph: GraphBatch):
        r, basis = edge_geometry(graph, self.max_degree)
        for i in range(self.num_layers):
            h = getattr(self, f"norm_{i}")(getattr(self, f"res_{i}")(h, graph, r, basis))
            h = {d: h[d].expand(-1, m, -1) for m, d in self.mid}
        h = self.conv_out(h, graph, r, basis)
        if not hasattr(self, "scalar_trick"):
            return h
        return {k: v * self.scalar_trick for k, v in h.items()}


class TFN(OursTFN):
    """Scalar-output TFN (reference ``models.py:15-77``): ``forward(
    node_feat [N, atom_feature_size], graph) -> [B, out_dim]``, the layers
    of :class:`OursTFN` from the node features as type 0 to ``num_channels
    * num_degrees`` scalars, their per-graph max over the real nodes, then
    ``fc0`` (ReLU) and ``fc1``."""

    def __init__(self, num_layers: int, atom_feature_size: int, num_channels: int,
                 num_nlayers: int = 1, num_degrees: int = 4, edge_dim: int = 0,
                 out_dim: int = 1, device=None, generator: Optional[torch.Generator] = None):
        width = num_channels * num_degrees
        super().__init__(num_layers, num_channels, num_nlayers, num_degrees, edge_dim,
                         in_types=((atom_feature_size, 0),), out_types=((width, 0),))
        self.fc0, self.fc1 = nn.Linear(width, width), nn.Linear(width, out_dim)
        placed(self, device, generator)

    def forward(self, node_feat: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        scalars = super().forward({0: node_feat[..., None]}, graph)[0][..., -1]   # [N, C]
        masked = torch.where(graph.node_mask[:, None], scalars,
                             torch.finfo(scalars.dtype).min)
        ids = graph.graph_id.long()[:, None].expand_as(masked)
        pooled = masked.new_zeros((graph.n_graphs + 1, masked.shape[1])).scatter_reduce(
            0, ids, masked, "amax", include_self=False)[:graph.n_graphs]
        return self.fc1(torch.relu(self.fc0(pooled)))


class SE3Transformer(OurSE3Transformer):
    """Scalar-output SE(3)-Transformer (reference ``models.py:144-205``):
    the layers of :class:`OurSE3Transformer` (without the output scale)
    from the node features as type 0, their per-graph mean over the real
    nodes, then ``fc0`` (ReLU) and ``fc1``."""

    def __init__(self, num_layers: int, atom_feature_size: int, num_channels: int,
                 num_degrees: int = 4, edge_dim: int = 0, div: float = 4, n_heads: int = 1,
                 out_dim: int = 1, device=None, generator: Optional[torch.Generator] = None):
        width = num_channels * num_degrees
        super().__init__(num_layers, num_channels, num_degrees, edge_dim, div, n_heads,
                         in_types=((atom_feature_size, 0),), out_types=((width, 0),),
                         scalar_trick=False)
        self.fc0, self.fc1 = nn.Linear(width, width), nn.Linear(width, out_dim)
        placed(self, device, generator)

    def forward(self, node_feat: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        scalars = super().forward({0: node_feat[..., None]}, graph)[0][..., -1]
        pooled = graph_mean_pool(scalars, graph.graph_id, graph.n_graphs, graph.node_mask)
        return self.fc1(torch.relu(self.fc0(pooled)))


class OurDynamics(nn.Module):
    """The CLIs' ``--model TFN`` (reference ``dynamics.py:10-107``):
    ``forward(graph) -> coords [N, 3]``, the type-1 output of ``se3``
    (:class:`OursTFN` for ``model="tfn"``, :class:`OurSE3Transformer` for
    ``"se3_transformer"``, at ``nf`` channels, ``n_layers`` layers and
    ``num_degrees`` degrees) on (charges as type 0, velocity as type 1),
    plus the positions.  The charges are ``graph.node_attr``, or else the
    first node feature.  ``node_feat_dim`` and ``edge_attr_dim`` are taken
    and not read (no edge features, as in the JAX model)."""

    def __init__(self, node_feat_dim: int = 0, edge_attr_dim: int = 0, nf: int = 32,
                 n_layers: int = 4, model: str = "tfn", num_degrees: int = 2, div: float = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if model == "tfn":
            self.se3 = OursTFN(num_layers=n_layers, num_channels=nf, num_degrees=num_degrees)
        elif model == "se3_transformer":
            self.se3 = OurSE3Transformer(num_layers=n_layers, num_channels=nf,
                                         num_degrees=num_degrees, div=div)
        else:
            raise ValueError(f"wrong model {model!r}")
        placed(self, device, generator)

    def forward(self, graph: GraphBatch) -> torch.Tensor:
        charges = graph.node_attr if graph.node_attr is not None else graph.node_feat[:, :1]
        h = {0: charges[..., None], 1: vec_to_sh(graph.vel)[:, None, :]}
        return vec_from_sh(self.se3(h, graph)[1][:, 0, :]) + graph.coord
