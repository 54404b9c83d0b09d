"""Geometric Vector Perceptron GNN (counterpart of ``fastegnn_tpu/models/gvp.py``;
reference ``models/GVP.py``, drorlab/gvp-pytorch style).

Features are ``(s [.., S], V [.., Vc, 3])`` tuples:

- :func:`norm_no_nan`: the vector norm with the clamp inside the square
  root, ``sqrt(max(sum x^2, 1e-8))``;
- :class:`GVPCell` (``GVP.py:89-153``): the vector channels mixed by a
  bias-free linear over the channel axis (``wh``), their norms joining the
  scalar path (``ws``), the output vectors from a second bias-free linear
  (``wv``), gated by the sigmoid of their norms.  The JAX cell's vector
  gate (``wsv``) and its cases without input or output vectors, which
  ``GVPNet`` never builds, are not ported;
- :class:`TupleLayerNorm` (``GVP.py:199-220``): torch's LayerNorm (eps
  1e-5) on the scalars, the vectors divided by their channels' RMS norm;
- :class:`TupleDropout` (``GVP.py:155-197``): scalar dropout and
  whole-vector-channel dropout, on only where ``forward`` is given
  ``train=True``;
- :class:`GVPConvolution` (``GVP.py:222-286``): messages
  ``GVP^n([s_dst, e_s, s_src], [V_dst, e_V, V_src])`` averaged at **src**,
  PyG's target;
- :class:`GVPConvBlock` (``GVP.py:289-384``) and :class:`GVPNet`
  (``GVP.py:388-456``): the node tuple ``(node_feat, [coord, vel])``, the
  edge tuple ``(edge_attr, [coord_dst - coord_src])``; ``forward(graph)``
  returns ``(coord_pred, (s, V))``, the prediction being the first output
  vector channel.  The CLI's configuration is node ``(100, 16)``, edge
  ``(32, 4)``, 3 message and 2 feed-forward GVPs per layer.

**Dropout stays off in training.**  The JAX CLI calls the model with its
default ``train=False`` (``fastegnn_tpu/train/step.py:69-70``), so GVP trains
without dropout there; the port's ``forward`` takes the same ``train``
argument and ignores ``nn.Module.train()`` (ROADMAP.md §3, a known
difference from the reference, which drops out in train mode).

Each layer gathers ``[s | V]`` (width ``S + 3 Vc``, 148 at the CLI's
configuration) once at dst and once at src over the real edges, whose
backwards are the segment-sum kernel over the dst and the src-sorted CSRs,
and sums ``[s | V]`` of the messages at src in one launch of the kernel
through ``src_perm``, divided by the real edges at each src clamped at 1 (the
JAX package's two masked means).  Padded edges are not read.

The modules keep the reference's ``state_dict`` keys (``W_v.0.scalar_norm``,
``W_v.1.wh``, ``layers.{i}.conv.message_func.{j}.ws``, ``layers.{i}.norm.1``,
``layers.{i}.ff_func.{j}``, ``W_out.1.wv``, ...), so a port ``state_dict``
maps into JAX params through ``fastegnn_tpu/utils/torch_import.py::
params_from_gvpnet_state_dict`` and back through
:func:`fastegnn_tpu_torch.utils.weights.state_dict_from_gvpnet_params`.
The reference's ``dense`` head, which ``forward`` never calls, is not
ported.  The model computes in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.basic import placed
from fastegnn_tpu_torch.models.fastegnn_core import gather_edge_ends
from fastegnn_tpu_torch.ops.spmm import src_segment_sum_csr

TupleSV = Tuple[torch.Tensor, torch.Tensor]


def norm_no_nan(x: torch.Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-8,
                sqrt: bool = True) -> torch.Tensor:
    """``sqrt(max(sum(x^2), eps))`` over ``dim`` (without the root where
    ``sqrt`` is false)."""
    out = (x * x).sum(dim, keepdim=keepdim).clamp_min(eps)
    return out.sqrt() if sqrt else out


class GVPCell(nn.Module):
    """One geometric vector perceptron ``(si, vi) -> (so, vo)``, with ReLU on
    the scalars and the norm gate on the vectors where ``activations``."""

    def __init__(self, in_dims: Tuple[int, int], out_dims: Tuple[int, int],
                 activations: bool = True):
        super().__init__()
        (si, vi), (so, vo) = in_dims, out_dims
        h = max(vi, vo)
        self.activations = activations
        self.wh = nn.Linear(vi, h, bias=False)
        self.ws = nn.Linear(si + h, so)
        self.wv = nn.Linear(h, vo, bias=False)

    def forward(self, x: TupleSV) -> TupleSV:
        s, v = x
        vh = self.wh(v.transpose(-1, -2))                         # [.., 3, h]
        s = self.ws(torch.cat([s, norm_no_nan(vh, dim=-2)], -1))
        v = self.wv(vh).transpose(-1, -2)                         # [.., vo, 3]
        if self.activations:
            s = torch.relu(s)
            v = v * torch.sigmoid(norm_no_nan(v, keepdim=True))
        return s, v


class TupleLayerNorm(nn.Module):
    """LayerNorm on the scalars; the vectors divided by the RMS of their
    channels' norms."""

    def __init__(self, scalar_dim: int):
        super().__init__()
        self.scalar_norm = nn.LayerNorm(scalar_dim, eps=1e-5)

    def forward(self, x: TupleSV) -> TupleSV:
        s, v = x
        vn = norm_no_nan(v, keepdim=True, sqrt=False).mean(-2, keepdim=True).sqrt()
        return self.scalar_norm(s), v / vn


class TupleDropout(nn.Module):
    """Scalar dropout and whole-vector-channel dropout, where ``train``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: TupleSV, train: bool = False) -> TupleSV:
        s, v = x
        if not train or self.rate == 0.0:
            return s, v
        keep = 1.0 - self.rate
        s = s * torch.bernoulli(torch.full_like(s, keep)) / keep
        v = v * torch.bernoulli(v.new_full(v.shape[:-1], keep))[..., None] / keep
        return s, v


def gvp_stack(dims: Sequence[Tuple[int, int]]) -> nn.ModuleList:
    """A chain of GVPCells through ``dims`` (the first entry the input);
    the last has no activations."""
    n = len(dims) - 1
    return nn.ModuleList(GVPCell(dims[i], dims[i + 1], activations=i < n - 1)
                         for i in range(n))


def run_stack(stack: nn.ModuleList, x: TupleSV) -> TupleSV:
    for cell in stack:
        x = cell(x)
    return x


class GVPConvolution(nn.Module):
    """Messages from ``[s_dst, e_s, s_src]`` / ``[V_dst, e_V, V_src]``
    through ``n_layers`` GVPs, averaged at src."""

    def __init__(self, node_dims: Tuple[int, int], edge_dims: Tuple[int, int],
                 n_layers: int = 3):
        super().__init__()
        (ns, nv), (es, ev) = node_dims, edge_dims
        self.message_func = gvp_stack([(2 * ns + es, 2 * nv + ev)] + [node_dims] * n_layers)

    def forward(self, x: TupleSV, edge: TupleSV, graph: GraphBatch) -> TupleSV:
        s, v = x
        n, S, V = s.shape[0], s.shape[1], v.shape[1]
        ne = graph.n_real_edges
        s_d, s_s, v_d, v_s = gather_edge_ends(graph, s, v.reshape(n, 3 * V))
        ms = torch.cat([s_d, edge[0], s_s], -1)
        mv = torch.cat([v_d.reshape(ne, V, 3), edge[1], v_s.reshape(ne, V, 3)], -2)
        out_s, out_v = run_stack(self.message_func, (ms, mv))
        total = src_segment_sum_csr(torch.cat([out_s, out_v.reshape(ne, 3 * V)], -1),
                                    graph.src[:ne], graph.src_perm, graph.src_rowptr, n)
        mean = total / (graph.src_rowptr[1:] - graph.src_rowptr[:-1]).clamp_min(1)[:, None]
        return mean[:, :S], mean[:, S:].reshape(n, V, 3)


class GVPConvBlock(nn.Module):
    """Residual convolution and feed-forward, each followed by dropout and a
    tuple LayerNorm."""

    def __init__(self, node_dims: Tuple[int, int], edge_dims: Tuple[int, int],
                 n_message: int = 3, n_feedforward: int = 2, drop_rate: float = 0.1):
        super().__init__()
        ns, nv = node_dims
        self.conv = GVPConvolution(node_dims, edge_dims, n_message)
        self.norm = nn.ModuleList(TupleLayerNorm(ns) for _ in range(2))
        self.dropout = nn.ModuleList(TupleDropout(drop_rate) for _ in range(2))
        hid = (4 * ns, 2 * nv)
        self.ff_func = gvp_stack([node_dims] + (
            [node_dims] if n_feedforward == 1 else [hid] * (n_feedforward - 1) + [node_dims]))

    def forward(self, x: TupleSV, edge: TupleSV, graph: GraphBatch,
                train: bool = False) -> TupleSV:
        dh = self.dropout[0](self.conv(x, edge, graph), train)
        x = self.norm[0]((x[0] + dh[0], x[1] + dh[1]))
        dh = self.dropout[1](run_stack(self.ff_func, x), train)
        return self.norm[1]((x[0] + dh[0], x[1] + dh[1]))


class GVPNet(nn.Module):
    """``forward(graph, train=False) -> (coord_pred [N, 3], (s, V))``."""

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, n_layers: int = 4,
                 node_h_dim: Tuple[int, int] = (100, 16), edge_h_dim: Tuple[int, int] = (32, 4),
                 drop_rate: float = 0.1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        node_h_dim, edge_h_dim = tuple(node_h_dim), tuple(edge_h_dim)
        self.W_v = nn.ModuleList([TupleLayerNorm(node_feat_dim),
                                  GVPCell((node_feat_dim, 2), node_h_dim, activations=False)])
        self.W_e = nn.ModuleList([TupleLayerNorm(edge_attr_dim),
                                  GVPCell((edge_attr_dim, 1), edge_h_dim, activations=False)])
        self.layers = nn.ModuleList(GVPConvBlock(node_h_dim, edge_h_dim, drop_rate=drop_rate)
                                    for _ in range(n_layers))
        self.W_out = nn.ModuleList([TupleLayerNorm(node_h_dim[0]),
                                    GVPCell(node_h_dim, node_h_dim)])
        placed(self, device, generator)

    def forward(self, graph: GraphBatch, train: bool = False):
        ne = graph.n_real_edges
        pos = graph.coord
        hv = run_stack(self.W_v, (graph.node_feat, torch.stack([pos, graph.vel], -2)))
        ev = (pos[graph.dst[:ne].long()] - pos[graph.src[:ne].long()])[:, None, :]
        he = run_stack(self.W_e, (graph.edge_attr[:ne], ev))
        for layer in self.layers:
            hv = layer(hv, he, graph, train)
        out = run_stack(self.W_out, hv)
        return out[1][:, 0, :], out
