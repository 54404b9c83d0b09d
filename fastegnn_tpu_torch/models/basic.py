"""The baselines of the model zoo (counterpart of
``fastegnn_tpu/models/basic.py``; reference ``models/basic.py``).

- :class:`BaseMLP` (``basic.py:172-196``): ``Linear, SiLU, Linear`` (keys
  ``mlp.0``, ``mlp.2``), the activation after the last linear where
  ``last_act``, a residual where ``residual``; ``flat`` takes tanh and 4x
  the hidden width.
- :func:`gram_scalars` and :class:`InvariantScalarNet`,
  :class:`EquivariantScalarNet`, :class:`EquivariantEdgeScalarNet`
  (``basic.py:199-282, 472-511``): invariant scalars from the Gram matrix
  of a stack of vectors ``[..., 3, K]`` (L2-normalised, clamped at 1e-12,
  where ``norm``), and vectors as learned combinations of the stack.
- :class:`EGNNLayer` / :class:`EGNN` (``basic.py:285-341``): the
  coordinate update is the dst mean of ``rij * phi_x(m)``, clipped to
  +-100; the node feature is replaced, not added to; ``forward`` returns
  ``(x, v, h)``.
- :class:`GNNLayer` / :class:`GNN` (``basic.py:364-404``): message passing
  on ``[coord, vel]``, positions from a 3-wide decoder; not equivariant.
- :class:`LinearDynamics` (``basic.py:407-415``): ``x + v t``, one learned
  ``t``.
- :class:`GCLRfVel` / :class:`RFVel` (``basic.py:418-469``): the dst mean
  of ``(x_i - x_j) tanh(phi(|x_i - x_j|, e))``, ``phi``'s last linear
  without a bias and drawn xavier-uniform with gain 0.001, plus ``v
  phi_v(|v|)`` with the velocity norm outside the gradient.
- :class:`EGMN` (``basic.py:344-361``): stacked EquivariantScalarNets,
  each appending its vector to the stack; :class:`FullMLP`
  (``basic.py:739-754``): an MLP on an array, not on a graph.

Every sum over the real edges runs on the segment-sum kernel on a CUDA
batch: the edge ends are gathered with :func:`gather_edge_ends` (or
``gather_dst`` / ``gather_src``), whose backwards are the kernel over the
dst and src CSRs, and summed with :func:`segment_mean_at_dst`; EGNN sums
``[f | m]`` in one launch.  Only the real edges are read, since padded
edges carry the out-of-range sentinel ``dst == N``.  Modules keep the
reference's ``state_dict`` keys (``layers.{i}.edge_message_net.
scalar_net.mlp.0``, ``decoder.0``, ``gcl_{i}.phi.0``, ...), so a port
``state_dict`` maps into JAX params through the importers of
``fastegnn_tpu/utils/torch_import.py`` and back through
``fastegnn_tpu_torch/utils/weights.py``.  The models compute in f32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch import resolve_device
from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.fastegnn_core import gather_edge_ends, segment_mean_at_dst
from fastegnn_tpu_torch.models.nn import init_parameters_, mlp
from fastegnn_tpu_torch.ops.spmm import gather_dst, gather_src

COORD_CLIP = 100.0   # EGNN's coordinate mean is clipped to +-100 (basic.py:309-310)
RF_GAIN = 1e-3       # xavier gain of RF's phi head, as the JAX GCLRfVel draws it


def placed(module: nn.Module, device=None, generator: Optional[torch.Generator] = None):
    """``module`` with its linears drawn from ``generator`` on the CPU
    (``models/nn.py::init_parameters_``), moved to ``device`` (the card
    unless ``"cpu"``)."""
    init_parameters_(module, generator)
    return module.to(resolve_device(device))


class BaseMLP(nn.Module):
    """Reference ``BaseMLP`` (``basic.py:172-196``)."""

    def __init__(self, in_dim: int, hidden: int, out: int, residual: bool = False,
                 last_act: bool = False, flat: bool = False):
        super().__init__()
        act = nn.Tanh if flat else nn.SiLU
        width = 4 * hidden if flat else hidden
        layers = [nn.Linear(in_dim, width), act(), nn.Linear(width, out)]
        if last_act:
            layers.append(act())
        self.mlp = nn.Sequential(*layers)
        self.residual = residual

    def forward(self, x):
        y = self.mlp(x)
        return x + y if self.residual else y


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x`` over its last axis's norm, clamped at ``eps``."""
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def gram_scalars(Z: torch.Tensor, norm: bool) -> torch.Tensor:
    """``[..., 3, K]`` -> the flattened Gram matrix ``Z^T Z`` ``[..., K*K]``,
    L2-normalised where ``norm``."""
    K = Z.shape[-1]
    g = torch.einsum("...ik,...il->...kl", Z, Z).reshape(*Z.shape[:-2], K * K)
    return l2_normalize(g) if norm else g


def _with(s: torch.Tensor, scalars: Optional[torch.Tensor]) -> torch.Tensor:
    return s if scalars is None else torch.cat([s, scalars], -1)


class InvariantScalarNet(nn.Module):
    """``BaseMLP`` on the Gram scalars of ``K`` vectors and ``n_scalars``
    scalars (``basic.py:245-282``)."""

    def __init__(self, n_vectors: int, n_scalars: int, hidden: int, out: int,
                 norm: bool = True, last_act: bool = False, flat: bool = False):
        super().__init__()
        self.norm = norm
        self.scalar_net = BaseMLP(n_vectors ** 2 + n_scalars, hidden, out,
                                  last_act=last_act, flat=flat)

    def forward(self, vectors, scalars=None):
        return self.scalar_net(_with(gram_scalars(vectors, self.norm), scalars))


class EquivariantScalarNet(nn.Module):
    """``vectors [..., 3, K]`` (+ scalars) -> ``(vector [..., 3], scalar
    [..., H])`` (``basic.py:199-242``)."""

    def __init__(self, n_vectors: int, n_scalars: int, hidden: int, norm: bool = True,
                 flat: bool = True):
        super().__init__()
        self.norm = norm
        self.in_scalar_net = BaseMLP(n_vectors ** 2 + n_scalars, hidden, hidden,
                                     last_act=True, flat=flat)
        self.out_vector_net = BaseMLP(hidden, hidden, n_vectors, flat=flat)
        self.out_scalar_net = BaseMLP(hidden, hidden, hidden, flat=flat)

    def forward(self, vectors, scalars=None) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.in_scalar_net(_with(gram_scalars(vectors, self.norm), scalars))
        vector = torch.einsum("...ik,...k->...i", vectors, self.out_vector_net(s))
        return vector, self.out_scalar_net(s)


class EquivariantEdgeScalarNet(nn.Module):
    """Per edge, the receiver's and sender's stacks ``[E, 3, K]`` -> (the
    sender's stack mixed by a learned ``[K, K]``, the message ``[E, H]``)
    (``basic.py:472-511``)."""

    def __init__(self, n_vectors: int, n_scalars: int, hidden: int, norm: bool = True,
                 flat: bool = False):
        super().__init__()
        self.norm = norm
        self.in_scalar_net = BaseMLP(n_vectors ** 2 + n_scalars, hidden, hidden,
                                     last_act=True, flat=flat)
        self.out_vector_net = BaseMLP(hidden, hidden, n_vectors ** 2, flat=flat)

    def forward(self, vectors_i, vectors_j, scalars=None):
        K = vectors_i.shape[-1]
        g = torch.einsum("...ik,...il->...kl", vectors_j, vectors_i)   # Z_j^T Z_i
        g = g.reshape(*g.shape[:-2], K * K)
        if self.norm:
            g = l2_normalize(g)
        s = self.in_scalar_net(_with(g, scalars))
        coef = self.out_vector_net(s).reshape(*s.shape[:-1], K, K)
        return torch.einsum("...ij,...jk->...ik", vectors_j, coef), s


class EGNNLayer(nn.Module):
    """Scalarization EGNN layer with an optional velocity term
    (``basic.py:285-320``)."""

    def __init__(self, hidden: int, edge_attr_dim: int, with_v: bool = False,
                 flat: bool = False, norm: bool = False):
        super().__init__()
        H = hidden
        self.edge_message_net = InvariantScalarNet(1, 2 * H + edge_attr_dim, H, H, norm=norm,
                                                   last_act=True, flat=flat)
        self.coord_net = BaseMLP(H, H, 1, flat=flat)
        if with_v:
            self.node_v_net = BaseMLP(H, H, 1, flat=flat)
        self.node_net = BaseMLP(2 * H, H, H, flat=flat)

    def forward(self, x, h, graph: GraphBatch, v=None):
        h_d, h_s, x_d, x_s = gather_edge_ends(graph, h, x)
        rij = x_d - x_s
        e = graph.edge_attr[:graph.n_real_edges]
        message = self.edge_message_net(rij[..., None], torch.cat([h_d, h_s, e], -1))
        f = rij * self.coord_net(message)
        # the dst means of f and of the messages, in one segment-sum
        tot = segment_mean_at_dst(torch.cat([f, message], -1), graph)
        tot_f = tot[:, :3].clamp(-COORD_CLIP, COORD_CLIP)
        x = x + tot_f if v is None else x + self.node_v_net(h) * v + tot_f
        return x, v, self.node_net(torch.cat([h, tot[:, 3:]], -1))


class EGNN(nn.Module):
    """Reference ``EGNN`` (``basic.py:323-341``): ``forward(graph) -> (x, v,
    h)``, ``v`` the input velocities (``None`` without ``with_v``)."""

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 n_layers: int = 4, with_v: bool = True, flat: bool = False,
                 norm: bool = False, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.with_v = with_v
        self.embedding = nn.Linear(node_feat_dim, hidden)
        self.layers = nn.ModuleList(EGNNLayer(hidden, edge_attr_dim, with_v, flat, norm)
                                    for _ in range(n_layers))
        placed(self, device, generator)

    def forward(self, graph: GraphBatch):
        h = self.embedding(graph.node_feat)
        x, v = graph.coord, graph.vel if self.with_v else None
        for layer in self.layers:
            x, v, h = layer(x, h, graph, v)
        return x, v, h


class GNNLayer(nn.Module):
    """``basic.py:364-379``: ``h + phi_h([mean of phi_e(h_i, h_j, e), h])``."""

    def __init__(self, hidden: int, edge_attr_dim: int, flat: bool = False):
        super().__init__()
        H = hidden
        self.edge_message_net = BaseMLP(2 * H + edge_attr_dim, H, H, flat=flat)
        self.node_net = BaseMLP(2 * H, H, H, flat=flat)

    def forward(self, h, graph: GraphBatch):
        ne = graph.n_real_edges
        h_d = gather_dst(h, graph.dst[:ne], graph.rowptr)
        h_s = gather_src(h, graph.src[:ne], graph.src_perm, graph.src_rowptr)
        message = self.edge_message_net(torch.cat([h_d, h_s, graph.edge_attr[:ne]], -1))
        agg = segment_mean_at_dst(message, graph)
        return h + self.node_net(torch.cat([agg, h], -1))


class GNN(nn.Module):
    """The non-equivariant baseline (``basic.py:382-404``; wiring
    ``utils/train.py:80-82``): input ``[coord, vel]``, so ``node_feat_dim``
    is not read; ``forward(graph) -> positions [N, 3]``."""

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 n_layers: int = 4, flat: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Linear(6, hidden)
        self.layers = nn.ModuleList(GNNLayer(hidden, edge_attr_dim, flat)
                                    for _ in range(n_layers))
        self.decoder = mlp(hidden, hidden, 3)
        placed(self, device, generator)

    def forward(self, graph: GraphBatch) -> torch.Tensor:
        h = self.embedding(torch.cat([graph.coord, graph.vel], -1))
        for layer in self.layers:
            h = layer(h, graph)
        return self.decoder(h)


class LinearDynamics(nn.Module):
    """``x + v t`` with one learned ``t``, starting at 1 (``basic.py:407-415``);
    ``forward(graph) -> positions [N, 3]``."""

    def __init__(self, node_feat_dim: int = 0, edge_attr_dim: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.time = nn.Parameter(torch.ones(1))
        placed(self, device, generator)

    def forward(self, graph: GraphBatch) -> torch.Tensor:
        return graph.coord + graph.vel * self.time


class GCLRfVel(nn.Module):
    """The radial-field cell (``basic.py:434-469``)."""

    def __init__(self, hidden: int, edge_attr_dim: int):
        super().__init__()
        head = nn.Linear(hidden, 1, bias=False)
        head.xavier_gain = RF_GAIN
        self.phi = nn.Sequential(nn.Linear(1 + edge_attr_dim, hidden), nn.SiLU(), head)
        self.coord_mlp_vel = mlp(1, hidden, 1)

    def forward(self, x, vel_norm, vel, graph: GraphBatch):
        ne = graph.n_real_edges
        x_diff = (gather_dst(x, graph.dst[:ne], graph.rowptr)
                  - gather_src(x, graph.src[:ne], graph.src_perm, graph.src_rowptr))
        radial = x_diff.norm(dim=-1, keepdim=True)
        m = x_diff * torch.tanh(self.phi(torch.cat([radial, graph.edge_attr[:ne]], -1)))
        x = x + segment_mean_at_dst(m, graph)
        return x + vel * self.coord_mlp_vel(vel_norm)


class RFVel(nn.Module):
    """Reference ``RF_vel`` (``basic.py:418-431``; CLI name "RF"):
    ``forward(graph) -> positions [N, 3]``; ``node_feat_dim`` is not read."""

    def __init__(self, node_feat_dim: int, edge_attr_dim: int, hidden: int = 64,
                 n_layers: int = 4, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", GCLRfVel(hidden, edge_attr_dim))
        placed(self, device, generator)

    def forward(self, graph: GraphBatch) -> torch.Tensor:
        vel_norm = graph.vel.norm(dim=-1, keepdim=True).detach()
        x = graph.coord
        for i in range(self.n_layers):
            x = getattr(self, f"gcl_{i}")(x, vel_norm, graph.vel, graph)
        return x


class EGMN(nn.Module):
    """Stacked EquivariantScalarNets over a growing list of vectors
    (``basic.py:344-361``): ``n_vectors`` vectors and ``n_scalars`` scalars
    in, ``(last vector [..., 3], scalars [..., H])`` out."""

    def __init__(self, n_vectors: int, n_scalars: int, hidden: int, n_layers: int,
                 norm: bool = False, flat: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            EquivariantScalarNet(n_vectors + i, n_scalars if i == 0 else hidden, hidden,
                                 norm=norm, flat=flat) for i in range(n_layers))

    def forward(self, vectors: Sequence[torch.Tensor], scalars: torch.Tensor):
        cur: List[torch.Tensor] = list(vectors)
        for layer in self.layers:
            vector, scalars = layer(torch.stack(cur, -1), scalars)
            cur.append(vector)
        return cur[-1], scalars


class FullMLP(nn.Module):
    """The non-geometric MLP baseline (``basic.py:739-754``) on an array
    ``[..., in_dim]``, not on a graph batch, as in the JAX package, so no
    training CLI can feed it (``cli/common.py`` raises for ``--model
    MLP``).  ``edge_attr_dim`` is not read."""

    def __init__(self, in_dim: int, edge_attr_dim: int = 0, hidden: int = 64,
                 n_layers: int = 4, flat: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Linear(in_dim, hidden)
        self.layers = nn.ModuleList(
            BaseMLP(hidden, hidden, hidden, residual=True, last_act=True, flat=flat)
            for _ in range(n_layers))
        self.output = nn.Linear(hidden, 3)
        placed(self, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embedding(x)
        for layer in self.layers:
            x = layer(x)
        return self.output(x)
