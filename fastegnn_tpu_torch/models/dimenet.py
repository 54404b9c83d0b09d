"""DimeNet / DimeNet++, directional message passing (counterpart of
``fastegnn_tpu/models/dimenet.py``; reference ``models/DimeNet.py``, PyG's
DimeNet adapted to emit a per-node 3-vector).

**Bases.**  The spherical Bessel basis ``sqrt(2) / |j_{l+1}(z_lm)| *
j_l(z_lm d / cutoff)`` over the first zeros ``z_lm`` of ``j_l``
(:func:`jn_zeros`, the JAX package's root finder, equal to its zeros
exactly) is evaluated in float64 and cast to f32: :func:`spherical_jn` is
Rayleigh's formula ``P_l(1/x) sin x + Q_l(1/x) cos x`` with exact integer
coefficients, and its power series below ``x = 4``, where the closed form
cancels (at ``x ~ 0.01`` it loses every digit of ``j_6`` even in f64).  The
JAX package evaluates sympy's closed form in f32, which is garbage near
``d = 0`` (ROADMAP.md §3, reference defect 8); the port follows the
function, not the defect, and needs no sympy.  The angular part is
``Y_l0`` by the Legendre recurrence in f32; the learned radial basis is
``envelope(d) * sin(freq * d)`` in f32, ``freq`` starting at ``n pi``.

**Triplets.**  A batch carries its :class:`~fastegnn_tpu_torch.graph.
Triplets`, built on its device from its own CSR tables
(:func:`~fastegnn_tpu_torch.graph.build_triplets`) and attached by
:class:`TripletDataset`, so ``forward(graph)`` reads them and the training
loop needs no hook.  The table holds exactly the real triplets: the JAX
table's capacity padding (1.3x the first batch's count, a static-shape
workaround) is dropped.

**Where the sums run.**  Only the real edges are read (the JAX package's
padded edges, which it gives ``dist = cutoff`` so that their envelope is
zero, are not there).  The messages' sum over each edge's triplets is the
segment-sum kernel over the table's ``idx_ji`` row pointer (no perm); the
output blocks' sum at ``i = src`` is ``src_segment_sum_csr``; the
embedding's ``z[i]`` / ``z[j]`` are ``gather_src`` / ``gather_dst``, whose
backwards are the kernel.  The triplet messages never keep a ``[T, ...]``
tensor for the backward but the basis ``sbf`` ``[T, S R]``, which all
blocks share:

- DimeNet's bilinear ``msg[t] = sum_jl sbf8[t, j] x_kj[kj[t], l] W[:, j, l]``
  contracts ``Y = x_kj W`` per edge first (``[E, B, H]``), then
  ``sum_j sbf8[t, j] Y[kj[t], j]`` in chunks of triplets
  (:class:`_BilinearMessages`), recomputing ``sbf8 = sbf lin_sbf^T`` and
  the gather in its backward; ``dY`` is one perm-form launch of the kernel
  per bilinear channel, over the table's ``kj_perm``;
- DimeNet++'s ``msg[t] = x_kj[kj[t]] * sbf2[t]`` (:class:`_ProductMessages`)
  with ``sbf2 = sbf (lin_sbf2 lin_sbf1)^T``: the two bias-free linears are
  one product, so neither ``[T, basis_emb]`` nor ``[T, int_emb]`` is kept;
  ``dx_kj`` is one perm-form launch over ``kj_perm``.

The reference's quirks are kept: the ++ block's after-skip stack is sized
by ``num_before_skip``; the output blocks' last linear (``lin``) starts at
zero; glorot-orthogonal linears, ``W ~ N(0, (2 / H)^2)``, the embedding's
weight ``U(-sqrt 3, sqrt 3)``.  The modules keep the reference's
``state_dict`` keys (``rbf.freq``, ``emb.emb``, ``emb.lin_rbf``,
``interaction_blocks.{b}.W``, ``interaction_blocks.{b}.layers_before_skip.
{i}.lin1``, ``output_blocks.{b}.lins.{i}``, ``output_blocks.{b}.lin``, ...),
so a port ``state_dict`` maps into JAX params through
``fastegnn_tpu/utils/torch_import.py::params_from_dimenet_state_dict`` and
back through :func:`fastegnn_tpu_torch.utils.weights.
state_dict_from_dimenet_params`.  The CLI's configuration
(``main_nbody.py:124-127``): hidden ``--dim_hidden``, ``num_blocks =
--num_layer``, bilinear 8, spherical 7, radial 6, cutoff 10; ++ at
int_emb 64, basis_emb 64, out_emb 256.  The models compute in f32.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.functional import silu

from fastegnn_tpu_torch.graph import GraphBatch, Triplets, build_triplets
from fastegnn_tpu_torch.models.basic import placed
from fastegnn_tpu_torch.ops.spmm import (
    gather_dst, gather_src, segment_sum_csr, sorted_segment_sum_csr, src_segment_sum_csr)

SERIES_BELOW, SERIES_TERMS = 4.0, 16   # j_l by its power series below x = 4
TRIPLET_CHUNK = 1 << 19                # triplets per chunk of the message gathers


# ---------------------------------------------------------------------------
# bases
# ---------------------------------------------------------------------------


def jn_zeros(n: int, k: int) -> np.ndarray:
    """First ``k`` positive zeros of ``j_l`` for ``l = 0..n-1`` (scipy
    ``brentq``, bracketed by the interlacing of consecutive orders' zeros);
    the JAX package's ``_jn_zeros``."""
    from scipy import special
    from scipy.optimize import brentq

    zeros = np.zeros((n, k + n), np.float64)
    zeros[0, :] = np.arange(1, k + n + 1) * np.pi
    for l in range(1, n):
        for i in range(k + n - l):
            lo, hi = zeros[l - 1, i], zeros[l - 1, i + 1]
            zeros[l, i] = brentq(lambda x: special.spherical_jn(l, x), lo + 1e-9, hi - 1e-9)
    return zeros[:, :k]


@functools.lru_cache(maxsize=None)
def _rayleigh(n: int) -> Tuple[List[List[int]], List[List[int]]]:
    """Integer coefficients of ``P_l``, ``Q_l`` in ``u = 1 / x`` with
    ``j_l = P_l(u) sin x + Q_l(u) cos x`` for ``l < n``, by
    ``j_{l+1} = (2l + 1) u j_l - j_{l-1}`` from ``j_{-1} = u cos x`` and
    ``j_0 = u sin x``."""
    def step(a, b, m):
        up = [0] + [m * c for c in a]
        return [x - y for x, y in zip(up, b + [0] * (len(up) - len(b)))]

    P, Q = [[0, 1]], [[0]]
    p_prev, q_prev = [0], [0, 1]
    for l in range(n - 1):
        p_next, q_next = step(P[l], p_prev, 2 * l + 1), step(Q[l], q_prev, 2 * l + 1)
        p_prev, q_prev = P[l], Q[l]
        P.append(p_next)
        Q.append(q_next)
    return P, Q


def _poly(coeffs, u: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(u)
    for c in reversed(coeffs):
        out = out * u + c
    return out


def spherical_jn(l: int, x: torch.Tensor) -> torch.Tensor:
    """``j_l(x)`` for a float64 ``x >= 0``: Rayleigh's closed form, and its
    power series ``x^l sum_k (-x^2 / 2)^k / (k! (2l + 2k + 1)!!)`` below
    ``SERIES_BELOW`` (within 2e-15 of scipy over ``[1e-3, 30]``)."""
    P, Q = _rayleigh(l + 1)
    small = x < SERIES_BELOW
    u = 1.0 / torch.where(small, torch.full_like(x, SERIES_BELOW), x)
    closed = _poly(P[l], u) * torch.sin(x) + _poly(Q[l], u) * torch.cos(x)
    c = 1.0 / math.prod(range(1, 2 * l + 2, 2))
    coeffs = []
    for k in range(SERIES_TERMS):
        coeffs.append(c)
        c *= -0.5 / ((k + 1) * (2 * l + 2 * k + 3))
    series = x**l * _poly(coeffs, x * x)
    return torch.where(small, series, closed)


@functools.lru_cache(maxsize=None)
def _bessel_table(num_spherical: int, num_radial: int) -> Tuple[np.ndarray, np.ndarray]:
    """The zeros ``z_lm`` and the norms ``sqrt(2) / |j_{l+1}(z_lm)|``."""
    from scipy import special

    zeros = jn_zeros(num_spherical, num_radial)
    norms = np.stack([math.sqrt(2.0) / np.abs(special.spherical_jn(l + 1, zeros[l]))
                      for l in range(num_spherical)])
    return zeros, norms


def bessel_basis(d01: torch.Tensor, num_spherical: int, num_radial: int) -> torch.Tensor:
    """``[E, S R]`` f32 normalised spherical Bessel basis
    ``sqrt(2) / |j_{l+1}(z_lm)| j_l(z_lm d01)`` (``l``-major), computed in
    float64."""
    zeros, norms = _bessel_table(num_spherical, num_radial)
    x = d01.double()[:, None]
    cols = [torch.as_tensor(norms[l], device=x.device)
            * spherical_jn(l, x * torch.as_tensor(zeros[l], device=x.device))
            for l in range(num_spherical)]
    return torch.cat(cols, -1).float()


def spherical_harmonics_m0(angle: torch.Tensor, num_spherical: int) -> torch.Tensor:
    """``[T, S]`` f32 real ``Y_l0(angle) = sqrt((2l + 1) / 4 pi) P_l(cos
    angle)``, the Legendre polynomials by their recurrence."""
    c = torch.cos(angle)
    legendre = [torch.ones_like(c), c]
    for l in range(1, num_spherical - 1):
        legendre.append(((2 * l + 1) * c * legendre[l] - l * legendre[l - 1]) / (l + 1))
    return torch.stack([math.sqrt((2 * l + 1) / (4 * math.pi)) * legendre[l]
                        for l in range(num_spherical)], -1)


def envelope(x: torch.Tensor, exponent: int = 5) -> torch.Tensor:
    """Smooth cutoff polynomial (``DimeNet.py:22-36``), zero from ``x = 1``."""
    p = exponent + 1
    a, b, c = -(p + 1) * (p + 2) / 2, p * (p + 2), -p * (p + 1) / 2
    xp0 = x ** (p - 1)
    val = 1.0 / x.clamp_min(1e-12) + a * xp0 + b * xp0 * x + c * xp0 * x * x
    return val * (x < 1.0).to(x.dtype)


# ---------------------------------------------------------------------------
# triplets
# ---------------------------------------------------------------------------


class TripletDataset:
    """Wraps a ``GraphDataset``: its ``collate`` and ``iter_batches`` give
    batches that carry their triplet table (``graph.triplets``).  The table
    is built once per batch object, so a batch the dataset's collate cache
    hands out again keeps the table it got."""

    def __init__(self, base):
        self.base = base

    def __len__(self) -> int:
        return len(self.base)

    def __getattr__(self, name):
        return getattr(self.base, name)

    @staticmethod
    def with_triplets(batch: GraphBatch) -> GraphBatch:
        if batch.triplets is None:
            batch.triplets = build_triplets(batch)
        return batch

    def collate(self, indices) -> GraphBatch:
        return self.with_triplets(self.base.collate(indices))

    def iter_batches(self, batch_size: int, rng=None, drop_last: bool = True,
                     prefetch: int = 2):
        for batch in self.base.iter_batches(batch_size, rng=rng, drop_last=drop_last,
                                            prefetch=prefetch):
            yield self.with_triplets(batch)


# ---------------------------------------------------------------------------
# triplet messages
# ---------------------------------------------------------------------------


def _chunks(n: int):
    return ((lo, min(lo + TRIPLET_CHUNK, n)) for lo in range(0, n, TRIPLET_CHUNK))


class _BilinearMessages(torch.autograd.Function):
    """``msg[t] = sum_j (sbf[t] w^T)[j] * y[kj[t], j]``: ``sbf`` [T, S R],
    ``w`` [B, S R], ``y`` [E, B, H] -> [T, H]."""

    @staticmethod
    def forward(ctx, sbf, w, y, kj, kj_perm, kj_rowptr):
        ctx.save_for_backward(sbf, w, y, kj, kj_perm, kj_rowptr)
        out = y.new_empty((sbf.shape[0], y.shape[2]))
        for lo, hi in _chunks(sbf.shape[0]):
            s8 = sbf[lo:hi] @ w.T
            torch.bmm(s8[:, None, :], y.index_select(0, kj[lo:hi]), out=out[lo:hi, None])
        return out

    @staticmethod
    def backward(ctx, g):
        sbf, w, y, kj, kj_perm, kj_rowptr = ctx.saved_tensors
        g = g.contiguous()
        dw = torch.zeros_like(w)
        for lo, hi in _chunks(sbf.shape[0]):
            ds8 = torch.bmm(y.index_select(0, kj[lo:hi]), g[lo:hi, :, None])[..., 0]
            dw += ds8.T @ sbf[lo:hi]
        s8 = sbf @ w.T
        dy = torch.stack([segment_sum_csr(s8[:, j, None] * g, kj_rowptr, kj_perm)
                          for j in range(w.shape[0])], 1)
        return None, dw, dy, None, None, None


class _ProductMessages(torch.autograd.Function):
    """``msg[t] = x[kj[t]] * (sbf[t] w^T)``: ``sbf`` [T, S R], ``w`` [F, S R],
    ``x`` [E, F] -> [T, F]."""

    @staticmethod
    def forward(ctx, sbf, w, x, kj, kj_perm, kj_rowptr):
        ctx.save_for_backward(sbf, w, x, kj, kj_perm, kj_rowptr)
        out = x.new_empty((sbf.shape[0], x.shape[1]))
        for lo, hi in _chunks(sbf.shape[0]):
            torch.mul(x.index_select(0, kj[lo:hi]), sbf[lo:hi] @ w.T, out=out[lo:hi])
        return out

    @staticmethod
    def backward(ctx, g):
        sbf, w, x, kj, kj_perm, kj_rowptr = ctx.saved_tensors
        rows = torch.empty_like(g)
        dw = torch.zeros_like(w)
        for lo, hi in _chunks(sbf.shape[0]):
            torch.mul(g[lo:hi], sbf[lo:hi] @ w.T, out=rows[lo:hi])
            dw += (g[lo:hi] * x.index_select(0, kj[lo:hi])).T @ sbf[lo:hi]
        return None, dw, segment_sum_csr(rows, kj_rowptr, kj_perm), None, None, None


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def glorot_orthogonal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None,
                       scale: float = 2.0) -> None:
    """An orthogonal draw scaled to variance ``scale / (fan_in + fan_out)``
    (PyG's ``glorot_orthogonal``, the JAX package's)."""
    nn.init.orthogonal_(weight, generator=generator)
    weight.mul_(torch.sqrt(scale / (sum(weight.shape) * weight.var(unbiased=False)
                                    .clamp_min(1e-12))))


def _glin(in_dim: int, out: int, bias: bool = True) -> nn.Linear:
    m = nn.Linear(in_dim, out, bias=bias)
    m.init_weight, m.zero_bias = glorot_orthogonal_, True
    return m


def _zero_lin(in_dim: int, out: int) -> nn.Linear:
    m = nn.Linear(in_dim, out, bias=False)
    m.init_weight = lambda w, generator: nn.init.zeros_(w)
    return m


class BesselRBF(nn.Module):
    """The learned radial basis ``envelope * sin(freq d01)`` (``DimeNet.py:
    39-56``), ``freq`` starting at ``(1..R) pi``."""

    def __init__(self, num_radial: int):
        super().__init__()
        self.freq = nn.Parameter(torch.arange(1, num_radial + 1, dtype=torch.float32) * math.pi)

    def forward(self, d01: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
        return env[:, None] * torch.sin(self.freq * d01[:, None])


class EmbeddingBlock(nn.Module):
    """``x_ji = silu(lin([z_i, z_j, silu(lin_rbf(rbf))]))`` with ``z =
    emb(node_feat)`` (``DimeNet.py:117-135``)."""

    def __init__(self, node_feat_dim: int, num_radial: int, hidden: int):
        super().__init__()
        self.emb = nn.Linear(node_feat_dim, hidden)
        bound = math.sqrt(3.0)
        self.emb.init_weight = lambda w, generator: nn.init.uniform_(w, -bound, bound,
                                                                     generator=generator)
        self.emb.zero_bias = True
        self.lin_rbf = _glin(num_radial, hidden)
        self.lin = _glin(3 * hidden, hidden)

    def forward(self, graph: GraphBatch, rbf: torch.Tensor) -> torch.Tensor:
        ne = graph.n_real_edges
        z = self.emb(graph.node_feat)
        z_i = gather_src(z, graph.src[:ne], graph.src_perm, graph.src_rowptr)
        z_j = gather_dst(z, graph.dst[:ne], graph.rowptr)
        return silu(self.lin(torch.cat([z_i, z_j, silu(self.lin_rbf(rbf))], -1)))


class ResidualLayer(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.lin1, self.lin2 = _glin(hidden, hidden), _glin(hidden, hidden)

    def forward(self, x):
        return x + silu(self.lin2(silu(self.lin1(x))))


def _residuals(hidden: int, n: int) -> nn.ModuleList:
    return nn.ModuleList(ResidualLayer(hidden) for _ in range(n))


def _run(layers, h):
    for layer in layers:
        h = layer(h)
    return h


class InteractionBlock(nn.Module):
    """DimeNet's bilinear interaction (``DimeNet.py:138-205``)."""

    def __init__(self, hidden: int, num_bilinear: int, num_spherical: int, num_radial: int,
                 num_before_skip: int = 1, num_after_skip: int = 2):
        super().__init__()
        self.lin_rbf = _glin(num_radial, hidden, bias=False)
        self.lin_sbf = _glin(num_spherical * num_radial, num_bilinear, bias=False)
        self.lin_kj, self.lin_ji = _glin(hidden, hidden), _glin(hidden, hidden)
        self.W = nn.Parameter(torch.empty(hidden, num_bilinear, hidden))
        self.layers_before_skip = _residuals(hidden, num_before_skip)
        self.lin = _glin(hidden, hidden)
        self.layers_after_skip = _residuals(hidden, num_after_skip)

    @torch.no_grad()
    def draw_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.normal_(self.W, 0.0, 2.0 / self.W.shape[0], generator=generator)

    def forward(self, x, rbf, sbf, trip: Triplets):
        H, B = self.W.shape[0], self.W.shape[1]
        x_ji = silu(self.lin_ji(x))
        x_kj = silu(self.lin_kj(x)) * self.lin_rbf(rbf)
        # Y[e, j, i] = sum_l x_kj[e, l] W[i, j, l], per edge
        y = (x_kj @ self.W.permute(2, 1, 0).reshape(H, B * H)).view(-1, B, H)
        msg = _BilinearMessages.apply(sbf, self.lin_sbf.weight, y, trip.idx_kj, trip.kj_perm,
                                      trip.kj_rowptr)
        h = x_ji + sorted_segment_sum_csr(msg, trip.idx_ji, trip.rowptr, x.shape[0])
        h = silu(self.lin(_run(self.layers_before_skip, h))) + x
        return _run(self.layers_after_skip, h)


class InteractionPPBlock(nn.Module):
    """DimeNet++'s interaction (``DimeNet.py:208-296``); its after-skip
    stack is sized by ``num_before_skip``, the reference's quirk."""

    def __init__(self, hidden: int, int_emb_size: int, basis_emb_size: int,
                 num_spherical: int, num_radial: int, num_before_skip: int = 1):
        super().__init__()
        self.lin_rbf1 = _glin(num_radial, basis_emb_size, bias=False)
        self.lin_rbf2 = _glin(basis_emb_size, hidden, bias=False)
        self.lin_sbf1 = _glin(num_spherical * num_radial, basis_emb_size, bias=False)
        self.lin_sbf2 = _glin(basis_emb_size, int_emb_size, bias=False)
        self.lin_kj, self.lin_ji = _glin(hidden, hidden), _glin(hidden, hidden)
        self.lin_down = _glin(hidden, int_emb_size, bias=False)
        self.lin_up = _glin(int_emb_size, hidden, bias=False)
        self.layers_before_skip = _residuals(hidden, num_before_skip)
        self.lin = _glin(hidden, hidden)
        self.layers_after_skip = _residuals(hidden, num_before_skip)

    def forward(self, x, rbf, sbf, trip: Triplets):
        x_ji = silu(self.lin_ji(x))
        x_kj = silu(self.lin_kj(x)) * self.lin_rbf2(self.lin_rbf1(rbf))
        x_kj = silu(self.lin_down(x_kj))
        w = self.lin_sbf2.weight @ self.lin_sbf1.weight     # sbf2 = sbf w^T
        msg = _ProductMessages.apply(sbf, w, x_kj, trip.idx_kj, trip.kj_perm, trip.kj_rowptr)
        agg = sorted_segment_sum_csr(msg, trip.idx_ji, trip.rowptr, x.shape[0])
        h = x_ji + silu(self.lin_up(agg))
        h = silu(self.lin(_run(self.layers_before_skip, h))) + x
        return _run(self.layers_after_skip, h)


class OutputBlock(nn.Module):
    """Edge states to node outputs (``DimeNet.py:299-380``): ``lin_rbf(rbf)
    * x`` summed at ``i = src``, then (++: ``lin_up`` to ``out_emb``)
    ``num_layers`` silu linears and the zero-initialised ``lin``."""

    def __init__(self, hidden: int, out_channels: int, num_radial: int, num_layers: int = 3,
                 out_emb_channels: Optional[int] = None):
        super().__init__()
        width = out_emb_channels or hidden
        self.lin_rbf = _glin(num_radial, hidden, bias=False)
        if out_emb_channels:
            self.lin_up = _glin(hidden, out_emb_channels, bias=False)
        self.lins = nn.ModuleList(_glin(width, width) for _ in range(num_layers))
        self.lin = _zero_lin(width, out_channels)

    def forward(self, x, rbf, graph: GraphBatch):
        ne = graph.n_real_edges
        x = src_segment_sum_csr(self.lin_rbf(rbf) * x, graph.src[:ne], graph.src_perm,
                                graph.src_rowptr, graph.num_nodes)
        if hasattr(self, "lin_up"):
            x = self.lin_up(x)
        for lin in self.lins:
            x = silu(lin(x))
        return self.lin(x)


class DimeNet(nn.Module):
    """``forward(graph) -> per-node [N, 3]``; ``graph.triplets`` must be
    set (:class:`TripletDataset`).  ``edge_attr_dim`` is not read."""

    def __init__(self, node_feat_dim: int, edge_attr_dim: int = 0, hidden: int = 64,
                 out_channels: int = 3, num_blocks: int = 4, num_bilinear: int = 8,
                 num_spherical: int = 7, num_radial: int = 6, cutoff: float = 10.0,
                 envelope_exponent: int = 5, plusplus: bool = False, int_emb_size: int = 64,
                 basis_emb_size: int = 64, out_emb_channels: int = 256,
                 num_before_skip: int = 1, num_after_skip: int = 2, num_output_layers: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cutoff, self.envelope_exponent = cutoff, envelope_exponent
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.rbf = BesselRBF(num_radial)
        self.emb = EmbeddingBlock(node_feat_dim, num_radial, hidden)
        out_emb = out_emb_channels if plusplus else None
        self.output_blocks = nn.ModuleList(
            OutputBlock(hidden, out_channels, num_radial, num_output_layers, out_emb)
            for _ in range(num_blocks + 1))
        self.interaction_blocks = nn.ModuleList(
            InteractionPPBlock(hidden, int_emb_size, basis_emb_size, num_spherical, num_radial,
                               num_before_skip) if plusplus
            else InteractionBlock(hidden, num_bilinear, num_spherical, num_radial,
                                  num_before_skip, num_after_skip)
            for _ in range(num_blocks))
        placed(self, device, generator)

    def forward(self, graph: GraphBatch) -> torch.Tensor:
        trip = graph.triplets
        if trip is None:
            raise ValueError("DimeNet reads the batch's triplet table: wrap the dataset in "
                             "models/dimenet.py::TripletDataset (or set graph.triplets = "
                             "build_triplets(graph))")
        ne, pos = graph.n_real_edges, graph.coord
        dist = (pos[graph.src[:ne].long()] - pos[graph.dst[:ne].long()]).norm(dim=-1)
        d01 = dist / self.cutoff
        env = envelope(d01, self.envelope_exponent)
        rbf = self.rbf(d01, env)

        pos_i = pos.index_select(0, trip.idx_i)
        pos_ji = pos.index_select(0, trip.idx_j) - pos_i
        pos_ki = pos.index_select(0, trip.idx_k) - pos_i
        angle = torch.atan2(torch.linalg.cross(pos_ji, pos_ki).norm(dim=-1),
                            (pos_ji * pos_ki).sum(-1))
        S, R = self.num_spherical, self.num_radial
        srbf = env[:, None] * bessel_basis(d01, S, R)
        sbf = (srbf.index_select(0, trip.idx_kj).view(-1, S, R)
               * spherical_harmonics_m0(angle, S)[:, :, None]).view(-1, S * R)

        x = self.emb(graph, rbf)
        P = self.output_blocks[0](x, rbf, graph)
        for block, out in zip(self.interaction_blocks, self.output_blocks[1:]):
            x = block(x, rbf, sbf, trip)
            P = P + out(x, rbf, graph)
        return P


def DimeNetPlusPlus(node_feat_dim: int, edge_attr_dim: int = 0, **kwargs) -> DimeNet:
    kwargs.setdefault("plusplus", True)
    return DimeNet(node_feat_dim, edge_attr_dim, **kwargs)
