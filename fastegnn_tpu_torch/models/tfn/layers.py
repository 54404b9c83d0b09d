"""TFN / SE(3)-Transformer layers on the port's batch (counterpart of
``fastegnn_tpu/models/tfn/layers.py``).

Degree-typed features are dicts ``{d: [N, mult, 2d+1]}``.  The equivariant
kernel basis is built per real edge from real spherical harmonics
contracted with real Clebsch-Gordan tables (``so3.py``).

Edge convention, the JAX package's (its module header): messages are built
from the features at ``dst`` and averaged at ``src``, with the relative
vector ``x[src] - x[dst]`` (``models.py::edge_geometry``).  Flipping it
keeps the layer equivariant, so only a comparison with the JAX layer can
catch it (``tests/test_torch_port_fast_tfn.py``,
``tests/test_torch_port_tfn_models.py``).

On the port's batch only the real edges are read (padded edges carry the
out-of-range sentinel ``dst == N``): the features are gathered once at dst
and at src (:func:`gather_ends`; ``ops/spmm.py``'s gathers, whose backward
is the segment-sum kernel), and the messages of every output degree are
summed at src in one call of the segment-sum kernel over the src-sorted
CSR (``ops/spmm.py::src_segment_sum_csr``), then divided by the src
counts.  The attention (:class:`GMABSE3`) sums at src the same way: its
softmax denominators (``ops/segment.py::segment_softmax``) and its
weighted values.

:class:`PairwiseConv` contracts the radial profile, the basis and the
gathered features without building the JAX package's per-edge kernel
``[E, m_out, 2d_out+1, m_in, 2d_in+1]``.  A pair whose profile ``[E,
m_out, m_in, nfreq]`` is wider than the radial MLP's hidden layer (at
``nf = 32``, 1,024-3,072 floats per edge) keeps no profile for the
backward either: :class:`_ProfileContraction` forms it over chunks of
edges and forms it again in the backward.  The pairs of FastTFN's one-
channel TFN (at most 3 floats per edge) keep theirs.  Under a profiler the
radial MLP and, where chunked, the contraction record the span
``tfn.radial`` (``utils/profiling.py::span``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.nn import he_linear
from fastegnn_tpu_torch.models.tfn.so3 import real_clebsch_gordan, real_sph_harm_all
from fastegnn_tpu_torch.ops.segment import segment_softmax
from fastegnn_tpu_torch.ops.spmm import gather_dst, gather_src, src_segment_sum_csr
from fastegnn_tpu_torch.utils.profiling import span

PROFILE_CHUNK = 1 << 26   # profile floats per chunk of edges (256 MiB in f32)


class Fiber:
    """Degree-typed feature structure: a list of (multiplicity, degree)
    (reference ``fibers.py:13-44``), built from ``num_degrees`` degrees of
    ``num_channels`` each, from a ``structure`` list or from a
    ``dictionary`` ``{degree: multiplicity}``."""

    def __init__(self, num_degrees=None, num_channels=None, structure=None, dictionary=None):
        if structure is not None:
            self.structure = list(structure)
        elif dictionary is not None:
            self.structure = [(dictionary[d], d) for d in sorted(dictionary)]
        else:
            self.structure = [(num_channels, d) for d in range(num_degrees)]
        self.multiplicities, self.degrees = zip(*self.structure)
        self.structure_dict = {d: m for m, d in self.structure}
        self.n_features = sum(m * (2 * d + 1) for m, d in self.structure)


@functools.lru_cache(maxsize=None)
def _cg(j1: int, j2: int, j3: int, device: torch.device) -> torch.Tensor:
    """The real CG table as an f32 tensor on ``device``, copied there once."""
    return torch.as_tensor(real_clebsch_gordan(j1, j2, j3), dtype=torch.float32,
                           device=device)


def compute_basis(edge_vec: torch.Tensor, max_degree: int) -> Dict[Tuple[int, int], torch.Tensor]:
    """Per-edge equivariant kernel blocks ``{(d_in, d_out): [E, nfreq,
    2d_out+1, 2d_in+1]}`` with ``nfreq = 2 min(d_in, d_out) + 1`` (J =
    |d_in - d_out| .. d_in + d_out), from Y_J of the edge direction (up to
    degree ``2 max_degree``) contracted with the real CG tables."""
    Y = real_sph_harm_all(2 * max_degree, edge_vec)
    basis = {}
    for di in range(max_degree + 1):
        for do in range(max_degree + 1):
            KJ = [torch.einsum("em,imo->eoi", Y[J], _cg(di, J, do, edge_vec.device))
                  for J in range(abs(di - do), di + do + 1)]
            basis[(di, do)] = torch.stack(KJ, dim=1)
    return basis


class RadialFunc(nn.Module):
    """Radial profile MLP (ref ``modules.py:192-227``): ``[1 + edge_dim] ->
    32 (LayerNorm, ReLU) -> 32 (LayerNorm, ReLU) -> nfreq m_in m_out``,
    He-uniform weights; returns ``[E, m_out, m_in, nfreq]``.  LayerNorm eps
    is 1e-5, the reference's; flax's ``scale`` is torch's ``weight``."""

    def __init__(self, in_dim: int, num_freq: int, m_in: int, m_out: int, mid: int = 32):
        super().__init__()
        self.num_freq, self.m_in, self.m_out, self.mid = num_freq, m_in, m_out, mid
        self.lin0 = he_linear(in_dim, mid)
        self.bn0 = nn.LayerNorm(mid, eps=1e-5)
        self.lin1 = he_linear(mid, mid)
        self.bn1 = nn.LayerNorm(mid, eps=1e-5)
        self.lin2 = he_linear(mid, num_freq * m_in * m_out)

    def hidden(self, feat: torch.Tensor) -> torch.Tensor:
        """The last hidden layer ``[E, mid]``, which ``lin2`` maps to the profile."""
        y = torch.relu(self.bn0(self.lin0(feat)))
        return torch.relu(self.bn1(self.lin1(y)))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        # the (m_out, m_in, nfreq) order fixes the column layout of lin2
        return self.lin2(self.hidden(feat)).reshape(-1, self.m_out, self.m_in, self.num_freq)


def _edge_chunks(n_edges: int, width: int):
    step = max(1, PROFILE_CHUNK // width)
    return ((lo, min(lo + step, n_edges)) for lo in range(0, n_edges, step))


class _ProfileContraction(torch.autograd.Function):
    """``out[e] = R[e] kh[e]`` with the radial profile ``R[e] = w y[e] + b``
    seen as ``[m_out, J]``: ``y`` [E, K] (the radial MLP's last hidden
    layer), ``w`` [m_out J, K], ``b`` [m_out J], ``kh`` [E, J, O]
    contiguous -> ``[E, m_out, O]``.  The profile is formed per chunk of
    edges (``PROFILE_CHUNK`` floats), in the forward and again in the
    backward, so that no ``[E, m_out J]`` tensor is kept."""

    @staticmethod
    def forward(ctx, y, w, b, kh):
        ctx.save_for_backward(y, w, b, kh)
        e, j, o = kh.shape
        mo = w.shape[0] // j
        out = kh.new_empty((e, mo, o))
        for lo, hi in _edge_chunks(e, w.shape[0]):
            R = torch.addmm(b, y[lo:hi], w.T).view(hi - lo, mo, j)
            torch.bmm(R, kh[lo:hi], out=out[lo:hi])
        return out

    @staticmethod
    def backward(ctx, g):
        y, w, b, kh = ctx.saved_tensors
        g = g.contiguous()
        e, j, _ = kh.shape
        mo = w.shape[0] // j
        need_y, need_w, need_b, need_kh = ctx.needs_input_grad
        dy = torch.empty_like(y) if need_y else None
        dw = torch.zeros_like(w) if need_w else None
        db = torch.zeros_like(b) if need_b else None
        dkh = torch.empty_like(kh) if need_kh else None
        for lo, hi in _edge_chunks(e, w.shape[0]):
            gc = g[lo:hi]
            if need_kh:
                R = torch.addmm(b, y[lo:hi], w.T).view(hi - lo, mo, j)
                torch.bmm(R.transpose(1, 2), gc, out=dkh[lo:hi])
            dR = torch.bmm(gc, kh[lo:hi].transpose(1, 2)).view(hi - lo, mo * j)
            if need_y:
                torch.mm(dR, w, out=dy[lo:hi])
            if need_w:
                dw.addmm_(dR.T, y[lo:hi])
            if need_b:
                db += dR.sum(0)
        return dy, dw, db, dkh


class PairwiseConv(nn.Module):
    """The (d_in -> d_out) pair of a convolution (ref ``modules.py:230-266``).

    ``forward(feat, basis, h_e)`` gives the pair's messages ``[E, m_out,
    2d_out+1]`` for the gathered input features ``h_e [E, m_in, 2d_in+1]``:
    ``sum_{n,f,i} R[e,m,n,f] K[e,f,o,i] h_e[e,n,i]``, contracted over the
    basis and the features first, so that no ``[E, m_out, 2d_out+1, m_in,
    2d_in+1]`` kernel is built.  A profile wider than the radial MLP's
    hidden layer (``chunked``) is contracted by :class:`_ProfileContraction`."""

    def __init__(self, d_in: int, m_in: int, d_out: int, m_out: int, edge_dim: int = 0):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.rp = RadialFunc(1 + edge_dim, 2 * min(d_in, d_out) + 1, m_in, m_out)
        self.chunked = self.rp.lin2.out_features > self.rp.mid

    def forward(self, feat, basis, h_e):
        K = basis[(self.d_in, self.d_out)]
        if not self.chunked:
            with span("tfn.radial"):
                R = self.rp(feat)                                 # [E, mo, mi, F]
            Kh = torch.einsum("efoi,eni->efon", K, h_e)
            return torch.einsum("emnf,efon->emo", R, Kh)
        # [E, mi, F, O]: the (m_in, nfreq) order of the profile's columns
        Kh = torch.einsum("efoi,eni->enfo", K, h_e)
        kh = Kh.reshape(Kh.shape[0], -1, Kh.shape[-1]).contiguous()
        with span("tfn.radial"):
            return _ProfileContraction.apply(self.rp.hidden(feat), self.rp.lin2.weight,
                                             self.rp.lin2.bias, kh)


def gather_ends(h: Dict[int, torch.Tensor], graph: GraphBatch, at_src: bool = True):
    """``{d: (h[d][dst], h[d][src])}`` over the real edges: every degree
    gathered in one ``gather_dst`` and one ``gather_src`` of the features
    laid side by side (no kernel runs unless the features need gradients).
    With ``at_src=False`` only the dst ends are gathered (the second entry
    is ``None``): the partial convolutions have no self-interaction."""
    ne, n = graph.n_real_edges, graph.num_nodes
    degrees = sorted(h)
    flat = torch.cat([h[d].reshape(n, -1) for d in degrees], -1)
    at_dst = gather_dst(flat, graph.dst[:ne], graph.rowptr)
    at_s = (gather_src(flat, graph.src[:ne], graph.src_perm, graph.src_rowptr) if at_src
            else None)
    out, lo = {}, 0
    for d in degrees:
        shape = h[d].shape[1:]
        hi = lo + math.prod(shape)
        out[d] = (at_dst[:, lo:hi].reshape(ne, *shape),
                  None if at_s is None else at_s[:, lo:hi].reshape(ne, *shape))
        lo = hi
    return out


def _split(total: torch.Tensor, fiber: Fiber) -> Dict[int, torch.Tensor]:
    """The columns of ``[X, sum m (2d+1)]`` as ``{d: [X, m, 2d+1]}``."""
    out, lo = {}, 0
    for m, d in fiber.structure:
        hi = lo + m * (2 * d + 1)
        out[d] = total[:, lo:hi].reshape(total.shape[0], m, 2 * d + 1)
        lo = hi
    return out


class _ConvCore(nn.Module):
    """The convolution of ``GConvSE3`` (``aggregate=True``: the messages'
    mean at src) and of ``GConvSE3Partial`` (``aggregate=False``: the
    per-edge messages): pairs ``pair_{d_in}_{d_out}`` and, with
    self-interaction, ``self_{d}`` weights ``[m_out, m_in]`` drawn
    ``normal / sqrt(m_in)``."""

    def __init__(self, f_in, f_out, self_interaction: bool = False, edge_dim: int = 0,
                 aggregate: bool = True):
        super().__init__()
        self.f_in, self.f_out = Fiber(structure=f_in), Fiber(structure=f_out)
        self.edge_dim, self.aggregate = edge_dim, aggregate
        self.self_degrees = []
        for mo, do in self.f_out.structure:
            for mi, di in self.f_in.structure:
                self.add_module(f"pair_{di}_{do}", PairwiseConv(di, mi, do, mo, edge_dim))
            if self_interaction and do in self.f_in.structure_dict:
                mi = self.f_in.structure_dict[do]
                self.register_parameter(f"self_{do}", nn.Parameter(torch.empty(mo, mi)))
                self.self_degrees.append(do)

    @torch.no_grad()
    def draw_parameters_(self, generator: Optional[torch.Generator]) -> None:
        for do in self.self_degrees:
            w = getattr(self, f"self_{do}")
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[-1]))

    def forward(self, h, graph: GraphBatch, r, basis, ends=None):
        ne, n = graph.n_real_edges, graph.num_nodes
        feat = torch.cat([graph.edge_attr[:ne], r], -1) if self.edge_dim else r
        if ends is None:
            ends = gather_ends(h, graph, at_src=bool(self.self_degrees))
        msgs = {}
        for mo, do in self.f_out.structure:
            msg = 0.0
            for mi, di in self.f_in.structure:
                msg = msg + getattr(self, f"pair_{di}_{do}")(feat, basis, ends[di][0])
            if do in self.self_degrees:
                msg = msg + torch.einsum("mn,eni->emi", getattr(self, f"self_{do}"), ends[do][1])
            msgs[do] = msg
        if not self.aggregate:
            return msgs
        # one sum at src for every output degree, then the mean over real edges
        total = src_segment_sum_csr(torch.cat([m.reshape(ne, -1) for m in msgs.values()], -1),
                                    graph.src[:ne], graph.src_perm, graph.src_rowptr, n)
        count = (graph.src_rowptr[1:] - graph.src_rowptr[:-1]).clamp_min(1).float()
        return _split(total / count[:, None], self.f_out)


class GConvSE3(nn.Module):
    """TFN graph convolution (ref ``modules.py:82-189``); ``forward(h, graph,
    r, basis, ends=None) -> {d: [N, m, 2d+1]}``, where ``ends`` are
    :func:`gather_ends` of ``h`` when the caller has them already."""

    def __init__(self, f_in, f_out, self_interaction: bool = False, edge_dim: int = 0):
        super().__init__()
        self.core = _ConvCore(f_in, f_out, self_interaction, edge_dim)

    def forward(self, h, graph: GraphBatch, r, basis, ends=None):
        return self.core(h, graph, r, basis, ends)


class GConvSE3Partial(nn.Module):
    """Node -> edge partial convolution (ref ``modules.py:385-467``):
    ``forward(h, graph, r, basis, ends=None) -> {d: [E_real, m, 2d+1]}``,
    the messages of the real edges, without self-interaction."""

    def __init__(self, f_in, f_out, edge_dim: int = 0):
        super().__init__()
        self.core = _ConvCore(f_in, f_out, False, edge_dim, aggregate=False)

    def forward(self, h, graph: GraphBatch, r, basis, ends=None):
        return self.core(h, graph, r, basis, ends)


class GNormSE3(nn.Module):
    """Norm nonlinearity (ref ``modules.py:302-367``): each degree's norms
    ``[N, m]`` (clamped at ``eps``) through LayerNorm (eps 1e-5) and ReLU
    (``bn_{d}``) or, with ``num_layers >= 1``, through that many LayerNorm,
    ReLU and He-uniform linears (``bn_{d}_{i}``, ``lin_{d}_{i}``, a bias on
    the last only), times the unit directions.  torch's norm has a zero
    gradient at a zero vector, so a zero feature row (a node with no edge at
    src) gives no NaN (the JAX layer's does: ROADMAP.md §3, defect 9)."""

    def __init__(self, fiber, num_layers: int = 0, eps: float = 1e-12):
        super().__init__()
        self.fiber, self.num_layers, self.eps = Fiber(structure=fiber), num_layers, eps
        for m, d in self.fiber.structure:
            if num_layers == 0:
                self.add_module(f"bn_{d}", nn.LayerNorm(m, eps=1e-5))
            for i in range(num_layers):
                self.add_module(f"bn_{d}_{i}", nn.LayerNorm(m, eps=1e-5))
                self.add_module(f"lin_{d}_{i}", he_linear(m, m, bias=i == num_layers - 1))

    def forward(self, h: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        out = {}
        for m, d in self.fiber.structure:
            v = h[d]
            norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(self.eps)
            phase = v / norm
            t = norm[..., 0]                                      # [N, m]
            if self.num_layers == 0:
                t = torch.relu(getattr(self, f"bn_{d}")(t))
            for i in range(self.num_layers):
                t = torch.relu(getattr(self, f"bn_{d}_{i}")(t))
                t = getattr(self, f"lin_{d}_{i}")(t)
            out[d] = t[..., None] * phase
        return out


class G1x1SE3(nn.Module):
    """Per-degree linear mixing (ref ``modules.py:269-300``): weights
    ``w_{d}`` ``[m_out, m_in]`` drawn ``normal / sqrt(m_in)``."""

    def __init__(self, f_in, f_out):
        super().__init__()
        f_in = Fiber(structure=f_in)
        self.f_out = Fiber(structure=f_out)
        for mo, do in self.f_out.structure:
            self.register_parameter(f"w_{do}", nn.Parameter(torch.empty(mo, f_in.structure_dict[do])))

    @torch.no_grad()
    def draw_parameters_(self, generator: Optional[torch.Generator]) -> None:
        for _, do in self.f_out.structure:
            w = getattr(self, f"w_{do}")
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[-1]))

    def forward(self, h: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        return {do: torch.einsum("mn,xni->xmi", getattr(self, f"w_{do}"), h[do])
                for _, do in self.f_out.structure}


def fiber2head(h: Dict[int, torch.Tensor], n_heads: int, fiber: Fiber) -> torch.Tensor:
    """Degrees stacked per head: ``[X, heads, sum m (2d+1) / heads]`` (ref
    ``fibers.py`` fiber2head; the JAX ``_fiber2head``)."""
    return torch.cat([h[d].reshape(h[d].shape[0], n_heads, -1) for _, d in fiber.structure], -1)


class GMABSE3(nn.Module):
    """Multi-head SE(3) attention over the real edges (ref
    ``modules.py:470-552``): logits ``<k_e, q[src]>`` per head over
    ``sqrt(f_key.n_features)``, their softmax at src, and the values
    weighted by it summed at src (one launch of the segment-sum kernel for
    every degree).  No parameters."""

    def __init__(self, f_value, f_key, n_heads: int = 1):
        super().__init__()
        self.f_value, self.f_key = Fiber(structure=f_value), Fiber(structure=f_key)
        self.n_heads = n_heads

    def forward(self, v_edge, k_edge, q_node, graph: GraphBatch):
        ne, n, heads = graph.n_real_edges, graph.num_nodes, self.n_heads
        src, perm, rowptr = graph.src[:ne], graph.src_perm, graph.src_rowptr
        k = fiber2head(k_edge, heads, self.f_key)                # [E, H, F]
        q = fiber2head(q_node, heads, self.f_key)                # [N, H, F]
        q_src = gather_src(q.reshape(n, -1), src, perm, rowptr).reshape(k.shape)
        e = (k * q_src).sum(-1) / math.sqrt(self.f_key.n_features)
        a = segment_softmax(e, src, perm, rowptr, n)             # [E, H]
        msgs = [(a[..., None, None] * v_edge[d].reshape(ne, heads, m // heads, 2 * d + 1))
                .reshape(ne, -1) for m, d in self.f_value.structure]
        total = src_segment_sum_csr(torch.cat(msgs, -1), src, perm, rowptr, n)
        return _split(total, self.f_value)


class GSE3Res(nn.Module):
    """Attention block (ref ``modules.py:555-607``): values ``v`` and keys
    ``k`` from partial convolutions (widths ``f_out``'s over ``div``; the
    keys only in the degrees of ``f_in``), queries ``q`` by
    :class:`G1x1SE3`, and ``attn``.  The reference comments its skip
    connection out, and so does the port."""

    def __init__(self, f_in, f_out, edge_dim: int = 0, div: float = 4, n_heads: int = 1):
        super().__init__()
        f_in_ = Fiber(structure=f_in)
        f_mid_out = Fiber(dictionary={d: int(m // div)
                                      for d, m in Fiber(structure=f_out).structure_dict.items()})
        f_mid_in = Fiber(dictionary={d: m for d, m in f_mid_out.structure_dict.items()
                                     if d in f_in_.structure_dict})
        self.v = GConvSE3Partial(f_in, f_mid_out.structure, edge_dim)
        self.k = GConvSE3Partial(f_in, f_mid_in.structure, edge_dim)
        self.q = G1x1SE3(f_in, f_mid_in.structure)
        self.attn = GMABSE3(f_mid_out.structure, f_mid_in.structure, n_heads)

    def forward(self, h, graph: GraphBatch, r, basis, ends=None):
        """``{d: [N, m, 2d+1]}``; ``ends`` are :func:`gather_ends` of ``h``
        (the dst ends suffice) when the caller has them."""
        if ends is None:
            ends = gather_ends(h, graph, at_src=False)
        v = self.v(h, graph, r, basis, ends)
        k = self.k(h, graph, r, basis, ends)
        return self.attn(v, k, self.q(h), graph)
