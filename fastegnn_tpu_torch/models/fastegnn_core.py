"""The layer math of the Fast* family, one copy (counterpart of
``fastegnn_tpu/models/fastegnn_core.py`` and of the copies in
``fast_rf.py`` and ``schnet.py`` there).

- :func:`gather_edge_ends`, :func:`edge_features`, :func:`edge_messages`:
  the per-edge chain phi_e -> (attention) -> phi_x gate -> coordinate
  translation (reference ``models/FastEGNN.py:102-108, 122-133,
  180-189``), for the layer variants the fused edge block does not cover
  (attention, normalize, tanh, hidden != 64), for FastSchNet and FastTFN.
- :func:`virtual_block`: the dense real <-> virtual block every Fast*
  layer runs (reference ``:111-150``), its heads through :func:`gate_head`, with
  :func:`virtual_feature_update` and :func:`node_feature_update` after it.
- :func:`virtual_and_node_update`: FastEGNN's layer after edge
  aggregation (reference ``:111-177, 192-223``).
- :func:`fits_fused` and :func:`real_edge_sums`: the real-edge dispatch of
  the layers with an edge MLP and a coordinate gate (FastEGNN, FastRF,
  VNEGNN's A2A cell), the fused edge block or the CSR branch.
- :func:`segment_mean_at_dst`: a dst mean of real-edge rows on the
  segment-sum kernel (FastSchNet, FastTFN).
- :class:`VirtualNodeModel`: the model skeleton of every virtual-node
  model (FastEGNN, FastRF, FastSchNet, FastTFN, VNEGNN).

They read a layer's weights in the reference layout (``EGCLVel``,
``RFGCLVel``, ``SchNetGCL``, ``TFNGCLVel``, VNEGNN's cells).  Virtual tensors are channel-second:
coordinates ``[B, C, 3]``, features ``[B, C, H]``, per-node virtual
messages ``[n, C, H]``.  The per-graph gather is a broadcast over the
batch's ``[B, n_max]`` node layout (:func:`per_graph_take`) and the
per-graph pool a masked sum over that layout (:func:`per_graph_pool`), unless the caller passes its
own ``take`` / ``pool`` (the owner-sharded path, ``parallel/owner_graph.py``,
whose rows are one shard of the batch).

Under a profiler the layer parts record spans (``utils/profiling.py::span``):
``model.embed`` (:meth:`VirtualNodeModel.embed`), ``layer.edges``
(:func:`real_edge_sums`), ``layer.virtual`` (:func:`virtual_block`) and
``layer.update`` (the coordinate and feature updates after it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn.functional import silu

from fastegnn_tpu_torch import resolve_device
from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.models.nn import init_parameters_, linear
from fastegnn_tpu_torch.ops.edge_kernel import FE_MAX, H as EDGE_H, fused_edge_block
from fastegnn_tpu_torch.ops.spmm import gather_dst, gather_src, sorted_segment_sum_csr
from fastegnn_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class LayerCfg:
    hidden: int
    virtual_channels: int
    residual: bool = True
    attention: bool = False
    normalize: bool = False
    tanh: bool = False
    coords_agg: str = "mean"
    has_gravity: bool = False
    epsilon: float = 1e-8
    compute_dtype: torch.dtype = torch.float32


def per_graph_take(table: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``table [B, ...]`` -> ``[N, ...]``: each node's row of its graph.

    A batch lays graph ``g`` out on node rows ``[g * n_max, (g + 1) * n_max)``
    (``graph.batch_graphs``), so the per-graph gather is a broadcast over
    that layout and its backward a plain sum over ``n_max`` — no scatter.
    Padded rows read their slot's graph; they are masked downstream.
    """
    B = table.shape[0]
    rest = table.shape[1:]
    return table[:, None].expand(B, n_nodes // B, *rest).reshape(n_nodes, *rest)


def per_graph_pool(z: torch.Tensor, node_mask: torch.Tensor, n_graphs: int) -> torch.Tensor:
    """``z [N, ...]`` -> ``[B, ...]``: each graph's mean over its real node
    rows, the dual of :func:`per_graph_take` over the same layout (the JAX
    ``graph_mean_pool``).  A sum over the ``n_max`` axis, which the card
    reduces in a fixed order; ``index_add_`` adds with float atomics there,
    so one batch's pool, and the step's losses, could change in the last
    bit from one call to the next."""
    n, rest = z.shape[0], z.shape[1:]
    m = node_mask.to(z.dtype).reshape(n_graphs, n // n_graphs, *(1,) * len(rest))
    total = (z.reshape(n_graphs, n // n_graphs, *rest) * m).sum(1)
    return total / m.sum(1).clamp_min(1.0)


def gather_edge_ends(graph, h: torch.Tensor, x: torch.Tensor):
    """``(h_dst, h_src, x_dst, x_src)`` over the real edges: one gather of
    ``[h | x]`` at dst and one at src, whose backwards are the segment-sum
    kernel over the dst CSR and over the src-sorted CSR (``ops/spmm.py``).
    Padded edges, whose ``dst`` is the out-of-range sentinel, are not read."""
    ne, H = graph.n_real_edges, h.shape[1]
    hx = torch.cat([h, x], -1)                                  # [N, H+3]
    hx_d = gather_dst(hx, graph.dst[:ne], graph.rowptr)
    hx_s = gather_src(hx, graph.src[:ne], graph.src_perm, graph.src_rowptr)
    return hx_d[:, :H], hx_s[:, :H], hx_d[:, H:], hx_s[:, H:]


def segment_mean_at_dst(data: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
    """``[N, F]`` mean of the real edges' rows ``data`` over each node's
    incoming edges (the segment-sum kernel over the dst CSR)."""
    n = graph.num_nodes
    total = sorted_segment_sum_csr(data, graph.dst[:graph.n_real_edges], graph.rowptr, n)
    return total / graph.dst_count.clamp_min(1.0)[:, None]


def edge_features(cfg: LayerCfg, layer, h_dst, h_src, radial, edge_attr):
    """``m_e [E, H]`` in the compute dtype: phi_e on ``[h_dst, h_src, radial,
    edge_attr]``, times the attention gate when the layer has one."""
    cd = cfg.compute_dtype
    e_in = torch.cat([h_dst, h_src, radial, edge_attr], -1)
    z = silu(linear(e_in, layer.edge_mlp[0], cd))
    m_e = silu(linear(z, layer.edge_mlp[2], cd))
    if cfg.attention:
        m_e = m_e * torch.sigmoid(linear(m_e, layer.att_mlp[0], cd))
    return m_e


def edge_messages(cfg: LayerCfg, layer, h_dst, h_src, x_dst, x_src, edge_attr, gate_mlp):
    """``(m_e [E, H] in the compute dtype, trans [E, 3] f32)`` for gathered
    edges, with the coordinate gate head ``gate_mlp``: the quantities the
    fused edge block sums per destination."""
    cd = cfg.compute_dtype
    coord_diff = x_dst - x_src
    radial = (coord_diff**2).sum(-1, keepdim=True)
    if cfg.normalize:
        coord_diff = coord_diff / (radial.sqrt().detach() + cfg.epsilon)
    m_e = edge_features(cfg, layer, h_dst, h_src, radial, edge_attr)
    gate = gate_head(gate_mlp, m_e, cd)
    if cfg.tanh:
        gate = torch.tanh(gate)
    return m_e, coord_diff * gate


def gate_head(mlp, z, cd=torch.float32):
    """``Linear, SiLU, Linear`` head evaluated in ``cd``, returned in f32."""
    return linear(silu(linear(z, mlp[0], cd)), mlp[2], cd).float()


def node_gate(mlp, h, cd):
    """The velocity / gravity head: ``Linear, SiLU`` and the last product in
    ``cd``, then its bias added in f32 after the product, as the JAX package
    does (``fastegnn_tpu/models/fastegnn_core.py:296-305``)."""
    last = mlp[2]
    z = silu(linear(h, mlp[0], cd))
    return torch.nn.functional.linear(z, last.weight.to(cd)).float() + last.bias.float()


@dataclass
class VirtualBlock:
    """What the dense real <-> virtual block gives a layer."""

    vdiff: torch.Tensor             # [n, C, 3] virtual minus real coordinates
    pull: torch.Tensor              # [n, 3] mean over C of vdiff * phi_xv(m_v)
    vx_new: torch.Tensor            # [B, C, 3] updated virtual coordinates
    m_v: torch.Tensor               # [n, C, H] real -> virtual messages
    pool_mv: Optional[torch.Tensor]  # [B, C, H] their per-graph mean, if asked


def virtual_block(cfg: LayerCfg, layer, h, x, vx, vh, node_mask,
                  pool_messages: bool = True, take=None, pool=None) -> VirtualBlock:
    """The dense real <-> virtual block of FastEGNN, FastRF and FastSchNet
    (the JAX package keeps a copy in each: ``fast_egnn.py``,
    ``fast_rf.py:51-107``, ``schnet.py:201-267``): vdiff, vrad and the gram
    matrix, phi_ev with its first layer split by input block, the gate heads
    phi_xv and phi_X, the virtual coordinate update and, when
    ``pool_messages``, the pooled messages.  The caller subtracts ``pull``
    from the real coordinates.

    ``take(table [B, ...]) -> [n, ...]`` and ``pool(z [n, ...]) -> [B, ...]``
    (the f32 per-graph mean over real nodes) default to the whole batch's
    :func:`per_graph_take` and :func:`per_graph_pool`; the owner-sharded path
    passes a take by ``graph_id`` and a pool summed over its shards (the
    JAX ``virtual_and_node_update(..., take=, pool=)``)."""
    with span("layer.virtual"):
        H, C = cfg.hidden, cfg.virtual_channels
        cd = cfg.compute_dtype
        n, B = h.shape[0], vx.shape[0]

        if take is None:
            def take(table):
                return per_graph_take(table, n)

        if pool is None:
            def pool(z):
                return per_graph_pool(z.float(), node_mask, B)

        vdiff = take(vx.float()) - x[:, None, :]                  # [n, C, 3]
        vrad = (vdiff * vdiff).sum(-1).sqrt()                      # [n, C]
        m_x = vx - pool(x)[:, None, :]
        gram = torch.einsum("bci,bdi->bcd", m_x, m_x)              # [B, C, C]

        # phi_ev on [h, vh, vrad, gram]; the first layer is split by input block
        ev0 = layer.edge_mlp_virtual[0]
        W0 = ev0.weight.to(cd)                                      # [H, 2H+1+C]
        zh = h.to(cd) @ W0[:, :H].T                                 # [n, H]
        zb = (vh.to(cd) @ W0[:, H:2 * H].T + gram.to(cd) @ W0[:, 2 * H + 1:].T
              + ev0.bias.to(cd))                                    # [B, C, H]
        z1 = zh[:, None, :] + vrad[..., None].to(cd) * W0[:, 2 * H] + take(zb)
        m_v = silu(linear(silu(z1), layer.edge_mlp_virtual[2], cd))  # [n, C, H]
        if cfg.attention:
            m_v = m_v * torch.sigmoid(linear(m_v, layer.att_mlp_virtual[0], cd))

        gate_xv = gate_head(layer.coord_mlp_r_virtual, m_v, cd)[..., 0]   # [n, C]
        gate_X = gate_head(layer.coord_mlp_v_virtual, m_v, cd)[..., 0]
        if cfg.tanh:
            gate_xv, gate_X = torch.tanh(gate_xv), torch.tanh(gate_X)

        pull = (vdiff * gate_xv[..., None]).sum(1) * (1.0 / C)
        vx_new = vx + pool((vdiff * gate_X[..., None]).reshape(n, 3 * C).to(cd)).reshape(B, C, 3)
        pool_mv = pool(m_v.reshape(n, C * H)).reshape(B, C, H) if pool_messages else None
        return VirtualBlock(vdiff=vdiff, pull=pull, vx_new=vx_new, m_v=m_v, pool_mv=pool_mv)


def virtual_feature_update(cfg: LayerCfg, layer, vh, pool_mv):
    """``vh [B, C, H]`` after phi_hv on ``[vh, pooled m_v]``."""
    dvh = gate_head(layer.node_mlp_virtual, torch.cat([vh, pool_mv], -1), cfg.compute_dtype)
    return vh + dvh if cfg.residual else dvh


def node_feature_update(cfg: LayerCfg, layer, h, agg_e, m_v, node_attr=None):
    """``h [n, H]`` after phi_h on ``[h, agg_e, m_v (, node_attr)]``.  The
    virtual messages flatten [H, C]-major, the reference layout of
    node_mlp.0's columns (models/FastEGNN.py:157)."""
    n, C, H = m_v.shape
    parts = [h, agg_e, m_v.transpose(1, 2).reshape(n, H * C)]
    if node_attr is not None:
        parts.append(node_attr)
    cd = cfg.compute_dtype
    dh = gate_head(layer.node_mlp, torch.cat([p.to(cd) for p in parts], -1), cd)
    return h + dh if cfg.residual else dh


def virtual_and_node_update(
    cfg: LayerCfg,
    layer,
    h: torch.Tensor,            # [n, H]
    x: torch.Tensor,            # [n, 3]
    v: torch.Tensor,            # [n, 3]
    vx: torch.Tensor,           # [B, C, 3] virtual coords
    vh: torch.Tensor,           # [B, C, H] virtual feats
    graph_id: torch.Tensor,     # [n] in [0, B]; the JAX signature's, unused here
    node_mask: torch.Tensor,    # [n] bool
    agg_x: torch.Tensor,        # [n, 3] aggregated edge translations
    agg_e: torch.Tensor,        # [n, H] aggregated edge messages (mean)
    gravity: Optional[torch.Tensor] = None,   # [3]
    node_attr: Optional[torch.Tensor] = None,
    take=None,
    pool=None,
):
    """FastEGNN's layer after edge aggregation; returns ``(h, x, vx, vh)``.
    ``take`` / ``pool``: :func:`virtual_block`'s."""
    cd = cfg.compute_dtype
    vb = virtual_block(cfg, layer, h, x, vx, vh, node_mask, take=take, pool=pool)
    with span("layer.update"):
        x_new = x + agg_x
        x_new = x_new - vb.pull
        x_new = x_new + node_gate(layer.coord_mlp_vel, h, cd) * v
        if cfg.has_gravity:
            x_new = x_new + node_gate(layer.gravity_mlp, h, cd) * gravity
        vh_new = virtual_feature_update(cfg, layer, vh, vb.pool_mv)
        h_new = node_feature_update(cfg, layer, h, agg_e, vb.m_v, node_attr)
    return h_new, x_new, vb.vx_new, vh_new


def fits_fused(cfg: LayerCfg, edge_attr_dim: int) -> bool:
    """Whether the fused edge block covers a layer: hidden 64, at most 3
    edge attributes, no attention, normalize or tanh, mean aggregation."""
    return (cfg.hidden == EDGE_H and edge_attr_dim <= FE_MAX and not cfg.attention
            and not cfg.normalize and not cfg.tanh and cfg.coords_agg == "mean")


def real_edge_sums(layer, h, x, graph: GraphBatch, gate_mlp=None, csr: bool = False):
    """``(m_sum [N, H], trans_sum [N, 3])``: the sums over each node's
    incoming real edges of the edge messages and coordinate translations of
    a layer with ``edge_mlp`` and the gate head ``gate_mlp`` (by default
    ``coord_mlp_r``: FastEGNN, FastRF; VNEGNN's A2A cell passes its
    ``coord_mlp``).  The fused edge block where ``layer.fused`` and not
    ``csr``, else the CSR branch: the edge ends gathered,
    :func:`edge_messages`, and one segment-sum of ``[m_e | trans]`` (the
    translations rounded to the compute dtype).

    ``graph`` needs only ``rowptr``, ``src``, ``dst``, ``edge_attr``,
    ``n_real_edges``, ``src_perm`` and ``src_rowptr``, over ``N`` = the
    rows of ``h`` and ``x``: a batch, or an owner shard whose table holds
    halo rows after its own (``parallel/owner_graph.py``)."""
    with span("layer.edges"):
        cfg = layer.cfg
        gate_mlp = layer.coord_mlp_r if gate_mlp is None else gate_mlp
        if layer.fused and not csr:
            e0, e2, g0, g2 = layer.edge_mlp[0], layer.edge_mlp[2], gate_mlp[0], gate_mlp[2]
            return fused_edge_block(
                h, x, graph.rowptr, graph.src, graph.dst, graph.edge_attr,
                e0.weight.t(), e0.bias, e2.weight.t(), e2.bias,
                g0.weight.t(), g0.bias, g2.weight.t(),
                compute_dtype=cfg.compute_dtype)
        ne, H = graph.n_real_edges, cfg.hidden
        h_d, h_s, x_d, x_s = gather_edge_ends(graph, h, x)
        m_e, trans = edge_messages(cfg, layer, h_d, h_s, x_d, x_s, graph.edge_attr[:ne], gate_mlp)
        summed = sorted_segment_sum_csr(
            torch.cat([m_e, trans.to(m_e.dtype)], -1), graph.dst[:ne], graph.rowptr, h.shape[0])
        return summed[:, :H], summed[:, H:]


class VirtualNodeModel(nn.Module):
    """What the virtual-node models share (reference
    ``models/FastEGNN.py:226-276``): the input embedding ``embedding_in``,
    the learned virtual features ``virtual_node_feat`` [1, H, C], the
    layers ``gcl_0 .. gcl_{L-1}`` that ``make_layer()`` builds (or, where
    it returns a dict of cells, ``{name}_0 .. {name}_{L-1}`` for each, as
    VNEGNN's ``A2A_i``, ``A2V_i``, ``V2A_i``), and the gravity buffer.  Parameters are drawn
    from ``generator`` on the CPU, then the model moves to ``device`` (CUDA
    unless ``"cpu"`` is asked for)."""

    def __init__(self, node_feat_dim: int, hidden: int, virtual_channels: int,
                 n_layers: int, gravity: Optional[Sequence[float]], make_layer,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if virtual_channels <= 0:
            raise ValueError("virtual_channels must be > 0")
        dev = resolve_device(device)
        H, C = hidden, virtual_channels
        self.hidden, self.virtual_channels, self.n_layers = H, C, n_layers
        self.embedding_in = nn.Linear(node_feat_dim, H)
        self.virtual_node_feat = nn.Parameter(torch.empty(1, H, C))
        for i in range(n_layers):
            made = make_layer()
            for name, cell in (made.items() if isinstance(made, dict) else [("gcl", made)]):
                self.add_module(f"{name}_{i}", cell)
        self.register_buffer(
            "gravity", None if gravity is None
            else torch.tensor(gravity, dtype=torch.float32), persistent=False)
        init_parameters_(self, generator)
        with torch.no_grad():
            nn.init.normal_(self.virtual_node_feat, generator=generator)
        self.to(dev)

    def layers(self):
        return [getattr(self, f"gcl_{i}") for i in range(self.n_layers)]

    def embed(self, graph: GraphBatch):
        """``(h [N, H], vx [B, C, 3], vh [B, C, H])`` before the first layer."""
        B, C, H = graph.n_graphs, self.virtual_channels, self.hidden
        with span("model.embed"):
            vh = self.virtual_node_feat.transpose(1, 2).expand(B, C, H)
            return self.embedding_in(graph.node_feat), graph.loc_mean.transpose(1, 2), vh
