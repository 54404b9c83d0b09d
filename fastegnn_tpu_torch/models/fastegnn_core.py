"""The FastEGNN layer math, one copy (counterpart of
``fastegnn_tpu/models/fastegnn_core.py``).

- :func:`edge_messages`: the per-edge chain phi_e -> (attention) -> phi_x
  gate -> coordinate translation (reference ``models/FastEGNN.py:102-108,
  122-133, 180-189``), for the layer variants the fused edge block does not
  cover (attention, normalize, tanh, hidden != 64).
- :func:`virtual_and_node_update`: everything after edge aggregation — the
  dense real <-> virtual block, the velocity / gravity gates, the virtual
  coordinate and feature updates and the node feature update (reference
  ``:111-177, 192-223``).

Both read the weights of an ``EGCLVel`` (``models/fast_egnn.py``) in the
reference layout.  Virtual tensors are channel-second: coordinates
``[B, C, 3]``, features ``[B, C, H]``, per-node virtual messages
``[n, C, H]``.  The per-graph gather is a broadcast over the batch's
``[B, n_max]`` node layout (:func:`per_graph_take`) and the per-graph pool a
masked ``index_add_`` mean.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.nn.functional import silu

from fastegnn_tpu_torch.models.nn import linear
from fastegnn_tpu_torch.ops.segment import graph_mean_pool


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


def edge_messages(cfg: LayerCfg, layer, h_dst, h_src, x_dst, x_src, edge_attr):
    """``(m_e [E, H] in the compute dtype, trans [E, 3] f32)`` for gathered
    edges: the quantities the fused edge block sums per destination."""
    cd = cfg.compute_dtype
    coord_diff = x_dst - x_src
    radial = (coord_diff**2).sum(-1, keepdim=True)
    if cfg.normalize:
        coord_diff = coord_diff / (radial.sqrt().detach() + cfg.epsilon)
    e_in = torch.cat([h_dst, h_src, radial, edge_attr], -1)
    z = silu(linear(e_in, layer.edge_mlp[0], cd))
    m_e = silu(linear(z, layer.edge_mlp[2], cd))
    if cfg.attention:
        m_e = m_e * torch.sigmoid(linear(m_e, layer.att_mlp[0], cd))
    gate = linear(silu(linear(m_e, layer.coord_mlp_r[0], cd)),
                  layer.coord_mlp_r[2], cd).float()
    if cfg.tanh:
        gate = torch.tanh(gate)
    return m_e, coord_diff * gate


def _gate_head(mlp, z, cd):
    """``Linear, SiLU, Linear`` head evaluated in ``cd``, returned in f32."""
    return linear(silu(linear(z, mlp[0], cd)), mlp[2], cd).float()


def virtual_and_node_update(
    cfg: LayerCfg,
    layer,
    h: torch.Tensor,            # [n, H]
    x: torch.Tensor,            # [n, 3]
    v: torch.Tensor,            # [n, 3]
    vx: torch.Tensor,           # [B, C, 3] virtual coords
    vh: torch.Tensor,           # [B, C, H] virtual feats
    graph_id: torch.Tensor,     # [n] in [0, B]; B = padding
    node_mask: torch.Tensor,    # [n] bool
    agg_x: torch.Tensor,        # [n, 3] aggregated edge translations
    agg_e: torch.Tensor,        # [n, H] aggregated edge messages (mean)
    gravity: Optional[torch.Tensor] = None,   # [3]
    node_attr: Optional[torch.Tensor] = None,
):
    """Everything after edge aggregation; returns ``(h, x, vx, vh)``."""
    H, C = cfg.hidden, cfg.virtual_channels
    cd = cfg.compute_dtype
    n, B = h.shape[0], vx.shape[0]

    def take(table):
        return per_graph_take(table, n)

    def pool(z):
        return graph_mean_pool(z.float(), graph_id, B, node_mask)

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

    gate_xv = _gate_head(layer.coord_mlp_r_virtual, m_v, cd)[..., 0]   # [n, C]
    gate_X = _gate_head(layer.coord_mlp_v_virtual, m_v, cd)[..., 0]
    if cfg.tanh:
        gate_xv, gate_X = torch.tanh(gate_xv), torch.tanh(gate_X)

    x_new = x + agg_x
    x_new = x_new - (vdiff * gate_xv[..., None]).sum(1) * (1.0 / C)
    x_new = x_new + _gate_head(layer.coord_mlp_vel, h, cd) * v
    if cfg.has_gravity:
        x_new = x_new + _gate_head(layer.gravity_mlp, h, cd) * gravity

    vx_new = vx + pool((vdiff * gate_X[..., None]).reshape(n, 3 * C).to(cd)).reshape(B, C, 3)
    pool_mv = pool(m_v.reshape(n, C * H)).reshape(B, C, H)
    dvh = _gate_head(layer.node_mlp_virtual, torch.cat([vh, pool_mv], -1), cd)
    vh_new = vh + dvh if cfg.residual else dvh

    # node MLP input: the virtual messages flatten [H, C]-major, the
    # reference layout of node_mlp.0's columns (models/FastEGNN.py:157)
    parts = [h, agg_e, m_v.transpose(1, 2).reshape(n, H * C)]
    if node_attr is not None:
        parts.append(node_attr)
    dh = _gate_head(layer.node_mlp, torch.cat([p.to(cd) for p in parts], -1), cd)
    h_new = h + dh if cfg.residual else dh
    return h_new, x_new, vx_new, vh_new
