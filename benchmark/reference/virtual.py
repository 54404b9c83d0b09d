"""The real <-> virtual block that every Fast* layer runs (reference
``models/FastEGNN.py:111-177``), for one graph in plain PyTorch f32:

- ``m_ic = phi_ev([h_i, H_c, |X_c - x_i|, G_c])`` with ``G = M M^T``,
  ``M = X - mean_i x_i``;
- the pull on the real nodes ``mean_c (X_c - x_i) phi_xv(m_ic)`` and the
  virtual update ``X_c + mean_i (X_c - x_i) phi_X(m_ic)``;
- ``H_c += phi_hv([H_c, mean_i m_ic])``; ``h_i += phi_h([h_i, agg_i, m_i])``
  with ``m_i`` the ``[H, C]``-major flattening of ``m_ic``.

Parameters are named as the reference's ``state_dict``.
"""

from __future__ import annotations

import torch
from torch.nn.functional import linear, silu


def mlp2(p, name, z, act_final=False):
    """``Linear, SiLU, Linear[, SiLU]`` with the parameters ``name.0`` / ``name.2``."""
    z = linear(silu(linear(z, p[f"{name}.0.weight"], p[f"{name}.0.bias"])),
               p[f"{name}.2.weight"], p.get(f"{name}.2.bias"))
    return silu(z) if act_final else z


def virtual_block(p, pre, h, x, vx, vh):
    """``(pull [n, 3], X_new [C, 3], m [n, C, H])`` of one layer."""
    n, H = h.shape
    C = vx.shape[0]
    vdiff = vx[None, :, :] - x[:, None, :]                     # [n, C, 3]
    vrad = vdiff.norm(dim=2, keepdim=True)                     # [n, C, 1]
    mx = vx - x.mean(0)
    gram = mx @ mx.T                                            # [C, C]
    ev_in = torch.cat([h[:, None, :].expand(n, C, H), vh[None].expand(n, C, H), vrad,
                       gram[None].expand(n, C, C)], 2)
    mv = mlp2(p, f"{pre}.edge_mlp_virtual", ev_in, True)       # [n, C, H]
    pull = (vdiff * mlp2(p, f"{pre}.coord_mlp_r_virtual", mv)).mean(1)
    vx_new = vx + (vdiff * mlp2(p, f"{pre}.coord_mlp_v_virtual", mv)).mean(0)
    return pull, vx_new, mv


def feature_updates(p, pre, h, vh, agg_m, mv):
    """``(h_new, H_new)`` after the node and virtual feature MLPs."""
    n, C, H = mv.shape
    vh_new = vh + mlp2(p, f"{pre}.node_mlp_virtual", torch.cat([vh, mv.mean(0)], 1))
    h_new = h + mlp2(p, f"{pre}.node_mlp",
                     torch.cat([h, agg_m, mv.transpose(1, 2).reshape(n, H * C)], 1))
    return h_new, vh_new


def edge_mean(values, dst, n):
    """The mean of edge rows over each node's incoming edges (0 where none)."""
    cnt = torch.zeros(n, device=values.device).index_add_(
        0, dst, torch.ones(dst.shape[0], device=values.device)).clamp_min(1.0)
    out = torch.zeros(n, values.shape[1], device=values.device).index_add_(0, dst, values)
    return out / cnt[:, None]


def embed(p, g, C):
    """``(h, X, H)`` before the first layer: the embedded node features,
    the virtual nodes at the graph's mean position, their learned features."""
    h = linear(g.node_feat, p["embedding_in.weight"], p["embedding_in.bias"])
    vx = g.loc.mean(0, keepdim=True).expand(C, 3)
    vh = p["virtual_node_feat"][0].T                            # [C, H]
    return h, vx, vh
