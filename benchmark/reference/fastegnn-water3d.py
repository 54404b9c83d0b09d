"""Plain FastEGNN forward for one graph (reference ``models/FastEGNN.py``,
``E_GCL_vel`` and ``FastEGNN``), written from its equations in PyTorch
f32: no kernel, no batching, no padding.  The parameters are named as the
reference's ``state_dict`` (``gcl_0.edge_mlp.0.weight``, ...).

Per layer, with real edges ``i <- j``: ``m_ij = phi_e([h_i, h_j, |x_i -
x_j|^2, a_ij])`` and ``t_ij = (x_i - x_j) phi_x(m_ij)``, both averaged
over ``i``'s incoming edges; the virtual block (``virtual.py``); then
``x_i += mean_j t_ij - pull_i + phi_v(h_i) v_i + phi_g(h_i) g`` and the
feature updates.  The model returns the last layer's ``x`` and ``X``.
"""

from __future__ import annotations

import torch

from benchmark.reference.virtual import edge_mean, embed, feature_updates, mlp2, virtual_block


def layer(p, pre, h, x, v, vx, vh, g, gravity):
    n = h.shape[0]
    dst, src = g.dst, g.src
    diff = x[dst] - x[src]
    radial = (diff * diff).sum(1, keepdim=True)
    m = mlp2(p, f"{pre}.edge_mlp", torch.cat([h[dst], h[src], radial, g.edge_attr], 1), True)
    trans = diff * mlp2(p, f"{pre}.coord_mlp_r", m)
    agg = edge_mean(torch.cat([trans, m], 1), dst, n)
    pull, vx_new, mv = virtual_block(p, pre, h, x, vx, vh)
    x_new = x + agg[:, :3] - pull + mlp2(p, f"{pre}.coord_mlp_vel", h) * v
    if gravity is not None:
        x_new = x_new + mlp2(p, f"{pre}.gravity_mlp", h) * gravity
    h_new, vh_new = feature_updates(p, pre, h, vh, agg[:, 3:], mv)
    return h_new, x_new, vx_new, vh_new


def forward(p, g, cfg):
    """``(x [n, 3], X [C, 3])`` of one graph."""
    gravity = (torch.tensor(cfg["gravity"], dtype=torch.float32, device=g.loc.device)
               if cfg.get("gravity") is not None else None)
    h, vx, vh = embed(p, g, cfg["virtual_channels"])
    x = g.loc
    for i in range(cfg["n_layers"]):
        h, x, vx, vh = layer(p, f"gcl_{i}", h, x, g.vel, vx, vh, g, gravity)
    return x, vx
