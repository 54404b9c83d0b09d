"""Plain FastTFN forward for one graph (reference ``models/FastTFN.py``):
FastEGNN's virtual-node block around a one-layer, one-channel TFN on
(charges as type 0, velocity as type 1) whose type-1 output moves the
positions, in PyTorch f32: no kernel, no batching, no padding.  The
parameters are named as the port's ``state_dict`` (the reference's keys
outside ``tfn_layer``, the TFN's own names inside it).

The TFN of a layer (``conv_out`` of degrees 0, 1 -> 1, with
self-interaction): over the real edges ``i -> j`` with ``d = x_j - x_i``
(the batch's input positions), the kernel basis ``K_(a,1)[f] = Y_J(d) .
CG(a, J, 1)`` for ``J = |a - 1| .. a + 1``, the radial profile ``R_a(|d|)``
(``Linear, LayerNorm, ReLU`` twice, then ``Linear`` to the ``2 min(a, 1) +
1`` frequencies), and the message ``sum_a sum_f R_a[f] K_(a,1)[f] h_a(i)
+ W_self h_1(j)``, averaged at ``j`` (the edge's src).  Type-1 features
are in the real-harmonic order (y, z, x) inside.

Per layer: ``x += TFN(...) - pull``, the virtual block, and (except in the
last layer, whose features nothing reads) the real edges' ``phi_e``
messages averaged at their dst into the node update.
"""

from __future__ import annotations

import functools

import torch
from torch.nn.functional import layer_norm, linear, relu

from benchmark.reference.so3 import real_clebsch_gordan, real_sph_harm_all
from benchmark.reference.virtual import edge_mean, embed, feature_updates, mlp2, virtual_block

TO_SH, FROM_SH = [1, 2, 0], [2, 0, 1]


@functools.lru_cache(maxsize=None)
def _cg(a: int, J: int, b: int, device) -> torch.Tensor:
    return torch.as_tensor(real_clebsch_gordan(a, J, b), dtype=torch.float32, device=device)


def kernel_basis(d: torch.Tensor):
    """``{(a, 1): [E, nfreq, 3, 2a + 1]}`` for input degrees a = 0, 1."""
    Y = real_sph_harm_all(2, d)
    return {(a, 1): torch.stack([torch.einsum("em,imo->eoi", Y[J], _cg(a, J, 1, d.device))
                                 for J in range(abs(a - 1), a + 2)], 1)
            for a in (0, 1)}


def radial(p, pre, r):
    y = relu(layer_norm(linear(r, p[f"{pre}.lin0.weight"], p[f"{pre}.lin0.bias"]), (32,),
                        p[f"{pre}.bn0.weight"], p[f"{pre}.bn0.bias"], eps=1e-5))
    y = relu(layer_norm(linear(y, p[f"{pre}.lin1.weight"], p[f"{pre}.lin1.bias"]), (32,),
                        p[f"{pre}.bn1.weight"], p[f"{pre}.bn1.bias"], eps=1e-5))
    return linear(y, p[f"{pre}.lin2.weight"], p[f"{pre}.lin2.bias"])     # [E, nfreq]


def tfn_move(p, pre, g, feats, r, K):
    """The layer's TFN output as plain (x, y, z) vectors ``[n, 3]``."""
    dst, src, n = g.dst, g.src, g.n
    msg = torch.einsum("mk,eki->emi", p[f"{pre}.self_1"], feats[1][src])
    for a in (0, 1):
        R = radial(p, f"{pre}.pair_{a}_1.rp", r)                  # [E, nfreq]
        msg = msg + torch.einsum("ef,efoi,eki->eko", R, K[(a, 1)], feats[a][dst])
    cnt = torch.zeros(n, device=r.device).index_add_(
        0, src, torch.ones_like(r[:, 0])).clamp_min(1.0)
    out = torch.zeros(n, 3, device=r.device).index_add_(0, src, msg[:, 0, :]) / cnt[:, None]
    return out[:, FROM_SH]


def forward(p, g, cfg):
    """``(x [n, 3], X [C, 3])`` of one graph."""
    gravity = (torch.tensor(cfg["gravity"], dtype=torch.float32, device=g.loc.device)
               if cfg.get("gravity") is not None else None)
    h, vx, vh = embed(p, g, cfg["virtual_channels"])
    x = g.loc
    d = g.loc[g.src] - g.loc[g.dst]
    r, K = d.norm(dim=1, keepdim=True), kernel_basis(d)
    feats = {0: g.node_attr[:, :, None], 1: g.vel[:, TO_SH][:, None, :]}
    L = cfg["n_layers"]
    for i in range(L):
        pre = f"gcl_{i}"
        x_new = x + tfn_move(p, f"{pre}.tfn_layer.conv_out.core", g, feats, r, K)
        pull, vx_new, mv = virtual_block(p, pre, h, x, vx, vh)
        x_new = x_new - pull
        if gravity is not None:
            x_new = x_new + mlp2(p, f"{pre}.gravity_mlp", h) * gravity
        if i < L - 1:
            diff = x[g.dst] - x[g.src]
            m = mlp2(p, f"{pre}.edge_mlp", torch.cat(
                [h[g.dst], h[g.src], (diff * diff).sum(1, keepdim=True), g.edge_attr], 1), True)
            h, vh = feature_updates(p, pre, h, vh, edge_mean(m, g.dst, g.n), mv)
        x, vx = x_new, vx_new
    return x, vx
