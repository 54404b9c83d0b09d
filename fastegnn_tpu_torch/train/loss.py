"""Losses: masked coordinate MSE and the MMD virtual-node loss
(counterpart of ``fastegnn_tpu/train/loss.py``; reference ``utils/train.py``).

- training loss = MSE + ``weight * (l_vv - l_rv)`` with
  ``l_vv = sum(k_vv)/B/C/C`` and ``l_rv = 2*sum(k_rv)/B/S/C``;
- the kernel is ``exp(-||x - y|| / (2 sigma^2))`` — the unsquared distance;
- the random node sample comes from the caller: ``scores`` [B, n_max]
  uniform draws for per-graph sampling (the ``sample * C`` smallest scores
  among each graph's real nodes), or ``perm`` [n_max], a permutation shared
  by the batch.  So a test can hand both packages the same draw.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over real nodes only."""
    m = mask.to(pred.dtype)[:, None]
    se = ((pred - target) ** 2) * m
    return se.sum() / (m.sum() * pred.shape[-1]).clamp_min(1.0)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, sigma: float) -> torch.Tensor:
    """``exp(-||x - y|| / (2 sigma^2))`` pairwise: [..., n, 3] x [..., m, 3]
    -> [..., n, m]."""
    d2 = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    return torch.exp(-d2.clamp_min(1e-24).sqrt() / (2.0 * sigma * sigma))


def mmd_loss(
    pred_coord: torch.Tensor,       # [N, 3]
    virtual_coord: torch.Tensor,    # [B, 3, C]
    node_mask: torch.Tensor,        # [N]
    n_graphs: int,
    sigma: float,
    sample: int,
    *,
    scores: Optional[torch.Tensor] = None,   # [B, n_max] per-graph sampling
    perm: Optional[torch.Tensor] = None,     # [n_max] shared sampling
) -> torch.Tensor:
    """``l_vv - l_rv``, pulling the virtual nodes toward the real nodes."""
    if (scores is None) == (perm is None):
        raise ValueError("pass exactly one of scores (per-graph) or perm (shared)")
    B = n_graphs
    n_max = pred_coord.shape[0] // B
    vloc = virtual_coord.transpose(1, 2)                # [B, C, 3]
    C = vloc.shape[1]
    coords = pred_coord.reshape(B, n_max, 3)
    mask = node_mask.reshape(B, n_max)
    s = min(sample * C, n_max)
    if scores is not None:
        keyed = scores + (~mask) * 2.0                  # real nodes first
        idx = torch.topk(-keyed, s, dim=1).indices      # [B, s] smallest
        sampled = torch.gather(coords, 1, idx[..., None].expand(B, s, 3))
        smask = torch.gather(mask, 1, idx)
    else:
        idx = perm[:s]
        sampled, smask = coords[:, idx, :], mask[:, idx]
    k_vv = rbf_kernel(vloc, vloc, sigma)
    k_rv = rbf_kernel(sampled, vloc, sigma) * smask[..., None]
    return k_vv.sum() / B / C / C - 2.0 * k_rv.sum() / B / s / C
