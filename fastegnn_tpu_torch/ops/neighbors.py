"""Graph construction on the host (numpy / scipy) and on a tensor's device.

Counterpart of ``fastegnn_tpu/ops/neighbors.py`` (its numpy builders),
kept as the port's own copy so the port never imports the JAX package:

- ``cutoff_edges_np``: complete graph minus self loops, keeping the
  ``(1 - cutoff_rate)`` fraction of shortest edges;
- ``radius_graph_np``: all ordered pairs strictly within radius ``r``
  (both directions, no self loops), with scipy's cKDTree;
- ``sort_cutoff_np``: keep the shortest fraction of an existing edge list;
- ``cutoff_edges_topk``: the ``num_edges`` shortest directed edges of the
  complete graph, on the tensor's device (the JAX one takes them with
  ``jax.lax.top_k``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def cutoff_edges_np(loc: np.ndarray, cutoff_rate: float) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k shortest directed edges of the complete graph, ascending by
    distance (ties broken by flattened index).  Returns ``(dst, src)``."""
    loc = np.asarray(loc, np.float64)
    n = loc.shape[0]
    diff = loc[:, None, :] - loc[None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    dist[np.diag_indices(n)] = 1e18
    k = int(n * (n - 1) * (1.0 - cutoff_rate))
    flat = dist.reshape(-1)
    idx = np.argpartition(flat, k - 1)[:k] if k < flat.size else np.arange(flat.size)
    idx = idx[np.argsort(flat[idx], kind="stable")]
    return (idx // n).astype(np.int32), (idx % n).astype(np.int32)


def radius_graph_np(loc: np.ndarray, r: float) -> Tuple[np.ndarray, np.ndarray]:
    """All ordered pairs strictly within radius ``r`` (no self loops);
    returns ``(dst, src)`` with both directions of every pair."""
    from scipy.spatial import cKDTree

    loc = np.asarray(loc, np.float64)
    pairs = cKDTree(loc).query_pairs(r, output_type="ndarray")  # [P, 2], i < j
    if pairs.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    a, b = pairs[:, 0], pairs[:, 1]
    dst = np.concatenate([a, b]).astype(np.int32)
    src = np.concatenate([b, a]).astype(np.int32)
    return dst, src


def sort_cutoff_np(
    dst: np.ndarray, src: np.ndarray, loc: np.ndarray, cutoff_rate: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the shortest ``(1 - cutoff_rate)`` fraction of the given edges."""
    d = np.linalg.norm(loc[dst] - loc[src], axis=1)
    order = np.argsort(d, kind="stable")
    keep = order[: int(order.size * (1.0 - cutoff_rate))]
    return dst[keep].astype(np.int32), src[keep].astype(np.int32)


def cutoff_edges_topk(loc: torch.Tensor, num_edges: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``num_edges`` shortest directed edges of the complete graph on
    ``loc [n, 3]`` (self loops masked with 1e18), ascending by squared
    distance, on ``loc``'s device; returns int32 ``(dst, src)``.

    ``jax.lax.top_k`` puts the lower flat index first among equal values,
    and every edge ties with its reverse, so the edges come from a stable
    sort of the squared distances: ``torch.topk`` does not fix the order of
    ties."""
    n = loc.shape[0]
    diff = loc[:, None, :] - loc[None, :, :]
    dist2 = (diff**2).sum(-1) + torch.eye(n, dtype=loc.dtype, device=loc.device) * 1e18
    idx = torch.sort(dist2.reshape(-1), stable=True).indices[:num_edges]
    return (idx // n).to(torch.int32), (idx % n).to(torch.int32)
