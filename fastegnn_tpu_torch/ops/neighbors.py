"""Host-side graph construction (numpy / scipy).

Counterpart of ``fastegnn_tpu/ops/neighbors.py`` (its numpy builders),
kept as the port's own copy so the port never imports the JAX package:

- ``cutoff_edges_np``: complete graph minus self loops, keeping the
  ``(1 - cutoff_rate)`` fraction of shortest edges;
- ``radius_graph_np``: all ordered pairs strictly within radius ``r``
  (both directions, no self loops), with scipy's cKDTree;
- ``sort_cutoff_np``: keep the shortest fraction of an existing edge list.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
