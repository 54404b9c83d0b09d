"""Water-3D-shaped synthetic graph (counterpart of the synthetic branch of
``bench.py::_positions`` and of ``bench.py::build_batch``).

The same seed-driven numpy geometry as the JAX package's benchmark: 24
Gaussian blobs (strong density contrast, a fat-tailed degree distribution),
a radius graph at r = 0.035 whose mean degree is calibrated to ``degree``,
Morton-ordered nodes, edge_attr ``[d0, d0]``, node_feat ``[|v|, 1]``,
target ``loc + vel``, and an edge capacity 5% above the real edges,
1024-aligned.
"""

from __future__ import annotations

import numpy as np

from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.ops.neighbors import radius_graph_np, sort_cutoff_np

RADIUS = 0.035


def _positions(n_nodes: int, degree: int, rng: np.random.Generator) -> np.ndarray:
    vol = n_nodes * (4.0 / 3.0) * np.pi * RADIUS**3 / degree
    side = vol ** (1.0 / 3.0)
    k = 24
    centers = rng.random((k, 3)) * side
    assign = rng.integers(0, k, n_nodes)
    loc = centers[assign] + rng.normal(size=(n_nodes, 3)) * (side * 0.07)
    return np.clip(loc, 0, side).astype(np.float32)


def build_batch(n_nodes: int = 8000, degree: int = 60, n_graphs: int = 1,
                channels: int = 3, seed: int = 0, device=None):
    """``(GraphBatch, n_real_edges, degree stats)`` on ``device``."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(n_graphs):
        loc = _positions(n_nodes, degree, rng)
        vel = (rng.normal(size=(n_nodes, 3)) * 0.01).astype(np.float32)
        dst, src = radius_graph_np(loc, RADIUS)
        actual = dst.size / n_nodes
        if abs(actual - degree) > 0.15 * degree:
            loc = (loc * (actual / degree) ** (1.0 / 3.0)).astype(np.float32)
            dst, src = radius_graph_np(loc, RADIUS)
        dst, src = sort_cutoff_np(dst, src, loc, 0.0)
        d0 = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True).astype(np.float32)
        q = np.ones((n_nodes, 1), np.float32)
        raw.append(dict(
            node_feat=np.concatenate([np.linalg.norm(vel, axis=1, keepdims=True), q], axis=1),
            coord=loc, vel=vel, dst=dst, src=src,
            edge_attr=np.concatenate([d0, d0], axis=1),
            coord_target=loc + vel, node_attr=q))
    e_max = max(r["dst"].size for r in raw)
    spec = GraphSpec(max_nodes=n_nodes, max_edges=int(np.ceil(e_max * 1.05 / 1024) * 1024),
                     n_graphs=n_graphs, edge_attr_dim=2, virtual_channels=channels)
    graphs = [pad_graph(spec, **r, spatial_sort=True) for r in raw]
    deg = np.concatenate([np.bincount(r["dst"], minlength=n_nodes) for r in raw])
    stats = dict(edge_degree_p50=int(np.percentile(deg, 50)),
                 edge_degree_p99=int(np.percentile(deg, 99)),
                 edge_degree_max=int(deg.max()))
    batch = batch_graphs(graphs, spec, device=device)
    return batch, batch.n_real_edges, stats
