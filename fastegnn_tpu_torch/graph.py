"""Static-shape batched geometric graphs (counterpart of ``fastegnn_tpu/graph.py``).

The padding conventions are the JAX package's, so both packages build the
same batch from the same raw graphs:

- ``dst``/``src`` are the reference's ``row``/``col``: the message of edge
  ``e`` is built from ``(h[dst[e]], h[src[e]])`` and summed at ``dst[e]``.
- Padded nodes have ``graph_id == n_graphs`` (a dump segment) and
  ``node_mask == False``.
- Padded edges have ``dst == total_nodes`` (an out-of-range sentinel),
  ``src == 0`` and ``edge_mask == False``.
- Edges are sorted by ``dst`` (stable), so padded edges come last, and the
  edge capacity is aligned to ``edge_align``.
- ``dst_count[n]`` is the real in-degree of node ``n``; ``loc_mean`` the
  per-graph mean position repeated over the virtual channels.

In place of the JAX package's slot packer and CSR-block tables the batch
carries ``rowptr`` [N + 1]: the CSR row pointer of the dst-sorted real
edges, so the real edges of row ``n`` are ``rowptr[n]:rowptr[n + 1]`` and
``rowptr[N]`` is the number of real edges.  The CUDA edge kernels walk it
directly; the sentinel tail past ``rowptr[N]`` is never read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static capacities for one bucket of graphs."""

    max_nodes: int
    max_edges: int
    n_graphs: int
    node_feat_dim: int = 2
    edge_attr_dim: int = 1
    node_attr_dim: int = 1
    virtual_channels: int = 3


@dataclasses.dataclass
class GraphBatch:
    """A fixed-capacity batch of geometric graphs.

    ``N`` = padded node capacity, ``E`` = padded edge capacity, ``B`` =
    number of graphs, ``C`` = virtual channels.
    """

    node_feat: torch.Tensor       # [N, F]
    coord: torch.Tensor           # [N, 3]
    vel: torch.Tensor             # [N, 3]
    node_mask: torch.Tensor       # [N] bool
    graph_id: torch.Tensor        # [N] int64 in [0, B]; B = padding
    dst: torch.Tensor             # [E] int32, dst-sorted; sentinel N on padding
    src: torch.Tensor             # [E] int32
    edge_attr: torch.Tensor       # [E, Fe]
    edge_mask: torch.Tensor       # [E] bool
    coord_target: torch.Tensor    # [N, 3]
    loc_mean: torch.Tensor        # [B, 3, C]
    dst_count: torch.Tensor       # [N] f32 real in-degree
    rowptr: torch.Tensor          # [N + 1] int32 CSR over the real edges
    n_graphs: int
    n_real_edges: int             # == rowptr[N], known on the host
    node_attr: Optional[torch.Tensor] = None   # [N, Fa]

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.dst.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coord.device

    def to(self, device) -> "GraphBatch":
        """A copy with every tensor on ``device``."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return GraphBatch(**moved)


def morton_order(coord: np.ndarray, bits: int = 10) -> np.ndarray:
    """Permutation sorting nodes along a 3-D Morton (Z-order) curve, so that
    radius-graph neighbours get nearby ids."""
    coord = np.asarray(coord)
    span = np.ptp(coord, axis=0).max() + 1e-9
    q = ((coord - coord.min(axis=0)) / span * (2**bits - 1)).astype(np.uint64)
    code = np.zeros(coord.shape[0], np.uint64)
    for b in range(bits):
        for d in range(coord.shape[1]):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                coord.shape[1] * b + d)
    return np.argsort(code, kind="stable")


def pad_graph(
    spec: GraphSpec,
    *,
    node_feat,
    coord,
    vel,
    dst,
    src,
    edge_attr,
    coord_target,
    node_attr=None,
    dtype=np.float32,
    spatial_sort: bool = False,
) -> dict:
    """Pad one raw graph's numpy arrays to the spec's single-graph
    capacities; ``spatial_sort`` relabels nodes in Morton order first."""
    if spatial_sort:
        perm = morton_order(coord)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        node_feat, coord, vel, coord_target = (
            np.asarray(a)[perm] for a in (node_feat, coord, vel, coord_target))
        dst, src = inv[np.asarray(dst)], inv[np.asarray(src)]
        if node_attr is not None:
            node_attr = np.asarray(node_attr)[perm]

    n = np.asarray(coord).shape[0]
    e = np.asarray(dst).shape[0]
    if n > spec.max_nodes or e > spec.max_edges:
        raise ValueError(
            f"graph ({n} nodes, {e} edges) exceeds spec "
            f"({spec.max_nodes} nodes, {spec.max_edges} edges)")

    def pad_to(arr, cap):
        arr = np.asarray(arr)
        return np.pad(arr, [(0, cap - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1))

    out = {
        "node_feat": pad_to(node_feat, spec.max_nodes).astype(dtype),
        "coord": pad_to(coord, spec.max_nodes).astype(dtype),
        "vel": pad_to(vel, spec.max_nodes).astype(dtype),
        "coord_target": pad_to(coord_target, spec.max_nodes).astype(dtype),
        "node_mask": pad_to(np.ones(n, bool), spec.max_nodes),
        "dst": pad_to(np.asarray(dst).astype(np.int32), spec.max_edges),
        "src": pad_to(np.asarray(src).astype(np.int32), spec.max_edges),
        "edge_attr": pad_to(edge_attr, spec.max_edges).astype(dtype),
        "edge_mask": pad_to(np.ones(e, bool), spec.max_edges),
        "n_nodes": n,
        "n_edges": e,
    }
    if node_attr is not None:
        out["node_attr"] = pad_to(node_attr, spec.max_nodes).astype(dtype)
    return out


def batch_graphs(
    graphs: Sequence[dict],
    spec: GraphSpec,
    *,
    edge_align: int = 1024,
    device=None,
) -> GraphBatch:
    """Concatenate padded single graphs into one ``GraphBatch`` on ``device``.

    Node ids of graph ``g`` are offset by ``g * spec.max_nodes``; edges are
    sorted by ``dst`` with a stable sort (padded edges last), then padded
    with sentinel edges up to a multiple of ``edge_align``.
    """
    from fastegnn_tpu_torch import resolve_device

    dev = resolve_device(device)
    b = len(graphs)
    if b != spec.n_graphs:
        raise ValueError(f"got {b} graphs for spec with n_graphs={spec.n_graphs}")

    def cat(key):
        return np.concatenate([g[key] for g in graphs], axis=0)

    total_nodes = b * spec.max_nodes
    graph_id = np.concatenate([
        np.where(g["node_mask"], np.int32(i), np.int32(b))
        for i, g in enumerate(graphs)]).astype(np.int32)
    dst = np.concatenate([
        np.where(g["edge_mask"], g["dst"] + i * spec.max_nodes, total_nodes)
        for i, g in enumerate(graphs)]).astype(np.int32)
    src = np.concatenate([
        np.where(g["edge_mask"], g["src"] + i * spec.max_nodes, 0)
        for i, g in enumerate(graphs)]).astype(np.int32)
    edge_attr, edge_mask = cat("edge_attr"), cat("edge_mask")

    # stable sort by dst (ids lie in [0, total_nodes]; the sentinel sorts last)
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    edge_attr, edge_mask = edge_attr[order], edge_mask[order]

    extra = -dst.shape[0] % edge_align
    if extra:
        dst = np.concatenate([dst, np.full(extra, total_nodes, np.int32)])
        src = np.concatenate([src, np.zeros(extra, np.int32)])
        edge_attr = np.concatenate(
            [edge_attr, np.zeros((extra, edge_attr.shape[1]), edge_attr.dtype)])
        edge_mask = np.concatenate([edge_mask, np.zeros(extra, bool)])

    real = dst[edge_mask]
    dst_count = np.bincount(real, minlength=total_nodes + 1)[:total_nodes]
    rowptr = np.searchsorted(dst, np.arange(total_nodes + 1), side="left")
    n_real = int(rowptr[-1])
    if not (edge_mask[:n_real].all() and not edge_mask[n_real:].any()):
        raise ValueError("real edges must precede the padded edges after sorting")

    c = spec.virtual_channels
    means = []
    for g in graphs:
        m = (g["coord"][: g["n_nodes"]].mean(axis=0) if g["n_nodes"]
             else np.zeros(3))
        means.append(np.repeat(m[:, None], c, axis=1))
    loc_mean = np.stack(means).astype(np.float32)

    node_attr = None
    if all("node_attr" in g for g in graphs):
        node_attr = torch.as_tensor(cat("node_attr"), device=dev)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return GraphBatch(
        node_feat=t(cat("node_feat")),
        coord=t(cat("coord")),
        vel=t(cat("vel")),
        node_mask=t(cat("node_mask")),
        graph_id=t(graph_id, torch.int64),
        dst=t(dst),
        src=t(src),
        edge_attr=t(edge_attr),
        edge_mask=t(edge_mask),
        coord_target=t(cat("coord_target")),
        loc_mean=t(loc_mean),
        dst_count=t(dst_count.astype(np.float32)),
        rowptr=t(rowptr.astype(np.int32)),
        n_graphs=b,
        n_real_edges=n_real,
        node_attr=node_attr,
    )
