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
directly; the sentinel tail past ``rowptr[N]`` is never read.  For the
src role it carries ``src_perm`` [n_real], the stable argsort of the real
edges' ``src``, and ``src_rowptr`` [N + 1], the row pointer of the
src-sorted real edges (the JAX package's ``src_perm`` / ``csr_src``): the
segment-sum kernel reads edge rows through them in ``gather_src``'s
backward (``ops/spmm.py``).

A batch of graphs with local (bond) edges, EGHN's pooling graph, carries
them as the JAX batch does: ``local_dst`` / ``local_src`` offset by
``g * max_nodes`` with masked slots pointing at node 0, in the graphs'
own order.  Beside them it carries the stable argsort of the real bonds by
dst, ``local_perm``, with its row pointer ``local_rowptr`` [N + 1], and
the same by src, ``local_src_perm`` / ``local_src_rowptr``, so that the
bond sums and the bond gathers' backwards run on the segment-sum kernel's
perm form without reordering the bonds.

A batch for DimeNet carries its triplet table (:class:`Triplets`, built by
:func:`build_triplets` from the batch's own CSR tables on the batch's
device; ``models/dimenet.py::TripletDataset`` attaches it).
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
    max_local_edges: int = 0      # capacity for local (bond) edges (EGHN)


@dataclasses.dataclass
class Triplets:
    """DimeNet's ``k -> j -> i`` triplets of a batch's real edges (reference
    ``DimeNet.py:559-582``): each real edge ``ji`` (``j = dst``, ``i = src``)
    paired with every real edge ``kj`` whose src is ``j``, except the one
    whose dst is ``i``.  The table holds exactly the real triplets, sorted
    by ``idx_ji`` and, within an edge, by ``idx_kj``: the JAX table's real
    prefix (``fastegnn_tpu/models/dimenet.py::build_triplets``) without its
    capacity padding.  ``rowptr`` [E_real + 1] is the row pointer of
    ``idx_ji``; ``kj_perm`` the stable argsort of ``idx_kj`` and
    ``kj_rowptr`` its row pointer, so that sums at either edge run on the
    segment-sum kernel."""

    idx_i: torch.Tensor       # [T] int32 node i
    idx_j: torch.Tensor       # [T] int32 node j
    idx_k: torch.Tensor       # [T] int32 node k
    idx_kj: torch.Tensor      # [T] int32 edge k -> j
    idx_ji: torch.Tensor      # [T] int32 edge j -> i, non-decreasing
    rowptr: torch.Tensor      # [E_real + 1] int32 row pointer of idx_ji
    kj_perm: torch.Tensor     # [T] int32 stable argsort of idx_kj
    kj_rowptr: torch.Tensor   # [E_real + 1] int32 its row pointer

    @property
    def num_triplets(self) -> int:
        return self.idx_ji.shape[0]

    def _apply(self, fn) -> "Triplets":
        return Triplets(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})


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
    src_perm: torch.Tensor        # [n_real] int32 stable argsort of real src
    src_rowptr: torch.Tensor      # [N + 1] int32 CSR over the src-sorted real edges
    n_graphs: int
    n_real_edges: int             # == rowptr[N], known on the host
    node_attr: Optional[torch.Tensor] = None   # [N, Fa]
    virtual_fibonacci: Optional[torch.Tensor] = None   # [B, 3, C] VNEGNN virtual positions
    # local (bond) edges, EGHN's: [El] in the graphs' order, masked slots at node 0
    local_dst: Optional[torch.Tensor] = None         # [El] int32
    local_src: Optional[torch.Tensor] = None         # [El] int32
    local_edge_attr: Optional[torch.Tensor] = None   # [El, Fl]
    local_edge_mask: Optional[torch.Tensor] = None   # [El] bool
    local_perm: Optional[torch.Tensor] = None        # [El_real] int32 real bonds by dst
    local_rowptr: Optional[torch.Tensor] = None      # [N + 1] int32 its row pointer
    local_src_perm: Optional[torch.Tensor] = None    # [El_real] int32 real bonds by src
    local_src_rowptr: Optional[torch.Tensor] = None  # [N + 1] int32 its row pointer
    triplets: Optional[Triplets] = None              # DimeNet's (build_triplets)

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.dst.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coord.device

    def _apply(self, fn) -> "GraphBatch":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = (fn(v) if isinstance(v, torch.Tensor)
                           else v._apply(fn) if isinstance(v, Triplets) else v)
        return GraphBatch(**out)

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """A copy with every tensor on ``device``."""
        return self._apply(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """A copy of a CPU batch in page-locked memory, so that a
        ``to(cuda, non_blocking=True)`` overlaps the host's work."""
        return self._apply(torch.Tensor.pin_memory)


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
    local_dst=None,
    local_src=None,
    local_edge_attr=None,
    dtype=np.float32,
    spatial_sort: bool = False,
) -> dict:
    """Pad one raw graph's numpy arrays to the spec's single-graph
    capacities (local bond edges, where given, to ``max_local_edges``);
    ``spatial_sort`` relabels nodes in Morton order first."""
    if spatial_sort:
        perm = morton_order(coord)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        node_feat, coord, vel, coord_target = (
            np.asarray(a)[perm] for a in (node_feat, coord, vel, coord_target))
        dst, src = inv[np.asarray(dst)], inv[np.asarray(src)]
        if node_attr is not None:
            node_attr = np.asarray(node_attr)[perm]
        if local_dst is not None:
            local_dst, local_src = inv[np.asarray(local_dst)], inv[np.asarray(local_src)]

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
    if local_dst is not None:
        el, cap = np.asarray(local_dst).shape[0], spec.max_local_edges
        if el > cap:
            raise ValueError(f"{el} local edges exceed spec capacity {cap}")
        out["local_dst"] = pad_to(np.asarray(local_dst).astype(np.int32), cap)
        out["local_src"] = pad_to(np.asarray(local_src).astype(np.int32), cap)
        out["local_edge_attr"] = pad_to(local_edge_attr, cap).astype(dtype)
        out["local_edge_mask"] = pad_to(np.ones(el, bool), cap)
        out["n_local_edges"] = el
    return out


def _csr_through(ids: np.ndarray, mask: np.ndarray, n: int):
    """``(perm, rowptr)``: the stable argsort of the masked-in ``ids`` (as
    indices into ``ids``) and the row pointer [n + 1] of that order."""
    real = np.flatnonzero(mask)
    perm = real[np.argsort(ids[real], kind="stable")]
    return perm, np.searchsorted(ids[perm], np.arange(n + 1), side="left")


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
    src_perm = np.argsort(src[:n_real], kind="stable")
    src_rowptr = np.searchsorted(src[:n_real][src_perm], np.arange(total_nodes + 1),
                                 side="left")

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
    # the protein dataset's graphs carry fibonacci-sphere virtual positions
    # [1, 3, C] (the JAX package attaches them in ProteinDataset.collate)
    fib = None
    if all("virtual_fibonacci" in g for g in graphs):
        fib = torch.as_tensor(cat("virtual_fibonacci"), device=dev)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    local = {}
    if all("local_dst" in g for g in graphs):
        # offset per graph slot like the main edges; masked slots point at
        # node 0 and are left out of the perms
        lmask = cat("local_edge_mask")
        ldst, lsrc = (np.concatenate([
            np.where(g["local_edge_mask"], g[k] + i * spec.max_nodes, 0)
            for i, g in enumerate(graphs)]).astype(np.int32) for k in ("local_dst", "local_src"))
        dperm, drowptr = _csr_through(ldst, lmask, total_nodes)
        sperm, srowptr = _csr_through(lsrc, lmask, total_nodes)
        local = dict(local_dst=t(ldst), local_src=t(lsrc),
                     local_edge_attr=t(cat("local_edge_attr")), local_edge_mask=t(lmask),
                     **{k: t(a.astype(np.int32)) for k, a in (
                         ("local_perm", dperm), ("local_rowptr", drowptr),
                         ("local_src_perm", sperm), ("local_src_rowptr", srowptr))})

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
        src_perm=t(src_perm.astype(np.int32)),
        src_rowptr=t(src_rowptr.astype(np.int32)),
        n_graphs=b,
        n_real_edges=n_real,
        node_attr=node_attr,
        virtual_fibonacci=fib,
        **local,
    )


def build_triplets(graph: GraphBatch) -> Triplets:
    """The batch's :class:`Triplets`, on its device, from its tables: for a
    real edge ``e`` with ``j = dst[e]`` and ``i = src[e]``, its triplets
    are the real edges ``src_perm[src_rowptr[j]:src_rowptr[j + 1]]`` (those
    whose src is ``j``, in edge order, as ``src_perm`` is a stable argsort)
    less those whose dst is ``i``."""
    dev, ne = graph.device, graph.n_real_edges
    dst, src = graph.dst[:ne].long(), graph.src[:ne].long()
    src_rowptr = graph.src_rowptr.long()
    start = src_rowptr[dst]
    count = src_rowptr[dst + 1] - start
    total = int(count.sum())
    e_rep = torch.repeat_interleave(torch.arange(ne, device=dev), count, output_size=total)
    first = torch.cumsum(count, 0) - count
    kj = graph.src_perm.long()[torch.arange(total, device=dev) - first[e_rep] + start[e_rep]]
    keep = dst[kj] != src[e_rep]
    ji, kj = e_rep[keep], kj[keep]
    kj_sorted, kj_perm = torch.sort(kj, stable=True)
    bounds = torch.arange(ne + 1, device=dev)
    i32 = torch.int32
    return Triplets(
        idx_i=src[ji].to(i32), idx_j=dst[ji].to(i32), idx_k=dst[kj].to(i32),
        idx_kj=kj.to(i32), idx_ji=ji.to(i32),
        rowptr=torch.searchsorted(ji, bounds).to(i32), kj_perm=kj_perm.to(i32),
        kj_rowptr=torch.searchsorted(kj_sorted, bounds).to(i32))
