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
  edge capacity is aligned to ``edge_align``.  A batch composes this
  order, and its CSR tables below, from each graph's :class:`EdgeTable`,
  built once per graph (:func:`edge_table`, by counting sorts in
  ``native``), so that collating a batch sorts nothing;
  :func:`batch_graphs_plain` builds the same batch by sorting it whole.
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

from fastegnn_tpu_torch import native


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


@dataclasses.dataclass(frozen=True)
class EdgeTable:
    """One padded graph's edge order and CSR tables (:func:`edge_table`),
    built once per graph so that :func:`batch_graphs` composes a batch's
    tables without sorting its edges.

    ``order`` lists the graph's real edges in stable ``dst`` order, then
    its padded edges in their own order; ``rowptr`` is the row pointer of
    the ordered real edges over ``max_nodes + 1`` rows, ``src_perm`` the
    stable argsort of their ``src`` and ``src_rowptr`` its row pointer.  A
    graph with bond edges also carries their stable argsorts by dst and by
    src (indices into its bond slots) with their row pointers.
    """

    order: np.ndarray                                 # [E] int32
    n_real: int
    rowptr: np.ndarray                                # [max_nodes + 1] int32
    src_perm: np.ndarray                              # [n_real] int32
    src_rowptr: np.ndarray                            # [max_nodes + 1] int32
    local_perm: Optional[np.ndarray] = None           # [El_real] int32
    local_rowptr: Optional[np.ndarray] = None         # [max_nodes + 1] int32
    local_src_perm: Optional[np.ndarray] = None       # [El_real] int32
    local_src_rowptr: Optional[np.ndarray] = None     # [max_nodes + 1] int32


def _csr(keys: np.ndarray, n: int, what: str):
    """``(perm, rowptr)``: the stable argsort of ``keys`` (node ids, which
    must lie in ``[0, n)``) and the row pointer [n + 1] of that order."""
    if keys.size and not (0 <= keys.min() and keys.max() < n):
        raise ValueError(f"{what} ids must lie in [0, {n})")
    rowptr = np.zeros(n + 1, np.int32)
    rowptr[1:] = np.cumsum(native.bincount_f32(keys, n), dtype=np.int64)
    return native.counting_argsort(keys, n), rowptr


def edge_table(graph: dict, spec: GraphSpec) -> EdgeTable:
    """The :class:`EdgeTable` of one padded graph (:func:`pad_graph`) under
    ``spec``'s ``max_nodes``: two counting sorts over its real edges, and
    two over its bonds where it has them."""
    n = spec.max_nodes
    mask = np.asarray(graph["edge_mask"], bool)
    real = np.flatnonzero(mask).astype(np.int32)
    perm, rowptr = _csr(np.asarray(graph["dst"])[real], n, "dst")
    ordered = real[perm]
    src_perm, src_rowptr = _csr(np.asarray(graph["src"])[ordered], n, "src")
    local = {}
    if "local_dst" in graph:
        lreal = np.flatnonzero(graph["local_edge_mask"]).astype(np.int32)
        for name, key in (("local", "local_dst"), ("local_src", "local_src")):
            lperm, lrowptr = _csr(np.asarray(graph[key])[lreal], n, key)
            local[f"{name}_perm"], local[f"{name}_rowptr"] = lreal[lperm], lrowptr
    return EdgeTable(order=np.concatenate([ordered, np.flatnonzero(~mask).astype(np.int32)]),
                     n_real=int(real.size), rowptr=rowptr, src_perm=src_perm,
                     src_rowptr=src_rowptr, **local)


def _check_count(graphs: Sequence[dict], spec: GraphSpec) -> None:
    if len(graphs) != spec.n_graphs:
        raise ValueError(f"got {len(graphs)} graphs for spec with n_graphs={spec.n_graphs}")


def _local_ids(graphs: Sequence[dict], max_nodes: int):
    """The batch's bond ``(dst, src)``, offset per graph slot like the main
    edges; masked slots point at node 0."""
    return (np.concatenate([
        np.where(g["local_edge_mask"], g[k] + i * max_nodes, 0)
        for i, g in enumerate(graphs)]).astype(np.int32) for k in ("local_dst", "local_src"))


def batch_graphs(
    graphs: Sequence[dict],
    spec: GraphSpec,
    *,
    edge_align: int = 1024,
    device=None,
    tables: Optional[Sequence[EdgeTable]] = None,
) -> GraphBatch:
    """Concatenate padded single graphs into one ``GraphBatch`` on ``device``.

    Node ids of graph ``g`` are offset by ``g * spec.max_nodes``, so the
    batch's stable sort by ``dst`` is each graph's real edges in their own
    stable dst order, graph after graph, then the padded edges: the batch
    gathers each graph's edges through its :class:`EdgeTable` (``tables``,
    one per graph; built here when not given) and offsets its tables,
    without sorting.  The edges are then padded with sentinel edges up to
    a multiple of ``edge_align``.
    """
    from fastegnn_tpu_torch import resolve_device

    dev = resolve_device(device)
    _check_count(graphs, spec)
    if tables is None:
        tables = [edge_table(g, spec) for g in graphs]
    mn = spec.max_nodes
    if len(tables) != len(graphs) or any(tb.rowptr.size != mn + 1 for tb in tables):
        raise ValueError(f"need one edge table over {mn} nodes per graph")
    total_nodes = len(graphs) * mn
    n_real = sum(tb.n_real for tb in tables)
    n_edges = sum(tb.order.size for tb in tables)
    cap = n_edges + -n_edges % edge_align
    dst = np.full(cap, total_nodes, np.int32)
    src = np.zeros(cap, np.int32)
    edge_attr = np.zeros((cap, graphs[0]["edge_attr"].shape[1]),
                         np.result_type(*(g["edge_attr"] for g in graphs)))
    edge_mask = np.zeros(cap, bool)
    edge_mask[:n_real] = True
    rowptr, src_rowptr = (np.empty(total_nodes + 1, np.int32) for _ in range(2))
    rowptr[-1] = src_rowptr[-1] = n_real
    src_perm = np.empty(n_real, np.int32)
    lo, pad = 0, n_real
    for i, (g, tb) in enumerate(zip(graphs, tables)):
        hi, real, rest = lo + tb.n_real, tb.order[:tb.n_real], tb.order[tb.n_real:]
        np.add(np.take(g["dst"], real), i * mn, out=dst[lo:hi], casting="unsafe")
        np.add(np.take(g["src"], real), i * mn, out=src[lo:hi], casting="unsafe")
        edge_attr[lo:hi] = np.take(g["edge_attr"], real, axis=0)
        edge_attr[pad:pad + rest.size] = np.take(g["edge_attr"], rest, axis=0)
        np.add(tb.rowptr[:-1], lo, out=rowptr[i * mn:(i + 1) * mn])
        np.add(tb.src_rowptr[:-1], lo, out=src_rowptr[i * mn:(i + 1) * mn])
        np.add(tb.src_perm, lo, out=src_perm[lo:hi])
        lo, pad = hi, pad + rest.size

    local = None
    if all("local_dst" in g for g in graphs):
        local, slot = {}, np.cumsum([0] + [g["local_dst"].shape[0] for g in graphs])
        for name in ("local", "local_src"):
            perms = [getattr(tb, f"{name}_perm") for tb in tables]
            base = np.cumsum([0] + [p.size for p in perms])
            local[f"{name}_perm"] = np.concatenate(
                [p + slot[i] for i, p in enumerate(perms)]).astype(np.int32)
            local[f"{name}_rowptr"] = np.append(np.concatenate(
                [getattr(tb, f"{name}_rowptr")[:-1] + base[i] for i, tb in enumerate(tables)]),
                base[-1]).astype(np.int32)
    return _assemble(graphs, spec, dev, local, dst=dst, src=src, edge_attr=edge_attr,
                     edge_mask=edge_mask, rowptr=rowptr, src_perm=src_perm,
                     src_rowptr=src_rowptr, dst_count=np.diff(rowptr).astype(np.float32))


def _csr_through(ids: np.ndarray, mask: np.ndarray, n: int):
    """``(perm, rowptr)``: the stable argsort of the masked-in ``ids`` (as
    indices into ``ids``) and the row pointer [n + 1] of that order."""
    real = np.flatnonzero(mask)
    perm = real[np.argsort(ids[real], kind="stable")]
    return perm, np.searchsorted(ids[perm], np.arange(n + 1), side="left")


def batch_graphs_plain(graphs: Sequence[dict], spec: GraphSpec, *, edge_align: int = 1024,
                       device=None) -> GraphBatch:
    """:func:`batch_graphs` by sorting the whole batch: stable argsorts of
    its edges by dst and by src, and of its bonds.  Its plain version, for
    the tests and the smoke run; the main path never calls it."""
    from fastegnn_tpu_torch import resolve_device

    dev = resolve_device(device)
    _check_count(graphs, spec)
    mn, total_nodes = spec.max_nodes, len(graphs) * spec.max_nodes
    dst = np.concatenate([np.where(g["edge_mask"], g["dst"] + i * mn, total_nodes)
                          for i, g in enumerate(graphs)]).astype(np.int32)
    src = np.concatenate([np.where(g["edge_mask"], g["src"] + i * mn, 0)
                          for i, g in enumerate(graphs)]).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    edges = [a[order] for a in (dst, src, *(np.concatenate([g[k] for g in graphs])
                                            for k in ("edge_attr", "edge_mask")))]
    extra = -dst.shape[0] % edge_align
    dst, src, edge_attr, edge_mask = (np.concatenate([a, np.full((extra, *a.shape[1:]), fill,
                                                                 a.dtype)])
                                      for a, fill in zip(edges, (total_nodes, 0, 0, False)))
    rowptr = np.searchsorted(dst, np.arange(total_nodes + 1), side="left")
    n_real = int(rowptr[-1])
    src_perm, src_rowptr = _csr_through(src, np.arange(src.size) < n_real, total_nodes)
    local = None
    if all("local_dst" in g for g in graphs):
        lmask = np.concatenate([g["local_edge_mask"] for g in graphs])
        (dperm, drowptr), (sperm, srowptr) = (_csr_through(ids, lmask, total_nodes)
                                              for ids in _local_ids(graphs, mn))
        local = dict(local_perm=dperm, local_rowptr=drowptr, local_src_perm=sperm,
                     local_src_rowptr=srowptr)
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return _assemble(graphs, spec, dev, local and {k: i32(a) for k, a in local.items()},
                     dst=dst, src=src, edge_attr=edge_attr, edge_mask=edge_mask,
                     rowptr=i32(rowptr), src_perm=i32(src_perm), src_rowptr=i32(src_rowptr),
                     dst_count=np.bincount(dst[edge_mask], minlength=total_nodes + 1)[
                         :total_nodes].astype(np.float32))


def _assemble(graphs: Sequence[dict], spec: GraphSpec, dev, local: Optional[dict],
              **edges: np.ndarray) -> GraphBatch:
    """The ``GraphBatch`` on ``dev`` of the batch's edge arrays ``edges``
    and bond tables ``local`` (numpy), with the graphs' node fields."""
    b = len(graphs)

    def cat(key):
        return np.concatenate([g[key] for g in graphs], axis=0)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    graph_id = np.concatenate([
        np.where(g["node_mask"], np.int32(i), np.int32(b))
        for i, g in enumerate(graphs)]).astype(np.int32)
    c = spec.virtual_channels
    means = []
    for g in graphs:
        m = (g["coord"][: g["n_nodes"]].mean(axis=0) if g["n_nodes"]
             else np.zeros(3))
        means.append(np.repeat(m[:, None], c, axis=1))
    loc_mean = np.stack(means).astype(np.float32)

    node_attr = None
    if all("node_attr" in g for g in graphs):
        node_attr = t(cat("node_attr"))
    # the protein dataset's graphs carry fibonacci-sphere virtual positions
    # [1, 3, C] (the JAX package attaches them in ProteinDataset.collate)
    fib = None
    if all("virtual_fibonacci" in g for g in graphs):
        fib = t(cat("virtual_fibonacci"))

    bonds = {}
    if local is not None:
        ldst, lsrc = _local_ids(graphs, spec.max_nodes)
        bonds = dict(local_dst=t(ldst), local_src=t(lsrc),
                     local_edge_attr=t(cat("local_edge_attr")),
                     local_edge_mask=t(cat("local_edge_mask")),
                     **{k: t(a) for k, a in local.items()})

    return GraphBatch(
        node_feat=t(cat("node_feat")),
        coord=t(cat("coord")),
        vel=t(cat("vel")),
        node_mask=t(cat("node_mask")),
        graph_id=t(graph_id, torch.int64),
        coord_target=t(cat("coord_target")),
        loc_mean=t(loc_mean),
        **{k: t(a) for k, a in edges.items()},
        n_graphs=b,
        n_real_edges=int(edges["rowptr"][-1]),
        node_attr=node_attr,
        virtual_fibonacci=fib,
        **bonds,
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
