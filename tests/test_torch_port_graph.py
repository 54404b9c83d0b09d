"""Port batching, neighbours and segment ops against the JAX package.

The same numpy raw graphs go through ``fastegnn_tpu.graph`` and
``fastegnn_tpu_torch.graph``; every array of the batch must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu import graph as jgraph
from fastegnn_tpu.ops import neighbors as jnb
from fastegnn_tpu.ops import segment as jseg
from fastegnn_tpu_torch import graph as pgraph
from fastegnn_tpu_torch.ops import neighbors as pnb
from fastegnn_tpu_torch.ops import segment as pseg

from helpers import random_raw_graph

_FIELDS = ("node_feat", "coord", "vel", "coord_target", "node_mask", "graph_id",
           "dst", "src", "edge_attr", "edge_mask", "dst_count", "loc_mean", "node_attr")


def _both(raws, pad_nodes, pad_edges, spatial_sort=False, edge_align=1024, csr=False):
    n = max(r["coord"].shape[0] for r in raws)
    e = max(r["dst"].shape[0] for r in raws)
    kw = dict(max_nodes=n + pad_nodes, max_edges=e + pad_edges, n_graphs=len(raws),
              edge_attr_dim=2, virtual_channels=3)
    js, ps = jgraph.GraphSpec(**kw), pgraph.GraphSpec(**kw)
    jpadded = [jgraph.pad_graph(js, **r, spatial_sort=spatial_sort) for r in raws]
    # csr: one graph per fused-kernel group, so the JAX batch carries its
    # CSR tables (src_perm, csr_src) only with csr_for_groups
    old = jgraph.EK5_MAX_NODES
    jgraph.EK5_MAX_NODES = js.max_nodes if csr else old
    try:
        jb = jgraph.batch_graphs(jpadded, js, edge_align=edge_align, csr_for_groups=csr)
    finally:
        jgraph.EK5_MAX_NODES = old
    pb = pgraph.batch_graphs(
        [pgraph.pad_graph(ps, **r, spatial_sort=spatial_sort) for r in raws], ps,
        edge_align=edge_align, device="cpu")
    return jb, pb


@pytest.mark.parametrize("pad_nodes,pad_edges,spatial_sort,edge_align",
                         [(0, 0, False, 1024), (5, 9, False, 1024),
                          (3, 7, True, 1024), (2, 0, False, 1)])
def test_batch_matches_jax_exactly(pad_nodes, pad_edges, spatial_sort, edge_align):
    rng = np.random.default_rng(0)
    raws = [random_raw_graph(rng, n, cutoff_rate=0.3) for n in (9, 12, 7)]
    jb, pb = _both(raws, pad_nodes, pad_edges, spatial_sort, edge_align)
    for f in _FIELDS:
        a, b = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)
    assert pb.n_graphs == jb.n_graphs


def test_rowptr_is_csr_of_real_edges():
    rng = np.random.default_rng(1)
    raws = [random_raw_graph(rng, n, cutoff_rate=0.5) for n in (10, 6, 11)]
    _, pb = _both(raws, 4, 5)
    dst, mask = pb.dst.numpy(), pb.edge_mask.numpy()
    n = pb.num_nodes
    want = np.searchsorted(dst[mask], np.arange(n + 1), side="left")
    np.testing.assert_array_equal(pb.rowptr.numpy(), want)
    assert pb.n_real_edges == int(mask.sum()) == int(pb.rowptr[-1])
    assert pb.rowptr.dtype == torch.int32 and pb.num_edges % 1024 == 0
    # the sentinel tail: padded edges carry dst == N and src == 0
    assert (dst[pb.n_real_edges:] == n).all() and (pb.src.numpy()[pb.n_real_edges:] == 0).all()


@pytest.mark.parametrize("pad_nodes,pad_edges,spatial_sort", [(0, 0, False), (4, 9, True)])
def test_src_csr_matches_jax(pad_nodes, pad_edges, spatial_sort):
    rng = np.random.default_rng(6)
    raws = [random_raw_graph(rng, n, cutoff_rate=0.4) for n in (10, 13, 8)]
    jb, pb = _both(raws, pad_nodes, pad_edges, spatial_sort, csr=True)
    assert jb.csr_src is not None
    n, n_real = pb.num_nodes, pb.n_real_edges
    # the JAX permutation runs over every edge and puts the padded ones last
    jperm = np.asarray(jb.src_perm)
    np.testing.assert_array_equal(pb.src_perm.numpy(), jperm[:n_real])
    assert (jperm[n_real:] >= n_real).all()
    starts, ends = np.asarray(jb.csr_src.starts).ravel(), np.asarray(jb.csr_src.ends).ravel()
    np.testing.assert_array_equal(pb.src_rowptr.numpy(), np.append(starts[:n], ends[n - 1]))
    assert pb.src_perm.dtype == pb.src_rowptr.dtype == torch.int32
    assert int(pb.src_rowptr[-1]) == n_real


def test_morton_order_matches_jax():
    loc = np.random.default_rng(2).normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_array_equal(pgraph.morton_order(loc), jgraph.morton_order(loc))


def test_to_moves_every_tensor():
    rng = np.random.default_rng(3)
    _, pb = _both([random_raw_graph(rng, 5)], 0, 0)
    moved = pb.to("cpu")
    for f in _FIELDS + ("rowptr", "src_perm", "src_rowptr"):
        assert torch.equal(getattr(moved, f), getattr(pb, f))
    assert moved.n_real_edges == pb.n_real_edges


def test_neighbors_match_jax():
    loc = np.random.default_rng(4).random((400, 3)).astype(np.float32)
    for a, b in zip(pnb.radius_graph_np(loc, 0.12), jnb.radius_graph_np(loc, 0.12)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pnb.cutoff_edges_np(loc[:30], 0.4), jnb.cutoff_edges_np(loc[:30], 0.4)):
        np.testing.assert_array_equal(a, b)
    dst, src = jnb.radius_graph_np(loc, 0.12)
    for a, b in zip(pnb.sort_cutoff_np(dst, src, loc, 0.3),
                    jnb.sort_cutoff_np(dst, src, loc, 0.3)):
        np.testing.assert_array_equal(a, b)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(50, 4)).astype(np.float32)
    ids = rng.integers(-2, 9, 50).astype(np.int32)    # out-of-range ids dropped
    mask = rng.random(50) > 0.3
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    np.testing.assert_allclose(
        pseg.segment_sum(t(data), t(ids), 7, t(mask)).numpy(),
        np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 7, jnp.asarray(mask))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pseg.segment_mean(t(data), t(ids), 7, t(mask)).numpy(),
        np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), 7, jnp.asarray(mask))),
        rtol=1e-6, atol=1e-6)
    gid = np.sort(rng.integers(0, 4, 50)).astype(np.int32)   # 3 graphs + dump id 3
    np.testing.assert_allclose(
        pseg.graph_mean_pool(t(data), t(gid), 3, t(mask)).numpy(),
        np.asarray(jseg.graph_mean_pool(jnp.asarray(data), jnp.asarray(gid), 3,
                                        jnp.asarray(mask))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_graph_sum_pool_matches_jax(masked):
    # 3 graphs of 8 rows, the last 2 rows of each padding with the dump id 3
    rng = np.random.default_rng(6)
    data = rng.normal(size=(24, 2, 3)).astype(np.float32)
    gid = np.where(np.arange(24) % 8 < 6, np.arange(24) // 8, 3).astype(np.int32)
    mask = gid < 3 if masked else None
    got = pseg.graph_sum_pool(torch.as_tensor(data), torch.as_tensor(gid), 3,
                              None if mask is None else torch.as_tensor(mask))
    want = np.asarray(jseg.graph_sum_pool(jnp.asarray(data), jnp.asarray(gid), 3,
                                          None if mask is None else jnp.asarray(mask)))
    assert got.shape == want.shape == (3, 2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# a random cloud, and a lattice whose equal distances tie far beyond each
# edge and its reverse; k from one edge to the whole complete graph
@pytest.mark.parametrize("cloud", ["random", "lattice"])
def test_cutoff_edges_topk_matches_jax(cloud):
    if cloud == "random":
        loc = np.random.default_rng(8).normal(size=(20, 3)).astype(np.float32)
    else:
        loc = np.stack(np.meshgrid(*[np.arange(3.0)] * 3), -1).reshape(-1, 3).astype(np.float32)
    n = loc.shape[0]
    for k in (1, 7, 3 * n, n * (n - 1)):
        got = pnb.cutoff_edges_topk(torch.as_tensor(loc), k)
        want = jnb.cutoff_edges_topk(jnp.asarray(loc), k)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32 and b.dtype == jnp.int32 and a.shape == (k,)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# batches composed from per-graph edge tables
# ---------------------------------------------------------------------------

_TABLE_FIELDS = ("rowptr", "src_perm", "src_rowptr", "local_dst", "local_src",
                 "local_edge_attr", "local_edge_mask", "local_perm", "local_rowptr",
                 "local_src_perm", "local_src_rowptr")


def _table_raws(kind):
    """Raw graphs: random ones; with bond edges (a chain and a few random
    bonds); with a graph of no real edge; or with a graph whose last rows
    have no in-edge."""
    rng = np.random.default_rng(7)
    raws = [random_raw_graph(rng, n, cutoff_rate=0.3) for n in (9, 12, 7)]
    if kind == "bonds":
        for r in raws:
            n = r["coord"].shape[0]
            extra = rng.integers(0, n, (2, 3))
            r["local_dst"] = np.concatenate([np.arange(n - 1), extra[0]]).astype(np.int32)
            r["local_src"] = np.concatenate([np.arange(1, n), extra[1]]).astype(np.int32)
            r["local_edge_attr"] = rng.random((n + 2, 2)).astype(np.float32)
    elif kind == "no edges":
        r = raws[1]
        r["dst"], r["src"] = r["dst"][:0], r["src"][:0]
        r["edge_attr"] = r["edge_attr"][:0]
    elif kind == "empty last rows":
        r = raws[0]
        keep = r["dst"] < r["coord"].shape[0] - 3
        r["dst"], r["src"], r["edge_attr"] = r["dst"][keep], r["src"][keep], r["edge_attr"][keep]
    return raws


def _table_batches(raws, pad_nodes, pad_edges, spatial_sort=False, edge_align=1024):
    """The JAX batch, the port's batch from a dataset's edge tables and the
    port's plain (sorting) batch of the same raw graphs."""
    from fastegnn_tpu_torch.data.batcher import GraphDataset

    n = max(r["coord"].shape[0] for r in raws)
    e = max(r["dst"].shape[0] for r in raws)
    bonds = max(r["local_dst"].shape[0] for r in raws) if "local_dst" in raws[0] else 0
    kw = dict(max_nodes=n + pad_nodes, max_edges=e + pad_edges, edge_attr_dim=2,
              virtual_channels=3, max_local_edges=bonds)
    js = jgraph.GraphSpec(n_graphs=len(raws), **kw)
    jb = jgraph.batch_graphs([jgraph.pad_graph(js, **r, spatial_sort=spatial_sort) for r in raws],
                             js, edge_align=edge_align)
    ps = pgraph.GraphSpec(n_graphs=1, **kw)
    padded = [pgraph.pad_graph(ps, **r, spatial_sort=spatial_sort) for r in raws]
    ds = GraphDataset(padded, ps, device="cpu")
    pb = pgraph.batch_graphs(padded, ds.batch_spec(len(raws)), edge_align=edge_align,
                             device="cpu", tables=ds.tables)
    plain = pgraph.batch_graphs_plain(padded, ds.batch_spec(len(raws)), edge_align=edge_align,
                                      device="cpu")
    return jb, pb, plain, ds


_TABLE_CASES = [("random", 0, 0, False, 1024), ("random", 5, 9, False, 1024),
                ("random", 3, 7, True, 1024), ("random", 2, 0, False, 1),
                ("bonds", 2, 3, True, 1024), ("no edges", 1, 4, False, 1024),
                ("empty last rows", 4, 2, False, 1)]


@pytest.mark.parametrize("kind,pad_nodes,pad_edges,spatial_sort,edge_align", _TABLE_CASES)
def test_batch_from_dataset_tables_matches_jax_exactly(kind, pad_nodes, pad_edges, spatial_sort,
                                                        edge_align):
    jb, pb, _, ds = _table_batches(_table_raws(kind), pad_nodes, pad_edges, spatial_sort,
                                   edge_align)
    fields = _FIELDS + (("local_dst", "local_src", "local_edge_attr", "local_edge_mask")
                        if kind == "bonds" else ())
    for f in fields:
        a, b = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)
    if edge_align == 1024:   # the dataset's collate (its edge_align) is the same batch
        got = ds.collate(list(range(len(ds))))
        for f in fields + _TABLE_FIELDS:
            if getattr(pb, f) is not None:
                assert torch.equal(getattr(got, f), getattr(pb, f)), f
    if kind == "no edges":
        assert int(pb.rowptr[2 * ds.spec.max_nodes]) == int(pb.rowptr[ds.spec.max_nodes])


@pytest.mark.parametrize("kind,pad_nodes,pad_edges,spatial_sort,edge_align", _TABLE_CASES)
def test_plain_collate_equals_batch_graphs(kind, pad_nodes, pad_edges, spatial_sort, edge_align):
    _, pb, plain, _ = _table_batches(_table_raws(kind), pad_nodes, pad_edges, spatial_sort,
                                     edge_align)
    for f in _FIELDS + _TABLE_FIELDS:
        a, b = getattr(plain, f), getattr(pb, f)
        assert (a is None) == (b is None) == (f.startswith("local") and kind != "bonds"), f
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), f
    assert plain.n_real_edges == pb.n_real_edges and plain.n_graphs == pb.n_graphs


@pytest.mark.parametrize("kind", ["random", "bonds"])
def test_batch_graphs_with_tables_sorts_nothing(kind, monkeypatch):
    raws = _table_raws(kind)
    _, want, _, ds = _table_batches(raws, 2, 3)
    spec = ds.batch_spec(len(raws))

    def no_sort(*args, **kwargs):
        raise AssertionError("a batch-wide sort ran")

    for name in ("argsort", "searchsorted", "bincount", "sort", "lexsort"):
        monkeypatch.setattr(np, name, no_sort)
    got = pgraph.batch_graphs(ds.graphs, spec, device="cpu", tables=ds.tables)
    monkeypatch.undo()
    for f in _FIELDS + _TABLE_FIELDS:
        if getattr(want, f) is not None:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_edge_table_rejects_ids_out_of_range():
    rng = np.random.default_rng(8)
    spec = pgraph.GraphSpec(max_nodes=10, max_edges=200, n_graphs=1, edge_attr_dim=2)
    g = pgraph.pad_graph(spec, **random_raw_graph(rng, 10))
    g["dst"][0] = 10
    with pytest.raises(ValueError, match="dst ids"):
        pgraph.edge_table(g, spec)
